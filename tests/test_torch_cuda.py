"""Kernel tests that need an NVIDIA card (marker ``cuda``; they skip
without one).

Torch-only on purpose: the machine with the card has no JAX, and the
repository's root ``conftest.py`` imports it, so run them there with
    python -m pytest --noconftest -p no:cacheprovider -m cuda tests/test_torch_cuda.py
Each kernel is held against its plain PyTorch version on the same inputs.
"""
from __future__ import annotations

import numpy as np
import pytest
import torch

from h3dgs_tpu_torch.ops import blend, kernels
from h3dgs_tpu_torch.ops.binning import bin_gaussians
from h3dgs_tpu_torch.ops.projection import project_gaussians
from h3dgs_tpu_torch.ops.rasterize import blend_args
from h3dgs_tpu_torch.scene.camera import look_at_camera

torch.set_num_threads(2)


def _blend_inputs(n, seed, width, height, opacity_lo):
    """Binned blend inputs of a seeded random scene (CPU tensors)."""
    rng = np.random.default_rng(seed)
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    scales = np.exp(rng.uniform(np.log(0.02), np.log(0.3), (n, 3)))
    quats = rng.normal(size=(n, 4))
    opac = rng.uniform(opacity_lo, 1.0, n)
    shs = rng.normal(0.0, 0.3, (n, 4, 3))
    shs[:, 0] = rng.uniform(-1.0, 1.5, (n, 3))
    cam = look_at_camera(eye=(0.2, -0.3, -3.0), target=(0, 0, 0), fovx=1.0,
                         width=width, height=height)
    t = [torch.as_tensor(np.asarray(a, np.float32))
         for a in (means, scales, quats, opac, shs)]
    proj = project_gaussians(*t, cam, 1)
    return blend_args(proj, bin_gaussians(proj, height, width))


@pytest.mark.cuda
@pytest.mark.parametrize("n,seed,width,height,opacity_lo", [
    (300, 0, 72, 52, 0.9),      # opaque: pixels terminate, 0.99 clamp hit
    (2000, 1, 333, 197, 0.2),   # ragged image edge, deep tiles
])
def test_blend_kernel_matches_plain(n, seed, width, height, opacity_lo):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    args = _blend_inputs(n, seed, width, height, opacity_lo)
    dev_args = tuple(a.cuda().contiguous() for a in args)
    before = kernels.LAUNCHES["blend_fwd"]
    got = blend.blend_forward(*dev_args, height, width)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["blend_fwd"] == before + 1
    want = blend.blend_plain(*args, height, width)
    # float32 rounding (expf, summation order): 1e-4, except pixels whose
    # termination test flips within rounding (at most 0.1 %).
    for g, w in zip(got[:3], want[:3]):
        d = (g.cpu() - w).abs()
        assert (d > 1e-4).float().mean() <= 1e-3, float(d.max())
    assert (got[3].cpu() == want[3]).float().mean() >= 0.999


@pytest.mark.cuda
def test_blend_kernel_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = [a.cuda().contiguous() for a in _blend_inputs(50, 2, 32, 32,
                                                         0.5)]
    bad = list(args)
    bad[0] = bad[0].double()                   # means2d not float32
    with pytest.raises(ValueError, match="means2d"):
        blend.blend_forward(*bad, 32, 32)
    bad = list(args)
    bad[6] = bad[6].cpu()                      # tile_start on the CPU
    with pytest.raises(ValueError, match="tile_start"):
        blend.blend_forward(*bad, 32, 32)
    with pytest.raises(ValueError, match="tile_start"):
        blend.blend_forward(*args, 48, 32)     # tile grid of another size


def _grad_close(got, want, what):
    """K2 tolerance: atomicAdd order makes the per-Gaussian sums
    non-deterministic, so max |d| <= 1e-3 max |g| and cosine >= 0.9999."""
    got = got.double().cpu().reshape(-1)
    want = want.double().cpu().reshape(-1)
    scale = float(want.abs().max())
    assert float((got - want).abs().max()) <= 1e-3 * scale + 1e-12, what
    cos = float(torch.dot(got, want)
                / (got.norm() * want.norm()).clamp_min(1e-30))
    assert cos >= 0.9999 or scale == 0.0, (what, cos)


@pytest.mark.cuda
@pytest.mark.parametrize("n,seed,width,height,opacity_lo", [
    (300, 0, 72, 52, 0.9),      # opaque: pixels terminate, 0.99 clamp hit
    (2000, 1, 333, 197, 0.2),   # ragged image edge, deep tiles
])
def test_blend_backward_kernel_matches_plain(n, seed, width, height,
                                             opacity_lo):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    args = [a.cuda().contiguous() for a in _blend_inputs(
        n, seed, width, height, opacity_lo)]
    color, invd, final_t, last = blend.blend_forward(*args, height, width)
    gen = torch.Generator(device="cuda").manual_seed(seed)
    g_color = torch.randn((3, height, width), generator=gen, device="cuda")
    g_invd = torch.randn((1, height, width), generator=gen, device="cuda")
    g_t = torch.randn((height, width), generator=gen, device="cuda")
    before = kernels.LAUNCHES["blend_bwd"]
    got = blend.blend_backward(*args, color, invd, final_t, last, g_color,
                               g_invd, g_t, height, width)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["blend_bwd"] == before + 1
    want = blend.blend_backward_plain(*args, color, invd, final_t, g_color,
                                      g_invd, g_t, height, width)
    for name, g, w in zip(("means2d", "conic", "rgb", "opacity",
                           "inv_depth"), got, want):
        _grad_close(g, w, name)
    # The sparse-Adam mask reads exact zeros: the same rows are nonzero.
    nz_k = got[3] != 0
    nz_p = want[3] != 0
    tiny = (got[3].abs() < 1e-12) & (want[3].abs() < 1e-12)
    assert bool(((nz_k == nz_p) | tiny).all())


@pytest.mark.cuda
def test_blend_backward_kernel_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = [a.cuda().contiguous() for a in _blend_inputs(50, 2, 32, 32,
                                                         0.5)]
    color, invd, final_t, last = blend.blend_forward(*args, 32, 32)
    g = torch.ones((3, 32, 32), device="cuda")
    g1 = torch.ones((1, 32, 32), device="cuda")
    gt = torch.ones((32, 32), device="cuda")
    with pytest.raises(ValueError, match="g_color"):
        blend.blend_backward(*args, color, invd, final_t, last, g[:2],
                             g1, gt, 32, 32)
    with pytest.raises(ValueError, match="last"):
        blend.blend_backward(*args, color, invd, final_t, last.long(), g,
                             g1, gt, 32, 32)
    with pytest.raises(ValueError, match="g_t"):
        blend.blend_backward(*args, color, invd, final_t, last, g, g1,
                             gt.cpu(), 32, 32)


@pytest.mark.cuda
@pytest.mark.parametrize("h,w,dark", [(61, 83, False), (128, 96, True),
                                      (11, 11, False)])
def test_ssim_kernel_matches_plain(h, w, dark):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from h3dgs_tpu_torch.ops import ssim

    rng = np.random.default_rng(h * w)
    if dark:
        # Dark, low-variance images: the variance terms cancel (H1).
        x = 0.02 + 0.002 * rng.random((3, h, w))
        y = 0.02 + 0.002 * rng.random((3, h, w))
    else:
        x = rng.random((3, h, w))
        y = np.clip(x + 0.1 * rng.normal(size=(3, h, w)), 0, 1)
    x = torch.as_tensor(x, dtype=torch.float32)
    y = torch.as_tensor(y, dtype=torch.float32)
    before = kernels.LAUNCHES["ssim"]
    loss, grad = ssim.fused_photometric_forward(x.cuda(), y.cuda(), 0.2)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["ssim"] == before + 1
    want_loss, want_grad = ssim.fused_photometric_plain(x, y, 0.2)
    assert abs(float(loss) - float(want_loss)) <= 1e-6
    scale = float(want_grad.abs().max())
    assert float((grad.cpu() - want_grad).abs().max()) <= 1e-4 * scale
    # Through autograd: pred gets the gradient, target none.
    xp = x.cuda().requires_grad_(True)
    yt = y.cuda().requires_grad_(True)
    ssim.fused_photometric_loss(xp, yt, 0.2).backward()
    assert yt.grad is None
    assert float((xp.grad.cpu() - want_grad).abs().max()) <= 1e-4 * scale


@pytest.mark.cuda
def test_ssim_kernel_rejects_bad_inputs():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from h3dgs_tpu_torch.ops import ssim

    x = torch.rand((3, 20, 20), device="cuda")
    with pytest.raises(ValueError, match="pred"):
        ssim.fused_photometric_forward(x.double(), x.double(), 0.2)
    with pytest.raises(ValueError, match="target"):
        ssim.fused_photometric_forward(x, x.cpu(), 0.2)
    with pytest.raises(ValueError, match="H, W"):
        small = x[:, :8].contiguous()
        ssim.fused_photometric_forward(small, small, 0.2)
