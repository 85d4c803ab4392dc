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
@pytest.mark.parametrize("h,w,dark", [
    (37, 53, False), (37, 53, True), (129, 217, True), (900, 1600, False),
    (900, 1600, True), (1080, 1920, False), (1080, 1920, True)])
def test_ssim_kernel_against_float64(h, w, dark):
    """Sizes that are no multiple of the kernel's strip (108 columns) or
    block, natural-like and dark images (small denominators of the map
    amplify roundings: the float32 plain version itself stands up to 6e-5
    of max |g| from float64). Against the float64 plain version: the loss
    within 5e-7 (the reference's kernel test's bound), the gradient's
    worst pixel within 1e-4 of max |g| (the port's tolerance for this
    kernel); at the full sizes, where a root mean square over millions of
    pixels is a stable statistic, the gradient's is no larger than the
    float32 plain version's. Two launches agree bit for bit."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from h3dgs_tpu_torch.ops import ssim

    gen = torch.Generator(device="cuda").manual_seed(h * w + dark)
    if dark:
        x = 0.02 + 0.002 * torch.rand((3, h, w), generator=gen,
                                      device="cuda")
        y = 0.02 + 0.002 * torch.rand((3, h, w), generator=gen,
                                      device="cuda")
    else:
        y = torch.nn.functional.avg_pool2d(
            torch.rand((1, 3, h, w), generator=gen, device="cuda"), 9, 1,
            4)[0].contiguous()
        x = (y + 0.05 * torch.randn((3, h, w), generator=gen,
                                    device="cuda")).clamp(0, 1)
    loss, grad = ssim.fused_photometric_forward(x, y, 0.2)
    loss2, grad2 = ssim.fused_photometric_forward(x, y, 0.2)
    torch.cuda.synchronize()
    assert float(loss) == float(loss2) and torch.equal(grad, grad2)
    _, p_grad = ssim.fused_photometric_plain(x, y, 0.2)
    r_loss, r_grad = ssim.fused_photometric_plain(x.double(), y.double(),
                                                  0.2)
    assert abs(float(loss) - float(r_loss)) <= 5e-7
    k_d, p_d = grad.double() - r_grad, p_grad.double() - r_grad
    assert float(k_d.abs().max()) <= 1e-4 * float(r_grad.abs().max())
    if h >= 900:
        assert float(k_d.pow(2).mean().sqrt()) <= \
            float(p_d.pow(2).mean().sqrt())
    assert torch.isfinite(grad).all()


@pytest.mark.cuda
@pytest.mark.parametrize("h,w", [(48, 64), (100, 130), (900, 1600)])
def test_ssim_kernel_reference_contract(h, w):
    """The reference's own kernel test (tests/test_pallas_ssim.py) on the
    card: uniform random images from a numpy seed, the kernel against the
    float32 plain version, loss within 5e-7 and gradient within 5e-6 of
    its largest value."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernel has no CPU mode)")
    from h3dgs_tpu_torch.ops import ssim

    rng = np.random.default_rng(h * 1000 + w)
    x = torch.as_tensor(rng.uniform(0, 1, (3, h, w)).astype(np.float32),
                        device="cuda")
    y = torch.as_tensor(rng.uniform(0, 1, (3, h, w)).astype(np.float32),
                        device="cuda")
    loss, grad = ssim.fused_photometric_forward(x, y, 0.2)
    p_loss, p_grad = ssim.fused_photometric_plain(x, y, 0.2)
    assert abs(float(loss) - float(p_loss)) <= 5e-7
    assert float((grad - p_grad).abs().max()) <= \
        5e-6 * float(p_grad.abs().max())


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


# ---------------------------------------------------------------------------
# Crafted entry lists for the cases the blend kernels' batching, warp skips
# and cull can get wrong. One row of 16x16 tiles; every tile lists Gaussians
# of its own (entries of a tile are distinct Gaussians).

def _conic_of(s1, s2, theta):
    """Conic of the covariance R diag(s1^2, s2^2) R^T + 0.3 I."""
    c, s = np.cos(theta), np.sin(theta)
    xx = c * c * s1 ** 2 + s * s * s2 ** 2 + 0.3
    yy = s * s * s1 ** 2 + c * c * s2 ** 2 + 0.3
    xy = c * s * (s1 ** 2 - s2 ** 2)
    det = xx * yy - xy * xy
    return np.stack([yy / det, -xy / det, xx / det], -1)


def _crafted(kind, seed=0):
    """(blend args on the CPU, height, width, rows that no pair reaches)."""
    rng = np.random.default_rng(seed)
    # K1 stages 256 entries a batch, K2 128: none, one batch, one more
    # than a batch, several batches.
    counts = {"batches": [0, 128, 129, 256, 257, 700, 1],
              "ended_warp": [600], "thin": [400, 400, 400],
              "thresholds": [64, 64], "untouched": [40, 300]}[kind]
    n_tiles = len(counts)
    height, width = 16, 16 * n_tiles
    if kind in ("thin", "thresholds"):
        width -= 5                                   # ragged right edge
    means, conic, opac = [], [], []
    for t, cnt in enumerate(counts):
        cx = 16.0 * t
        m = np.stack([rng.uniform(cx - 3, cx + 19, cnt),
                      rng.uniform(-3, 19, cnt)], 1)
        if kind == "thin":
            q = _conic_of(rng.uniform(5, 40, cnt), rng.uniform(0.05, 0.4, cnt),
                          rng.uniform(0, np.pi, cnt))
            o = rng.uniform(0.02, 0.3, cnt)
        else:
            q = _conic_of(rng.uniform(0.8, 4.0, cnt),
                          rng.uniform(0.8, 4.0, cnt),
                          rng.uniform(0, np.pi, cnt))
            # Faint: the walk goes deep before a pixel ends.
            o = rng.uniform(0.01, 0.08, cnt)
        if kind == "ended_warp":
            # Three opaque pinpoint splats on each of the tile's top-left
            # 8x4 pixels come first: that warp's pixels end (T < 1e-4)
            # inside the first batch, the other warps walk on through the
            # later batches.
            xs, ys = np.meshgrid(np.arange(8.0), np.arange(4.0))
            m[:96] = np.tile(np.stack([xs.ravel(), ys.ravel()], 1), (3, 1))
            q[:96] = _conic_of(np.full(96, 0.1), np.full(96, 0.1),
                               np.zeros(96))
            o[:96] = 1.0
        if kind == "thresholds":
            # Means on pixel centres: expf(0) = 1, so alpha is the opacity,
            # a few float32 steps around 1/255 and around the 0.99 clamp.
            m = np.stack([cx + rng.integers(0, 16, cnt),
                          rng.integers(0, 16, cnt)], 1).astype(np.float64)
            steps = rng.integers(-3, 4, cnt)
            base = np.where(rng.random(cnt) < 0.5, np.float32(1.0 / 255.0),
                            np.float32(0.99))
            o = base.astype(np.float32)
            for _ in range(3):
                o = np.where(steps > 0, np.nextafter(o, np.float32(2)),
                             np.where(steps < 0,
                                      np.nextafter(o, np.float32(0)), o))
                steps = steps - np.sign(steps)
        means.append(m), conic.append(q), opac.append(o)
    means = np.concatenate(means).astype(np.float32)
    conic = np.concatenate(conic).astype(np.float32)
    opac = np.concatenate(opac).astype(np.float32)
    n = means.shape[0]
    untouched = []
    if kind == "untouched":
        # Listed in a tile, yet no pair contributes: an opacity under
        # 1/255, a splat far outside its tile, and one hidden behind
        # opaque splats that end every pixel of the first tile before it.
        opac[5] = 1.0 / 300.0
        means[7] = [400.0, -300.0]
        means[:4] = [[4.0, 4.0], [12.0, 4.0], [4.0, 12.0], [12.0, 12.0]]
        conic[:4] = _conic_of(np.full(4, 9.0), np.full(4, 9.0), np.zeros(4))
        opac[:4] = 1.0
        # Twelve more opaque rows on the same four spots: every pixel of
        # tile 0 ends well before its last entry.
        means[8:20] = np.tile(means[:4], (3, 1))
        conic[8:20] = np.tile(conic[:4], (3, 1))
        opac[8:20] = 1.0
        untouched = [5, 7, 39]
    gauss_idx = np.arange(n, dtype=np.int32)
    if kind == "untouched":
        # Tile 0 walks its opaque rows first, row 39 last.
        first = [0, 1, 2, 3] + list(range(8, 20))
        rest = [i for i in range(40) if i not in first]
        gauss_idx[:40] = first + rest
    tile_count = np.asarray(counts, np.int32)
    tile_start = (np.cumsum(tile_count) - tile_count).astype(np.int32)
    args = (torch.as_tensor(means), torch.as_tensor(conic),
            torch.as_tensor(rng.uniform(0, 1, (n, 3)).astype(np.float32)),
            torch.as_tensor(opac),
            torch.as_tensor(rng.uniform(0.1, 1, n).astype(np.float32)),
            torch.as_tensor(gauss_idx), torch.as_tensor(tile_start),
            torch.as_tensor(tile_count))
    return args, height, width, untouched


def _run_both(args, height, width, seed):
    """K1 and K2 on the card, and the plain versions on the CPU."""
    dev = [a.cuda().contiguous() for a in args]
    fwd = blend.blend_forward(*dev, height, width)
    gen = torch.Generator().manual_seed(seed)
    cot = (torch.randn((3, height, width), generator=gen),
           torch.randn((1, height, width), generator=gen),
           torch.randn((height, width), generator=gen))
    got = blend.blend_backward(*dev, *fwd, *(c.cuda() for c in cot), height,
                               width)
    torch.cuda.synchronize()
    fwd_plain = blend.blend_plain(*args, height, width)
    want = blend.blend_backward_plain(*args, *fwd_plain[:3], *cot, height,
                                      width)
    return fwd, got, fwd_plain, want


@pytest.mark.cuda
@pytest.mark.parametrize("kind", ["batches", "ended_warp", "thin",
                                  "thresholds", "untouched"])
def test_blend_kernels_crafted_cases(kind):
    """Tiles with no entry, exactly one staged batch, one entry more and
    several batches; a warp whose pixels all end before the later batches;
    thin rotated splats across the warps' footprints (the cull); alphas a
    few float32 steps around 1/255 and the 0.99 clamp; Gaussians listed in
    a tile that no pair reaches, whose gradient rows must stay exact
    zeros."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card (the kernels have no CPU mode)")
    args, height, width, untouched = _crafted(kind)
    fwd, got, fwd_plain, want = _run_both(args, height, width, 3)
    # K1: float32 rounding only; no termination flip allowed to hide a
    # lost or doubled entry (at most one pixel in a thousand over 1e-4).
    for g, w in zip(fwd[:3], fwd_plain[:3]):
        d = (g.cpu() - w).abs()
        assert (d > 1e-4).float().mean() <= 1e-3, (kind, float(d.max()))
        assert float(d.max()) <= 1e-3, (kind, float(d.max()))
    assert (fwd[3].cpu() == fwd_plain[3]).float().mean() >= 0.999
    if kind == "batches":
        assert bool((fwd[2][:, :16] == 1.0).all())      # the empty tile
        assert bool((fwd[3][:, :16] == -1).all())
    if kind == "ended_warp":
        # The first warp's pixels ended inside the first batch, the others
        # went on into the later ones.
        last = fwd[3].cpu()
        assert int(last[:4, :8].max()) < 128 < int(last[8:, 8:].min())
    for name, g, w in zip(("means2d", "conic", "rgb", "opacity",
                           "inv_depth"), got, want):
        _grad_close(g, w, (kind, name))
    nz_k = got[3].cpu() != 0
    nz_p = want[3] != 0
    tiny = (got[3].cpu().abs() < 1e-12) & (want[3].abs() < 1e-12)
    assert bool(((nz_k == nz_p) | tiny).all())
    for row in untouched:
        for g, w in zip(got, want):
            assert bool((w[row] == 0).all()), (kind, row)   # the scene holds
            assert bool((g[row] == 0).all()), (kind, row)   # bit for bit


@pytest.mark.cuda
def test_blend_backward_two_launches_agree():
    """atomicAdd order changes from launch to launch: two launches on the
    same inputs agree within K2's tolerance, and their masks are equal."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = [a.cuda().contiguous() for a in _blend_inputs(2000, 1, 333, 197,
                                                         0.2)]
    fwd = blend.blend_forward(*args, 197, 333)
    gen = torch.Generator(device="cuda").manual_seed(7)
    cot = (torch.randn((3, 197, 333), generator=gen, device="cuda"),
           torch.randn((1, 197, 333), generator=gen, device="cuda"),
           torch.randn((197, 333), generator=gen, device="cuda"))
    a = blend.blend_backward(*args, *fwd, *cot, 197, 333)
    b = blend.blend_backward(*args, *fwd, *cot, 197, 333)
    for name, x, y in zip(("means2d", "conic", "rgb", "opacity",
                           "inv_depth"), a, b):
        _grad_close(x, y, name)
    assert torch.equal(a[3] != 0, b[3] != 0)


@pytest.mark.cuda
def test_blend_autograd_uses_saved_rows():
    """Through autograd (the training path) K2 runs on the rows and the
    tile order that the forward saved: same gradients as the standalone
    wrapper, one launch of each kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    args = [a.cuda().contiguous() for a in _blend_inputs(500, 4, 120, 90,
                                                         0.3)]
    leaves = [a.clone().requires_grad_(True) for a in args[:5]]
    before = dict(kernels.LAUNCHES)
    color, invd, final_t, last = blend.blend_forward(*leaves, *args[5:], 90,
                                                     120)
    loss = (color.square().sum() + invd.sum() + (final_t * 0.5).sum())
    loss.backward()
    assert kernels.LAUNCHES["blend_fwd"] == before["blend_fwd"] + 1
    assert kernels.LAUNCHES["blend_bwd"] == before["blend_bwd"] + 1
    want = blend.blend_backward(
        *args, color.detach(), invd.detach(), final_t.detach(), last,
        2.0 * color.detach(), torch.ones_like(invd),
        torch.full_like(final_t, 0.5), 90, 120)
    for leaf, w in zip(leaves, want):
        _grad_close(leaf.grad, w.reshape(leaf.shape), "autograd")


@pytest.mark.cuda
def test_pack_prepass_and_occupancy():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    for n in (0, 1, 255, 256, 257, 5000):
        cols = [torch.randn((n, 2)), torch.randn((n, 3)), torch.randn((n, 3)),
                torch.randn(n), torch.randn(n)]
        rows = blend.pack_rows(*(c.cuda() for c in cols))
        assert torch.equal(rows.cpu(), blend.pack_rows_plain(*cols)), n
    with pytest.raises(ValueError, match="conic"):
        blend.pack_rows(cols[0].cuda(), cols[1].cuda().double(),
                        *(c.cuda() for c in cols[2:]))
    for name in ("blend_fwd", "blend_bwd"):
        blocks, threads = kernels.occupancy(name)
        assert blocks >= 1 and threads == 256


# ------------------------------------------------------------ evaluation ---

@pytest.mark.cuda
def test_lpips_card_matches_float64(tmp_path):
    """LPIPS on the card (cuDNN convolutions, TF32 switched off for them;
    ``chip_smoke.py``'s synthetic weights) within ``chip_smoke.LPIPS_REL``
    relative of the same network in float64 on the CPU, and the same
    distance with TF32 allowed beyond it (so the limit tells the two
    apart); TF32 left as it was outside the call."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chip_smoke import LPIPS_REL, synthetic_lpips_weights
    from h3dgs_tpu_torch.eval import metrics

    path = str(tmp_path / "lpips.npz")
    arrays = synthetic_lpips_weights(path)
    rng = np.random.default_rng(1)
    a = rng.uniform(0, 1, (3, 180, 320)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.05, a.shape), 0, 1).astype(np.float32)
    cudnn = torch.backends.cudnn
    tf32 = cudnn.allow_tf32
    got = metrics.lpips(a, b, weights_path=path)
    assert cudnn.allow_tf32 == tf32
    net = metrics.LPIPSNet(arrays).cuda()
    x = torch.as_tensor(np.stack([a, b])).cuda() * 2.0 - 1.0
    with torch.no_grad(), cudnn.flags(
            enabled=cudnn.enabled, benchmark=cudnn.benchmark,
            deterministic=cudnn.deterministic, allow_tf32=True):
        got_tf32 = float(net.distance(net.features(x)))
    net64 = metrics.LPIPSNet(arrays).double()
    with torch.no_grad():
        want = float(net64(torch.as_tensor(a), torch.as_tensor(b)))
    assert want > 0 and abs(got - want) <= LPIPS_REL * want, (got, want)
    assert abs(got_tf32 - want) > LPIPS_REL * want, (got_tf32, want)
    assert metrics.lpips(a, a, weights_path=path) < 1e-6


@pytest.mark.cuda
def test_render_on_card_matches_cpu():
    """``render`` with an exact index subset and a trained exposure on the
    card (one K1 launch) against the same call with ``device="cpu"``: the
    image within 1/255 but for termination flips (at most 1e-3 of the
    values), visibility and radii scattered back equal, zero off the
    subset; ``render_coarse`` the same way without them."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from h3dgs_tpu_torch import render as render_lib
    from h3dgs_tpu_torch.model import state as state_lib

    rng = np.random.default_rng(4)
    n, cap = 300, 320
    quats = rng.normal(size=(n, 4))
    opac = rng.uniform(0.3, 0.95, (n, 1))
    st = state_lib.from_arrays(
        rng.uniform(-1, 1, (n, 3)), rng.uniform(-0.6, 0.6, (n, 1, 3)),
        rng.normal(0, 0.1, (n, 3, 3)), np.log(opac / (1 - opac)),
        np.log(rng.uniform(0.04, 0.15, (n, 3))),
        quats / np.linalg.norm(quats, axis=1, keepdims=True),
        capacity=cap, max_sh_degree=1, device="cpu")
    cam = look_at_camera(eye=(0.3, -0.2, -3.2), target=(0, 0, 0), fovx=1.0,
                         width=160, height=120)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    exp = np.eye(3, 4, dtype=np.float32)
    exp[0, 0], exp[2, 1], exp[1, 3] = 0.9, 0.05, 0.02
    idx = np.arange(3, n, 2)

    def run(device):
        return render_lib.render(cam, st, bg, use_trained_exp=True,
                                 exposure=torch.as_tensor(exp),
                                 indices=torch.as_tensor(idx), device=device)

    kernels.reset_launches()
    card = run(None)
    torch.cuda.synchronize()
    assert kernels.LAUNCHES["blend_fwd"] == 1
    cpu = run("cpu")
    assert card["render"].is_cuda and set(card) == set(cpu)
    d = (card["render"].cpu() - cpu["render"]).abs()
    assert (d > 1.0 / 255).float().mean() <= 1e-3, float(d.max())
    assert float(card["render"].min()) >= 0 and float(card["render"].max()) <= 1
    vis = card["visibility_filter"].cpu()
    assert torch.equal(vis, cpu["visibility_filter"])
    assert torch.equal(card["radii"].cpu(), cpu["radii"])
    rows = np.zeros(cap, bool)
    rows[idx] = True
    assert int(vis.sum()) > 20 and not vis[~rows].any()
    assert not card["radii"].cpu()[~rows].any()

    card, cpu = (render_lib.render_coarse(cam, st, bg, device=dev)
                 for dev in (None, "cpu"))
    d = (card["render"].cpu() - cpu["render"]).abs()
    assert (d > 1.0 / 255).float().mean() <= 1e-3, float(d.max())
    assert torch.equal(card["radii"].cpu(), cpu["radii"])


def _write_tiny_scene(root, n=80, n_views=3, width=64, height=48):
    """A COLMAP scene written with ``chip_smoke.py``'s writers (the card's
    machine has no JAX): ground-truth PNGs rendered on the card, and the
    hierarchy of a perturbed copy of the Gaussians. Returns the
    hierarchy's path."""
    import os

    from chip_smoke import colmap_points, write_views
    from h3dgs_tpu_torch.hierarchy.io import write_hier
    from h3dgs_tpu_torch.hierarchy.tree import build_hierarchy
    from h3dgs_tpu_torch.io import colmap as colmap_io

    rng = np.random.default_rng(3)
    means = rng.uniform(-1, 1, (n, 3)).astype(np.float32)
    scales = np.exp(rng.uniform(np.log(0.06), np.log(0.18), (n, 3)))
    quats = np.tile(np.array([1.0, 0, 0, 0]), (n, 1))
    opac = rng.uniform(0.5, 0.95, n)
    shs = np.zeros((n, 16, 3))
    shs[:, 0] = rng.uniform(-0.6, 0.6, (n, 3))
    os.makedirs(os.path.join(root, "images"))
    cameras = [look_at_camera(eye=(4 * np.sin(a), -0.8, -4 * np.cos(a)),
                              target=(0, 0, 0), fovx=1.1, width=width,
                              height=height)
               for a in np.linspace(0, 2 * np.pi, n_views, endpoint=False)]
    gt = [torch.as_tensor(np.asarray(x, np.float32), device="cuda")
          for x in (means, scales, quats, opac, shs)]
    cams, imgs, _ = write_views(root, cameras, gt, depths=False)
    colmap_io.write_model_binary(os.path.join(root, "sparse", "0"), cams,
                                 imgs, colmap_points(means, shs, rng))
    hshs = shs + np.concatenate([rng.normal(0, 0.1, (n, 1, 3)),
                                 np.zeros((n, 15, 3))], axis=1)
    h = build_hierarchy(means + rng.normal(0, 0.02, means.shape), hshs,
                        opac * 0.9, np.log(scales), quats)
    path = os.path.join(root, "merged.hier")
    write_hier(path, h)
    return path


@pytest.mark.cuda
def test_render_hierarchy_on_card(tmp_path, monkeypatch):
    """``render_hierarchy`` on the card and on the CPU over the same tiny
    scene: K1 launched once per view and tau on the card; the same cut
    sizes; PSNR within 0.05 dB, SSIM within 1e-4, LPIPS (synthetic weights)
    within 1e-4 relative."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chip_smoke import synthetic_lpips_weights
    from h3dgs_tpu_torch.cli import render_hierarchy
    from h3dgs_tpu_torch.eval import metrics

    root = str(tmp_path / "scene")
    hier = _write_tiny_scene(root)
    weights = str(tmp_path / "lpips.npz")
    synthetic_lpips_weights(weights)
    monkeypatch.setenv(metrics.LPIPS_WEIGHTS_ENV, weights)
    argv = ["-s", root, "--hierarchy", hier, "--taus", "0", "30",
            "--no_images"]
    kernels.reset_launches()
    card = render_hierarchy.main(argv + ["-m", str(tmp_path / "card")])
    torch.cuda.synchronize()
    assert kernels.LAUNCHES == {"blend_fwd": 3 * 2, "blend_bwd": 0,
                                "ssim": 0}
    cpu = render_hierarchy.main(argv + ["-m", str(tmp_path / "cpu"),
                                        "--device", "cpu"])
    for tau in (0.0, 30.0):
        g, w = card[tau], cpu[tau]
        assert (g["cut_mean"], g["cut_min"], g["cut_max"]) == \
            (w["cut_mean"], w["cut_min"], w["cut_max"])
        assert abs(g["psnr"] - w["psnr"]) <= 0.05, (g, w)
        assert abs(g["ssim"] - w["ssim"]) <= 1e-4, (g, w)
        assert abs(g["lpips"] - w["lpips"]) <= 1e-4 * w["lpips"], (g, w)
    assert card[30.0]["cut_mean"] < card[0.0]["cut_mean"]
