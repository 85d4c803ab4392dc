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
