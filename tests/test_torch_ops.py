"""Parity of the port's camera, SH, projection, binning, blend and
rasterizer with the JAX package (XLA path, the CPU default), on the same
seeded numpy inputs. Tolerances are stated per test."""
from __future__ import annotations

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h3dgs_tpu.ops import binning as jbin
from h3dgs_tpu.ops import projection as jproj
from h3dgs_tpu.ops import rasterize as jras
from h3dgs_tpu.ops.reference import blend_reference
from h3dgs_tpu.train.step import apply_exposure as japply_exposure
from h3dgs_tpu.utils import sh as jsh
from h3dgs_tpu.utils import transforms as jtr
from h3dgs_tpu_torch.ops import binning as tbin
from h3dgs_tpu_torch.ops import blend as tblend
from h3dgs_tpu_torch.ops import projection as tproj
from h3dgs_tpu_torch.ops import rasterize as tras
from h3dgs_tpu_torch.train.step import apply_exposure as tapply_exposure
from h3dgs_tpu_torch.utils import sh as tsh
from h3dgs_tpu_torch.utils import transforms as ttr

from .test_torch_common import camera_pair, np_, scene_tensors, t_
from .utils import random_scene

torch.set_num_threads(2)

# The XLA blend's per-tile cap; parity scenes stay under it (the XLA path
# silently stops at max_per_tile, the port never truncates).
XCFG = jras.RasterizeConfig(max_entries=1 << 15, max_per_tile=1024,
                            chunk=32, backend="xla")


def _near(a, b, tol, frac=1e-3):
    """|a - b| <= tol except on at most ``frac`` of the elements (pixels
    whose termination test flips within float32 rounding)."""
    d = np.abs(np_(a).astype(np.float64) - np_(b).astype(np.float64))
    assert np.isfinite(d).all()
    bad = (d > tol).mean()
    assert bad <= frac, (bad, d.max())
    return d


def _proj_to_torch(p) -> tproj.ProjectedGaussians:
    return tproj.ProjectedGaussians(*(t_(x) for x in p))


def _dense_scene(n=300, seed=3):
    """Opaque, overlapping splats: pixels terminate (T < 1e-4) and the
    0.99 alpha clamp is hit."""
    return random_scene(n, seed, sh_degree=1, spread=0.5, opacity_lo=0.9,
                        opacity_hi=1.0, scale_lo=0.08, scale_hi=0.3)


def test_camera_and_sh():
    jc, tc = camera_pair((0.3, -0.2, -4.0), fovx=1.1, width=80, height=56)
    for f in ("view", "full_proj", "cam_center", "tanfovx", "tanfovy"):
        np.testing.assert_array_equal(np.asarray(getattr(jc, f)),
                                      np_(getattr(tc, f)))
    assert (tc.height, tc.width) == (jc.height, jc.width)
    np.testing.assert_allclose(np_(tc.focal_x), np.asarray(jc.focal_x),
                               rtol=1e-7)

    rng = np.random.default_rng(0)
    sh = rng.normal(size=(64, 25, 3)).astype(np.float32)
    dirs = rng.normal(size=(64, 3)).astype(np.float32)
    dirs /= np.linalg.norm(dirs, axis=1, keepdims=True)
    for deg in range(5):
        # float32 polynomial in the same order: ~1 ulp.
        np.testing.assert_allclose(
            np_(tsh.eval_sh(deg, t_(sh), t_(dirs))),
            np.asarray(jsh.eval_sh(deg, jnp.asarray(sh), jnp.asarray(dirs))),
            rtol=1e-5, atol=1e-6)
    rgb = rng.uniform(size=(8, 3)).astype(np.float32)
    np.testing.assert_allclose(np_(tsh.rgb_to_sh(t_(rgb))),
                               np.asarray(jsh.rgb_to_sh(rgb)), rtol=1e-7)
    q = rng.normal(size=(32, 4)).astype(np.float32)
    np.testing.assert_allclose(np_(ttr.normalize_quat(t_(q))),
                               np.asarray(jtr.normalize_quat(q)),
                               rtol=1e-6, atol=1e-7)
    ex = rng.normal(size=(3, 4)).astype(np.float32)
    img = rng.uniform(size=(3, 8, 10)).astype(np.float32)
    np.testing.assert_allclose(np_(tapply_exposure(t_(img), t_(ex))),
                               np.asarray(japply_exposure(img, ex)),
                               rtol=1e-5, atol=1e-6)


def test_projection_parity():
    means, scales, quats, opac, shs = random_scene(500, 1, sh_degree=3,
                                                   spread=3.2)
    jc, tc = camera_pair((0.3, -0.2, -3.0), fovx=1.1, width=96, height=64)
    jp = jproj.project_gaussians(means, scales, quats, opac, shs, jc, 3)
    tp = tproj.project_gaussians(*scene_tensors(means, scales, quats, opac,
                                                shs), tc, 3)
    valid = np.asarray(jp.valid)
    assert valid.sum() > 100 and (~valid).sum() > 0   # near cull exercised
    np.testing.assert_array_equal(np_(tp.valid), valid)
    # Radius = ceil(3 sqrt(lambda)): a float32 rounding at an integer
    # boundary may move it by 1 on a rare row.
    assert (np_(tp.radius) == np.asarray(jp.radius)).mean() >= 0.999
    v = valid
    # float32, same per-component formula: relative ~1e-6.
    for f in ("means2d", "conic", "rgb", "depth"):
        np.testing.assert_allclose(np_(getattr(tp, f))[v],
                                   np.asarray(getattr(jp, f))[v],
                                   rtol=2e-5, atol=1e-5, err_msg=f)


def test_binning_parity():
    """Same projected inputs: per-tile counts exact, per-tile entry order
    equal (depths are distinct)."""
    means, scales, quats, opac, shs = random_scene(400, 2, sh_degree=1,
                                                   spread=1.2)
    jc, _ = camera_pair((0.2, -0.3, -3.5), fovx=1.0, width=100, height=70)
    jp = jproj.project_gaussians(means, scales, quats, opac, shs, jc, 1)
    jb = jbin.bin_gaussians(jp, 70, 100, 1 << 15)
    tb = tbin.bin_gaussians(_proj_to_torch(jp), 70, 100)
    total = int(jb.total_entries)
    assert 0 < total < (1 << 15)
    assert int(tb.total_entries) == total == tb.gauss_idx.shape[0]
    np.testing.assert_array_equal(np_(tb.tile_count),
                                  np.asarray(jb.tile_count))
    np.testing.assert_array_equal(np_(tb.tile_start),
                                  np.asarray(jb.tile_start))
    np.testing.assert_array_equal(np_(tb.gauss_idx),
                                  np.asarray(jb.gauss_idx)[:total])


def test_binning_depth_ties_by_index():
    """Exact depth ties in a tile are ordered by Gaussian index."""
    n = 6
    proj = tproj.ProjectedGaussians(
        means2d=torch.full((n, 2), 8.0), conic=torch.tensor([[0.5, 0, 0.5]]
                                                             ).repeat(n, 1),
        rgb=torch.ones(n, 3), opacity=torch.full((n,), 0.5),
        depth=torch.tensor([2.0, 1.0, 2.0, 1.0, 3.0, 1.0]),
        radius=torch.full((n,), 3, dtype=torch.int32),
        valid=torch.ones(n, dtype=torch.bool))
    b = tbin.bin_gaussians(proj, 16, 16)
    assert b.gauss_idx.tolist() == [1, 3, 5, 0, 2, 4]


@pytest.fixture(scope="module")
def dense_blend_inputs():
    means, scales, quats, opac, shs = _dense_scene()
    jc, tc = camera_pair((0.1, -0.1, -3.0), fovx=1.0, width=72, height=52)
    jp = jproj.project_gaussians(means, scales, quats, opac, shs, jc, 1)
    jb = jbin.bin_gaussians(jp, 52, 72, XCFG.max_entries)
    assert int(np.asarray(jb.tile_count).max()) < XCFG.max_per_tile
    tp = _proj_to_torch(jp)
    tb = tbin.bin_gaussians(tp, 52, 72)
    inv_depth = 1.0 / torch.clamp_min(tp.depth, 1e-6)
    args = (tp.means2d, tp.conic, tp.rgb, tp.opacity, inv_depth,
            tb.gauss_idx, tb.tile_start, tb.tile_count)
    return jc, jp, jb, tb, args


def test_blend_plain_matches_xla_and_reference(dense_blend_inputs):
    jc, jp, jb, tb, args = dense_blend_inputs
    color, invd, trans, last = tblend.blend_plain(*args, 52, 72)
    bg = jnp.zeros(3, jnp.float32)
    x_img, x_invd, x_t = jras.blend_tiles(jp, jb, 52, 72, bg, XCFG)
    r_img, r_invd, r_t = blend_reference(jp, jc, bg)

    t = np_(trans)
    assert (t < 1e-3).mean() > 0.05          # pixels terminate
    assert float(np.max(np.asarray(jp.opacity))) > 0.99  # clamp is hit
    # Against the XLA tile blend: 1e-4 except termination flips (0.1 %).
    _near(color, x_img, 1e-4)
    _near(invd, x_invd, 1e-4)
    _near(trans, x_t, 1e-4)
    # Against the all-pairs oracle: the tiled paths cap each splat at its
    # 3-sigma radius (as the CUDA rasterizer does) while the oracle does
    # not, so opaque splats' outer rims differ; held to the JAX package's
    # own dense-overdraw bound (tests/test_rasterize.py: 1 % of pixels
    # beyond 3e-5, none beyond 0.05), which the XLA path meets the same way.
    for got, ref in ((color, r_img), (invd, r_invd), (trans, r_t)):
        d = _near(got, ref, 3e-5, frac=0.01)
        assert d.max() <= 0.05

    # The last contributing entry lies inside the pixel's tile range.
    ty, tx = np.meshgrid(np.arange(52) // 16, np.arange(72) // 16,
                         indexing="ij")
    tile = ty * 5 + tx
    start = np_(tb.tile_start)[tile]
    count = np_(tb.tile_count)[tile]
    lst = np_(last)
    has = lst >= 0
    assert has.mean() > 0.5
    assert ((lst[has] >= start[has]) & (lst[has] < start[has]
                                        + count[has])).all()


def test_blend_plain_chunk_size_invariant(dense_blend_inputs):
    """The chunked walk carries T and the termination flag exactly: chunk
    size changes only float32 rounding, never which entries count."""
    *_, args = dense_blend_inputs
    a = tblend.blend_plain(*args, 52, 72, chunk=7)
    b = tblend.blend_plain(*args, 52, 72, chunk=64)
    for x, y in zip(a[:3], b[:3]):
        _near(x, y, 1e-5)
    assert (np_(a[3]) == np_(b[3])).mean() >= 0.999


def test_rasterize_parity():
    means, scales, quats, opac, shs = random_scene(300, 5, sh_degree=2,
                                                   spread=1.0)
    jc, tc = camera_pair((0.3, -0.2, -3.0), fovx=1.0, width=80, height=60)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    jo = jras.rasterize(means, scales, quats, opac, shs, jc, 2,
                        jnp.asarray(bg), config=XCFG)
    to = tras.rasterize(*scene_tensors(means, scales, quats, opac, shs), tc,
                        2, t_(bg))
    # The JAX package's entry-budget counters have no counterpart: the
    # port drops nothing, and its entry count is n_duplicates.
    budget = {"n_truncated", "n_raw", "n_bwd_quanta"}
    assert set(to) == set(jo) - budget
    assert int(to["n_duplicates"]) == int(jo["n_duplicates"])
    assert int(to["n_duplicates"]) == int(jo["n_raw"])
    assert int(jo["n_truncated"]) == 0
    assert (np_(to["radii"]) == np.asarray(jo["radii"])).mean() >= 0.999
    # float32 projection + blend: 1e-4 except termination flips.
    _near(to["render"], jo["render"], 1e-4)
    _near(to["invdepth"], jo["invdepth"], 1e-4)
    _near(to["final_transmittance"], jo["final_transmittance"], 1e-4)
