"""What the blend wrappers prepare around the CUDA kernels, on the CPU:
the packed row layout and K2's gradient rows, the tile order, and the
safety of the per-footprint cull (``cull_plain`` is the plain form of
``csrc/blend_common.cuh:cull_footprint``). The kernels themselves are held
against the plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``); the plain versions against the JAX package in
``tests/test_torch_ops.py`` and ``tests/test_torch_train.py``."""
from __future__ import annotations

import numpy as np
import pytest
import torch

from h3dgs_tpu_torch.ops import blend

torch.set_num_threads(2)


def _columns(n, seed):
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.normal(size=s).astype(np.float32))
            for s in ((n, 2), (n, 3), (n, 3), (n,), (n,))]


def test_pack_rows_layout_and_round_trip():
    cols = _columns(37, 0)
    rows = blend.pack_rows(*cols)          # CPU tensors: the plain version
    assert rows.shape == (37, blend.ROW_COLS) and rows.dtype == torch.float32
    means2d, conic, rgb, opacity, inv_depth = cols
    # mx, my, opacity, inv_depth | ca, cb, cc, 0 | r, g, b, 0
    assert torch.equal(rows[:, 0:2], means2d)
    assert torch.equal(rows[:, 2], opacity)
    assert torch.equal(rows[:, 3], inv_depth)
    assert torch.equal(rows[:, 4:7], conic)
    assert torch.equal(rows[:, 8:11], rgb)
    assert bool((rows[:, 7] == 0).all()) and bool((rows[:, 11] == 0).all())
    for got, want in zip(blend.unpack_grads(rows), cols):
        assert got.shape == want.shape and torch.equal(got, want)


def test_unpack_grads_keeps_exact_zeros():
    """The sparse-Adam mask reads ``g_opacity != 0``: rows the kernel never
    touched unpack to exact zeros, touched rows to their values."""
    rows = torch.zeros((6, blend.ROW_COLS))
    rows[2] = torch.arange(1.0, 13.0)
    rows[4, 2] = -1e-30                    # a tiny opacity gradient survives
    rows[5, 2] = -0.0                      # a negative zero is no gradient
    g_means, g_conic, g_rgb, g_opacity, g_invd = blend.unpack_grads(rows)
    assert (g_opacity != 0).tolist() == [False, False, True, False, True,
                                         False]
    for g in (g_means, g_conic, g_rgb, g_invd):
        assert bool((g[[0, 1, 3, 5]] == 0).all())
    assert g_means[2].tolist() == [1.0, 2.0]
    assert float(g_opacity[2]) == 3.0 and float(g_invd[2]) == 4.0
    assert g_conic[2].tolist() == [5.0, 6.0, 7.0]
    assert g_rgb[2].tolist() == [9.0, 10.0, 11.0]


@pytest.mark.parametrize("counts", [
    [3, 5, 5, 0, 9],
    [0, 0, 0, 0],
    [7],
    [],
    list(np.random.default_rng(1).integers(0, 40, 500)),
])
def test_tile_order_is_deepest_first_and_stable(counts):
    tile_count = torch.as_tensor(counts, dtype=torch.int32)
    order = blend.tile_order(tile_count)
    assert order.dtype == torch.int64 and order.shape == tile_count.shape
    assert sorted(order.tolist()) == list(range(len(counts)))
    taken = tile_count[order].tolist()
    assert taken == sorted(counts, reverse=True)
    # Ties keep tile order.
    for a, b in zip(order.tolist(), order.tolist()[1:]):
        if counts[a] == counts[b]:
            assert a < b


def _conics(rng, n, thin):
    """Conics of 2D covariances R diag(s1^2, s2^2) R^T + 0.3 I (the
    projection's low-pass), float32."""
    s1 = np.exp(rng.uniform(np.log(0.3), np.log(300.0 if thin else 12.0), n))
    s2 = s1 * (rng.uniform(1e-3, 0.05, n) if thin
               else rng.uniform(0.2, 1.0, n))
    th = rng.uniform(0, np.pi, n)
    c, s = np.cos(th), np.sin(th)
    xx = c * c * s1 ** 2 + s * s * s2 ** 2 + 0.3
    yy = s * s * s1 ** 2 + c * c * s2 ** 2 + 0.3
    xy = c * s * (s1 ** 2 - s2 ** 2)
    det = xx * yy - xy * xy
    return np.stack([yy / det, -xy / det, xx / det], 1).astype(np.float32)


def _cull_scene(kind, seed, n=3000, size=48):
    rng = np.random.default_rng(seed)
    thin = kind in ("thin", "far", "boundary")
    conic = _conics(rng, n, thin)
    means = rng.uniform(-40.0, size + 40.0, (n, 2))
    if kind == "far":
        # Long thin splats, half of them centred far off screen.
        far = rng.random(n) < 0.5
        means[far] = rng.uniform(-3000.0, 3000.0, (int(far.sum()), 2))
    means = means.astype(np.float32)
    opacity = rng.uniform(0.01, 1.0, n)
    if kind == "threshold":
        # Around 1/255 (nothing ever passes below it) and around the clamp.
        opacity = np.where(rng.random(n) < 0.5,
                           (1.0 / 255.0) * rng.uniform(0.9, 1.3, n),
                           rng.uniform(0.97, 1.0, n))
    return means, conic, opacity.astype(np.float32)


@pytest.mark.parametrize("origin", [(0, 0), (1872, 1040)])
@pytest.mark.parametrize("kind", ["round", "thin", "threshold", "far",
                                  "boundary"])
def test_cull_plain_never_culls_a_passing_pixel(kind, origin):
    """Over seeded scenes (round, thin and rotated, opacities at the 1/255
    and 0.99 thresholds, means far off screen, means placed where a
    footprint's nearest column sits on the alpha = 1/255 contour): the cull
    is never true for an (entry, 8x4 footprint) in which any pixel passes
    the exact float32 test ``power <= 0 and alpha >= 1/255``."""
    size = 48
    means, conic, opacity = _cull_scene(kind, 11 + len(kind))
    ox, oy = origin
    means = means + np.asarray([ox, oy], np.float32)
    if kind == "boundary":
        # Put each mean left of the first footprint column by the contour's
        # half-extent sqrt(2 L cc / det), times 1 -+ a few float32 ulps to
        # 1e-3: the cull's decision sits on its own threshold.
        ca, cb, cc = (conic[:, i].astype(np.float64) for i in range(3))
        big_l = np.log(255.0 * opacity.astype(np.float64))
        ext = np.sqrt(np.maximum(2.0 * big_l * cc / (ca * cc - cb * cb), 0))
        jitter = np.random.default_rng(5).choice(
            [-1e-3, -1e-5, -3e-7, 0.0, 3e-7, 1e-5, 1e-3], len(ext))
        means[:, 0] = (ox + 8.0 - ext * (1.0 + jitter)).astype(np.float32)
    m, q, o = (torch.as_tensor(a) for a in (means, conic, opacity))

    fx0 = torch.arange(ox, ox + size, 8, dtype=torch.float32)
    fy0 = torch.arange(oy, oy + size, 4, dtype=torch.float32)
    x0 = fx0.repeat(len(fy0))[None, :]                           # [1, F]
    y0 = fy0.repeat_interleave(len(fx0))[None, :]
    culled = blend.cull_plain(m[:, None, :], q[:, None, :], o[:, None],
                              x0, x0 + 7.0, y0, y0 + 3.0)        # [G, F]

    # The exact test, as blend_plain writes it, on the footprints' pixels.
    px = (x0[..., None] + torch.arange(8.0).repeat(4))           # [1, F, 32]
    py = (y0[..., None] + torch.arange(4.0).repeat_interleave(8))
    dx = px - m[:, None, None, 0]
    dy = py - m[:, None, None, 1]
    ca, cb, cc = (q[:, None, None, i] for i in range(3))
    power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
    alpha = torch.clamp_max(o[:, None, None] * torch.exp(power),
                            blend.ALPHA_MAX)
    passes = ((power <= 0.0) & (alpha >= blend.ALPHA_EPS)).any(-1)  # [G, F]

    assert not bool((culled & passes).any()), int((culled & passes).sum())
    # Not vacuous: some footprints have a passing pixel, and the cull
    # removes a good part of those that have none.
    assert int(passes.sum()) > 0
    empty = ~passes
    assert float((culled & empty).sum()) >= 0.3 * float(empty.sum())


def test_cull_plain_does_not_cull_in_doubt():
    """NaN inputs and conics that are not positive definite are never
    culled by the rectangle test; an opacity under 1/255 always is."""
    m = torch.tensor([[100.0, 100.0]] * 4)
    q = torch.tensor([[1.0, 2.0, 1.0],            # negative determinant
                      [float("nan"), 0.0, 1.0],
                      [1.0, 0.0, 1.0],
                      [1.0, 0.0, 1.0]])
    o = torch.tensor([0.5, 0.5, float("nan"), 1.0 / 300.0])
    got = blend.cull_plain(m, q, o, 0.0, 7.0, 0.0, 3.0)
    assert got.tolist() == [False, False, False, True]
