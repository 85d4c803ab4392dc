"""Tile binning: duplicate Gaussians per overlapped tile and depth-sort.

Counterpart of ``h3dgs_tpu/ops/binning.py:bin_gaussians``. Each visible
Gaussian covers a tile rectangle (the ``_tight_rects`` rule); its
duplicates are generated with ``repeat_interleave`` and ordered by one
stable ``torch.sort`` on a packed int64 key ``tile_id << 32 | bits(depth)``.
Depth is > 0.2 for every visible Gaussian, so its float32 bits sort like
the floats; the stable sort over entries generated in Gaussian order
breaks exact depth ties by Gaussian index.

Unlike the reference, the entry list is allocated at the exact
``total_entries``: nothing is dropped at a budget, so there is no
``max_entries``. The TPU's chunk-aligned layout (``bin_gaussians_aligned``)
is not ported. Two reads size the work on the host: the entry count
(``repeat_interleave``) and the tile counts (``bincount`` reads the ids'
range); each runs in a ``.sync`` span, and the counter
``raster.entries`` adds the entry count (``utils/profiling.py``).
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from ..utils import profiling
from .projection import ProjectedGaussians

TILE = 16  # pixels per tile side


def num_tiles(height: int, width: int, tile: int = TILE):
    ty = -(-height // tile)
    tx = -(-width // tile)
    return ty, tx


class BinnedGaussians(NamedTuple):
    """Depth-sorted entries, contiguous per tile."""
    gauss_idx: torch.Tensor      # [D] int32 source Gaussian per entry
    tile_start: torch.Tensor     # [T] int32 first entry of each tile
    tile_count: torch.Tensor     # [T] int32 entries in each tile
    total_entries: torch.Tensor  # [] int32 (== D)


def _floor_tile(v: torch.Tensor, tile: int, hi: int) -> torch.Tensor:
    """floor(v / tile) as int32, clamped to [-1, hi + 1] before the cast so
    far-off-screen splats cannot overflow it (the callers clip to
    [0, hi], so the clamp changes no result)."""
    return torch.clamp(torch.floor(v / tile), -1.0, hi + 1.0).to(torch.int32)


def _tight_rects(proj: ProjectedGaussians, tiles_y: int, tiles_x: int,
                 tile: int):
    """Tile rectangle per splat from the tight per-axis alpha bbox.

    {alpha >= 1/255} = {power >= -L} with L = ln(255*opac), whose
    axis-aligned half-extents are sqrt(2*L*cov_xx) / sqrt(2*L*cov_yy)
    (cov2d = conic^-1), capped by the radius.

    Returns (rect_min_x, rect_min_y, span_x, span_y, counts).
    """
    x = proj.means2d[:, 0]
    y = proj.means2d[:, 1]
    r = proj.radius.to(x.dtype)
    ca = proj.conic[:, 0]
    cb = proj.conic[:, 1]
    cc = proj.conic[:, 2]
    det_c = torch.clamp_min(ca * cc - cb * cb, 1e-24)
    big_l = torch.log(torch.clamp_min(255.0 * proj.opacity, 1.0 + 1e-6))
    # cov_xx = cc/det_c, cov_yy = ca/det_c; 1e-3 px guards sqrt rounding.
    ext_x = torch.minimum(torch.sqrt(2.0 * big_l * cc / det_c) + 1e-3, r)
    ext_y = torch.minimum(torch.sqrt(2.0 * big_l * ca / det_c) + 1e-3, r)
    # Covered columns are [x-ext, x+ext]; the exclusive tile bound is
    # floor((x+ext)/tile) + 1.
    rect_min_x = _floor_tile(x - ext_x, tile, tiles_x).clamp(0, tiles_x)
    rect_min_y = _floor_tile(y - ext_y, tile, tiles_y).clamp(0, tiles_y)
    rect_max_x = (_floor_tile(x + ext_x, tile, tiles_x) + 1).clamp(0, tiles_x)
    rect_max_y = (_floor_tile(y + ext_y, tile, tiles_y) + 1).clamp(0, tiles_y)
    span_x = torch.clamp_min(rect_max_x - rect_min_x, 0)
    span_y = torch.clamp_min(rect_max_y - rect_min_y, 0)
    counts = torch.where(proj.valid & (proj.radius > 0), span_x * span_y,
                         torch.zeros_like(span_x))
    return rect_min_x, rect_min_y, span_x, span_y, counts


def bin_gaussians(proj: ProjectedGaussians, height: int, width: int,
                  tile: int = TILE, first_tile_row: int = 0
                  ) -> BinnedGaussians:
    """``first_tile_row`` > 0 leaves the tile rows above it empty: a pixel
    band's binning (``parallel/band_render.py``) keeps the full frame's
    tile grid, and every entry of its tiles, in the full frame's order."""
    tiles_y, tiles_x = num_tiles(height, width, tile)
    n_tiles = tiles_y * tiles_x
    dev = proj.means2d.device

    rect_min_x, rect_min_y, span_x, span_y, counts = _tight_rects(
        proj, tiles_y, tiles_x, tile)
    if first_tile_row > 0:
        rect_max_y = rect_min_y + span_y
        rect_min_y = torch.clamp_min(rect_min_y, first_tile_row)
        span_y = torch.clamp_min(rect_max_y - rect_min_y, 0)
        counts = torch.where(counts > 0, span_x * span_y,
                             torch.zeros_like(counts))
    counts64 = counts.long()
    n = counts64.shape[0]

    # One entry per (Gaussian, covered tile), generated in Gaussian order;
    # the tile is row-major within the Gaussian's rectangle.
    with profiling.span("raster.entries.sync"):
        gauss = torch.repeat_interleave(torch.arange(n, device=dev),
                                        counts64)
    total = gauss.shape[0]
    profiling.count("raster.entries", total)
    offsets = torch.cumsum(counts64, 0) - counts64             # exclusive
    j = torch.arange(total, device=dev) - offsets[gauss]
    g_span_x = span_x.long()[gauss]
    tx = rect_min_x.long()[gauss] + j % g_span_x
    ty = rect_min_y.long()[gauss] + j // g_span_x
    tile_id = ty * tiles_x + tx

    depth_bits = proj.depth.contiguous().view(torch.int32).long()
    key = (tile_id << 32) | depth_bits[gauss]
    _, order = torch.sort(key, stable=True)

    with profiling.span("raster.tiles.sync"):
        tile_count = torch.bincount(tile_id, minlength=n_tiles)
    tile_start = torch.cumsum(tile_count, 0) - tile_count
    return BinnedGaussians(
        gauss_idx=gauss[order].to(torch.int32),
        tile_start=tile_start.to(torch.int32),
        tile_count=tile_count.to(torch.int32),
        total_entries=torch.tensor(total, dtype=torch.int32, device=dev),
    )
