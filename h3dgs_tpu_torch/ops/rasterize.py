"""Tiled rasterization: project -> bin -> blend (K1) -> background.

Counterpart of ``h3dgs_tpu/ops/rasterize.py:rasterize`` and the serving
half of ``blend_auto``, with the same output keys. Forward only: the
blend's backward (kernel K2) comes with the training slice.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..scene.camera import Camera
from .binning import TILE, BinnedGaussians, bin_gaussians
from .blend import blend_forward
from .projection import ProjectedGaussians, project_gaussians


class RasterizeConfig(NamedTuple):
    """Rasterizer settings.

    Only the tile size carries over from the reference config. Its entry
    budget (``max_entries``), per-tile cap (``max_per_tile``) and Pallas
    fields describe the TPU's static-shape layout: the port allocates the
    exact entry count and never truncates a tile, so they have no
    counterpart here.
    """
    tile: int = TILE


def blend_args(proj: ProjectedGaussians, binned: BinnedGaussians):
    """The blend kernel's inputs: contiguous per-Gaussian columns (inverse
    depth included) and the binned entry list."""
    inv_depth = 1.0 / torch.clamp_min(proj.depth, 1e-6)
    return (proj.means2d.contiguous(), proj.conic.contiguous(),
            proj.rgb.contiguous(), proj.opacity.contiguous(),
            inv_depth.contiguous(), binned.gauss_idx, binned.tile_start,
            binned.tile_count)


def blend_auto(proj: ProjectedGaussians, height: int, width: int, bg_color,
               config: RasterizeConfig = RasterizeConfig()):
    """Bin and blend projected Gaussians into an image.

    Returns (image [3,H,W], invdepth [1,H,W], final_T [H,W], n_need [],
    n_truncated [] (always 0: nothing is dropped), n_raw [] (the true
    entry count), n_bwd_quanta [] (-1: not tracked)).
    """
    if config.tile != TILE:
        raise ValueError(f"the blend kernel uses {TILE}x{TILE} tiles, "
                         f"got tile={config.tile}")
    binned = bin_gaussians(proj, height, width, config.tile)
    color, invdepth, final_t, _last = blend_forward(
        *blend_args(proj, binned), height, width)
    bg = torch.as_tensor(bg_color, dtype=color.dtype, device=color.device)
    image = color + final_t[None] * bg[:, None, None]
    dev = color.device
    return (image, invdepth, final_t, binned.total_entries,
            torch.zeros((), dtype=torch.int32, device=dev),
            binned.total_entries,
            torch.full((), -1, dtype=torch.int32, device=dev))


def rasterize(
    means3d, scales, quats, opacities, shs, camera: Camera, sh_degree: int,
    bg_color, scale_modifier: float = 1.0,
    colors_precomp: Optional[torch.Tensor] = None,
    means2d_offset: Optional[torch.Tensor] = None,
    config: RasterizeConfig = RasterizeConfig(),
):
    """Full rasterization pass on the Gaussians' device.

    Returns a dict: render [3,H,W], invdepth [1,H,W], final_transmittance
    [H,W], radii [N], visibility_filter [N] bool, n_duplicates [],
    n_truncated [], n_raw [], n_bwd_quanta [].
    """
    proj = project_gaussians(means3d, scales, quats, opacities, shs, camera,
                             sh_degree, scale_modifier,
                             colors_precomp=colors_precomp)
    if means2d_offset is not None:
        proj = proj._replace(means2d=proj.means2d + means2d_offset)
    image, invdepth, final_t, n_dup, n_trunc, n_raw, n_bwd = blend_auto(
        proj, camera.height, camera.width, bg_color, config)
    return {
        "render": image,
        "invdepth": invdepth,
        "final_transmittance": final_t,
        "radii": proj.radius,
        "visibility_filter": proj.radius > 0,
        "n_duplicates": n_dup,
        "n_truncated": n_trunc,
        "n_raw": n_raw,
        "n_bwd_quanta": n_bwd,
    }
