"""One frame rendered as horizontal pixel bands, one band per device
(counterpart of ``h3dgs_tpu/parallel/band_render.py``).

Each band's device projects the full Gaussian set (projection is a few ms
and needs no gather of a culled set), bins only the entries of its own
tile rows and launches the blend (K1) on them; the bands are then
concatenated on the first device and trimmed to the frame's height. The
band height ``hb`` is a multiple of the tile size, so every band's tiles
are tiles of the full frame.

The JAX package shifts each band's screen-space means by the band's row
offset ``y0`` and blends an ``hb``-tall viewport. In float32, ``y - y0``
can round when a splat's centre lies above row ``y0 / 2`` (or above the
frame) while its footprint reaches into the band, so a shifted band can
differ from the full frame in the last bits. The port keeps the full
frame's coordinates instead: a band's binning keeps the full tile grid
down to the band's last row and leaves the rows above the band empty
(``ops/binning.py``, ``first_tile_row``). A splat whose centre lies in
another band but whose footprint reaches this one keeps its entries
here, and every tile sees the same entries in the same order with the
same pixel coordinates as in the full frame, so the bands are the full
frame bit for bit. The JAX package's ``pmax`` of the entry budget over
bands has no counterpart: the port's binning is exact.
"""
from __future__ import annotations

from typing import Sequence

import torch

from ..ops.binning import bin_gaussians
from ..ops.blend import blend_forward
from ..ops.projection import ProjectedGaussians, project_gaussians
from ..ops.rasterize import RasterizeConfig, blend_args
from ..scene.camera import Camera


def band_height(height: int, n_bands: int, tile: int) -> int:
    """Rows per band: the frame split in ``n_bands``, rounded up to whole
    tiles."""
    return -(-height // (n_bands * tile)) * tile


def render_banded(means3d, scales, quats, opacities, shs, camera: Camera,
                  sh_degree: int, bg_color, devices: Sequence,
                  scale_modifier: float = 1.0,
                  config: RasterizeConfig = RasterizeConfig()):
    """Render one view in ``len(devices)`` pixel bands, band ``b`` on
    ``devices[b]`` (devices may repeat). Forward only. Returns the same
    keys as ``ops.rasterize.rasterize`` on ``devices[0]``:
    ``n_duplicates`` is the largest band's entry count; ``radii`` and
    ``visibility_filter`` come from the first band's projection."""
    devices = [torch.device(d) for d in devices]
    height, width, tile = camera.height, camera.width, config.tile
    hb = band_height(height, len(devices), tile)
    images, invds, finals, entries = [], [], [], []
    radius = None
    for band, dev in enumerate(devices):
        y0, y1 = band * hb, min((band + 1) * hb, height)
        if y0 >= height:
            break
        cam = camera.to(dev)
        proj = project_gaussians(
            *(torch.as_tensor(a).to(dev) for a in (means3d, scales, quats,
                                                  opacities, shs)),
            cam, sh_degree, scale_modifier)
        binned = bin_gaussians(ProjectedGaussians(
            *(t.detach() for t in proj)), y1, width, tile,
            first_tile_row=y0 // tile)
        color, invd, final_t, _ = blend_forward(*blend_args(proj, binned),
                                                y1, width)
        bg = torch.as_tensor(bg_color, dtype=color.dtype, device=dev)
        image = color + final_t[None] * bg[:, None, None]
        out = devices[0]
        images.append(image[:, y0:].to(out))
        invds.append(invd[:, y0:].to(out))
        finals.append(final_t[y0:].to(out))
        entries.append(binned.total_entries.to(out))
        if radius is None:
            radius = proj.radius
    return {
        "render": torch.cat(images, dim=1),
        "invdepth": torch.cat(invds, dim=1),
        "final_transmittance": torch.cat(finals, dim=0),
        "radii": radius,
        "visibility_filter": radius > 0,
        "n_duplicates": torch.stack(entries).max(),
    }
