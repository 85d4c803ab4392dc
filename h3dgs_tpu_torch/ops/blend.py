"""Blend forward (K1): the CUDA kernel's wrapper and its plain version.

Front-to-back alpha blending of depth-sorted per-tile entries, with the
reference blend contract (``h3dgs_tpu/ops/rasterize.py:blend_tiles``,
``ops/reference.py``): alpha = min(0.99, o * exp(power)), an entry is
skipped when power > 0 or alpha < 1/255, and a pixel is done, without
that entry contributing, once T * (1 - alpha) would drop below 1e-4.

``blend_forward`` launches ``csrc/blend_fwd.cu`` for CUDA tensors and
runs ``blend_plain`` only for tensors on the CPU. ``blend_plain`` is the
same function in plain torch; the CPU tests hold it against the JAX
package and ``chip_smoke.py`` holds the kernel against it on the card.

Outputs (before background): color [3,H,W], inverse depth [1,H,W], final
transmittance [H,W], and each pixel's last contributing entry index
[H,W] int32 (an index into the binned entry list, -1 for none).
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels
from .binning import TILE, num_tiles

ALPHA_EPS = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4
ALPHA_MAX = 0.99


def _tile_pixel_grid(tiles_y: int, tiles_x: int, tile: int, device):
    """Pixel coordinates per tile: ([T, P], [T, P]) f32, P = tile*tile,
    pixel p of a tile at row p // tile, column p % tile."""
    ar = torch.arange(tile, device=device)
    ly = ar.repeat_interleave(tile)
    lx = ar.repeat(tile)
    ty = torch.arange(tiles_y, device=device).repeat_interleave(tiles_x)
    tx = torch.arange(tiles_x, device=device).repeat(tiles_y)
    px = (tx[:, None] * tile + lx[None, :]).to(torch.float32)
    py = (ty[:, None] * tile + ly[None, :]).to(torch.float32)
    return px, py


def _untile(t_p_c: torch.Tensor, tiles_y: int, tiles_x: int, tile: int,
            height: int, width: int) -> torch.Tensor:
    """[T, P, C] -> [C, H, W]."""
    c = t_p_c.shape[-1]
    img = t_p_c.reshape(tiles_y, tiles_x, tile, tile, c)
    img = img.permute(4, 0, 2, 1, 3).reshape(c, tiles_y * tile,
                                             tiles_x * tile)
    return img[:, :height, :width]


def blend_plain(means2d, conic, rgb, opacity, inv_depth, gauss_idx,
                tile_start, tile_count, height: int, width: int,
                tile: int = TILE, chunk: int = 32,
                count_evaluated: bool = False):
    """Plain-torch blend, vectorised over tiles and pixels.

    Walks every tile's entries in chunks of ``chunk``. Inside a chunk the
    transmittance is a sequential ``cumprod`` of (1 - alpha) started from
    the carried T, so it rounds like the kernel's running product; the
    termination flag is carried across chunks.

    ``count_evaluated``: also return the per-pixel number of entries the
    contract evaluates (up to and including the one that ends the pixel),
    the data-dependent work a bound on the kernel counts.
    """
    dev = means2d.device
    tiles_y, tiles_x = num_tiles(height, width, tile)
    n_tiles = tiles_y * tiles_x
    px, py = _tile_pixel_grid(tiles_y, tiles_x, tile, dev)
    p = tile * tile
    inside = (px < width) & (py < height)

    color = torch.zeros((n_tiles, p, 3), dtype=torch.float32, device=dev)
    invd = torch.zeros((n_tiles, p), dtype=torch.float32, device=dev)
    trans = torch.ones((n_tiles, p), dtype=torch.float32, device=dev)
    last = torch.full((n_tiles, p), -1, dtype=torch.int64, device=dev)
    evaluated = torch.zeros((n_tiles, p), dtype=torch.int64, device=dev)
    # Pixels past the image edge start as done, like the kernel's.
    term = ~inside

    d = gauss_idx.shape[0]
    gidx = gauss_idx.long()
    start = tile_start.long()
    count = tile_count.long()
    max_count = int(count.max()) if n_tiles and d else 0
    for c0 in range(0, max_count, chunk):
        ks = c0 + torch.arange(chunk, device=dev)                   # [G]
        in_range = ks[None, :] < count[:, None]                     # [T, G]
        entry = start[:, None] + ks[None, :]
        gi = gidx[entry.clamp(0, d - 1)]                            # [T, G]

        mean = means2d[gi]                                          # [T, G, 2]
        con = conic[gi]                                             # [T, G, 3]
        dx = px[:, None, :] - mean[..., 0:1]                        # [T, G, P]
        dy = py[:, None, :] - mean[..., 1:2]
        power = (-0.5 * (con[..., 0:1] * dx * dx + con[..., 2:3] * dy * dy)
                 - con[..., 1:2] * dx * dy)
        alpha = torch.clamp_max(opacity[gi][..., None] * torch.exp(power),
                                ALPHA_MAX)
        ok = in_range[..., None] & (power <= 0.0) & (alpha >= ALPHA_EPS)
        alpha = torch.where(ok, alpha, torch.zeros_like(alpha))

        # t_seq[:, k] = T before entry k, t_seq[:, k + 1] = T after it.
        t_seq = torch.cumprod(torch.cat([trans[:, None, :], 1.0 - alpha],
                                        dim=1), dim=1)              # [T, G+1, P]
        t_excl = t_seq[:, :-1]
        t_incl = t_seq[:, 1:]
        # t_incl is non-increasing along the chunk, so the live entries
        # (before the pixel ends) form a prefix.
        live = (~term[:, None, :]) & (t_incl >= TRANSMITTANCE_EPS)
        contrib = torch.where(live, alpha * t_excl,
                              torch.zeros_like(alpha))
        for c in range(3):
            color[..., c] += (contrib * rgb[gi][..., c:c + 1]).sum(dim=1)
        invd += (contrib * inv_depth[gi][..., None]).sum(dim=1)

        if count_evaluated:
            evaluated += (in_range[..., None] & (~term[:, None, :])
                          & (t_excl >= TRANSMITTANCE_EPS)).sum(dim=1)
        n_live = live.sum(dim=1)                                    # [T, P]
        trans = torch.gather(t_seq, 1, n_live[:, None, :])[:, 0]
        chunk_last = torch.where(live & ok, entry[..., None],
                                 torch.full_like(entry[..., None], -1)
                                 ).amax(dim=1)
        last = torch.maximum(last, chunk_last)
        term = term | (t_incl[:, -1] < TRANSMITTANCE_EPS)

    out = (_untile(color, tiles_y, tiles_x, tile, height, width),
           _untile(invd[..., None], tiles_y, tiles_x, tile, height, width),
           _untile(trans[..., None], tiles_y, tiles_x, tile, height,
                   width)[0],
           _untile(last[..., None], tiles_y, tiles_x, tile, height,
                   width)[0].to(torch.int32))
    if count_evaluated:
        return out + (_untile(evaluated[..., None], tiles_y, tiles_x, tile,
                              height, width)[0],)
    return out


_FLOAT_ARGS = (("means2d", 2), ("conic", 3), ("rgb", 3), ("opacity", 0),
               ("inv_depth", 0))


def _check_inputs(tensors: dict, height: int, width: int, tile: int):
    device = tensors["means2d"].device
    if device.type != "cuda":
        raise ValueError(f"blend_fwd kernel needs CUDA tensors, got {device}")
    if tile != TILE:
        raise ValueError(f"blend_fwd kernel is built for {TILE}x{TILE} "
                         f"tiles, got {tile}")
    n = tensors["means2d"].shape[0]
    for name, cols in _FLOAT_ARGS:
        t = tensors[name]
        shape = (n, cols) if cols else (n,)
        if t.dtype != torch.float32 or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want float32 {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
    tiles_y, tiles_x = num_tiles(height, width, tile)
    for name, size in (("gauss_idx", None), ("tile_start", tiles_y * tiles_x),
                       ("tile_count", tiles_y * tiles_x)):
        t = tensors[name]
        if t.dtype != torch.int32 or t.dim() != 1 or (
                size is not None and t.shape[0] != size):
            raise ValueError(f"{name}: want int32 [{size or 'D'}], got "
                             f"{t.dtype} {tuple(t.shape)}")
    for name, t in tensors.items():
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def _launch_blend_fwd(means2d, conic, rgb, opacity, inv_depth, gauss_idx,
                      tile_start, tile_count, height: int, width: int):
    lib = kernels.load("blend_fwd")
    fn = lib.blend_fwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 4
                   + [ctypes.c_void_p] * 5)
    dev = means2d.device
    tiles_y, tiles_x = num_tiles(height, width, TILE)
    color = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    invd = torch.empty((1, height, width), dtype=torch.float32, device=dev)
    trans = torch.empty((height, width), dtype=torch.float32, device=dev)
    last = torch.empty((height, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(means2d.data_ptr(), conic.data_ptr(), rgb.data_ptr(),
                    opacity.data_ptr(), inv_depth.data_ptr(),
                    gauss_idx.data_ptr(), tile_start.data_ptr(),
                    tile_count.data_ptr(), tiles_y * tiles_x, tiles_x,
                    height, width, color.data_ptr(), invd.data_ptr(),
                    trans.data_ptr(), last.data_ptr(), stream)
    kernels.check("blend_fwd", status)
    kernels.LAUNCHES["blend_fwd"] += 1
    return color, invd, trans, last


class _BlendForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, means2d, conic, rgb, opacity, inv_depth, gauss_idx,
                tile_start, tile_count, height, width):
        args = (means2d, conic, rgb, opacity, inv_depth, gauss_idx,
                tile_start, tile_count)
        if all(t.device.type == "cpu" for t in args):
            out = blend_plain(*args, height, width)
        else:
            _check_inputs(dict(zip(
                ("means2d", "conic", "rgb", "opacity", "inv_depth",
                 "gauss_idx", "tile_start", "tile_count"), args)),
                height, width, TILE)
            out = _launch_blend_fwd(*args, height, width)
        ctx.mark_non_differentiable(out[3])
        return out

    @staticmethod
    def backward(ctx, *grads):
        raise NotImplementedError(
            "the blend backward is kernel K2 (h3dgs_tpu/ops/pallas_blend.py:"
            "_bwd_kernel); it is ported with the training slice")


def blend_forward(means2d, conic, rgb, opacity, inv_depth, gauss_idx,
                  tile_start, tile_count, height: int, width: int):
    """Blend binned entries (K1). CPU tensors run ``blend_plain``; CUDA
    tensors launch the kernel or raise. Returns (color [3,H,W], invdepth
    [1,H,W], final_T [H,W], last entry [H,W] int32)."""
    return _BlendForward.apply(means2d, conic, rgb, opacity, inv_depth,
                               gauss_idx, tile_start, tile_count, height,
                               width)
