"""Blend forward (K1) and backward (K2): the CUDA kernels' wrappers and
their plain versions.

Front-to-back alpha blending of depth-sorted per-tile entries, with the
reference blend contract (``h3dgs_tpu/ops/rasterize.py:blend_tiles``,
``ops/reference.py``): alpha = min(0.99, o * exp(power)), an entry is
skipped when power > 0 or alpha < 1/255, and a pixel is done, without
that entry contributing, once T * (1 - alpha) would drop below 1e-4.

``blend_forward`` launches ``csrc/blend_fwd.cu`` for CUDA tensors and
runs ``blend_plain`` only for tensors on the CPU; its autograd backward
launches ``csrc/blend_bwd.cu`` (K2) for CUDA tensors and runs
``blend_backward_plain`` for CPU tensors. The plain versions are the same
functions in plain torch; the CPU tests hold them against the JAX package
(``jax.vjp`` of the XLA blend for the backward) and ``chip_smoke.py``
holds the kernels against them on the card.

Both kernels stage an entry as its Gaussian's **packed row**: 12 float32
(``mx, my, opacity, inv_depth | ca, cb, cc, 0 | r, g, b, 0``), three
16-byte vectors, so that an entry is three asynchronous 16-byte copies and
the alpha test reads the first two vectors. The rows are written by a
pre-pass of K1's launch (``pack_kernel`` in ``csrc/blend_common.cuh``) into
a ``[N, 12]`` buffer that the wrapper allocates and saves for K2; a pack
made of torch ops (``torch.cat``) was measured and dropped, and so was
gathering the rows from the five columns inside the kernels
(``PERF.md``). The wrapper also prepares, once per forward and saved for
the backward, the **tile order** (``tile_order``): the tiles sorted
deepest first, in which the blocks take them. K2 accumulates into
``[N, 12]`` gradient rows of the same layout, which ``unpack_grads``
slices into the five gradients. ``cull_plain`` is the plain form of the
kernels' per-footprint cull, for the tests that prove it safe.

Outputs (before background): color [3,H,W], inverse depth [1,H,W], final
transmittance [H,W], and each pixel's last contributing entry index
[H,W] int32 (an index into the binned entry list, -1 for none). The
backward takes the cotangents of the first three and returns gradients
per Gaussian: means2d [N,2], conic [N,3], rgb [N,3], opacity [N],
inverse depth [N].
"""
from __future__ import annotations

import ctypes

import torch

from . import kernels
from .binning import TILE, num_tiles

ALPHA_EPS = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4
ALPHA_MAX = 0.99


def _tile_pixel_grid(tiles_y: int, tiles_x: int, tile: int, device,
                     dtype=torch.float32):
    """Pixel coordinates per tile: ([T, P], [T, P]), P = tile*tile, pixel p
    of a tile at row p // tile, column p % tile."""
    ar = torch.arange(tile, device=device)
    ly = ar.repeat_interleave(tile)
    lx = ar.repeat(tile)
    ty = torch.arange(tiles_y, device=device).repeat_interleave(tiles_x)
    tx = torch.arange(tiles_x, device=device).repeat(tiles_y)
    px = (tx[:, None] * tile + lx[None, :]).to(dtype)
    py = (ty[:, None] * tile + ly[None, :]).to(dtype)
    return px, py


def _untile(t_p_c: torch.Tensor, tiles_y: int, tiles_x: int, tile: int,
            height: int, width: int) -> torch.Tensor:
    """[T, P, C] -> [C, H, W]."""
    c = t_p_c.shape[-1]
    img = t_p_c.reshape(tiles_y, tiles_x, tile, tile, c)
    img = img.permute(4, 0, 2, 1, 3).reshape(c, tiles_y * tile,
                                             tiles_x * tile)
    return img[:, :height, :width]


ROW_COLS = 12  # floats per packed row, and per gradient row of K2


def unpack_grads(rows: torch.Tensor):
    """(means2d, conic, rgb, opacity, inv_depth) views of K2's [N, 12]
    gradient rows, laid out like the kernels' staged entry rows:
    mx, my, opacity, inv_depth | ca, cb, cc, - | r, g, b, -."""
    return (rows[:, 0:2], rows[:, 4:7], rows[:, 8:11], rows[:, 2],
            rows[:, 3])


def pack_rows_plain(means2d, conic, rgb, opacity, inv_depth) -> torch.Tensor:
    """The packed rows in plain torch, [N, 12]: what the kernels' pack
    pre-pass writes (and the inverse of ``unpack_grads``)."""
    pad = means2d.new_zeros((means2d.shape[0], 1))
    return torch.cat([means2d, opacity[:, None], inv_depth[:, None], conic,
                      pad, rgb, pad], dim=1)


def tile_order(tile_count: torch.Tensor) -> torch.Tensor:
    """The tiles as the kernels' blocks take them: deepest first, ties in
    tile order (a stable sort), int64 [T]."""
    return torch.sort(tile_count, descending=True, stable=True).indices


# Margins of the cull, the constants of csrc/blend_common.cuh.
CULL_ABS = 1e-3
CULL_REL = 2e-6
CULL_DET_REL = 1e-6
CULL_SLACK = 1.00001


def cull_plain(means2d, conic, opacity, x0, x1, y0, y1) -> torch.Tensor:
    """The kernels' conservative cull (``cull_footprint``) in plain torch:
    True where no pixel of the footprint [x0, x1] x [y0, y1] (inclusive
    pixel coordinates; scalars or tensors broadcast against the Gaussians)
    can pass the exact float32 test ``power <= 0 and alpha >= 1/255``.

    A passing pixel has -power <= ln(255 o) + rounding; for a positive
    definite conic the least -power over a column at distance dx from the
    mean is dx^2 det / (2 cc) (dy^2 det / (2 ca) over a row). Anything in
    doubt (NaN, a non-positive determinant) is not culled.
    """
    mx, my = means2d[..., 0], means2d[..., 1]
    ca, cb, cc = conic[..., 0], conic[..., 1], conic[..., 2]
    zero = torch.zeros((), dtype=mx.dtype, device=mx.device)
    dx0, dx1 = x0 - mx, mx - x1
    dy0, dy1 = y0 - my, my - y1
    dx_min = torch.maximum(zero, torch.maximum(dx0, dx1))
    dy_min = torch.maximum(zero, torch.maximum(dy0, dy1))
    dx_max = torch.maximum(dx0.abs(), dx1.abs())
    dy_max = torch.maximum(dy0.abs(), dy1.abs())
    s = ca * dx_max * dx_max + cc * dy_max * dy_max
    lm = torch.log(255.0 * opacity) + (CULL_ABS + CULL_REL * s)
    ac, bb = ca * cc, cb * cb
    det_lo = (ac - bb) - CULL_DET_REL * (ac + bb)
    definite = (ca > 0) & (cc > 0) & (det_lo > 0)
    out_x = dx_min * dx_min * det_lo > 2.0 * cc * lm * CULL_SLACK
    out_y = dy_min * dy_min * det_lo > 2.0 * ca * lm * CULL_SLACK
    return (lm < 0) | (definite & (out_x | out_y))


def blend_plain(means2d, conic, rgb, opacity, inv_depth, gauss_idx,
                tile_start, tile_count, height: int, width: int,
                tile: int = TILE, chunk: int = 32,
                count_evaluated: bool = False):
    """Plain-torch blend, vectorised over tiles and pixels, in the inputs'
    float type (float32 on the main path; float64 gives a reference).

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

    dt = means2d.dtype
    color = torch.zeros((n_tiles, p, 3), dtype=dt, device=dev)
    invd = torch.zeros((n_tiles, p), dtype=dt, device=dev)
    trans = torch.ones((n_tiles, p), dtype=dt, device=dev)
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
        raise ValueError(f"blend kernels need CUDA tensors, got {device}")
    if tile != TILE:
        raise ValueError(f"blend kernels are built for {TILE}x{TILE} "
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


# blend_fwd_launch: five columns, N, pack, entry list (3) and tile order,
# n_tiles, tiles_x, height, width, four outputs, stream.
_FWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int]
                 + [ctypes.c_void_p] * 5 + [ctypes.c_int] * 4
                 + [ctypes.c_void_p] * 5)


def _launch_blend_fwd(means2d, conic, rgb, opacity, inv_depth, gauss_idx,
                      tile_start, tile_count, order, height: int,
                      width: int):
    fn = kernels.load("blend_fwd").blend_fwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = _FWD_ARGTYPES
    dev = means2d.device
    n = means2d.shape[0]
    pack = torch.empty((n, ROW_COLS), dtype=torch.float32, device=dev)
    tiles_y, tiles_x = num_tiles(height, width, TILE)
    color = torch.empty((3, height, width), dtype=torch.float32, device=dev)
    invd = torch.empty((1, height, width), dtype=torch.float32, device=dev)
    trans = torch.empty((height, width), dtype=torch.float32, device=dev)
    last = torch.empty((height, width), dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(means2d.data_ptr(), conic.data_ptr(), rgb.data_ptr(),
                    opacity.data_ptr(), inv_depth.data_ptr(), n,
                    pack.data_ptr(), gauss_idx.data_ptr(),
                    tile_start.data_ptr(), tile_count.data_ptr(),
                    order.data_ptr(),
                    tiles_y * tiles_x, tiles_x, height, width,
                    color.data_ptr(), invd.data_ptr(), trans.data_ptr(),
                    last.data_ptr(), stream)
    kernels.check("blend_fwd", status)
    kernels.LAUNCHES["blend_fwd"] += 1
    return (color, invd, trans, last), pack


def pack_rows(means2d, conic, rgb, opacity, inv_depth) -> torch.Tensor:
    """The packed rows alone, [N, 12]: for CUDA tensors the pack pre-pass
    of K1's launch without the blend (not counted as a launch of K1), for
    CPU tensors ``pack_rows_plain``. The main path never calls it: K1's
    launch packs. It lets the pre-pass be timed and checked on its own."""
    cols = (means2d, conic, rgb, opacity, inv_depth)
    if all(t.device.type == "cpu" for t in cols):
        return pack_rows_plain(*cols)
    dev = means2d.device
    n = means2d.shape[0]
    for (name, width), t in zip(_FLOAT_ARGS, cols):
        shape = (n, width) if width else (n,)
        if (t.device != dev or t.dtype != torch.float32
                or tuple(t.shape) != shape or not t.is_contiguous()):
            raise ValueError(f"{name}: want contiguous float32 {shape} on "
                             f"{dev}")
    fn = kernels.load("blend_fwd").blend_fwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = _FWD_ARGTYPES
    pack = torch.empty((n, ROW_COLS), dtype=torch.float32, device=dev)
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(*(t.data_ptr() for t in cols), n, pack.data_ptr(),
                    None, None, None, None, 0, 1, TILE, TILE, None, None,
                    None, None, stream)
    kernels.check("blend_fwd", status)
    return pack


def _tile_image(img: torch.Tensor, tiles_y: int, tiles_x: int,
                tile: int) -> torch.Tensor:
    """[C, H, W] -> [T, P, C], zero past the image edge (the inverse of
    ``_untile``)."""
    c, h, w = img.shape
    full = img.new_zeros((c, tiles_y * tile, tiles_x * tile))
    full[:, :h, :w] = img
    t = full.reshape(c, tiles_y, tile, tiles_x, tile)
    return t.permute(1, 3, 2, 4, 0).reshape(tiles_y * tiles_x, tile * tile,
                                             c)


def blend_backward_plain(means2d, conic, rgb, opacity, inv_depth, gauss_idx,
                         tile_start, tile_count, color, invdepth, final_t,
                         g_color, g_invd, g_t, height: int, width: int,
                         tile: int = TILE, chunk: int = 32,
                         last=None):
    """Plain-torch blend backward: the closed form, vectorised over tiles,
    in the inputs' float type.

    Re-walks the forward of ``blend_plain`` chunk by chunk (same cumprod
    transmittance, same termination) and, per entry k of a pixel,
      d_alpha = T_k (g.a_k) - (g.C - P_k) / (1 - alpha_k)
                - g_T T_fin / (1 - alpha_k),
    with a_k = (r, g, b, invd), C the pixel's color and inverse depth
    before background (``color``, ``invdepth``) and P_k the inclusive
    prefix of (g.a_j) alpha_j T_j -- the suffix of K2 written as total
    minus prefix, as ``pallas_blend.py:653-654`` writes it. d_alpha is
    kept for contributing entries only and chained through exp(power)
    where the raw alpha is below the 0.99 clamp. Per-entry values are
    summed per Gaussian with ``index_add_`` (the "add" reduction).

    Returns (d_means2d [N,2], d_conic [N,3], d_rgb [N,3], d_opacity [N],
    d_inv_depth [N]). Given ``last`` (the forward's last-entry index
    [H,W]), also return the numbers of (entry, pixel) pairs up to each
    pixel's last contributing entry, and of contributing pairs -- the work
    a bound on K2 counts.
    """
    dev = means2d.device
    dt = means2d.dtype
    n = means2d.shape[0]
    tiles_y, tiles_x = num_tiles(height, width, tile)
    n_tiles = tiles_y * tiles_x
    px, py = _tile_pixel_grid(tiles_y, tiles_x, tile, dev, dt)
    p = tile * tile
    inside = (px < width) & (py < height)

    g_px = _tile_image(g_color, tiles_y, tiles_x, tile)             # [T,P,3]
    gd_px = _tile_image(g_invd.reshape(1, height, width), tiles_y, tiles_x,
                        tile)[..., 0]
    gt_px = _tile_image(g_t.reshape(1, height, width), tiles_y, tiles_x,
                        tile)[..., 0]
    tfin_px = _tile_image(final_t.reshape(1, height, width), tiles_y,
                          tiles_x, tile)[..., 0]
    total = ((g_px * _tile_image(color, tiles_y, tiles_x, tile)).sum(-1)
             + gd_px * _tile_image(invdepth.reshape(1, height, width),
                                   tiles_y, tiles_x, tile)[..., 0])
    gt_tfin = gt_px * tfin_px                                       # [T,P]
    count_pairs = last is not None
    if count_pairs:
        last_px = _tile_image(last.reshape(1, height, width).long(),
                              tiles_y, tiles_x, tile)[..., 0]
        last_px = torch.where(inside, last_px, torch.full_like(last_px, -1))

    grads = torch.zeros((n, 10), dtype=dt, device=dev)
    trans = torch.ones((n_tiles, p), dtype=dt, device=dev)
    prefix = torch.zeros((n_tiles, p), dtype=dt, device=dev)
    term = ~inside
    pairs = torch.zeros((), dtype=torch.int64, device=dev)
    contrib_pairs = torch.zeros((), dtype=torch.int64, device=dev)

    d = gauss_idx.shape[0]
    gidx = gauss_idx.long()
    start = tile_start.long()
    count = tile_count.long()
    max_count = int(count.max()) if n_tiles and d else 0
    for c0 in range(0, max_count, chunk):
        ks = c0 + torch.arange(chunk, device=dev)
        in_range = ks[None, :] < count[:, None]                     # [T,G]
        entry = start[:, None] + ks[None, :]
        gi = gidx[entry.clamp(0, d - 1)]

        mean = means2d[gi]
        con = conic[gi]
        dx = px[:, None, :] - mean[..., 0:1]                        # [T,G,P]
        dy = py[:, None, :] - mean[..., 1:2]
        ca, cb, cc = con[..., 0:1], con[..., 1:2], con[..., 2:3]
        power = -0.5 * (ca * dx * dx + cc * dy * dy) - cb * dx * dy
        e = torch.exp(power)
        alpha_raw = opacity[gi][..., None] * e
        alpha = torch.clamp_max(alpha_raw, ALPHA_MAX)
        ok = in_range[..., None] & (power <= 0.0) & (alpha >= ALPHA_EPS)
        alpha = torch.where(ok, alpha, torch.zeros_like(alpha))

        t_seq = torch.cumprod(torch.cat([trans[:, None, :], 1.0 - alpha],
                                        dim=1), dim=1)
        t_excl = t_seq[:, :-1]
        t_incl = t_seq[:, 1:]
        live = (~term[:, None, :]) & (t_incl >= TRANSMITTANCE_EPS)
        used = live & ok
        contrib = torch.where(used, alpha * t_excl, torch.zeros_like(alpha))

        col = rgb[gi]                                               # [T,G,3]
        idg = inv_depth[gi]                                         # [T,G]
        ga = (g_px[:, None, :, 0] * col[..., 0:1]
              + g_px[:, None, :, 1] * col[..., 1:2]
              + g_px[:, None, :, 2] * col[..., 2:3]
              + gd_px[:, None, :] * idg[..., None])                 # [T,G,P]
        q = contrib * ga
        incl = prefix[:, None, :] + torch.cumsum(q, dim=1)
        one_minus = 1.0 - alpha
        d_alpha = (t_excl * ga - (total[:, None, :] - incl) / one_minus
                   - gt_tfin[:, None, :] / one_minus)
        d_alpha = torch.where(used & (alpha_raw < ALPHA_MAX), d_alpha,
                              torch.zeros_like(d_alpha))
        d_power = d_alpha * alpha_raw
        per_entry = torch.stack([
            (d_power * (ca * dx + cb * dy)).sum(-1),
            (d_power * (cc * dy + cb * dx)).sum(-1),
            (d_power * (-0.5 * dx * dx)).sum(-1),
            (d_power * (-dx * dy)).sum(-1),
            (d_power * (-0.5 * dy * dy)).sum(-1),
            (contrib * g_px[:, None, :, 0]).sum(-1),
            (contrib * g_px[:, None, :, 1]).sum(-1),
            (contrib * g_px[:, None, :, 2]).sum(-1),
            (d_alpha * e).sum(-1),
            (contrib * gd_px[:, None, :]).sum(-1),
        ], dim=-1)                                                  # [T,G,10]
        sel = in_range.reshape(-1)
        grads.index_add_(0, gi.reshape(-1)[sel],
                         per_entry.reshape(-1, 10)[sel])

        if count_pairs:
            pairs += (in_range[..., None]
                      & (entry[..., None] <= last_px[:, None, :])).sum()
            contrib_pairs += used.sum()
        prefix = prefix + q.sum(dim=1)
        n_live = live.sum(dim=1)
        trans = torch.gather(t_seq, 1, n_live[:, None, :])[:, 0]
        term = term | (t_incl[:, -1] < TRANSMITTANCE_EPS)

    out = (grads[:, 0:2], grads[:, 2:5], grads[:, 5:8], grads[:, 8],
           grads[:, 9])
    if count_pairs:
        return out + (int(pairs), int(contrib_pairs))
    return out


def _check_pixels(tensors: dict, device):
    for name, (t, shape, dtype) in tensors.items():
        if t.dtype != dtype or tuple(t.shape) != shape:
            raise ValueError(f"{name}: want {dtype} {shape}, got "
                             f"{t.dtype} {tuple(t.shape)}")
        if t.device != device:
            raise ValueError(f"{name} is on {t.device}, not {device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


_ARG_NAMES = ("means2d", "conic", "rgb", "opacity", "inv_depth", "gauss_idx",
              "tile_start", "tile_count")


# blend_bwd_launch: five columns, N, pack, do_pack, entry list (2) and tile
# order, n_tiles, tiles_x, height, width, five per-pixel inputs, grads,
# stream.
_BWD_ARGTYPES = ([ctypes.c_void_p] * 5 + [ctypes.c_int] + [ctypes.c_void_p]
                 + [ctypes.c_int] + [ctypes.c_void_p] * 3
                 + [ctypes.c_int] * 4 + [ctypes.c_void_p] * 7)


def _blend_backward_cuda(columns, pack, gauss_idx, tile_start, order,
                         final_t, last, g_color, g_invd, g_t, height: int,
                         width: int):
    """Check the per-pixel tensors and launch K2 on the packed rows (the
    caller checked the per-Gaussian columns and the entry list).
    ``columns`` (means2d, conic, rgb, opacity, inv_depth) is None when
    ``pack`` already holds the rows, written by K1's launch; otherwise the
    launch packs them first."""
    hw = (height, width)
    dev = pack.device
    _check_pixels({
        "final_t": (final_t, hw, torch.float32),
        "last": (last, hw, torch.int32),
        "g_color": (g_color, (3,) + hw, torch.float32),
        "g_invd": (g_invd, (1,) + hw, torch.float32),
        "g_t": (g_t, hw, torch.float32)}, dev)
    fn = kernels.load("blend_bwd").blend_bwd_launch
    fn.restype = ctypes.c_int
    fn.argtypes = _BWD_ARGTYPES
    n = pack.shape[0]
    tiles_y, tiles_x = num_tiles(height, width, TILE)
    grads = torch.zeros((n, ROW_COLS), dtype=torch.float32, device=dev)
    col_ptrs = ([None] * 5 if columns is None
                else [t.data_ptr() for t in columns])
    with torch.cuda.device(dev):
        stream = torch.cuda.current_stream(dev).cuda_stream
        status = fn(*col_ptrs, n, pack.data_ptr(), int(columns is not None),
                    gauss_idx.data_ptr(), tile_start.data_ptr(),
                    order.data_ptr(), tiles_y * tiles_x, tiles_x, height,
                    width, final_t.data_ptr(), last.data_ptr(),
                    g_color.data_ptr(), g_invd.data_ptr(), g_t.data_ptr(),
                    grads.data_ptr(), stream)
    kernels.check("blend_bwd", status)
    kernels.LAUNCHES["blend_bwd"] += 1
    return unpack_grads(grads)


def blend_backward(means2d, conic, rgb, opacity, inv_depth, gauss_idx,
                   tile_start, tile_count, color, invdepth, final_t, last,
                   g_color, g_invd, g_t, height: int, width: int):
    """Blend backward (K2). CPU tensors run ``blend_backward_plain``; CUDA
    tensors launch the kernel or raise. Returns per-Gaussian gradients
    (means2d [N,2], conic [N,3], rgb [N,3], opacity [N], inv_depth [N])."""
    args = (means2d, conic, rgb, opacity, inv_depth, gauss_idx, tile_start,
            tile_count)
    if all(t.device.type == "cpu" for t in args):
        return blend_backward_plain(*args, color, invdepth, final_t,
                                    g_color, g_invd, g_t, height, width)
    _check_inputs(dict(zip(_ARG_NAMES, args)), height, width, TILE)
    pack = torch.empty((means2d.shape[0], ROW_COLS), dtype=torch.float32,
                       device=means2d.device)
    return _blend_backward_cuda(args[:5], pack, gauss_idx, tile_start,
                                tile_order(tile_count), final_t, last,
                                g_color, g_invd, g_t, height, width)


class _BlendForward(torch.autograd.Function):
    @staticmethod
    def forward(ctx, means2d, conic, rgb, opacity, inv_depth, gauss_idx,
                tile_start, tile_count, height, width):
        args = (means2d, conic, rgb, opacity, inv_depth, gauss_idx,
                tile_start, tile_count)
        ctx.on_cpu = all(t.device.type == "cpu" for t in args)
        if ctx.on_cpu:
            out = blend_plain(*args, height, width)
            ctx.save_for_backward(*args, *out)
        else:
            _check_inputs(dict(zip(_ARG_NAMES, args)), height, width, TILE)
            order = tile_order(tile_count)
            out, pack = _launch_blend_fwd(*args, order, height, width)
            # K2 reads the rows K1's launch packed, in the same tile order.
            ctx.save_for_backward(pack, gauss_idx, tile_start, order,
                                  out[2], out[3])
        ctx.mark_non_differentiable(out[3])
        ctx.size = (height, width)
        return out

    @staticmethod
    def backward(ctx, g_color, g_invd, g_t, _g_last):
        cot = (g_color.contiguous(), g_invd.contiguous(), g_t.contiguous())
        if ctx.on_cpu:
            grads = blend_backward(*ctx.saved_tensors, *cot, *ctx.size)
        else:
            grads = _blend_backward_cuda(None, *ctx.saved_tensors, *cot,
                                         *ctx.size)
        return grads + (None,) * 5


def blend_forward(means2d, conic, rgb, opacity, inv_depth, gauss_idx,
                  tile_start, tile_count, height: int, width: int):
    """Blend binned entries (K1). CPU tensors run ``blend_plain``; CUDA
    tensors launch the kernel or raise. Returns (color [3,H,W], invdepth
    [1,H,W], final_T [H,W], last entry [H,W] int32)."""
    return _BlendForward.apply(means2d, conic, rgb, opacity, inv_depth,
                               gauss_idx, tile_start, tile_count, height,
                               width)
