"""Plain reference renderer: projection, tile binning, the blend and its
closed-form backward, in plain torch operations of any float type.

The semantics are those of the 3DGS-family rasterizer the port follows:
EWA projection with a tan-clamped Jacobian and +0.3 px dilation, radius
ceil(3 sqrt(lambda_max)), z < 0.2 near cull, opacity cull at 1/255;
16 x 16 tiles, each splat listed in the tiles its tight alpha box covers,
entries sorted by (tile, depth); front-to-back blending with alpha =
min(0.99, o exp(power)), an entry skipped when power > 0 or alpha < 1/255,
a pixel done once T (1 - alpha) would fall below 1e-4. This file is the
benchmark's frozen copy of those plain functions and imports nothing of
the program.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

TILE = 16
NEAR_CULL_Z = 0.2
COV2D_DILATION = 0.3
ALPHA_EPS = 1.0 / 255.0
TRANSMITTANCE_EPS = 1e-4
ALPHA_MAX = 0.99

SH_C0 = 0.28209479177387814
SH_C1 = 0.4886025119029199
SH_C2 = (1.0925484305920792, -1.0925484305920792, 0.31539156525252005,
         -1.0925484305920792, 0.5462742152960396)
SH_C3 = (-0.5900435899266435, 2.890611442640554, -0.4570457994644658,
         0.3731763325901154, -0.4570457994644658, 1.445305721320277,
         -0.5900435899266435)


class Cam(NamedTuple):
    """A camera as the reference uses it: float32 tensors on the device
    (``view`` world->camera 4x4, ``full_proj`` projection @ view,
    ``center`` [3], ``tanfovx``, ``tanfovy``) and the image size."""
    view: torch.Tensor
    full_proj: torch.Tensor
    center: torch.Tensor
    tanfovx: float
    tanfovy: float
    width: int
    height: int


def eval_sh(degree: int, sh: torch.Tensor, x, y, z) -> torch.Tensor:
    """Colour [N,3] of SH coefficients [N,K,3] along unit directions."""
    basis = [torch.full_like(x, SH_C0)]
    if degree >= 1:
        basis += [-SH_C1 * y, SH_C1 * z, -SH_C1 * x]
    if degree >= 2:
        xx, yy, zz = x * x, y * y, z * z
        xy, yz, xz = x * y, y * z, x * z
        basis += [SH_C2[0] * xy, SH_C2[1] * yz,
                  SH_C2[2] * (2.0 * zz - xx - yy), SH_C2[3] * xz,
                  SH_C2[4] * (xx - yy)]
    if degree >= 3:
        basis += [SH_C3[0] * y * (3.0 * xx - yy), SH_C3[1] * xy * z,
                  SH_C3[2] * y * (4.0 * zz - xx - yy),
                  SH_C3[3] * z * (2.0 * zz - 3.0 * xx - 3.0 * yy),
                  SH_C3[4] * x * (4.0 * zz - xx - yy),
                  SH_C3[5] * z * (xx - yy), SH_C3[6] * x * (xx - 3.0 * yy)]
    out = basis[0][:, None] * sh[:, 0]
    for i in range(1, len(basis)):
        out = out + basis[i][:, None] * sh[:, i]
    return out


class Projected(NamedTuple):
    means2d: torch.Tensor
    conic: torch.Tensor
    rgb: torch.Tensor
    opacity: torch.Tensor
    depth: torch.Tensor
    radius: torch.Tensor
    valid: torch.Tensor


def project(means3d, scales, quats, opacities, shs, cam: Cam,
            sh_degree: int) -> Projected:
    """3D Gaussians (activated scales, raw quaternions, activated
    opacities, SH [N,K,3]) -> screen-space splats, differentiable."""
    dt = means3d.dtype
    view = cam.view.to(dt)
    fp = cam.full_proj.to(dt)
    x3, y3, z3 = means3d[:, 0], means3d[:, 1], means3d[:, 2]

    def affine(row):
        return row[0] * x3 + row[1] * y3 + row[2] * z3 + row[3]

    pvx, pvy, depth = affine(view[0]), affine(view[1]), affine(view[2])
    hx, hy, hw = affine(fp[0]), affine(fp[1]), affine(fp[3])
    inv_w = 1.0 / (hw + 1e-7)
    m2x = ((hx * inv_w + 1.0) * float(cam.width) - 1.0) * 0.5
    m2y = ((hy * inv_w + 1.0) * float(cam.height) - 1.0) * 0.5
    means2d = torch.stack([m2x, m2y], dim=-1)

    q = quats / torch.sqrt(torch.sum(quats * quats, -1, keepdim=True)
                           + 1e-12)
    qw, qx, qy, qz = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    r = [[1 - 2 * (qy * qy + qz * qz), 2 * (qx * qy - qw * qz),
          2 * (qx * qz + qw * qy)],
         [2 * (qx * qy + qw * qz), 1 - 2 * (qx * qx + qz * qz),
          2 * (qy * qz - qw * qx)],
         [2 * (qx * qz - qw * qy), 2 * (qy * qz + qw * qx),
          1 - 2 * (qx * qx + qy * qy)]]
    s = [scales[:, 0], scales[:, 1], scales[:, 2]]
    lm = [[r[i][k] * s[k] for k in range(3)] for i in range(3)]

    def c3(i, j):
        return lm[i][0] * lm[j][0] + lm[i][1] * lm[j][1] + lm[i][2] * lm[j][2]

    cov = [[c3(i, j) for j in range(3)] for i in range(3)]
    fx = cam.width / (2.0 * cam.tanfovx)
    fy = cam.height / (2.0 * cam.tanfovy)
    limx, limy = 1.3 * cam.tanfovx, 1.3 * cam.tanfovy
    z = depth
    tx = torch.clamp(pvx / z, -limx, limx) * z
    ty = torch.clamp(pvy / z, -limy, limy) * z
    inv_z = 1.0 / z
    inv_z2 = inv_z * inv_z
    j00, j02 = fx * inv_z, -fx * tx * inv_z2
    j11, j12 = fy * inv_z, -fy * ty * inv_z2
    w = view[:3, :3]
    m0 = [j00 * w[0, c] + j02 * w[2, c] for c in range(3)]
    m1 = [j11 * w[1, c] + j12 * w[2, c] for c in range(3)]
    cm0 = [cov[c][0] * m0[0] + cov[c][1] * m0[1] + cov[c][2] * m0[2]
           for c in range(3)]
    cm1 = [cov[c][0] * m1[0] + cov[c][1] * m1[1] + cov[c][2] * m1[2]
           for c in range(3)]
    cov_a = m0[0] * cm0[0] + m0[1] * cm0[1] + m0[2] * cm0[2] + COV2D_DILATION
    cov_b = m0[0] * cm1[0] + m0[1] * cm1[1] + m0[2] * cm1[2]
    cov_c = m1[0] * cm1[0] + m1[1] * cm1[1] + m1[2] * cm1[2] + COV2D_DILATION
    det = cov_a * cov_c - cov_b * cov_b
    det_ok = det > 0.0
    inv_det = torch.where(det_ok, 1.0 / torch.where(det_ok, det,
                                                    torch.ones_like(det)),
                          torch.zeros_like(det))
    conic = torch.stack([cov_c * inv_det, -cov_b * inv_det, cov_a * inv_det],
                        dim=-1)
    mid = 0.5 * (cov_a + cov_c)
    lam = mid + torch.sqrt(torch.clamp_min(mid * mid - det, 0.1))
    radius_f = torch.ceil(3.0 * torch.sqrt(lam))

    c = cam.center.to(dt)
    dx, dy, dz = x3 - c[0], y3 - c[1], z3 - c[2]
    inv_n = 1.0 / torch.sqrt(dx * dx + dy * dy + dz * dz).clamp_min(1e-12)
    rgb = torch.clamp_min(eval_sh(sh_degree, shs, dx * inv_n, dy * inv_n,
                                  dz * inv_n) + 0.5, 0.0)
    valid = ((depth > NEAR_CULL_Z) & det_ok & (radius_f > 0.0)
             & (opacities >= 1.0 / 255.0))
    radius = torch.where(valid, radius_f, torch.zeros_like(radius_f)).to(
        torch.int32)
    return Projected(means2d, conic, rgb, opacities, depth, radius, valid)


class Binned(NamedTuple):
    gauss_idx: torch.Tensor
    tile_start: torch.Tensor
    tile_count: torch.Tensor


def num_tiles(height: int, width: int):
    return -(-height // TILE), -(-width // TILE)


def bin_splats(p: Projected, height: int, width: int) -> Binned:
    """Every visible splat listed in each tile its alpha >= 1/255 box
    (capped by the radius) covers; entries ordered by tile, then depth
    (ties by splat index)."""
    ty_n, tx_n = num_tiles(height, width)
    x, y = p.means2d[:, 0].float(), p.means2d[:, 1].float()
    r = p.radius.float()
    ca, cb, cc = (p.conic[:, i].float() for i in range(3))
    det_c = torch.clamp_min(ca * cc - cb * cb, 1e-24)
    big_l = torch.log(torch.clamp_min(255.0 * p.opacity.float(), 1.0 + 1e-6))
    ext_x = torch.minimum(torch.sqrt(2.0 * big_l * cc / det_c) + 1e-3, r)
    ext_y = torch.minimum(torch.sqrt(2.0 * big_l * ca / det_c) + 1e-3, r)

    def fl(v, hi):
        return torch.clamp(torch.floor(v / TILE), -1.0, hi + 1.0).to(
            torch.int64)

    x0 = fl(x - ext_x, tx_n).clamp(0, tx_n)
    y0 = fl(y - ext_y, ty_n).clamp(0, ty_n)
    x1 = (fl(x + ext_x, tx_n) + 1).clamp(0, tx_n)
    y1 = (fl(y + ext_y, ty_n) + 1).clamp(0, ty_n)
    sx = (x1 - x0).clamp_min(0)
    sy = (y1 - y0).clamp_min(0)
    counts = torch.where(p.valid & (p.radius > 0), sx * sy,
                         torch.zeros_like(sx))
    dev = x.device
    g = torch.repeat_interleave(torch.arange(counts.numel(), device=dev),
                                counts)
    off = torch.cumsum(counts, 0) - counts
    j = torch.arange(g.numel(), device=dev) - off[g]
    tile = (y0[g] + j // sx[g]) * tx_n + x0[g] + j % sx[g]
    key_depth = p.depth.float().contiguous()[g]
    order = torch.argsort(key_depth, stable=True)
    order = order[torch.argsort(tile[order], stable=True)]
    count = torch.bincount(tile, minlength=ty_n * tx_n)
    return Binned(g[order], torch.cumsum(count, 0) - count, count)


def _pixel_grid(ty_n, tx_n, device, dtype):
    ar = torch.arange(TILE, device=device)
    ly, lx = ar.repeat_interleave(TILE), ar.repeat(TILE)
    ty = torch.arange(ty_n, device=device).repeat_interleave(tx_n)
    tx = torch.arange(tx_n, device=device).repeat(ty_n)
    return ((tx[:, None] * TILE + lx[None]).to(dtype),
            (ty[:, None] * TILE + ly[None]).to(dtype))


def _untile(t, ty_n, tx_n, h, w):
    c = t.shape[-1]
    img = t.reshape(ty_n, tx_n, TILE, TILE, c).permute(4, 0, 2, 1, 3)
    return img.reshape(c, ty_n * TILE, tx_n * TILE)[:, :h, :w]


def _tile(img, ty_n, tx_n):
    c, h, w = img.shape
    full = img.new_zeros((c, ty_n * TILE, tx_n * TILE))
    full[:, :h, :w] = img
    t = full.reshape(c, ty_n, TILE, tx_n, TILE).permute(1, 3, 2, 4, 0)
    return t.reshape(ty_n * tx_n, TILE * TILE, c)


def _walk(means2d, conic, opacity, binned: Binned, h, w, chunk, visit):
    """Walk every tile's entries ``chunk`` at a time, front to back.
    ``visit(state)`` sees, per chunk, the tensors of the contract (shape
    [T, G, P]) and the carried transmittance; returns nothing."""
    dev, dt = means2d.device, means2d.dtype
    ty_n, tx_n = num_tiles(h, w)
    px, py = _pixel_grid(ty_n, tx_n, dev, dt)
    inside = (px < w) & (py < h)
    trans = torch.ones((ty_n * tx_n, TILE * TILE), dtype=dt, device=dev)
    term = ~inside
    d = binned.gauss_idx.numel()
    start, count = binned.tile_start.long(), binned.tile_count.long()
    max_count = int(count.max()) if d else 0
    for c0 in range(0, max_count, chunk):
        ks = c0 + torch.arange(chunk, device=dev)
        in_range = ks[None, :] < count[:, None]
        entry = start[:, None] + ks[None, :]
        gi = binned.gauss_idx[entry.clamp(0, max(d - 1, 0))].long()
        mean, con = means2d[gi], conic[gi]
        dx = px[:, None, :] - mean[..., 0:1]
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
        t_excl, t_incl = t_seq[:, :-1], t_seq[:, 1:]
        live = (~term[:, None, :]) & (t_incl >= TRANSMITTANCE_EPS)
        visit(dict(gi=gi, entry=entry, in_range=in_range, dx=dx, dy=dy,
                   ca=ca, cb=cb, cc=cc, e=e, alpha_raw=alpha_raw,
                   alpha=alpha, ok=ok, live=live, t_excl=t_excl,
                   t_incl=t_incl, term=term))
        n_live = live.sum(dim=1)
        trans = torch.gather(t_seq, 1, n_live[:, None, :])[:, 0]
        term = term | (t_incl[:, -1] < TRANSMITTANCE_EPS)
    return trans


def blend(p: Projected, binned: Binned, h: int, w: int, chunk: int = 32):
    """Forward blend of the binned splats. Returns (colour [3,H,W],
    inverse depth [1,H,W], final T [H,W], last contributing entry [H,W]
    int64, evaluated (entry, pixel) pairs per pixel [H,W] int64)."""
    dev, dt = p.means2d.device, p.means2d.dtype
    ty_n, tx_n = num_tiles(h, w)
    n_t = ty_n * tx_n
    color = torch.zeros((n_t, TILE * TILE, 3), dtype=dt, device=dev)
    invd = torch.zeros((n_t, TILE * TILE), dtype=dt, device=dev)
    last = torch.full((n_t, TILE * TILE), -1, dtype=torch.int64, device=dev)
    evaluated = torch.zeros((n_t, TILE * TILE), dtype=torch.int64,
                            device=dev)
    inv_depth = 1.0 / torch.clamp_min(p.depth, 1e-6)

    def visit(s):
        nonlocal last
        contrib = torch.where(s["live"], s["alpha"] * s["t_excl"],
                              torch.zeros_like(s["alpha"]))
        for c in range(3):
            color[..., c] += (contrib * p.rgb[s["gi"]][..., c:c + 1]).sum(1)
        invd.add_((contrib * inv_depth[s["gi"]][..., None]).sum(1))
        evaluated.add_((s["in_range"][..., None] & ~s["term"][:, None, :]
                        & (s["t_excl"] >= TRANSMITTANCE_EPS)).sum(1))
        cl = torch.where(s["live"] & s["ok"], s["entry"][..., None],
                         torch.full_like(s["entry"][..., None], -1))
        last = torch.maximum(last, cl.amax(dim=1))

    trans = _walk(p.means2d, p.conic, p.opacity, binned, h, w, chunk, visit)
    return (_untile(color, ty_n, tx_n, h, w),
            _untile(invd[..., None], ty_n, tx_n, h, w),
            _untile(trans[..., None], ty_n, tx_n, h, w)[0],
            _untile(last[..., None], ty_n, tx_n, h, w)[0],
            _untile(evaluated[..., None], ty_n, tx_n, h, w)[0])


def blend_backward(p: Projected, binned: Binned, color, invdepth, final_t,
                   last, g_color, g_invd, g_t, h: int, w: int,
                   chunk: int = 32):
    """Closed-form gradients of the blend with respect to means2d [N,2],
    conic [N,3], rgb [N,3], opacity [N] and inverse depth [N], summed per
    splat; also the number of (entry, pixel) pairs up to each pixel's last
    contributing entry, and of contributing pairs."""
    dev, dt = p.means2d.device, p.means2d.dtype
    n = p.means2d.shape[0]
    ty_n, tx_n = num_tiles(h, w)
    g_px = _tile(g_color, ty_n, tx_n)
    gd_px = _tile(g_invd.reshape(1, h, w), ty_n, tx_n)[..., 0]
    gt_tfin = (_tile(g_t.reshape(1, h, w), ty_n, tx_n)[..., 0]
               * _tile(final_t.reshape(1, h, w), ty_n, tx_n)[..., 0])
    total = ((g_px * _tile(color, ty_n, tx_n)).sum(-1)
             + gd_px * _tile(invdepth.reshape(1, h, w), ty_n, tx_n)[..., 0])
    last_px = _tile(last.reshape(1, h, w).to(dt), ty_n, tx_n)[..., 0]
    px, py = _pixel_grid(ty_n, tx_n, dev, dt)
    last_px = torch.where((px < w) & (py < h), last_px,
                          torch.full_like(last_px, -1))
    inv_depth = 1.0 / torch.clamp_min(p.depth, 1e-6)
    grads = torch.zeros((n, 10), dtype=dt, device=dev)
    prefix = torch.zeros_like(gt_tfin)
    counts = [0, 0]

    def visit(s):
        nonlocal prefix
        used = s["live"] & s["ok"]
        contrib = torch.where(used, s["alpha"] * s["t_excl"],
                              torch.zeros_like(s["alpha"]))
        col = p.rgb[s["gi"]]
        ga = (g_px[:, None, :, 0] * col[..., 0:1]
              + g_px[:, None, :, 1] * col[..., 1:2]
              + g_px[:, None, :, 2] * col[..., 2:3]
              + gd_px[:, None, :] * inv_depth[s["gi"]][..., None])
        q = contrib * ga
        incl = prefix[:, None, :] + torch.cumsum(q, dim=1)
        om = 1.0 - s["alpha"]
        d_alpha = (s["t_excl"] * ga - (total[:, None, :] - incl) / om
                   - gt_tfin[:, None, :] / om)
        d_alpha = torch.where(used & (s["alpha_raw"] < ALPHA_MAX), d_alpha,
                              torch.zeros_like(d_alpha))
        d_power = d_alpha * s["alpha_raw"]
        dx, dy = s["dx"], s["dy"]
        ca, cb, cc = s["ca"], s["cb"], s["cc"]
        per = torch.stack([
            (d_power * (ca * dx + cb * dy)).sum(-1),
            (d_power * (cc * dy + cb * dx)).sum(-1),
            (d_power * (-0.5 * dx * dx)).sum(-1),
            (d_power * (-dx * dy)).sum(-1),
            (d_power * (-0.5 * dy * dy)).sum(-1),
            (contrib * g_px[:, None, :, 0]).sum(-1),
            (contrib * g_px[:, None, :, 1]).sum(-1),
            (contrib * g_px[:, None, :, 2]).sum(-1),
            (d_alpha * s["e"]).sum(-1),
            (contrib * gd_px[:, None, :]).sum(-1)], dim=-1)
        sel = s["in_range"].reshape(-1)
        grads.index_add_(0, s["gi"].reshape(-1)[sel], per.reshape(-1, 10)[sel])
        counts[0] += int((s["in_range"][..., None]
                          & (s["entry"][..., None].to(dt)
                             <= last_px[:, None, :])).sum())
        counts[1] += int(used.sum())
        prefix = prefix + q.sum(dim=1)

    _walk(p.means2d, p.conic, p.opacity, binned, h, w, chunk, visit)
    d_inv = grads[:, 9]
    return (grads[:, 0:2], grads[:, 2:5], grads[:, 5:8], grads[:, 8], d_inv,
            counts[0], counts[1])


class _Blend(torch.autograd.Function):
    """The blend as an autograd function: forward by ``blend``, backward
    by the closed form, so the reference differentiates through the
    projection, the loss and the exposure with torch's autograd."""

    @staticmethod
    def forward(ctx, means2d, conic, rgb, opacity, depth, binned, h, w,
                record):
        p = Projected(means2d, conic, rgb, opacity, depth, None, None)
        color, invd, final_t, last, evaluated = blend(p, binned, h, w)
        ctx.save_for_backward(means2d, conic, rgb, opacity, depth, color,
                              invd, final_t, last)
        ctx.binned, ctx.size, ctx.record = binned, (h, w), record
        record["k1_pairs"] = int(evaluated.sum())
        ctx.mark_non_differentiable(last)
        return color, invd, final_t, last

    @staticmethod
    def backward(ctx, g_color, g_invd, g_t, _g_last):
        means2d, conic, rgb, opacity, depth, color, invd, final_t, last = \
            ctx.saved_tensors
        p = Projected(means2d, conic, rgb, opacity, depth, None, None)
        h, w = ctx.size
        d_m, d_c, d_rgb, d_o, d_inv, pairs, used = blend_backward(
            p, ctx.binned, color, invd, final_t, last, g_color, g_invd, g_t,
            h, w)
        ctx.record["k2_pairs"], ctx.record["k2_contrib"] = pairs, used
        # inverse depth = 1 / max(depth, 1e-6)
        d_depth = torch.where(depth > 1e-6, -d_inv / (depth * depth),
                              torch.zeros_like(depth))
        return d_m, d_c, d_rgb, d_o, d_depth, None, None, None, None


def rasterize(means3d, scales, quats, opacities, shs, cam: Cam,
              sh_degree: int, bg, offset=None, record=None):
    """Project, bin and blend; differentiable in every float input.
    Returns (image [3,H,W] with background, inverse depth [1,H,W],
    projected splats). ``record`` receives the blend's pair counts."""
    p = project(means3d, scales, quats, opacities, shs, cam, sh_degree)
    if offset is not None:
        p = p._replace(means2d=p.means2d + offset)
    det = Projected(*(t.detach() if t is not None else None for t in p))
    binned = bin_splats(det, cam.height, cam.width)
    if record is not None:
        record["entries"] = int(binned.gauss_idx.numel())
        record["visible"] = int((det.radius > 0).sum())
    color, invd, final_t, _ = _Blend.apply(
        p.means2d, p.conic, p.rgb, p.opacity, p.depth, binned, cam.height,
        cam.width, record if record is not None else {})
    image = color + final_t[None] * bg.to(color.dtype)[:, None, None]
    return image, invd, p
