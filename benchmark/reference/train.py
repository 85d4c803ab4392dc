"""Plain reference of the per-chunk training step and of a densify pass.

One step, as the upstream trainer defines it (``train_single.py`` with
its ``OptimizationParams`` defaults): render the view (projection,
binning, blend) with the view's 3x4 exposure applied and clamped to
[0, 1]; loss 0.8 L1 + 0.2 (1 - SSIM) on the masked image (11-tap
Gaussian window, sigma 1.5, zero padding) plus the weighted inverse-depth
L1; gradients by autograd (the blend by its closed form); skybox rows'
gradients zeroed; densification statistics from the screen-space
gradient; Adam (beta 0.9 / 0.999, eps 1e-15) on the live rows whose
opacity gradient is nonzero, with one shared step count; the exposure's
Adam (eps 1e-8) on every row; then live non-scaffold rows wider than 2 %
of the scene extent shrink by 0.8. Written in plain torch in any float
type; it imports nothing of the program.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from .render import rasterize

LAMBDA_DSSIM = 0.2
ITERATIONS = 30_000
LRS = {"f_dc": 0.0025, "f_rest": 0.0025 / 20.0, "opacity": 0.05,
       "scaling": 0.005, "rotation": 0.001}
LEAVES = ("xyz", "f_dc", "f_rest", "opacity", "scaling", "rotation")


def expon_lr(step, lr_init, lr_final, delay_steps=0, delay_mult=1.0,
             max_steps=1_000_000) -> float:
    """Log-linear decay with an optional sine delay, in float32."""
    step = np.float32(step)
    if delay_steps > 0:
        rate = np.float32(delay_mult) + np.float32(1.0 - delay_mult) * np.sin(
            np.float32(0.5 * np.pi) * np.clip(step / np.float32(delay_steps),
                                              0.0, 1.0), dtype=np.float32)
    else:
        rate = np.float32(1.0)
    t = np.clip(step / np.float32(max_steps), 0.0, 1.0).astype(np.float32)
    lerp = np.exp(np.log(np.float32(lr_init)) * (np.float32(1.0) - t)
                  + np.log(np.float32(lr_final)) * t, dtype=np.float32)
    return float(np.float32(rate * lerp))


def _window(dtype, device, size=11, sigma=1.5):
    xs = [math.exp(-((x - size // 2) ** 2) / (2.0 * sigma ** 2))
          for x in range(size)]
    s = sum(xs)
    return torch.tensor([x / s for x in xs], dtype=dtype, device=device)


def _blur(img, win):
    k = win.numel()
    r = k // 2
    _, h, w = img.shape
    xp = torch.nn.functional.pad(img, (0, 0, r, r))
    out = sum(win[i] * xp[:, i:i + h] for i in range(k))
    xp = torch.nn.functional.pad(out, (r, r, 0, 0))
    return sum(win[i] * xp[:, :, i:i + w] for i in range(k))


def ssim(a, b):
    win = _window(a.dtype, a.device)
    c1, c2 = 0.01 ** 2, 0.03 ** 2
    mu1, mu2 = _blur(a, win), _blur(b, win)
    s11 = _blur(a * a, win) - mu1 * mu1
    s22 = _blur(b * b, win) - mu2 * mu2
    s12 = _blur(a * b, win) - mu1 * mu2
    m = (((2 * mu1 * mu2 + c1) * (2 * s12 + c2))
         / ((mu1 * mu1 + mu2 * mu2 + c1) * (s11 + s22 + c2)))
    return m.mean()


def photometric(pred, gt):
    return ((1.0 - LAMBDA_DSSIM) * (pred - gt).abs().mean()
            + LAMBDA_DSSIM * (1.0 - ssim(pred, gt)))


def view_loss(params: dict, alive, exp_row, view: dict, it: int, bg,
              offset, record: dict, half: bool = False):
    """Loss of one view and what the update reads of its render.
    ``half`` keeps only the upper half of the image (a planted fault)."""
    dt = params["xyz"].dtype
    opac = torch.where(alive[:, None], torch.sigmoid(params["opacity"]),
                       torch.zeros_like(params["opacity"]))[:, 0]
    rot = params["rotation"]
    rot = rot / torch.sqrt(torch.sum(rot * rot, -1, keepdim=True) + 1e-12)
    shs = torch.cat([params["f_dc"], params["f_rest"]], dim=1)
    image, invd, proj = rasterize(
        params["xyz"], torch.exp(params["scaling"]), rot, opac, shs,
        view["cam"], 3, bg, offset=offset, record=record)
    m = exp_row[:3, :3]
    image = (image[:, None] * m[:, :, None, None]).sum(dim=0) \
        + exp_row[:3, 3][:, None, None]
    image = torch.clamp(image, 0.0, 1.0) * view["alpha"].to(dt)
    gt = view["gt"].to(dt)
    dmask, gt_invd = view["depth_mask"].to(dt), view["invdepth"].to(dt)
    if half:
        rows = image.shape[1] // 2
        image, gt = image[:, :rows], gt[:, :rows]
        invd, gt_invd, dmask = (invd[:, :rows], gt_invd[:, :rows],
                                dmask[:, :rows])
    photo = photometric(image, gt)
    w = expon_lr(it, 1.0, 0.01, max_steps=ITERATIONS)
    depth = w * ((invd - gt_invd).abs() * dmask).mean()
    return photo, depth, proj


def adam(p, g, mu, nu, step, lr, mask, eps):
    """One masked Adam step on a leaf; returns (p, mu, nu)."""
    b1, b2 = 0.9, 0.999
    bc1 = 1.0 - b1 ** step
    bc2 = 1.0 - b2 ** step
    m = mask.reshape((-1,) + (1,) * (p.dim() - 1))
    mu_n = torch.where(m, b1 * mu + (1.0 - b1) * g, mu)
    nu_n = torch.where(m, b2 * nu + (1.0 - b2) * g * g, nu)
    upd = (lr / bc1) * mu_n / (torch.sqrt(nu_n) / math.sqrt(bc2) + eps)
    return torch.where(m, p - upd, p), mu_n, nu_n


def train_step(st: dict, view: dict, it: int, bg, extent: float,
               n_skybox: int, n_protected: int, record: dict,
               half: bool = False) -> dict:
    """One step from the state ``st`` (dict: the six leaves, ``alive``,
    ``exposure`` [V,3,4], ``mu``/``nu`` dicts over the leaves and
    ``exposure``, ``step``, ``accum``, ``denom``, ``radii``). Returns the
    next state; ``record`` gets the losses, the gradients as Adam received
    them, and the blend's pair counts."""
    dt = st["xyz"].dtype
    params = {k: st[k].detach().requires_grad_(True) for k in LEAVES}
    idx = view["index"]
    exp_row = st["exposure"][idx].detach().requires_grad_(True)
    offset = torch.zeros((st["xyz"].shape[0], 2), dtype=dt,
                         device=st["xyz"].device, requires_grad=True)
    photo, depth, proj = view_loss(params, st["alive"], exp_row, view, it,
                                   bg, offset, record, half)
    grads = torch.autograd.grad(photo + depth,
                                [params[k] for k in LEAVES]
                                + [offset, exp_row], allow_unused=True,
                                materialize_grads=True)
    g = dict(zip(LEAVES, grads[:6]))
    g_off, g_exp_row = grads[6], grads[7]
    rows = torch.arange(st["xyz"].shape[0], device=st["xyz"].device)
    locked = rows < n_skybox
    with torch.no_grad():
        for k in LEAVES:
            m = locked.reshape((-1,) + (1,) * (g[k].dim() - 1))
            g[k] = torch.where(m, torch.zeros_like(g[k]), g[k])
        vis = proj.radius > 0
        norm = torch.linalg.vector_norm(g_off, dim=-1)
        out = dict(st)
        out["accum"] = torch.where(vis, torch.maximum(st["accum"], norm),
                                   st["accum"])
        out["denom"] = st["denom"] + vis.to(st["denom"].dtype)
        out["radii"] = torch.where(vis, torch.maximum(
            st["radii"], proj.radius.to(st["radii"].dtype)), st["radii"])
        step = st["step"] + 1
        relevant = (g["opacity"][:, 0] != 0.0) & st["alive"]
        lrs = dict(LRS)
        lrs["xyz"] = expon_lr(it, 0.00002, 0.0000002, delay_mult=0.01,
                              max_steps=30_000) * extent
        mu, nu = dict(st["mu"]), dict(st["nu"])
        for k in LEAVES:
            out[k], mu[k], nu[k] = adam(st[k], g[k], st["mu"][k],
                                        st["nu"][k], step, lrs[k], relevant,
                                        1e-15)
        g_exp = torch.zeros_like(st["exposure"])
        g_exp[idx] = g_exp_row
        exp_lr = expon_lr(it, 0.001, 0.0001, delay_steps=5000,
                          delay_mult=0.001, max_steps=ITERATIONS)
        every = torch.ones(g_exp.shape[0], dtype=torch.bool,
                           device=g_exp.device)
        out["exposure"], mu["exposure"], nu["exposure"] = adam(
            st["exposure"], g_exp, st["mu"]["exposure"],
            st["nu"]["exposure"], step, exp_lr, every, 1e-8)
        out["mu"], out["nu"], out["step"] = mu, nu, step
        big = (torch.exp(out["scaling"]).amax(dim=1) > 0.02 * extent) \
            & st["alive"] & (rows >= n_protected)
        out["scaling"] = torch.where(big[:, None],
                                     out["scaling"] + math.log(0.8),
                                     out["scaling"])
    record["photo"] = float(photo.detach())
    record["depth"] = float(depth.detach())
    # The gradients as Adam receives them: on the rows it updates.
    record["grads"] = {k: torch.where(
        relevant.reshape((-1,) + (1,) * (g[k].dim() - 1)), g[k],
        torch.zeros_like(g[k])) for k in LEAVES}
    record["grads"]["exposure"] = g_exp
    return out


def densify(st: dict, eps: torch.Tensor, extent: float, n_protected: int,
            max_grad: float = 0.015, min_opacity: float = 0.005,
            percent_dense: float = 0.0001) -> dict:
    """One densify-and-prune pass under fixed capacity: clone small and
    split large live Gaussians whose max screen gradient x max radius x
    opacity^(1/5) reaches ``max_grad`` (opacity above 0.15, scaffold
    exempt) into the free rows in row order, two split children at
    offsets R (eps * s) with scales / 1.6, originals of splits and
    Gaussians below ``min_opacity`` removed. ``eps`` [2, C, 3] are the
    split offsets' standard normals. Returns xyz, scaling, alive."""
    c = st["xyz"].shape[0]
    dev = st["xyz"].device
    alive = st["alive"]
    opac = torch.where(alive, torch.sigmoid(st["opacity"][:, 0]),
                       torch.zeros_like(st["opacity"][:, 0]))
    scales = torch.exp(st["scaling"])
    max_scale = scales.amax(dim=1)
    protected = torch.arange(c, device=dev) < n_protected
    score = st["accum"] * st["radii"] * opac ** 0.2
    base = (score >= max_grad) & (opac > 0.15) & alive & ~protected
    clone = base & (max_scale <= percent_dense * extent)
    split = base & (max_scale > percent_dense * extent)
    free = torch.nonzero(~alive, as_tuple=True)[0]
    n_free = free.numel()
    clone_src = torch.nonzero(clone, as_tuple=True)[0]
    split_src = torch.nonzero(split, as_tuple=True)[0]
    n_c = min(clone_src.numel(), n_free)
    clone_src = clone_src[:n_c]
    n_s = max(0, min(split_src.numel(), (n_free - n_c) // 2))
    split_src = split_src[:n_s]
    xyz, scl = st["xyz"].clone(), st["scaling"].clone()
    new_alive = alive.clone()
    xyz[free[:n_c]] = st["xyz"][clone_src]
    scl[free[:n_c]] = st["scaling"][clone_src]
    new_alive[free[:n_c]] = True
    q = st["rotation"] / torch.sqrt(
        (st["rotation"] * st["rotation"]).sum(-1, keepdim=True) + 1e-12)
    w, x, y, z = q.unbind(-1)
    rot = torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(c, 3, 3)
    for j in range(2):
        dest = free[n_c + 2 * torch.arange(n_s, device=dev) + j]
        offs = (rot * (eps[j] * scales)[:, None, :]).sum(-1)
        xyz[dest] = (st["xyz"] + offs)[split_src]
        scl[dest] = st["scaling"][split_src] - math.log(1.6)
        new_alive[dest] = True
    new_alive[split_src] = False
    prune = (opac < min_opacity) & alive & ~protected
    new_alive &= ~prune
    return {"xyz": xyz, "scaling": scl, "alive": new_alive,
            "n_clone": n_c, "n_split": n_s, "n_prune": int(prune.sum())}
