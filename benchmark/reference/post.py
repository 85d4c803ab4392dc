"""Plain reference of the hierarchy post-training step.

One step, as the upstream post-training defines it (``train_post.py``):
the view-adaptive cut of the hierarchy at a granularity limit (nodes whose
parent is coarser than the limit and that are leaves or fine enough),
each cut node interpolated with its parent (activated scales and
opacities, the parent's quaternion flipped into the child's hemisphere)
with gradients flowing to both, the sky rows appended, the view rendered
with its pretrained exposure and clamped, loss 0.8 L1 + 0.2 (1 - SSIM),
gradients of anchor and sky rows zeroed, then Adam (eps 1e-15) on every
row. Plain torch in any float type; it imports nothing of the program.
"""
from __future__ import annotations

import torch

from .render import rasterize
from .serve import node_sizes
from .train import LEAVES, LRS, adam, expon_lr, photometric


def cut_splats(params: dict, nodes, boxes, center, limit, n_nodes: int):
    """The interpolated splats of the cut (xyz, scales, quaternions,
    opacities, SH [K,16,3]) with the sky rows (those past ``n_nodes``)
    appended, differentiable in ``params``; and the cut size."""
    size = node_sizes(boxes, center)
    parent = nodes[:, 0].long()
    has_parent = parent >= 0
    psize = torch.where(has_parent, size[parent.clamp_min(0)],
                        torch.full_like(size, float("inf")))
    is_leaf = nodes[:, 2] == 0
    in_cut = (psize > limit) & (is_leaf | (size <= limit))
    idx = torch.nonzero(in_cut, as_tuple=True)[0]
    par = torch.where(has_parent[idx], parent[idx], idx)
    denom = psize[idx] - size[idx]
    big = denom > 1e-12
    w = torch.where(torch.isfinite(psize[idx]) & big,
                    (psize[idx] - limit) / torch.where(
                        big, denom, torch.ones_like(denom)),
                    torch.ones_like(denom)).clamp(0.0, 1.0)
    w = w.to(params["xyz"].dtype)[:, None]

    def act(rows):
        feats = torch.cat([params["f_dc"][rows], params["f_rest"][rows]], 1)
        return (params["xyz"][rows], torch.exp(params["scaling"][rows]),
                params["rotation"][rows], params["opacity"][rows, 0].abs(),
                feats)

    c_xyz, c_scl, c_rot, c_op, c_sh = act(idx)
    p_xyz, p_scl, p_rot, p_op, p_sh = act(par)
    p_rot = torch.where((c_rot * p_rot).sum(-1, keepdim=True) < 0, -p_rot,
                        p_rot)
    xyz = w * c_xyz + (1 - w) * p_xyz
    scales = w * c_scl + (1 - w) * p_scl
    quats = w * c_rot + (1 - w) * p_rot
    opac = w[:, 0] * c_op + (1 - w[:, 0]) * p_op
    shs = w[..., None] * c_sh + (1 - w[..., None]) * p_sh
    sky = torch.arange(n_nodes, params["xyz"].shape[0],
                       device=params["xyz"].device)
    s_xyz, s_scl, s_rot, s_op, s_sh = act(sky)
    return (torch.cat([xyz, s_xyz]), torch.cat([scales, s_scl]),
            torch.cat([quats, s_rot]), torch.cat([opac, s_op]),
            torch.cat([shs, s_sh])), int(idx.numel())


def post_step(st: dict, view: dict, limit, exp_row, it: int, bg,
              extent: float, locked, nodes, boxes, n_nodes: int,
              record: dict, half: bool = False) -> dict:
    """One step from ``st`` (the six leaves over [nodes | sky] rows,
    ``mu``/``nu`` dicts, ``step``); returns the next state. ``record``
    gets the loss, the gradients as Adam receives them and the counts."""
    dt = st["xyz"].dtype
    params = {k: st[k].detach().requires_grad_(True) for k in LEAVES}
    cam = view["cam"]
    splats, n_cut = cut_splats(params, nodes, boxes.to(dt),
                               cam.center.to(dt), limit.to(dt), n_nodes)
    image, _invd, _p = rasterize(*splats, cam, 3, bg, record=record)
    m = exp_row.to(dt)[:3, :3]
    image = (image[:, None] * m[:, :, None, None]).sum(dim=0) \
        + exp_row.to(dt)[:3, 3][:, None, None]
    image = torch.clamp(image, 0.0, 1.0) * view["alpha"].to(dt)
    gt = view["gt"].to(dt)
    if half:
        rows = image.shape[1] // 2
        image, gt = image[:, :rows], gt[:, :rows]
    photo = photometric(image, gt)
    grads = torch.autograd.grad(photo, [params[k] for k in LEAVES],
                                materialize_grads=True, allow_unused=True)
    with torch.no_grad():
        g = {}
        for k, gk in zip(LEAVES, grads):
            mk = locked.reshape((-1,) + (1,) * (gk.dim() - 1))
            g[k] = torch.where(mk, torch.zeros_like(gk), gk)
        step = st["step"] + 1
        lrs = dict(LRS)
        lrs["xyz"] = expon_lr(it, 0.00002, 0.0000002, delay_mult=0.01,
                              max_steps=30_000) * extent
        every = torch.ones(st["xyz"].shape[0], dtype=torch.bool,
                           device=st["xyz"].device)
        out = dict(st)
        mu, nu = dict(st["mu"]), dict(st["nu"])
        for k in LEAVES:
            out[k], mu[k], nu[k] = adam(st[k], g[k], st["mu"][k],
                                        st["nu"][k], step, lrs[k], every,
                                        1e-15)
        out["mu"], out["nu"], out["step"] = mu, nu, step
    record["photo"] = float(photo.detach())
    record["grads"] = g
    record["cut"] = n_cut
    return out
