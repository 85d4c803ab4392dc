"""Plain reference of one served frame of a hierarchy.

Given the hierarchy's arrays (per node: xyz, SH [M,16,3], activated
opacity, log scales, rotations, node columns, nested boxes), a camera and
a pixel granularity tau, it works out the frame the viewer should get:

1. granularity of every node: |box diagonal| / max(distance from the
   camera to the box, 1e-9);
2. budget fit: the first limit of the ladder limit0 * 1.5^k (k < 16)
   whose cut fits the splat budget, limit0 = 2 (tau + 0.5) tan(fov_x / 2)
   / (width / 2); then the 5 % finer limit when its cut fits too (the
   viewer's reuse hysteresis);
3. the cut: nodes whose parent is coarser than the limit and that are
   leaves or fine enough themselves;
4. LOD interpolation of each cut node with its parent, weight
   (size(parent) - limit) / (size(parent) - size(node)) clamped to [0, 1],
   on activated scales and opacities, with the parent's quaternion
   flipped into the child's hemisphere;
5. projection, binning and blending on a black background, clamped to
   [0, 1] and truncated to uint8.
"""
from __future__ import annotations

import torch

from .render import bin_splats, blend, project

LADDER_STEPS = 16
LADDER_RATIO = 1.5
REUSE_MARGIN = 0.05


def pixel_limit(tau: float, tanfovx: float, width: int) -> float:
    return (2.0 * (tau + 0.5)) * tanfovx / (0.5 * width)


def _norm3(v):
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def node_sizes(boxes, center):
    diag = _norm3(boxes[:, 1] - boxes[:, 0])
    delta = torch.clamp_min(torch.maximum(boxes[:, 0] - center,
                                          center - boxes[:, 1]), 0.0)
    return diag / torch.clamp_min(_norm3(delta), 1e-9)


def select(h: dict, center, limit0: float, budget: int):
    """Steps 1-4: the interpolated splats of the cut (xyz, scales,
    quaternions, opacities, SH) and the cut size."""
    nodes, boxes = h["nodes"], h["boxes"]
    size = node_sizes(boxes, center)
    parent = nodes[:, 0].long()
    has_parent = parent >= 0
    psize = torch.where(has_parent, size[parent.clamp_min(0)],
                        torch.full_like(size, float("inf")))
    is_leaf = nodes[:, 2] == 0

    def count(limit):
        return int(((psize > limit) & (is_leaf | (size <= limit))).sum())

    ladder = [limit0 * LADDER_RATIO ** k for k in range(LADDER_STEPS)]
    ladder_t = (torch.tensor(limit0, dtype=torch.float32, device=size.device)
                * LADDER_RATIO ** torch.arange(LADDER_STEPS,
                                               dtype=torch.float32,
                                               device=size.device))
    limit = ladder_t[-1]
    for k in range(len(ladder)):
        if count(ladder_t[k]) <= budget:
            limit = ladder_t[k]
            break
    hyst = limit * (1.0 - REUSE_MARGIN)
    if count(hyst) <= budget:
        limit = hyst
    in_cut = (psize > limit) & (is_leaf | (size <= limit))
    idx = torch.nonzero(in_cut, as_tuple=True)[0]
    par = torch.where(has_parent[idx], parent[idx], idx)
    denom = psize[idx] - size[idx]
    big = denom > 1e-12
    wgt = torch.where(torch.isfinite(psize[idx]) & big,
                      (psize[idx] - limit) / torch.where(
                          big, denom, torch.ones_like(denom)),
                      torch.ones_like(denom)).clamp(0.0, 1.0)[:, None]

    def lerp(a):
        return wgt * a[idx] + (1.0 - wgt) * a[par]

    xyz = lerp(h["xyz"])
    scales = lerp(torch.exp(h["scaling"]))
    opac = lerp(h["alpha"].abs()[:, None])[:, 0]
    shs = (wgt[..., None] * h["shs"][idx]
           + (1.0 - wgt[..., None]) * h["shs"][par])
    qc, qp = h["rotation"][idx], h["rotation"][par]
    qp = torch.where((qc * qp).sum(-1, keepdim=True) < 0, -qp, qp)
    quats = wgt * qc + (1.0 - wgt) * qp
    return (xyz, scales, quats, opac, shs), idx.numel()


def frame(h: dict, cam, tau: float, budget: int, dtype=torch.float32):
    """The frame [H, W, 3] uint8 and the blend's evaluated pairs and the
    cut size, computed in ``dtype``."""
    limit0 = pixel_limit(tau, cam.tanfovx, cam.width)
    (xyz, scales, quats, opac, shs), n_cut = select(
        h, cam.center, limit0, budget)
    args = [t.to(dtype) for t in (xyz, scales, quats, opac, shs)]
    p = project(*args, cam, 3)
    binned = bin_splats(p, cam.height, cam.width)
    color, _invd, final_t, _last, evaluated = blend(p, binned, cam.height,
                                                    cam.width)
    img = torch.clamp(color.float(), 0.0, 1.0)   # black background
    img = (img.permute(1, 2, 0) * 255.0).to(torch.uint8)
    return img, {"k1_pairs": int(evaluated.sum()), "cut": n_cut,
                 "visible": int((p.radius > 0).sum()),
                 "entries": int(binned.gauss_idx.numel())}
