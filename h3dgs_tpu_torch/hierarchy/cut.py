"""View-adaptive hierarchy cuts + LOD interpolation (torch).

Counterpart of ``h3dgs_tpu/hierarchy/cut.py``. Boxes are nested
(hierarchy/tree.py), so the projected granularity
  size(n) = ||box_diag(n)|| / max(dist(cam, box(n)), eps)
is monotone non-increasing along every root->leaf path, and the cut is the
flat per-node predicate
  in_cut(n)  =  size(parent(n)) > limit  and  (leaf(n) or size(n) <= limit).
Interpolation lerps w * child + (1 - w) * parent with a quaternion sign
fix, w following where the limit falls between parent and child
granularity. Norms are written out as sqrt(sum of squares) so cut
membership matches the reference bit for bit.
"""
from __future__ import annotations

from typing import NamedTuple, Optional

import torch

from ..utils import profiling
from .tree import N_CHILDREN, PARENT

DIST_EPS = 1e-9


class Cut(NamedTuple):
    """A fixed-capacity cut through the hierarchy."""
    indices: torch.Tensor       # [K] i32 node indices (== Gaussian rows); M = pad
    parents: torch.Tensor       # [K] i32 parent node indices (self for root/pad)
    weights: torch.Tensor       # [K] f32 child weight w in [0, 1]
    num_siblings: torch.Tensor  # [K] i32
    valid: torch.Tensor         # [K] bool
    count: torch.Tensor         # [] i32 true cut size (may exceed K: overflow)
    size: int                   # the true cut size as read on the host


def norm3(v: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(v[..., 0] * v[..., 0] + v[..., 1] * v[..., 1]
                      + v[..., 2] * v[..., 2])


def node_sizes(boxes: torch.Tensor, cam_center: torch.Tensor) -> torch.Tensor:
    """Projected granularity of every node for a camera position. [M]"""
    diag = norm3(boxes[:, 1] - boxes[:, 0])
    delta = torch.clamp_min(torch.maximum(boxes[:, 0] - cam_center,
                                          cam_center - boxes[:, 1]), 0.0)
    dist = norm3(delta)
    return diag / torch.clamp_min(dist, DIST_EPS)


def _parent_sizes(nodes: torch.Tensor, size: torch.Tensor):
    parent = nodes[:, PARENT].long()
    has_parent = parent >= 0
    psize = torch.where(has_parent, size[parent.clamp_min(0)],
                        torch.full_like(size, float("inf")))
    is_leaf = nodes[:, N_CHILDREN] == 0
    return psize, is_leaf


def cut_mask(nodes: torch.Tensor, boxes: torch.Tensor, limit,
             cam_center: torch.Tensor):
    """Per-node cut membership + interpolation weight ([M] bool, [M] f32,
    [M] f32 sizes)."""
    size = node_sizes(boxes, cam_center)
    psize, is_leaf = _parent_sizes(nodes, size)
    limit = torch.as_tensor(limit, dtype=size.dtype, device=size.device)
    in_cut = (psize > limit) & (is_leaf | (size <= limit))

    denom = psize - size
    big = denom > 1e-12
    w = torch.where(torch.isfinite(psize) & big,
                    (psize - limit) / torch.where(big, denom,
                                                  torch.ones_like(denom)),
                    torch.ones_like(denom))
    return in_cut, torch.clamp(w, 0.0, 1.0), size


def cut_counts(nodes: torch.Tensor, boxes: torch.Tensor,
               cam_center: torch.Tensor, limits: torch.Tensor) -> torch.Tensor:
    """Cut sizes for a whole ladder of limits in one pass. [K]"""
    size = node_sizes(boxes, cam_center)
    psize, is_leaf = _parent_sizes(nodes, size)
    lim = limits[None, :]
    in_cut = (psize[:, None] > lim) & (is_leaf[:, None]
                                       | (size[:, None] <= lim))
    return in_cut.sum(dim=0, dtype=torch.int32)


def expand_to_size(nodes: torch.Tensor, boxes: torch.Tensor, limit,
                   cam_center: torch.Tensor,
                   max_cut: Optional[int]) -> Cut:
    """Select the view-adaptive cut, compacted to capacity ``max_cut``:
    ascending node indices padded with M; ``count`` is the true size.
    ``max_cut=None`` sizes the cut exactly (no padding, never truncated).
    The selection's size is read on the host either way (one device
    sync, in the span ``cut.count.sync``) and kept as ``size``."""
    m = nodes.shape[0]
    dev = nodes.device
    in_cut, w_all, _ = cut_mask(nodes, boxes, limit, cam_center)
    with profiling.span("cut.count.sync"):
        (sel,) = torch.nonzero(in_cut, as_tuple=True)
    count = torch.tensor(sel.shape[0], dtype=torch.int32, device=dev)
    if max_cut is None:
        max_cut = sel.shape[0]
    k = min(sel.shape[0], max_cut)
    idx = torch.full((max_cut,), m, dtype=torch.int64, device=dev)
    idx[:k] = sel[:k]
    valid = torch.arange(max_cut, device=dev) < k
    safe = torch.where(valid, idx, torch.zeros_like(idx))
    parent = nodes[safe, PARENT].long()
    parent = torch.where(valid & (parent >= 0), parent, safe)
    nsib = torch.where(parent != safe, nodes[parent, N_CHILDREN],
                       torch.ones_like(nodes[parent, N_CHILDREN]))
    return Cut(
        indices=idx.to(torch.int32),
        parents=parent.to(torch.int32),
        weights=torch.where(valid, w_all[safe], torch.zeros_like(w_all[safe])),
        num_siblings=torch.where(valid, nsib,
                                 torch.ones_like(nsib)).to(torch.int32),
        valid=valid,
        count=count,
        size=sel.shape[0],
    )


# interp_table column layout: xyz 0-2, activated scales 3-5, rotation
# 6-9, |opacity| 10, shs (f_dc + f_rest flattened) 11-58; 59-63 pad.
_T_XYZ, _T_SCL, _T_ROT, _T_OP, _T_SH = 0, 3, 6, 10, 11
_T_COLS = 64


def interp_table(params: dict) -> torch.Tensor:
    """[M, 64] fused attribute table for interpolate_cut (activated where
    the reference lerps activated values). The viewer caches it across
    frames, so per-frame interpolation is two row gathers."""
    m = params["xyz"].shape[0]
    feats = torch.cat([params["f_dc"], params["f_rest"]], dim=1)
    t = torch.cat([
        params["xyz"],
        torch.exp(params["scaling"]),
        params["rotation"],
        torch.abs(params["opacity"]),
        feats.reshape(m, 48),
    ], dim=1)                                               # [M, 59]
    return torch.nn.functional.pad(t, (0, _T_COLS - t.shape[1]))


def interpolate_cut(params: dict, cut: Cut, table: torch.Tensor = None):
    """Gather + lerp hierarchy attributes for the cut's nodes.

    ``params``: xyz [M,3], f_dc [M,1,3], f_rest [M,15,3], opacity [M,1]
    (pre-activation, |x| semantics), scaling [M,3] log, rotation [M,4].
    Returns activated per-splat tensors of length K (xyz, scales, quats,
    opacity, shs [K,16,3]). ``table``: optional prebuilt interp_table.
    """
    if table is None:
        table = interp_table(params)
    k = cut.indices.shape[0]
    ci = torch.where(cut.valid, cut.indices,
                     torch.zeros_like(cut.indices)).long()
    pi = cut.parents.long()
    w = cut.weights[:, None]

    rc = table[ci]                                          # [K, 64]
    rp = table[pi]
    lin = w * rc + (1.0 - w) * rp
    xyz = lin[:, _T_XYZ:_T_XYZ + 3]
    scales = lin[:, _T_SCL:_T_SCL + 3]
    opac = torch.where(cut.valid, lin[:, _T_OP],
                       torch.zeros_like(lin[:, _T_OP]))
    shs = lin[:, _T_SH:_T_SH + 48].reshape(k, 16, 3)

    # Quaternion sign fix: flip parent where dot(child, parent) < 0.
    qc = rc[:, _T_ROT:_T_ROT + 4]
    qp = rp[:, _T_ROT:_T_ROT + 4]
    dots = torch.sum(qc * qp, dim=-1, keepdim=True)
    qp = torch.where(dots < 0, -qp, qp)
    quats = w * qc + (1.0 - w) * qp
    return xyz, scales, quats, opac, shs


def pixel_limit(tau: float, tanfovx: float, width: int) -> float:
    """Granularity limit from a pixel-space target tau (reference formula
    threshold = (2 * (tau + 0.5)) * tanfovx / (0.5 * width))."""
    return (2.0 * (tau + 0.5)) * tanfovx / (0.5 * width)
