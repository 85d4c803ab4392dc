"""A hierarchy of Gaussians, built on the device from seeded leaves.

The tree is the port's ``.hier`` layout (node columns PARENT,
FIRST_CHILD, N_CHILDREN, DEPTH; children contiguous; boxes nested), made
here by the benchmark's own code: leaves in chunk-major Morton order, a
balanced binary tree by splitting every leaf range at its midpoint (so
the root of a two-chunk scene splits exactly at the chunk boundary), and
interior Gaussians by opacity-and-area-weighted moment matching of their
two children. Boxes are each node's 3-sigma box, unioned with its
children's. Both the program and the reference are handed the same
arrays.
"""
from __future__ import annotations

import torch

PARENT, FIRST_CHILD, N_CHILDREN, DEPTH = 0, 1, 2, 3


def morton_order(xyz: torch.Tensor) -> torch.Tensor:
    """Indices sorting points by a 30-bit Morton code over their box."""
    lo = xyz.min(dim=0).values
    span = (xyz.max(dim=0).values - lo).clamp_min(1e-9)
    q = ((xyz - lo) / span * 1023.0).round().long().clamp(0, 1023)
    code = torch.zeros(xyz.shape[0], dtype=torch.long, device=xyz.device)
    for bit in range(10):
        for axis in range(3):
            code |= ((q[:, axis] >> bit) & 1) << (3 * bit + axis)
    return torch.argsort(code, stable=True)


def tree_structure(n: int, device):
    """Level-ordered balanced binary tree over ``n`` leaves.

    Returns (nodes int32 [M,4], leaf_of int64 [M] (leaf index, -1 for
    interior), levels: list of (first node, count) per depth)."""
    a = torch.zeros(1, dtype=torch.long, device=device)
    b = torch.full((1,), n, dtype=torch.long, device=device)
    parent = torch.full((1,), -1, dtype=torch.long, device=device)
    cols, leaf_of, levels = [], [], []
    first = 0
    depth = 0
    while a.numel():
        cnt = a.numel()
        levels.append((first, cnt))
        size = b - a
        interior = size >= 2
        n_int = int(interior.sum())
        # Children of this level's interior nodes, in order, form the next
        # level: interior node k's children are next-level slots 2r, 2r+1
        # with r its rank among the interior nodes.
        rank = torch.cumsum(interior.long(), 0) - 1
        nxt = first + cnt
        first_child = torch.where(interior, nxt + 2 * rank,
                                  torch.full_like(rank, -1))
        cols.append(torch.stack([
            parent, first_child, torch.where(interior, 2, 0),
            torch.full_like(parent, depth)], dim=1))
        leaf_of.append(torch.where(interior, torch.full_like(a, -1), a))
        ia, ib = a[interior], b[interior]
        mid = (ia + ib) // 2
        ids = torch.arange(first, first + cnt, device=device)[interior]
        a = torch.stack([ia, mid], dim=1).reshape(-1)
        b = torch.stack([mid, ib], dim=1).reshape(-1)
        parent = ids.repeat_interleave(2)
        first = nxt
        depth += 1
        assert a.numel() == 2 * n_int
    return (torch.cat(cols).to(torch.int32), torch.cat(leaf_of), levels)


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    q = q / q.norm(dim=-1, keepdim=True)
    w, x, y, z = q.unbind(-1)
    return torch.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], dim=-1).reshape(q.shape[:-1] + (3, 3))


def rotmat_to_quat(r: torch.Tensor) -> torch.Tensor:
    """Proper rotations [...,3,3] -> unit quaternions (w, x, y, z)."""
    m00, m11, m22 = r[..., 0, 0], r[..., 1, 1], r[..., 2, 2]
    qw = 0.5 * torch.sqrt((1 + m00 + m11 + m22).clamp_min(0))
    qx = 0.5 * torch.sqrt((1 + m00 - m11 - m22).clamp_min(0))
    qy = 0.5 * torch.sqrt((1 - m00 + m11 - m22).clamp_min(0))
    qz = 0.5 * torch.sqrt((1 - m00 - m11 + m22).clamp_min(0))
    qx = torch.copysign(qx, r[..., 2, 1] - r[..., 1, 2])
    qy = torch.copysign(qy, r[..., 0, 2] - r[..., 2, 0])
    qz = torch.copysign(qz, r[..., 1, 0] - r[..., 0, 1])
    q = torch.stack([qw, qx, qy, qz], dim=-1)
    return q / q.norm(dim=-1, keepdim=True).clamp_min(1e-12)


def batched_eigh(a: torch.Tensor, sweeps: int = 8):
    """Eigenvalues [K,3] and eigenvectors (columns, a proper rotation)
    [K,3,3] of symmetric [K,3,3] matrices by cyclic Jacobi rotations, in
    elementwise operations (no solver library, no matmul precision
    setting)."""
    a = a.clone()
    k = a.shape[0]
    v = torch.eye(3, dtype=a.dtype, device=a.device).repeat(k, 1, 1)

    def mul(x, y):
        return (x[:, :, :, None] * y[:, None, :, :]).sum(dim=2)

    for _ in range(sweeps):
        for p, q in ((0, 1), (0, 2), (1, 2)):
            apq = a[:, p, q]
            nz = apq.abs() > 1e-30
            theta = (a[:, q, q] - a[:, p, p]) / torch.where(
                nz, 2 * apq, torch.ones_like(apq))
            t = torch.sign(theta) / (theta.abs() + torch.sqrt(theta * theta
                                                              + 1))
            t = torch.where(theta == 0, torch.ones_like(t), t)
            c = torch.where(nz, 1 / torch.sqrt(t * t + 1),
                            torch.ones_like(t))
            s = torch.where(nz, t * c, torch.zeros_like(t))
            j = torch.eye(3, dtype=a.dtype, device=a.device).repeat(k, 1, 1)
            j[:, p, p] = c
            j[:, q, q] = c
            j[:, p, q] = s
            j[:, q, p] = -s
            a = mul(mul(j.transpose(1, 2), a), j)
            v = mul(v, j)
    return torch.diagonal(a, dim1=1, dim2=2), v


def build_hierarchy(leaves: dict, order: torch.Tensor, locked=None):
    """Hierarchy arrays over ``leaves`` (dict of xyz [N,3], sh [N,16,3],
    scaling [N,3] log, rotation [N,4], opacity [N] activated) taken in
    ``order``. Returns a dict of tensors on the leaves' device: xyz,
    shs, alpha, scaling, rotation, nodes, boxes; with ``locked`` [N] bool
    also ``anchors`` (int32 node indices): the locked leaves and every
    node above one, which post-training keeps fixed."""
    dev = leaves["xyz"].device
    n = order.numel()
    nodes, leaf_of, levels = tree_structure(n, dev)
    m = nodes.shape[0]
    xyz = torch.zeros((m, 3), device=dev)
    shs = torch.zeros((m, 16, 3), device=dev)
    alpha = torch.zeros(m, device=dev)
    scaling = torch.zeros((m, 3), device=dev)
    rotation = torch.zeros((m, 4), device=dev)
    cov = torch.zeros((m, 3, 3), device=dev)
    boxes = torch.zeros((m, 2, 3), device=dev)

    is_leaf = leaf_of >= 0
    src = order[leaf_of[is_leaf]]
    xyz[is_leaf] = leaves["xyz"][src]
    shs[is_leaf] = leaves["sh"][src]
    alpha[is_leaf] = leaves["opacity"][src]
    scaling[is_leaf] = leaves["scaling"][src]
    rotation[is_leaf] = leaves["rotation"][src]
    anchor = torch.zeros(m, dtype=torch.bool, device=dev)
    if locked is not None:
        anchor[is_leaf] = locked[src]
    rot = quat_to_rotmat(rotation[is_leaf])
    s2 = torch.exp(2 * scaling[is_leaf])
    cov[is_leaf] = rot @ torch.diag_embed(s2) @ rot.transpose(-1, -2)
    ext = 3 * torch.exp(scaling[is_leaf]).amax(dim=1, keepdim=True)
    boxes[is_leaf, 0] = xyz[is_leaf] - ext
    boxes[is_leaf, 1] = xyz[is_leaf] + ext

    def area(logs):
        s = torch.exp(logs).sort(dim=1, descending=True).values
        return s[:, 0] * s[:, 1]

    # Interior nodes, deepest level first: every child is done before its
    # parent.
    for first, cnt in reversed(levels):
        ids = torch.arange(first, first + cnt, device=dev)
        ids = ids[nodes[ids, N_CHILDREN] > 0]
        if ids.numel() == 0:
            continue
        c0 = nodes[ids, FIRST_CHILD].long()
        kids = torch.stack([c0, c0 + 1], dim=1)                    # [K,2]
        w = alpha[kids] * area(scaling[kids].reshape(-1, 3)).reshape(-1, 2)
        wsum = w.sum(dim=1).clamp_min(1e-12)
        wn = w / wsum[:, None]
        mu = (wn[..., None] * xyz[kids]).sum(dim=1)
        d = xyz[kids] - mu[:, None]
        c = (wn[..., None, None] * (cov[kids] + d[..., :, None]
                                    * d[..., None, :])).sum(dim=1)
        evals, evecs = batched_eigh(c)
        s = torch.sqrt(evals.clamp_min(1e-12))
        xyz[ids] = mu
        cov[ids] = c
        scaling[ids] = torch.log(s)
        rotation[ids] = rotmat_to_quat(evecs)
        shs[ids] = (wn[..., None, None] * shs[kids]).sum(dim=1)
        a_kids = alpha[kids] * area(scaling[kids].reshape(-1, 3)).reshape(
            -1, 2)
        alpha[ids] = (a_kids.sum(dim=1) / area(scaling[ids])).clamp(
            0.01, 0.99)
        ext = 3 * s.amax(dim=1, keepdim=True)
        boxes[ids, 0] = torch.minimum(mu - ext, boxes[kids, 0].amin(dim=1))
        boxes[ids, 1] = torch.maximum(mu + ext, boxes[kids, 1].amax(dim=1))
        anchor[ids] = anchor[kids].any(dim=1)
    out = {"xyz": xyz, "shs": shs, "alpha": alpha, "scaling": scaling,
           "rotation": rotation, "nodes": nodes, "boxes": boxes}
    if locked is not None:
        out["anchors"] = torch.nonzero(anchor, as_tuple=True)[0].to(
            torch.int32)
    return out
