"""Cross-chunk hierarchy consolidation (GaussianHierarchyMerger equivalent).

The port's own copy of ``h3dgs_tpu/hierarchy/merge.py`` (host numpy; its
outputs are bit-equal to it). Deduplicate cross-chunk / scaffold overlap
using each chunk's bounds, then stitch the chunk trees under one global
root.

Algorithm (vectorized numpy, level-by-level — no per-node recursion):

  1. Per chunk, a leaf is *owned* iff its position falls inside the chunk's
     own XY box (inclusive; chunks tile the XY plane, out-of-box leaves are
     scaffold-ring / neighbor duplicates).
  2. Keep every node whose subtree contains an owned leaf (bottom-up pass
     per level). Interior nodes may end up with a single child — allowed by
     the node layout and harmless to cut selection — so sibling contiguity
     survives an order-preserving renumbering.
  3. Concatenate pruned chunk trees, permute each chunk root to the front
     block, and add one global root whose children are the chunk roots
     (contiguous by construction), moment-matched from them.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np

from .tree import (DEPTH, FIRST_CHILD, N_CHILDREN, PARENT, Hierarchy,
                   merge_gaussian_pairs)


def prune_to_box(h: Hierarchy, box_min: np.ndarray, box_max: np.ndarray,
                 axes=(0, 1)) -> Hierarchy:
    """Drop subtrees with no leaf inside the box (checked on ``axes``)."""
    nodes = h.nodes
    m = h.n_nodes
    is_leaf = nodes[:, N_CHILDREN] == 0
    owned = np.ones(m, bool)
    for a in axes:
        owned &= (h.xyz[:, a] >= box_min[a]) & (h.xyz[:, a] <= box_max[a])
    keep = is_leaf & owned

    # Bottom-up per level (argsort instead of assuming level-major layout,
    # so pruning also works on already-merged trees).
    depth = nodes[:, DEPTH]
    by_depth = np.argsort(depth, kind="stable")
    dsorted = depth[by_depth]
    max_d = int(dsorted[-1])
    level_start = np.searchsorted(dsorted, np.arange(max_d + 2))
    max_nc = int(nodes[:, N_CHILDREN].max(initial=0))
    for d in range(max_d - 1, -1, -1):
        idx = by_depth[level_start[d]:level_start[d + 1]]
        interior = nodes[idx, N_CHILDREN] > 0
        pi = idx[interior]
        if pi.size == 0:
            continue
        fc = nodes[pi, FIRST_CHILD]
        nc = nodes[pi, N_CHILDREN]
        any_kept = np.zeros(pi.shape, bool)
        for j in range(max_nc):    # children are contiguous [fc, fc+nc)
            any_kept |= (j < nc) & keep[np.minimum(fc + j, m - 1)]
        keep[pi] = keep[pi] | any_kept

    if not keep.any():
        raise ValueError("chunk box owns no leaves")

    new_id = np.cumsum(keep) - 1
    kept_idx = np.nonzero(keep)[0]
    nn = nodes[kept_idx].copy()

    old_fc = nodes[kept_idx, FIRST_CHILD]
    old_nc = nodes[kept_idx, N_CHILDREN]
    interior = old_nc > 0
    fc_safe = np.maximum(old_fc, 0)
    n_kept = np.zeros(kept_idx.shape, np.int32)
    first_kept = fc_safe.copy()
    for j in range(max_nc - 1, -1, -1):
        child = np.minimum(fc_safe + j, m - 1)
        kj = interior & (j < old_nc) & keep[child]
        n_kept += kj.astype(np.int32)
        first_kept = np.where(kj, child, first_kept)
    nn[:, N_CHILDREN] = np.where(interior, n_kept, 0)
    nn[:, FIRST_CHILD] = np.where(interior & (n_kept > 0),
                                  new_id[first_kept], -1)
    old_par = nodes[kept_idx, PARENT]
    nn[:, PARENT] = np.where(old_par >= 0, new_id[np.maximum(old_par, 0)], -1)

    anchors = h.anchors[keep[h.anchors]] if h.anchors.size else h.anchors
    return Hierarchy(
        xyz=h.xyz[kept_idx], shs=h.shs[kept_idx], alpha=h.alpha[kept_idx],
        scaling=h.scaling[kept_idx], rotation=h.rotation[kept_idx],
        nodes=nn, boxes=h.boxes[kept_idx],
        anchors=new_id[anchors].astype(np.int32),
    )


def _fold_merge(hs: Sequence[Hierarchy], roots: np.ndarray):
    """Moment-match K chunk roots into one global-root Gaussian."""
    xyz = np.stack([h.xyz[r] for h, r in zip(hs, roots)])
    shs = np.stack([h.shs[r] for h, r in zip(hs, roots)])
    alpha = np.stack([h.alpha[r] for h, r in zip(hs, roots)])
    scaling = np.stack([h.scaling[r] for h, r in zip(hs, roots)])
    rot = np.stack([h.rotation[r] for h, r in zip(hs, roots)])
    while xyz.shape[0] > 1:
        k = xyz.shape[0]
        left = np.arange(0, k - 1, 2)
        right = left + 1
        merged = merge_gaussian_pairs(xyz, shs, alpha, scaling, rot,
                                      left, right)
        tail = slice(k - 1, k) if k % 2 else slice(0, 0)
        xyz = np.concatenate([merged["xyz"], xyz[tail]])
        shs = np.concatenate([merged["shs"], shs[tail]])
        alpha = np.concatenate([merged["alpha"], alpha[tail]])
        scaling = np.concatenate([merged["scaling"], scaling[tail]])
        rot = np.concatenate([merged["rotation"], rot[tail]])
    return xyz[0], shs[0], alpha[0], scaling[0], rot[0]


def merge_hierarchies(hierarchies: Sequence[Hierarchy],
                      centers: Sequence[np.ndarray],
                      extents: Sequence[np.ndarray]) -> Hierarchy:
    """Merge per-chunk (post-optimized) hierarchies into one tree."""
    if len(hierarchies) == 1 and centers is None:
        return hierarchies[0]
    pruned = []
    for h, c, e in zip(hierarchies, centers, extents):
        c = np.asarray(c, np.float32)
        e = np.asarray(e, np.float32)
        pruned.append(prune_to_box(h, c - e / 2, c + e / 2))

    k = len(pruned)
    sizes = np.asarray([h.n_nodes for h in pruned])
    base = np.concatenate([[0], np.cumsum(sizes)])[:-1]
    total = int(sizes.sum()) + 1  # + global root

    # Permutation: [global root, chunk roots..., remaining nodes in order].
    # Roots were never anyone's child, so removing them from the sequence
    # keeps every sibling pair adjacent.
    roots_old = np.asarray([b + h.root for b, h in zip(base, pruned)])
    others = np.setdiff1d(np.arange(total - 1), roots_old)
    pos = np.empty(total - 1, np.int64)  # old concat idx -> new idx
    pos[roots_old] = 1 + np.arange(k)
    pos[others] = 1 + k + np.arange(others.size)

    def cat(field):
        return np.concatenate([getattr(h, field) for h in pruned])

    m1 = total
    xyz = np.zeros((m1, 3), np.float32)
    shs = np.zeros((m1, 16, 3), np.float32)
    alpha = np.zeros(m1, np.float32)
    scaling = np.zeros((m1, 3), np.float32)
    rotation = np.zeros((m1, 4), np.float32)
    nodes = np.full((m1, 4), -1, np.int32)
    boxes = np.zeros((m1, 2, 3), np.float32)

    xyz[pos] = cat("xyz")
    shs[pos] = cat("shs")
    alpha[pos] = cat("alpha")
    scaling[pos] = cat("scaling")
    rotation[pos] = cat("rotation")
    boxes[pos] = cat("boxes")

    old_nodes = cat("nodes").copy()
    # Rebase child/parent pointers to the concatenated index space.
    off = np.repeat(base, sizes)
    old_nodes[:, PARENT] = np.where(old_nodes[:, PARENT] >= 0,
                                    old_nodes[:, PARENT] + off, -1)
    old_nodes[:, FIRST_CHILD] = np.where(old_nodes[:, FIRST_CHILD] >= 0,
                                         old_nodes[:, FIRST_CHILD] + off, -1)
    remapped = old_nodes.copy()
    remapped[:, PARENT] = np.where(
        old_nodes[:, PARENT] >= 0,
        pos[np.maximum(old_nodes[:, PARENT], 0)], -1)
    remapped[:, FIRST_CHILD] = np.where(
        old_nodes[:, FIRST_CHILD] >= 0,
        pos[np.maximum(old_nodes[:, FIRST_CHILD], 0)], -1)
    remapped[:, DEPTH] += 1
    nodes[pos] = remapped
    nodes[pos[roots_old], PARENT] = 0

    # Global root.
    r_xyz, r_shs, r_alpha, r_scaling, r_rot = _fold_merge(
        pruned, np.asarray([h.root for h in pruned]))
    xyz[0], shs[0], alpha[0] = r_xyz, r_shs, r_alpha
    scaling[0], rotation[0] = r_scaling, r_rot
    nodes[0] = (-1, 1, k, 0)
    boxes[0, 0] = boxes[1:, 0].min(axis=0)
    boxes[0, 1] = boxes[1:, 1].max(axis=0)

    anchors = np.concatenate(
        [pos[b + h.anchors] for b, h in zip(base, pruned)
         if h.anchors.size] or [np.zeros(0, np.int64)])
    return Hierarchy(xyz=xyz, shs=shs, alpha=alpha, scaling=scaling,
                     rotation=rotation, nodes=nodes, boxes=boxes,
                     anchors=np.sort(anchors).astype(np.int32))
