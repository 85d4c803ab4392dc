"""Gaussian hierarchy: construction (host-side, vectorized numpy).

The port's own copy of ``h3dgs_tpu/hierarchy/tree.py`` (numpy path only;
outputs are bit-equal to it). Equivalent of the reference's native ``GaussianHierarchyCreator``
(upstream scripts/full_train.py:138,186-200 pins the CLI contract;
the submodule source is absent from the snapshot, so the build algorithm is
re-derived from the paper: a spatial tree whose interior nodes are single
Gaussians obtained by opacity-and-area-weighted moment matching of their
children).

Design differences from the CUDA/C++ reference, chosen for the TPU renderer:

  * **Morton-ordered implicit balanced binary tree.** Leaves are the input
    Gaussians sorted by Morton code; interior node i covers a contiguous
    leaf range split at its midpoint. The whole structure is generated
    level-by-level with vectorized numpy — no per-node recursion — and the
    bottom-up moment-matching merge is likewise one vectorized pass per
    level (O(log N) batched ops).
  * **Nested AABBs.** Every interior box is the union of its children's
    boxes (plus its own 3-sigma box). Nesting makes the projected
    granularity monotone non-increasing from root to leaf for *any* camera
    position, which turns view-adaptive cut selection into a single
    per-node predicate — fully parallel on TPU (see hierarchy/cut.py) —
    instead of the reference's sequential tree walk
    (``expand_to_size``, upstream train_post.py:91-99).

Node array layout (int32 [M, 4]): columns PARENT (-1 for root),
FIRST_CHILD (-1 for leaf; children are contiguous), N_CHILDREN, DEPTH.
Node index == row index into the Gaussian attribute arrays (1:1).
Boxes are float32 [M, 2, 3] (min, max corners).
"""
from __future__ import annotations

import dataclasses

import numpy as np

PARENT, FIRST_CHILD, N_CHILDREN, DEPTH = 0, 1, 2, 3
NODE_COLS = 4


@dataclasses.dataclass
class Hierarchy:
    """Host-side hierarchy: per-node Gaussians + tree structure.

    Attribute arrays have M = 2N-1 rows (leaves + interior). ``alpha`` is
    the *activated* opacity (the post trainer uses |x| activation, matching
    the reference create_from_hier, scene/gaussian_model.py:393-394).
    """
    xyz: np.ndarray        # [M, 3] f32
    shs: np.ndarray        # [M, 16, 3] f32 (dc + 15 rest)
    alpha: np.ndarray      # [M] f32 activated opacity
    scaling: np.ndarray    # [M, 3] f32 log-scale
    rotation: np.ndarray   # [M, 4] f32 unit quaternion (w, x, y, z)
    nodes: np.ndarray      # [M, 4] i32
    boxes: np.ndarray      # [M, 2, 3] f32
    anchors: np.ndarray    # [A] i32 node indices locked during post-opt

    @property
    def n_nodes(self) -> int:
        return self.nodes.shape[0]

    @property
    def n_leaves(self) -> int:
        return int(np.sum(self.nodes[:, N_CHILDREN] == 0))

    @property
    def root(self) -> int:
        (r,) = np.nonzero(self.nodes[:, PARENT] < 0)[0][:1]
        return int(r)

    def validate(self):
        """Structural invariants (cheap; used by tests and tools)."""
        nodes, boxes = self.nodes, self.boxes
        m = self.n_nodes
        assert self.xyz.shape == (m, 3)
        assert np.sum(nodes[:, PARENT] < 0) == 1, "exactly one root"
        interior = nodes[:, N_CHILDREN] > 0
        fc = nodes[interior, FIRST_CHILD]
        nc = nodes[interior, N_CHILDREN]
        assert np.all(fc >= 0) and np.all(fc + nc <= m)
        # children point back at their parent
        par_of_child = nodes[fc, PARENT]
        assert np.all(par_of_child == np.nonzero(interior)[0])
        # nested boxes
        p = nodes[:, PARENT]
        has_p = p >= 0
        assert np.all(boxes[p[has_p], 0] <= boxes[has_p, 0] + 1e-5)
        assert np.all(boxes[p[has_p], 1] >= boxes[has_p, 1] - 1e-5)


def _expand_bits(v: np.ndarray) -> np.ndarray:
    v = v.astype(np.uint64) & np.uint64(0x1FFFFF)
    v = (v | (v << np.uint64(32))) & np.uint64(0x1F00000000FFFF)
    v = (v | (v << np.uint64(16))) & np.uint64(0x1F0000FF0000FF)
    v = (v | (v << np.uint64(8))) & np.uint64(0x100F00F00F00F00F)
    v = (v | (v << np.uint64(4))) & np.uint64(0x10C30C30C30C30C3)
    v = (v | (v << np.uint64(2))) & np.uint64(0x1249249249249249)
    return v


def morton_order(xyz: np.ndarray) -> np.ndarray:
    """Argsort of 63-bit Morton codes over the point AABB."""
    mn = xyz.min(axis=0)
    mx = xyz.max(axis=0)
    q = ((xyz - mn) / np.maximum(mx - mn, 1e-12) * ((1 << 21) - 1))
    q = np.clip(q, 0, (1 << 21) - 1).astype(np.uint64)
    code = (_expand_bits(q[:, 0])
            | (_expand_bits(q[:, 1]) << np.uint64(1))
            | (_expand_bits(q[:, 2]) << np.uint64(2)))
    return np.argsort(code, kind="stable")


def quat_to_rotmat_np(q: np.ndarray) -> np.ndarray:
    """[N,4] (w,x,y,z) unit quats -> [N,3,3] (same convention as
    utils/transforms.quat_to_rotmat)."""
    q = q / np.linalg.norm(q, axis=-1, keepdims=True).clip(1e-12)
    w, x, y, z = q[:, 0], q[:, 1], q[:, 2], q[:, 3]
    return np.stack([
        1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y),
        2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x),
        2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y),
    ], axis=-1).reshape(-1, 3, 3)


def rotmat_to_quat_np(R: np.ndarray) -> np.ndarray:
    """[N,3,3] rotation matrices -> [N,4] (w,x,y,z), vectorized Shepperd."""
    m00, m01, m02 = R[:, 0, 0], R[:, 0, 1], R[:, 0, 2]
    m10, m11, m12 = R[:, 1, 0], R[:, 1, 1], R[:, 1, 2]
    m20, m21, m22 = R[:, 2, 0], R[:, 2, 1], R[:, 2, 2]
    tr = m00 + m11 + m22
    # Four candidate formulations; pick the numerically safest per row.
    qw = np.sqrt(np.maximum(0, 1 + tr)) / 2
    qx = np.sqrt(np.maximum(0, 1 + m00 - m11 - m22)) / 2
    qy = np.sqrt(np.maximum(0, 1 - m00 + m11 - m22)) / 2
    qz = np.sqrt(np.maximum(0, 1 - m00 - m11 + m22)) / 2
    qx = np.copysign(qx, m21 - m12)
    qy = np.copysign(qy, m02 - m20)
    qz = np.copysign(qz, m10 - m01)
    q = np.stack([qw, qx, qy, qz], axis=-1)
    # Rows where w is tiny: rebuild from the dominant diagonal entry.
    bad = qw < 1e-4
    if np.any(bad):
        for i in np.nonzero(bad)[0]:
            Ri = R[i]
            k = np.argmax([Ri[0, 0], Ri[1, 1], Ri[2, 2]])
            a, b, c = k, (k + 1) % 3, (k + 2) % 3
            s = np.sqrt(max(1e-12, 1 + Ri[a, a] - Ri[b, b] - Ri[c, c])) * 2
            v = np.zeros(4)
            v[1 + a] = s / 4
            v[1 + b] = (Ri[b, a] + Ri[a, b]) / s
            v[1 + c] = (Ri[c, a] + Ri[a, c]) / s
            v[0] = (Ri[c, b] - Ri[b, c]) / s
            q[i] = v
    return (q / np.linalg.norm(q, axis=-1, keepdims=True).clip(1e-12)).astype(
        np.float32)


def covariance_np(scaling_log: np.ndarray, rotation: np.ndarray) -> np.ndarray:
    """[N,3,3] world covariance R diag(s^2) R^T."""
    s2 = np.exp(2.0 * scaling_log)
    R = quat_to_rotmat_np(rotation)
    return np.einsum("nij,nj,nkj->nik", R, s2, R)


def merge_gaussian_pairs(xyz, shs, alpha, scaling, rotation,
                         left: np.ndarray, right: np.ndarray):
    """Moment-match pairs of Gaussians into parents (vectorized).

    Weights are alpha * sqrt(det Sigma) (the integral of each child's
    opacity over space); parent mean/covariance/SH match the first and
    second moments of the weighted mixture; parent alpha preserves the
    total opacity mass and is clamped to 1 (re-derived from the paper —
    creator source absent from the snapshot, see module docstring).

    Returns dict of parent attrs for each (left[i], right[i]) pair.
    """
    w = alpha * np.exp(np.sum(scaling, axis=1))        # alpha * prod(s)
    w1, w2 = w[left], w[right]
    wsum = np.maximum(w1 + w2, 1e-20)
    f1 = (w1 / wsum)[:, None]
    f2 = (w2 / wsum)[:, None]

    mu = f1 * xyz[left] + f2 * xyz[right]
    sh = f1[:, :, None] * shs[left] + f2[:, :, None] * shs[right]

    cov = covariance_np(scaling, rotation)
    d1 = xyz[left] - mu
    d2 = xyz[right] - mu
    cov_p = (f1[:, :, None] * (cov[left] + d1[:, :, None] * d1[:, None, :])
             + f2[:, :, None] * (cov[right] + d2[:, :, None] * d2[:, None, :]))

    evals, evecs = np.linalg.eigh(cov_p.astype(np.float64))
    scales_p = np.sqrt(np.clip(evals, 1e-14, None))
    # eigh may return a reflection; flip one axis to get det=+1.
    det = np.linalg.det(evecs)
    evecs[det < 0, :, 2] *= -1.0
    quat_p = rotmat_to_quat_np(evecs)
    alpha_p = np.minimum(1.0, wsum / np.maximum(np.prod(scales_p, axis=1),
                                                1e-20))
    return {
        "xyz": mu.astype(np.float32),
        "shs": sh.astype(np.float32),
        "alpha": alpha_p.astype(np.float32),
        "scaling": np.log(scales_p).astype(np.float32),
        "rotation": quat_p,
    }


def _three_sigma_box(xyz, scaling_log, rotation):
    """Axis-aligned 3-sigma bounds of each Gaussian: [N,2,3]."""
    cov = covariance_np(scaling_log, rotation)
    half = 3.0 * np.sqrt(np.maximum(np.einsum("nii->ni", cov), 1e-14))
    return np.stack([xyz - half, xyz + half], axis=1).astype(np.float32)


BACKENDS = ("auto", "numpy", "native")


def resolve_backend(backend: str) -> str:
    """``auto`` -> ``native`` when a C++ compiler is found, else
    ``numpy``; the others name themselves."""
    if backend not in BACKENDS:
        raise ValueError(f"unknown hierarchy backend {backend!r}; "
                         f"choose from {BACKENDS}")
    if backend == "auto":
        from ..native import native_available
        return "native" if native_available() else "numpy"
    return backend


def build_hierarchy(xyz, shs, alpha, scaling, rotation,
                    locked_leaf_mask: np.ndarray | None = None,
                    backend: str = "auto") -> Hierarchy:
    """Build the full hierarchy over N flat Gaussians.

    ``locked_leaf_mask`` [N] marks leaves (scaffold / out-of-chunk rows)
    whose enclosing nodes become anchors — fixed during post-optimization
    (reference anchors.bin contract, upstream train_post.py:176-181).

    ``backend``: "native" runs the C++ builder (``native.py``, the same
    algorithm, built from source at first use; a failed build raises),
    "numpy" this vectorized implementation, "auto" the C++ builder when a
    C++ compiler is found. The two give the same structure, leaf set and
    anchors, but not always the same bytes: the C++ builder quantises the
    Morton codes in double, this one in float32, so a few rows of a large
    chunk can differ.
    """
    if resolve_backend(backend) == "native":
        from ..native import build_hierarchy_native
        return build_hierarchy_native(xyz, shs, alpha, scaling, rotation,
                                      locked_leaf_mask)
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    if n == 0:
        raise ValueError("cannot build a hierarchy over 0 Gaussians")
    shs = np.asarray(shs, np.float32).reshape(n, -1, 3)
    if shs.shape[1] < 16:
        shs = np.concatenate(
            [shs, np.zeros((n, 16 - shs.shape[1], 3), np.float32)], axis=1)
    alpha = np.asarray(alpha, np.float32).reshape(n)
    scaling = np.asarray(scaling, np.float32)
    rotation = np.asarray(rotation, np.float32)
    rotation = rotation / np.linalg.norm(rotation, axis=1,
                                         keepdims=True).clip(1e-12)
    order = morton_order(xyz)

    # --- level-by-level structure over sorted-leaf ranges ---
    levels = []  # (lo, hi) arrays per level; nodes laid out level-major
    lo = np.zeros(1, np.int64)
    hi = np.full(1, n, np.int64)
    while lo.size:
        levels.append((lo, hi))
        interior = (hi - lo) > 1
        mid = (lo + hi) >> 1
        lo, hi = (np.stack([lo[interior], mid[interior]], 1).reshape(-1),
                  np.stack([mid[interior], hi[interior]], 1).reshape(-1))

    counts = [l.size for l, _ in levels]
    offsets = np.concatenate([[0], np.cumsum(counts)])
    m = int(offsets[-1])
    assert m == 2 * n - 1

    nodes = np.full((m, NODE_COLS), -1, np.int32)
    leaf_src = np.full(m, -1, np.int64)   # original Gaussian per leaf node
    for d, (llo, lhi) in enumerate(levels):
        idx = offsets[d] + np.arange(llo.size)
        nodes[idx, DEPTH] = d
        interior = (lhi - llo) > 1
        n_int = int(interior.sum())
        nodes[idx, N_CHILDREN] = np.where(interior, 2, 0)
        if n_int:
            rank = np.cumsum(interior) - 1
            fc = offsets[d + 1] + 2 * rank
            nodes[idx[interior], FIRST_CHILD] = fc[interior]
            child_idx = (fc[interior][:, None]
                         + np.arange(2)[None, :]).reshape(-1)
            nodes[child_idx, PARENT] = np.repeat(idx[interior], 2)
        is_leaf = ~interior
        leaf_src[idx[is_leaf]] = order[llo[is_leaf]]

    # --- per-node attributes: leaves copied, interiors merged bottom-up ---
    a_xyz = np.zeros((m, 3), np.float32)
    a_shs = np.zeros((m, 16, 3), np.float32)
    a_alpha = np.zeros(m, np.float32)
    a_scaling = np.full((m, 3), -15.0, np.float32)
    a_rot = np.zeros((m, 4), np.float32)
    a_rot[:, 0] = 1.0
    boxes = np.zeros((m, 2, 3), np.float32)
    anchor_flag = np.zeros(m, bool)

    leaves = leaf_src >= 0
    src = leaf_src[leaves]
    a_xyz[leaves] = xyz[src]
    a_shs[leaves] = shs[src]
    a_alpha[leaves] = alpha[src]
    a_scaling[leaves] = scaling[src]
    a_rot[leaves] = rotation[src]
    boxes[leaves] = _three_sigma_box(xyz[src], scaling[src], rotation[src])
    if locked_leaf_mask is not None:
        anchor_flag[leaves] = np.asarray(locked_leaf_mask, bool)[src]

    for d in range(len(levels) - 2, -1, -1):
        idx = offsets[d] + np.arange(counts[d])
        interior = nodes[idx, N_CHILDREN] > 0
        pi = idx[interior]
        if pi.size == 0:
            continue
        lc = nodes[pi, FIRST_CHILD].astype(np.int64)
        rc = lc + 1
        merged = merge_gaussian_pairs(a_xyz, a_shs, a_alpha, a_scaling,
                                      a_rot, lc, rc)
        a_xyz[pi] = merged["xyz"]
        a_shs[pi] = merged["shs"]
        a_alpha[pi] = merged["alpha"]
        a_scaling[pi] = merged["scaling"]
        a_rot[pi] = merged["rotation"]
        own = _three_sigma_box(merged["xyz"], merged["scaling"],
                               merged["rotation"])
        boxes[pi, 0] = np.minimum(np.minimum(boxes[lc, 0], boxes[rc, 0]),
                                  own[:, 0])
        boxes[pi, 1] = np.maximum(np.maximum(boxes[lc, 1], boxes[rc, 1]),
                                  own[:, 1])
        anchor_flag[pi] = anchor_flag[lc] | anchor_flag[rc]

    return Hierarchy(
        xyz=a_xyz, shs=a_shs, alpha=a_alpha, scaling=a_scaling,
        rotation=a_rot, nodes=nodes, boxes=boxes,
        anchors=np.nonzero(anchor_flag)[0].astype(np.int32),
    )
