"""Hierarchy serialization: ``.hier`` (port's copy of
``h3dgs_tpu/hierarchy/io.py``; byte-compatible both ways).

Role-equivalent of the reference's ``gaussian_hierarchy._C.load_hierarchy``
/ ``write_hierarchy`` (upstream scene/gaussian_model.py:326-399,
419-427) and the anchors.bin consumed at :357-364. The native submodule is
absent from the reference snapshot, so the byte layout is our own (versioned
and self-describing); the *contents* match the load_hierarchy contract:
(xyz, shs[M,16,3], activated alpha, log scales, unit quats, nodes, boxes).

All arrays little-endian; header: magic ``H3HR``, u32 version, u32 M,
u32 A (anchor count), u32 sh_degree.
"""
from __future__ import annotations

import struct

import numpy as np

from .tree import NODE_COLS, Hierarchy

MAGIC = b"H3HR"
VERSION = 1


def write_hier(path: str, h: Hierarchy, sh_degree: int = 3) -> None:
    m = h.n_nodes
    with open(path, "wb") as f:
        f.write(MAGIC)
        f.write(struct.pack("<IIII", VERSION, m, h.anchors.size, sh_degree))
        for arr, dt in ((h.xyz, "<f4"), (h.shs, "<f4"), (h.alpha, "<f4"),
                        (h.scaling, "<f4"), (h.rotation, "<f4"),
                        (h.nodes, "<i4"), (h.boxes, "<f4"),
                        (h.anchors, "<i4")):
            np.ascontiguousarray(arr, dtype=dt).tofile(f)


def read_hier(path: str) -> Hierarchy:
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != MAGIC:
            raise ValueError(f"{path}: not a .hier file (magic {magic!r})")
        version, m, a, _sh_degree = struct.unpack("<IIII", f.read(16))
        if version != VERSION:
            raise ValueError(f"{path}: unsupported .hier version {version}")

        def rd(shape, dt):
            n = int(np.prod(shape))
            arr = np.fromfile(f, dtype=dt, count=n)
            if arr.size != n:
                raise ValueError(f"{path}: truncated .hier file")
            return arr.reshape(shape)

        return Hierarchy(
            xyz=rd((m, 3), "<f4"),
            shs=rd((m, 16, 3), "<f4"),
            alpha=rd((m,), "<f4"),
            scaling=rd((m, 3), "<f4"),
            rotation=rd((m, 4), "<f4"),
            nodes=rd((m, NODE_COLS), "<i4"),
            boxes=rd((m, 2, 3), "<f4"),
            anchors=rd((a,), "<i4"),
        )
