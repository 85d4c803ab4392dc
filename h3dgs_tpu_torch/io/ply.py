"""Minimal PLY reader for 3DGS point clouds (no external deps).

The port's own copy of the reading half of ``h3dgs_tpu/io/ply.py``. Reads
the attribute layout the reference ecosystem uses
(upstream scene/gaussian_model.py:441-453,491-508): per-vertex
float32 properties x,y,z, nx,ny,nz, f_dc_0..2, f_rest_0..3k, opacity,
scale_0..2, rot_0..3 in binary_little_endian. Coefficients are stored
channel-major (f_rest index = channel * n_rest + coeff), matching the
reference's transpose-then-flatten save.
"""
from __future__ import annotations

from typing import Dict

import numpy as np

_PLY_DTYPES = {
    "float": np.float32, "float32": np.float32,
    "double": np.float64, "float64": np.float64,
    "uchar": np.uint8, "uint8": np.uint8,
    "char": np.int8, "int8": np.int8,
    "short": np.int16, "ushort": np.uint16,
    "int": np.int32, "int32": np.int32,
    "uint": np.uint32, "uint32": np.uint32,
}


def read_ply_vertices(path: str) -> Dict[str, np.ndarray]:
    """Parse the 'vertex' element of a PLY file into {property: array}."""
    with open(path, "rb") as f:
        header = []
        while True:
            line = f.readline().decode("ascii").strip()
            header.append(line)
            if line == "end_header":
                break
        fmt = next(l for l in header if l.startswith("format")).split()[1]

        elements = []  # (name, count, [(prop_name, dtype)])
        cur = None
        for line in header:
            parts = line.split()
            if not parts:
                continue
            if parts[0] == "element":
                cur = (parts[1], int(parts[2]), [])
                elements.append(cur)
            elif parts[0] == "property" and cur is not None:
                if parts[1] == "list":
                    raise ValueError("list properties unsupported")
                cur[2].append((parts[2], _PLY_DTYPES[parts[1]]))

        out = {}
        for name, count, props in elements:
            rec = np.dtype([(p, d) for p, d in props])
            if fmt == "binary_little_endian":
                data = np.frombuffer(f.read(rec.itemsize * count), dtype=rec)
            elif fmt == "ascii":
                data = np.loadtxt(f, dtype=rec, max_rows=count)
            elif fmt == "binary_big_endian":
                data = np.frombuffer(f.read(rec.itemsize * count),
                                     dtype=rec.newbyteorder(">"))
            else:
                raise ValueError(f"unknown ply format {fmt}")
            if name == "vertex":
                out = {p: np.ascontiguousarray(data[p]) for p, _ in props}
        return out


def read_gaussian_ply(path: str, sh_degree: int):
    """Load a trained-Gaussians PLY.

    Returns dict with xyz [N,3], features_dc [N,1,3], features_rest
    [N,K-1,3], opacity [N,1] (pre-activation), scaling [N,3] (log),
    rotation [N,4].
    """
    v = read_ply_vertices(path)
    n = v["x"].shape[0]
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    opacity = v["opacity"].astype(np.float32)[:, None]
    f_dc = np.stack([v["f_dc_0"], v["f_dc_1"], v["f_dc_2"]],
                    axis=1).astype(np.float32)[:, None, :]  # [N,1,3]

    n_rest = (sh_degree + 1) ** 2 - 1
    rest_names = sorted((k for k in v if k.startswith("f_rest_")),
                        key=lambda s: int(s.split("_")[-1]))
    if len(rest_names) != 3 * n_rest:
        raise ValueError(
            f"expected {3*n_rest} f_rest properties, found {len(rest_names)}")
    if n_rest:
        rest = np.stack([v[k] for k in rest_names], axis=1).astype(np.float32)
        # stored channel-major: [N, 3, n_rest] -> [N, n_rest, 3]
        rest = rest.reshape(n, 3, n_rest).transpose(0, 2, 1)
    else:
        rest = np.zeros((n, 0, 3), np.float32)

    scaling = np.stack([v["scale_0"], v["scale_1"], v["scale_2"]],
                       axis=1).astype(np.float32)
    rotation = np.stack([v["rot_0"], v["rot_1"], v["rot_2"], v["rot_3"]],
                        axis=1).astype(np.float32)
    return dict(xyz=xyz, features_dc=f_dc, features_rest=rest,
                opacity=opacity, scaling=scaling, rotation=rotation)
