"""Minimal PLY reader and writer for 3DGS point clouds (no external deps).

The port's own copy of ``h3dgs_tpu/io/ply.py``. Reads and writes
the attribute layout the reference ecosystem uses
(upstream scene/gaussian_model.py:441-453,491-508): per-vertex
float32 properties x,y,z, nx,ny,nz, f_dc_0..2, f_rest_0..3k, opacity,
scale_0..2, rot_0..3 in binary_little_endian. Coefficients are stored
channel-major (f_rest index = channel * n_rest + coeff), matching the
reference's transpose-then-flatten save.
"""
from __future__ import annotations

import os
from typing import Dict, Tuple

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


def write_gaussian_ply(path: str, xyz, features_dc, features_rest, opacity,
                       scaling, rotation):
    """Write a trained-Gaussians PLY in the reference's layout."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    xyz = np.asarray(xyz, np.float32)
    n = xyz.shape[0]
    f_dc = np.asarray(features_dc, np.float32).transpose(0, 2, 1).reshape(n, -1)
    f_rest = np.asarray(features_rest, np.float32).transpose(0, 2, 1).reshape(n, -1)
    opacity = np.asarray(opacity, np.float32).reshape(n, 1)
    scaling = np.asarray(scaling, np.float32)
    rotation = np.asarray(rotation, np.float32)

    names = (["x", "y", "z", "nx", "ny", "nz"]
             + [f"f_dc_{i}" for i in range(f_dc.shape[1])]
             + [f"f_rest_{i}" for i in range(f_rest.shape[1])]
             + ["opacity"]
             + [f"scale_{i}" for i in range(scaling.shape[1])]
             + [f"rot_{i}" for i in range(rotation.shape[1])])
    data = np.concatenate(
        [xyz, np.zeros_like(xyz), f_dc, f_rest, opacity, scaling, rotation],
        axis=1).astype(np.float32)

    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for nm in names:
            f.write(f"property float {nm}\n".encode())
        f.write(b"end_header\n")
        f.write(np.ascontiguousarray(data).tobytes())


def read_points3d_ply(path: str) -> Tuple[np.ndarray, np.ndarray]:
    """Read an input point cloud PLY -> (xyz [N,3] f32, rgb [N,3] f32 0..1)."""
    v = read_ply_vertices(path)
    xyz = np.stack([v["x"], v["y"], v["z"]], axis=1).astype(np.float32)
    if "red" in v:
        rgb = np.stack([v["red"], v["green"], v["blue"]], axis=1)
        rgb = rgb.astype(np.float32)
        if rgb.max() > 1.0:
            rgb /= 255.0
    else:
        rgb = np.full_like(xyz, 0.5)
    return xyz, rgb


def write_points3d_ply(path: str, xyz: np.ndarray, rgb: np.ndarray):
    """Write an input point cloud (xyz + uchar rgb + zero normals)."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    n = xyz.shape[0]
    rec = np.dtype([("x", "<f4"), ("y", "<f4"), ("z", "<f4"),
                    ("nx", "<f4"), ("ny", "<f4"), ("nz", "<f4"),
                    ("red", "u1"), ("green", "u1"), ("blue", "u1")])
    data = np.zeros(n, dtype=rec)
    data["x"], data["y"], data["z"] = xyz[:, 0], xyz[:, 1], xyz[:, 2]
    rgb8 = np.clip(np.asarray(rgb) * (255.0 if np.asarray(rgb).max() <= 1.0 else 1.0),
                   0, 255).astype(np.uint8)
    data["red"], data["green"], data["blue"] = rgb8[:, 0], rgb8[:, 1], rgb8[:, 2]
    with open(path, "wb") as f:
        f.write(b"ply\nformat binary_little_endian 1.0\n")
        f.write(f"element vertex {n}\n".encode())
        for nm, t in [("x", "float"), ("y", "float"), ("z", "float"),
                      ("nx", "float"), ("ny", "float"), ("nz", "float"),
                      ("red", "uchar"), ("green", "uchar"), ("blue", "uchar")]:
            f.write(f"property {t} {nm}\n".encode())
        f.write(b"end_header\n")
        f.write(data.tobytes())
