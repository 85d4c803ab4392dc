"""Writers of the dataset files a chunk is trained from: 16-bit gray PNG
(the depth maps; the views are JPEG, ``jpeg.py``), COLMAP's binary
model, the 3DGS point-cloud PLY, and the small text files beside them.
Written here from the format specifications, so the inputs do not
depend on the program's writers."""
from __future__ import annotations

import concurrent.futures as cf
import json
import os
import struct
import zlib

import numpy as np


def _chunk(tag: bytes, data: bytes) -> bytes:
    return (struct.pack(">I", len(data)) + tag + data
            + struct.pack(">I", zlib.crc32(tag + data) & 0xFFFFFFFF))


def png_bytes(arr: np.ndarray) -> bytes:
    """PNG of an [H,W] uint16 array (gray, filter None)."""
    if arr.dtype != np.uint16 or arr.ndim != 2:
        raise ValueError(f"unsupported PNG array {arr.dtype} {arr.shape}")
    h, w = arr.shape
    rows = arr.astype(">u2").view(np.uint8)
    body = np.concatenate([np.zeros((h, 1), np.uint8), rows], axis=1)
    ihdr = struct.pack(">IIBBBBB", w, h, 16, 0, 0, 0, 0)
    return (b"\x89PNG\r\n\x1a\n" + _chunk(b"IHDR", ihdr)
            + _chunk(b"IDAT", zlib.compress(body.tobytes(), 1))
            + _chunk(b"IEND", b""))


def write_pngs(items, workers: int = 8) -> None:
    """Write (path, array) pairs in ``workers`` threads (zlib releases
    the interpreter lock)."""
    def one(item):
        path, arr = item
        with open(path, "wb") as f:
            f.write(png_bytes(arr))

    with cf.ThreadPoolExecutor(workers) as pool:
        for fut in [pool.submit(one, it) for it in items]:
            fut.result()


def rotmat_to_qvec(r: np.ndarray) -> np.ndarray:
    """COLMAP's (w, x, y, z) of a world->camera rotation."""
    rxx, ryx, rzx, rxy, ryy, rzy, rxz, ryz, rzz = r.flat
    k = np.array([[rxx - ryy - rzz, 0, 0, 0],
                  [ryx + rxy, ryy - rxx - rzz, 0, 0],
                  [rzx + rxz, rzy + ryz, rzz - rxx - ryy, 0],
                  [ryz - rzy, rzx - rxz, rxy - ryx, rxx + ryy + rzz]]) / 3.0
    vals, vecs = np.linalg.eigh(k)
    q = vecs[[3, 0, 1, 2], np.argmax(vals)]
    return -q if q[0] < 0 else q


def write_colmap(sparse: str, cams: list, points_xyz: np.ndarray,
                 points_rgb: np.ndarray) -> None:
    """cameras.bin (one PINHOLE camera per view), images.bin and
    points3D.bin (no tracks). ``cams``: dicts with rows, t, width,
    height, fx, fy, name."""
    os.makedirs(sparse, exist_ok=True)
    with open(os.path.join(sparse, "cameras.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for i, c in enumerate(cams):
            f.write(struct.pack("<iiQQ", i + 1, 1, c["width"], c["height"]))
            f.write(struct.pack("<4d", c["fx"], c["fy"], c["width"] / 2.0,
                                c["height"] / 2.0))
    with open(os.path.join(sparse, "images.bin"), "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for i, c in enumerate(cams):
            f.write(struct.pack("<i", i + 1))
            f.write(struct.pack("<4d", *rotmat_to_qvec(np.asarray(c["rows"]))))
            f.write(struct.pack("<3d", *c["t"]))
            f.write(struct.pack("<i", i + 1))
            f.write(c["name"].encode() + b"\x00")
            f.write(struct.pack("<Q", 0))
    n = points_xyz.shape[0]
    rec = np.zeros(n, dtype=np.dtype([("id", "<u8"), ("xyz", "<f8", 3),
                                      ("rgb", "u1", 3), ("err", "<f8"),
                                      ("tl", "<u8")]))
    rec["id"] = np.arange(1, n + 1)
    rec["xyz"] = points_xyz
    rec["rgb"] = points_rgb
    with open(os.path.join(sparse, "points3D.bin"), "wb") as f:
        f.write(struct.pack("<Q", n))
        f.write(rec.tobytes())


def write_gaussian_ply(path: str, xyz, f_dc, f_rest, opacity, scaling,
                       rotation) -> None:
    """Binary little-endian PLY of Gaussians (x y z nx ny nz f_dc_* f_rest_*
    opacity scale_* rot_*), coefficients channel-major."""
    n = xyz.shape[0]
    rest = np.ascontiguousarray(np.transpose(f_rest, (0, 2, 1))).reshape(n, -1)
    dc = np.asarray(f_dc).reshape(n, 3)
    cols = ([("x", xyz[:, 0]), ("y", xyz[:, 1]), ("z", xyz[:, 2])]
            + [(f"n{a}", np.zeros(n)) for a in "xyz"]
            + [(f"f_dc_{i}", dc[:, i]) for i in range(3)]
            + [(f"f_rest_{i}", rest[:, i]) for i in range(rest.shape[1])]
            + [("opacity", np.asarray(opacity).reshape(n))]
            + [(f"scale_{i}", scaling[:, i]) for i in range(3)]
            + [(f"rot_{i}", rotation[:, i]) for i in range(4)])
    rec = np.zeros(n, dtype=[(k, "<f4") for k, _ in cols])
    for k, v in cols:
        rec[k] = v
    os.makedirs(os.path.dirname(path), exist_ok=True)
    header = ("ply\nformat binary_little_endian 1.0\n"
              f"element vertex {n}\n"
              + "".join(f"property float {k}\n" for k, _ in cols)
              + "end_header\n")
    with open(path, "wb") as f:
        f.write(header.encode("ascii"))
        f.write(rec.tobytes())


def write_text(path: str, text: str) -> None:
    os.makedirs(os.path.dirname(path), exist_ok=True)
    with open(path, "w") as f:
        f.write(text)


def write_json(path: str, obj) -> None:
    write_text(path, json.dumps(obj))
