"""COLMAP sparse-model IO: cameras / images / points3D, binary and text.

The port's own copy of ``h3dgs_tpu/io/colmap.py`` (numpy only). The
points3D reader and writer are vectorised with numpy, byte-compatible with
the reference's record-by-record versions.

Role-equivalent of the reference's readers (scene/colmap_loader.py) and the
read-write helper used throughout preprocessing
(preprocess/read_write_model.py). Implemented from the public COLMAP
binary/text format: little-endian structs, camera model table below.

All arrays are numpy; quaternions are (w, x, y, z) and rotations follow
COLMAP's world-to-camera convention (R = quat, t translation).
"""
from __future__ import annotations

import dataclasses
import os
import struct
from typing import Dict

import numpy as np

# model_id -> (name, num_params)
CAMERA_MODELS = {
    0: ("SIMPLE_PINHOLE", 3),
    1: ("PINHOLE", 4),
    2: ("SIMPLE_RADIAL", 4),
    3: ("RADIAL", 5),
    4: ("OPENCV", 8),
    5: ("OPENCV_FISHEYE", 8),
    6: ("FULL_OPENCV", 12),
    7: ("FOV", 5),
    8: ("SIMPLE_RADIAL_FISHEYE", 4),
    9: ("RADIAL_FISHEYE", 5),
    10: ("THIN_PRISM_FISHEYE", 12),
}
CAMERA_MODEL_IDS = {name: mid for mid, (name, _) in CAMERA_MODELS.items()}


@dataclasses.dataclass
class ColmapCamera:
    id: int
    model: str
    width: int
    height: int
    params: np.ndarray  # model-specific


@dataclasses.dataclass
class ColmapImage:
    id: int
    qvec: np.ndarray       # [4] (w, x, y, z)
    tvec: np.ndarray       # [3]
    camera_id: int
    name: str
    xys: np.ndarray        # [P, 2] keypoints
    point3d_ids: np.ndarray  # [P] int64 (-1 = no 3D point)

    def rotmat(self) -> np.ndarray:
        return qvec2rotmat(self.qvec)


@dataclasses.dataclass
class ColmapPoints3D:
    """Struct-of-arrays for all 3D points (scales to tens of millions)."""
    ids: np.ndarray        # [N] int64
    xyz: np.ndarray        # [N, 3] f64
    rgb: np.ndarray        # [N, 3] u8
    error: np.ndarray      # [N] f64
    track_offsets: np.ndarray   # [N+1] into track_elems
    track_image_ids: np.ndarray   # [T] int32
    track_point2d_idxs: np.ndarray  # [T] int32


def qvec2rotmat(q: np.ndarray) -> np.ndarray:
    w, x, y, z = q
    return np.array([
        [1 - 2 * (y * y + z * z), 2 * (x * y - w * z), 2 * (x * z + w * y)],
        [2 * (x * y + w * z), 1 - 2 * (x * x + z * z), 2 * (y * z - w * x)],
        [2 * (x * z - w * y), 2 * (y * z + w * x), 1 - 2 * (x * x + y * y)],
    ])


def rotmat2qvec(R: np.ndarray) -> np.ndarray:
    from ..hierarchy.tree import rotmat_to_quat_np
    return rotmat_to_quat_np(R[None]).astype(np.float64)[0]


# ---------------------------------------------------------------- binary ---

def _read(f, fmt):
    return struct.unpack("<" + fmt, f.read(struct.calcsize("<" + fmt)))


def _read_string(f) -> str:
    out = b""
    while True:
        c = f.read(1)
        if c == b"\x00" or c == b"":
            return out.decode("utf-8")
        out += c


def read_cameras_binary(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            cid, model_id, w, h = _read(f, "iiQQ")
            name, np_ = CAMERA_MODELS[model_id]
            params = np.asarray(_read(f, "d" * np_))
            cams[cid] = ColmapCamera(cid, name, int(w), int(h), params)
    return cams


def write_cameras_binary(path: str, cams: Dict[int, ColmapCamera]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(cams)))
        for c in cams.values():
            mid = CAMERA_MODEL_IDS[c.model]
            f.write(struct.pack("<iiQQ", c.id, mid, c.width, c.height))
            f.write(struct.pack("<" + "d" * len(c.params), *c.params))


def read_images_binary(path: str) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path, "rb") as f:
        (n,) = _read(f, "Q")
        for _ in range(n):
            iid = _read(f, "i")[0]
            qvec = np.asarray(_read(f, "dddd"))
            tvec = np.asarray(_read(f, "ddd"))
            (cam_id,) = _read(f, "i")
            name = _read_string(f)
            (npts,) = _read(f, "Q")
            data = np.fromfile(f, dtype=np.dtype("<f8, <f8, <i8"),
                               count=npts)
            xys = np.stack([data["f0"], data["f1"]], axis=-1) \
                if npts else np.zeros((0, 2))
            pids = data["f2"] if npts else np.zeros(0, np.int64)
            imgs[iid] = ColmapImage(iid, qvec, tvec, cam_id, name, xys, pids)
    return imgs


def write_images_binary(path: str, imgs: Dict[int, ColmapImage]) -> None:
    with open(path, "wb") as f:
        f.write(struct.pack("<Q", len(imgs)))
        for im in imgs.values():
            f.write(struct.pack("<i", im.id))
            f.write(struct.pack("<dddd", *im.qvec))
            f.write(struct.pack("<ddd", *im.tvec))
            f.write(struct.pack("<i", im.camera_id))
            f.write(im.name.encode("utf-8") + b"\x00")
            npts = im.xys.shape[0]
            f.write(struct.pack("<Q", npts))
            rec = np.empty(npts, dtype=np.dtype("<f8, <f8, <i8"))
            rec["f0"] = im.xys[:, 0]
            rec["f1"] = im.xys[:, 1]
            rec["f2"] = im.point3d_ids
            rec.tofile(f)


_P3D_HEAD = 51  # bytes before a point's track: QdddBBBdQ


def _gather(buf: np.ndarray, offs: np.ndarray, width: int, dtype: str):
    """The ``width``-byte field at each byte offset, viewed as ``dtype``."""
    idx = offs[:, None] + np.arange(width)
    return np.ascontiguousarray(buf[idx]).view(dtype).reshape(offs.shape[0],
                                                               -1)


def read_points3d_binary(path: str) -> ColmapPoints3D:
    """Records are parsed with numpy gathers over their byte offsets (a
    Python pass only walks the track lengths), so millions of points load
    in seconds."""
    with open(path, "rb") as f:
        raw = f.read()
    buf = np.frombuffer(raw, np.uint8)
    (n,) = struct.unpack_from("<Q", raw, 0)
    offs = np.empty(n, np.int64)
    tls = np.empty(n, np.int64)
    off = 8
    for i in range(n):
        offs[i] = off
        (tl,) = struct.unpack_from("<Q", raw, off + 43)
        tls[i] = tl
        off += _P3D_HEAD + 8 * tl
    ids = _gather(buf, offs, 8, "<u8")[:, 0].astype(np.int64)
    xyz = _gather(buf, offs + 8, 24, "<f8")
    rgb = buf[offs[:, None] + 32 + np.arange(3)].astype(np.uint8)
    err = _gather(buf, offs + 35, 8, "<f8")[:, 0]
    track_offs = np.zeros(n + 1, np.int64)
    np.cumsum(tls, out=track_offs[1:])
    total = int(track_offs[-1])
    # Byte offset of every track element, point by point.
    elem = (np.repeat(offs + _P3D_HEAD - 8 * track_offs[:-1], tls)
            + 8 * np.arange(total))
    t_img = _gather(buf, elem, 4, "<i4")[:, 0] if total else np.zeros(
        0, np.int32)
    t_p2d = _gather(buf, elem + 4, 4, "<i4")[:, 0] if total else np.zeros(
        0, np.int32)
    return ColmapPoints3D(
        ids=ids, xyz=xyz.reshape(n, 3), rgb=rgb.reshape(n, 3), error=err,
        track_offsets=track_offs, track_image_ids=t_img.astype(np.int32),
        track_point2d_idxs=t_p2d.astype(np.int32))


def write_points3d_binary(path: str, pts: ColmapPoints3D) -> None:
    """All records are packed into one byte array with numpy."""
    n = pts.ids.shape[0]
    offs_t = np.asarray(pts.track_offsets, np.int64)
    tls = offs_t[1:] - offs_t[:-1]
    rec_len = _P3D_HEAD + 8 * tls
    starts = 8 + np.concatenate([[0], np.cumsum(rec_len)[:-1]]).astype(
        np.int64) if n else np.zeros(0, np.int64)
    out = np.zeros(8 + int(rec_len.sum()), np.uint8)
    out[:8] = np.frombuffer(struct.pack("<Q", n), np.uint8)

    def put(offs, arr, dtype):
        b = np.ascontiguousarray(np.asarray(arr).astype(dtype)).view(
            np.uint8).reshape(offs.shape[0], -1)
        out[offs[:, None] + np.arange(b.shape[1])] = b

    if n:
        put(starts, pts.ids.reshape(n, 1), "<u8")
        put(starts + 8, pts.xyz.reshape(n, 3), "<f8")
        put(starts + 32, pts.rgb.reshape(n, 3), np.uint8)
        put(starts + 35, pts.error.reshape(n, 1), "<f8")
        put(starts + 43, tls.reshape(n, 1), "<u8")
        total = int(offs_t[-1] - offs_t[0])
        if total:
            elem = (np.repeat(starts + _P3D_HEAD - 8 * (offs_t[:-1]
                                                        - offs_t[0]), tls)
                    + 8 * np.arange(total))
            lo, hi = offs_t[0], offs_t[-1]
            put(elem, pts.track_image_ids[lo:hi].reshape(-1, 1), "<i4")
            put(elem + 4, pts.track_point2d_idxs[lo:hi].reshape(-1, 1),
                "<i4")
    with open(path, "wb") as f:
        f.write(out.tobytes())


# ------------------------------------------------------------------ text ---

def read_cameras_text(path: str) -> Dict[int, ColmapCamera]:
    cams = {}
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            cams[int(e[0])] = ColmapCamera(
                int(e[0]), e[1], int(e[2]), int(e[3]),
                np.asarray([float(x) for x in e[4:]]))
    return cams


def read_images_text(path: str) -> Dict[int, ColmapImage]:
    imgs = {}
    with open(path) as f:
        # Keep blank lines: an image with zero keypoints has an EMPTY
        # POINTS2D line, and dropping it would shift the meta/points
        # pairing for every subsequent image.
        lines = [ln.strip() for ln in f if not ln.startswith("#")]
    while lines and not lines[-1]:
        lines.pop()
    for meta, pts in zip(lines[0::2], lines[1::2]):
        e = meta.split()
        iid = int(e[0])
        p = pts.split()
        xys = np.asarray(p, dtype=np.float64).reshape(-1, 3)[:, :2] \
            if p else np.zeros((0, 2))
        pids = np.asarray(p[2::3], dtype=np.int64) if p \
            else np.zeros(0, np.int64)
        imgs[iid] = ColmapImage(
            iid, np.asarray(e[1:5], np.float64),
            np.asarray(e[5:8], np.float64), int(e[8]), e[9], xys, pids)
    return imgs


def read_points3d_text(path: str) -> ColmapPoints3D:
    ids, xyz, rgb, err = [], [], [], []
    offs = [0]
    t_img, t_p2d = [], []
    with open(path) as f:
        for line in f:
            line = line.strip()
            if not line or line.startswith("#"):
                continue
            e = line.split()
            ids.append(int(e[0]))
            xyz.append([float(x) for x in e[1:4]])
            rgb.append([int(x) for x in e[4:7]])
            err.append(float(e[7]))
            tr = np.asarray(e[8:], np.int64).reshape(-1, 2)
            t_img.append(tr[:, 0].astype(np.int32))
            t_p2d.append(tr[:, 1].astype(np.int32))
            offs.append(offs[-1] + tr.shape[0])
    n = len(ids)
    return ColmapPoints3D(
        ids=np.asarray(ids, np.int64),
        xyz=np.asarray(xyz, np.float64).reshape(n, 3),
        rgb=np.asarray(rgb, np.uint8).reshape(n, 3),
        error=np.asarray(err, np.float64),
        track_offsets=np.asarray(offs, np.int64),
        track_image_ids=(np.concatenate(t_img) if n
                         else np.zeros(0, np.int32)),
        track_point2d_idxs=(np.concatenate(t_p2d) if n
                            else np.zeros(0, np.int32)))


def write_model_text(path: str, cams, imgs, pts: ColmapPoints3D) -> None:
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "cameras.txt"), "w") as f:
        for c in cams.values():
            f.write(f"{c.id} {c.model} {c.width} {c.height} "
                    + " ".join(repr(float(p)) for p in c.params) + "\n")
    with open(os.path.join(path, "images.txt"), "w") as f:
        for im in imgs.values():
            f.write(f"{im.id} " + " ".join(repr(float(v)) for v in im.qvec)
                    + " " + " ".join(repr(float(v)) for v in im.tvec)
                    + f" {im.camera_id} {im.name}\n")
            f.write(" ".join(
                f"{float(x)!r} {float(y)!r} {p}" for (x, y), p
                in zip(im.xys, im.point3d_ids)) + "\n")
    with open(os.path.join(path, "points3D.txt"), "w") as f:
        for i in range(pts.ids.shape[0]):
            lo, hi = pts.track_offsets[i], pts.track_offsets[i + 1]
            tr = " ".join(f"{a} {b}" for a, b in zip(
                pts.track_image_ids[lo:hi], pts.track_point2d_idxs[lo:hi]))
            f.write(f"{pts.ids[i]} "
                    + " ".join(repr(float(v)) for v in pts.xyz[i]) + " "
                    + " ".join(str(v) for v in pts.rgb[i])
                    + f" {float(pts.error[i])!r} {tr}\n")


# ------------------------------------------------------------- dispatch ---

def read_model(sparse_dir: str):
    """(cameras, images, points3d) from a sparse model dir (bin or text).

    Matches the reference's fallback order (scene/dataset_readers.py: bin
    first, then text).
    """
    b = os.path.join(sparse_dir, "cameras.bin")
    if os.path.exists(b):
        cams = read_cameras_binary(b)
        imgs = read_images_binary(os.path.join(sparse_dir, "images.bin"))
        p3d_path = os.path.join(sparse_dir, "points3D.bin")
        pts = (read_points3d_binary(p3d_path)
               if os.path.exists(p3d_path) else None)
    else:
        cams = read_cameras_text(os.path.join(sparse_dir, "cameras.txt"))
        imgs = read_images_text(os.path.join(sparse_dir, "images.txt"))
        p3d_path = os.path.join(sparse_dir, "points3D.txt")
        pts = (read_points3d_text(p3d_path)
               if os.path.exists(p3d_path) else None)
    return cams, imgs, pts


def write_model_binary(sparse_dir: str, cams, imgs,
                       pts: ColmapPoints3D | None) -> None:
    os.makedirs(sparse_dir, exist_ok=True)
    write_cameras_binary(os.path.join(sparse_dir, "cameras.bin"), cams)
    write_images_binary(os.path.join(sparse_dir, "images.bin"), imgs)
    if pts is not None:
        write_points3d_binary(os.path.join(sparse_dir, "points3D.bin"), pts)
