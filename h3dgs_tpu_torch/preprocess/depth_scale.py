"""Mono-depth calibration: per-image scale/offset for inverse depth maps.

The port's own copy of ``h3dgs_tpu/preprocess/depth_scale.py``.
Equivalent of the reference's preprocess/make_depth_scale.py (+ the
per-chunk driver make_chunks_depth_scale.py): project each image's SfM
points, sample the monocular inverse-depth map at the keypoints, and match
medians + mean absolute deviations between inverse COLMAP depth and
inverse mono depth. Writes sparse/0/depth_params.json.

The map is decoded by the port's PNG codec with ``cv2.imread``'s
``IMREAD_UNCHANGED`` channels (a multi-channel map gives its blue
channel, OpenCV's channel 0) and sampled on the device
(``imgproc.sample_bilinear_replicate``, ``cv2.remap``'s contract); the
projection and the median / MAD arithmetic stay the JAX package's numpy.
"""
from __future__ import annotations

import concurrent.futures as cf
import json
import os

import numpy as np
import torch

from ..io import colmap as C
from ..utils.runtime import DeviceLike, resolve_device
from .imgproc import load_unchanged, sample_bilinear_replicate


def get_scale(image: C.ColmapImage, cam: C.ColmapCamera,
              points3d_ordered: np.ndarray, depths_dir: str,
              device: DeviceLike = None):
    """{image_name, scale, offset} for one view, or ``None`` when its map
    ``<depths_dir>/<stem>.png`` is missing. A map that cannot be decoded
    raises."""
    device = resolve_device(device)
    pid = image.point3d_ids
    mask = (pid >= 0) & (pid < len(points3d_ordered))
    pid = pid[mask]
    valid_xys = image.xys[mask]
    pts = points3d_ordered[pid] if len(pid) else np.zeros((1, 3))

    R = C.qvec2rotmat(image.qvec)
    pts_cam = pts @ R.T + image.tvec
    inv_colmap = 1.0 / np.maximum(pts_cam[..., 2], 1e-12)

    stem = os.path.splitext(image.name)[0]
    inv_mono_map = load_unchanged(os.path.join(depths_dir, stem + ".png"))
    if inv_mono_map is None:
        return None
    if inv_mono_map.ndim != 2:
        inv_mono_map = inv_mono_map[..., 0]
    s = inv_mono_map.shape[0] / cam.height

    maps = (valid_xys * s).astype(np.float32) if len(pid) \
        else np.zeros((0, 2), np.float32)
    ok = ((maps[..., 0] >= 0) & (maps[..., 1] >= 0)
          & (maps[..., 0] < cam.width * s)
          & (maps[..., 1] < cam.height * s)
          & (pts_cam[..., 2] > 0)) if len(pid) else np.zeros(0, bool)

    if ok.sum() > 10 and (inv_colmap.max() - inv_colmap.min()) > 1e-3:
        maps = torch.as_tensor(maps[ok], device=device)
        inv_colmap = inv_colmap[ok]
        mono = torch.from_numpy(inv_mono_map.astype(np.int32)).to(device)
        inv_mono = sample_bilinear_replicate(
            mono.to(torch.float32) / (2 ** 16), maps[:, 0],
            maps[:, 1]).cpu().numpy()
        t_c = np.median(inv_colmap)
        s_c = np.mean(np.abs(inv_colmap - t_c))
        t_m = np.median(inv_mono)
        s_m = np.mean(np.abs(inv_mono - t_m))
        scale = float(s_c / s_m) if s_m > 0 else 0.0
        offset = float(t_c - t_m * scale)
    else:
        scale, offset = 0.0, 0.0
    return {"image_name": stem, "scale": scale, "offset": offset}


def make_depth_scale(base_dir: str, depths_dir: str,
                     device: DeviceLike = None) -> dict:
    device = resolve_device(device)
    cams, images, pts = C.read_model(os.path.join(base_dir, "sparse", "0"))
    ordered = np.zeros((int(pts.ids.max()) + 1, 3))
    ordered[pts.ids] = pts.xyz

    with cf.ThreadPoolExecutor() as pool:
        results = list(pool.map(
            lambda im: get_scale(im, cams[im.camera_id], ordered,
                                 depths_dir, device), images.values()))
    params = {r["image_name"]: {"scale": r["scale"], "offset": r["offset"]}
              for r in results if r is not None}
    with open(os.path.join(base_dir, "sparse/0/depth_params.json"),
              "w") as f:
        json.dump(params, f, indent=2)
    return params


def make_chunks_depth_scale(chunks_dir: str, depths_dir: str,
                            device: DeviceLike = None) -> None:
    """Run calibration for every chunk (make_chunks_depth_scale.py)."""
    device = resolve_device(device)
    for name in sorted(os.listdir(chunks_dir)):
        base = os.path.join(chunks_dir, name)
        if os.path.isdir(os.path.join(base, "sparse", "0")):
            print(f"depth scale for chunk {name}")
            make_depth_scale(base, depths_dir, device)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base_dir", required=True)
    p.add_argument("--depths_dir", required=True)
    p.add_argument("--all_chunks", action="store_true",
                   help="treat base_dir as a chunks dir and process each")
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)
    if a.all_chunks:
        make_chunks_depth_scale(a.base_dir, a.depths_dir, a.device)
    else:
        make_depth_scale(a.base_dir, a.depths_dir, a.device)


if __name__ == "__main__":
    main()
