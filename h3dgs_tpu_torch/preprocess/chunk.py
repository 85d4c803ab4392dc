"""Scene chunking: split the aligned model into trainable spatial chunks.

The port's own copy of ``h3dgs_tpu/preprocess/chunk.py``. Equivalent of
the reference's preprocess/make_chunk.py: a padded XY grid of
``chunk_size`` cells (z unbounded); per-chunk camera selection by visible
SfM point count (in-box cams need >50 points, 2x-box cams kept with p=0.5,
far cams kept with p proportional to visible fraction), blur rejection via
Laplacian variance < mean - sigma, 100-1500 cameras per chunk, SfM points
stripped for re-triangulation, center.txt/extent.txt per chunk, and a
blending_dict.json of test-image visibility counts.

On the device: every image's gray + Laplacian variance (decoded in host
threads) and every image's visible-point count in every chunk box, in
float64 with the JAX package's strict ``<`` / ``>`` tests, so the counts
are its integers. On the host: the camera decisions, with the same
``random.Random(seed)`` drawn in the same order, and the files.
"""
from __future__ import annotations

import concurrent.futures as cf
import dataclasses
import json
import os
import random

import numpy as np
import torch

from ..io import colmap as C
from ..io.meta import write_vec
from ..utils.runtime import DeviceLike, resolve_device
from .imgproc import gray_bgr2gray, laplacian_var, load_bgr8
from .reorient import camera_centers


def laplacian_variance(image_path: str, device: DeviceLike = None) -> float:
    """Variance of the Laplacian of the image's gray (the JAX package's
    ``cv2.Laplacian(cvtColor(imread(path), BGR2GRAY), CV_32F).var()``);
    0.0 for a missing file, as there. A file that cannot be decoded
    raises."""
    device = resolve_device(device)
    image = load_bgr8(image_path)
    if image is None:
        return 0.0
    return laplacian_var(gray_bgr2gray(torch.from_numpy(image).to(device)))


def box_mask(xyz: torch.Tensor, pmin: np.ndarray,
             pmax: np.ndarray) -> torch.Tensor:
    """[N] bool: ``all(xyz < pmax) & all(xyz > pmin)`` over the last axis,
    in float64 as the JAX package tests it (``xyz`` float64)."""
    lo = torch.as_tensor(pmin, dtype=torch.float64, device=xyz.device)
    hi = torch.as_tensor(pmax, dtype=torch.float64, device=xyz.device)
    return (xyz < hi).all(-1) & (xyz > lo).all(-1)


def visible_counts(points: torch.Tensor, owner: torch.Tensor,
                   n_images: int, boxes) -> np.ndarray:
    """[len(boxes), n_images] int64: for each (pmin, pmax) box, how many of
    each image's visible points (``points`` [M, 3] float64, ``owner`` [M]
    the image's index) lie strictly inside it."""
    out = torch.zeros(len(boxes), n_images, dtype=torch.int64,
                      device=points.device)
    for b, (pmin, pmax) in enumerate(boxes):
        out[b] = torch.bincount(owner[box_mask(points, pmin, pmax)],
                                minlength=n_images)
    return out.cpu().numpy()


def _grid(bbox: np.ndarray, chunk_size: float):
    """The chunk cells in the JAX loop's order: (i, j, corner_min,
    corner_max, pmin, pmax), border cells widened to +-1e12
    (make_chunk:139-148)."""
    extent = bbox[1] - bbox[0]
    n_w = round(extent[0] / chunk_size)
    n_h = round(extent[1] / chunk_size)
    cells = []
    for i in range(n_w):
        for j in range(n_h):
            corner_min = bbox[0] + np.array(
                [i * chunk_size, j * chunk_size, 0.0])
            corner_max = bbox[0] + np.array(
                [(i + 1) * chunk_size, (j + 1) * chunk_size, 0.0])
            corner_min[2], corner_max[2] = -1e12, 1e12
            pmin, pmax = corner_min.copy(), corner_max.copy()
            if i == 0:
                pmin[0] = -1e12
            if j == 0:
                pmin[1] = -1e12
            if i == n_w - 1:
                pmax[0] = 1e12
            if j == n_h - 1:
                pmax[1] = 1e12
            cells.append((i, j, corner_min, corner_max, pmin, pmax))
    return cells


def make_chunks(base_dir: str, images_dir: str, output_path: str,
                chunk_size: float = 100.0, min_padd: float = 0.2,
                lapla_thresh: float = 1.0, min_n_cams: int = 100,
                max_n_cams: int = 1500, add_far_cams: bool = True,
                seed: int = 0, device: DeviceLike = None) -> list:
    """Returns the list of written chunk dicts {name, center, extent}."""
    device = resolve_device(device)
    rng = random.Random(seed)
    cams, images, pts = C.read_model(os.path.join(base_dir, "sparse", "0"))

    test_file = os.path.join(base_dir, "test.txt")
    blending_dict = None
    if os.path.exists(test_file):
        with open(test_file) as f:
            blending_dict = {ln.strip(): {} for ln in f if ln.strip()}

    centers = camera_centers(images)
    keys = list(images.keys())

    # Filter unreliable points (error >= 10).
    good = pts.error < 1e1
    xyzs = pts.xyz[good]
    colors = pts.rgb[good]
    errors = pts.error[good]
    indices = pts.ids[good]

    id_to_row = np.full(int(pts.ids.max()) + 1, -1, np.int64)
    id_to_row[indices] = np.arange(indices.shape[0])

    # Per-image visible (filtered) points: rows of xyzs, and their image.
    rows = []
    for k in keys:
        pid = images[k].point3d_ids
        pid = pid[(pid >= 0) & (pid < id_to_row.shape[0])]
        r = id_to_row[pid]
        rows.append(r[r >= 0])
    n_visible = np.array([len(r) for r in rows], np.int64)
    xyz_dev = torch.as_tensor(xyzs, dtype=torch.float64, device=device)
    owner = torch.as_tensor(np.repeat(np.arange(len(keys)), n_visible),
                            device=device)
    points = xyz_dev[torch.as_tensor(np.concatenate(rows), device=device)]

    # Padded global grid (make_chunk.py:100-109).
    bbox = np.stack([centers.min(axis=0), centers.max(axis=0)])
    bbox[0, :2] -= min_padd * chunk_size
    bbox[1, :2] += min_padd * chunk_size
    extent = bbox[1] - bbox[0]
    padd = np.array([chunk_size - extent[0] % chunk_size,
                     chunk_size - extent[1] % chunk_size])
    bbox[0, :2] -= padd / 2
    bbox[1, :2] += padd / 2
    bbox[0, 2], bbox[1, 2] = -1e12, 1e12

    laplacians = None
    if lapla_thresh > 0:
        with cf.ThreadPoolExecutor() as pool:
            vals = list(pool.map(
                lambda k: laplacian_variance(
                    os.path.join(images_dir, images[k].name), device), keys))
        laplacians = dict(zip(keys, vals))

    cells = _grid(bbox, chunk_size)
    counts = visible_counts(points, owner, len(keys),
                            [(c[4], c[5]) for c in cells])
    del points, owner
    written = []

    for (i, j, corner_min, corner_max, pmin, pmax), n_pts_of in zip(
            cells, counts):
        box_center = (corner_max + corner_min) / 2
        half = (corner_max - corner_min) / 2
        ext_min = box_center - 2 * half
        ext_max = box_center + 2 * half

        valid = np.zeros(len(keys), bool)
        for ci, k in enumerate(keys):
            n_pts = int(n_pts_of[ci])
            c = centers[ci]
            if np.all(c < corner_max) and np.all(c > corner_min):
                valid[ci] = n_pts > 50
            elif np.all(c < ext_max) and np.all(c > ext_min):
                valid[ci] = n_pts > 50 and rng.uniform(0, 1) > 0.5
            if not valid[ci] and n_pts > 10 and add_far_cams:
                valid[ci] = rng.uniform(0, 0.5) < (
                    n_pts / max(int(n_visible[ci]), 1))

        if lapla_thresh > 0 and valid.any():
            sel = np.array([laplacians[k]
                            for ci, k in enumerate(keys) if valid[ci]])
            thr = sel.mean() - lapla_thresh * sel.std()
            for ci, k in enumerate(keys):
                if valid[ci] and laplacians[k] < thr:
                    valid[ci] = False

        while valid.sum() > max_n_cams:
            on = np.nonzero(valid)[0]
            valid[on[rng.randint(0, len(on) - 1)]] = False

        if valid.sum() <= min_n_cams:
            continue

        inside = box_mask(xyz_dev, pmin, pmax).cpu().numpy()
        name = f"{i}_{j}"
        out_dir = os.path.join(output_path, name)
        out_colmap = os.path.join(out_dir, "sparse", "0")
        os.makedirs(out_colmap, exist_ok=True)

        images_out = {}
        for ci, k in enumerate(keys):
            if not valid[ci]:
                continue
            im = images[k]
            images_out[k] = dataclasses.replace(
                im, xys=np.zeros((0, 2)),
                point3d_ids=np.zeros(0, np.int64))
            if blending_dict is not None and im.name in blending_dict:
                n_vis = int(np.isin(im.point3d_ids,
                                    indices[inside]).sum())
                blending_dict[im.name][name] = str(n_vis)

        n_in = int(inside.sum())
        pts_out = C.ColmapPoints3D(
            ids=indices[inside],
            xyz=xyzs[inside],
            rgb=np.clip(colors[inside], 0, 255).astype(np.uint8),
            error=errors[inside],
            track_offsets=np.zeros(n_in + 1, np.int64),
            track_image_ids=np.zeros(0, np.int32),
            track_point2d_idxs=np.zeros(0, np.int32))
        C.write_model_binary(out_colmap, cams, images_out, pts_out)

        write_vec(os.path.join(out_dir, "center.txt"),
                  (corner_min + corner_max) / 2)
        write_vec(os.path.join(out_dir, "extent.txt"),
                  corner_max - corner_min)
        written.append({"name": name,
                        "center": (corner_min + corner_max) / 2,
                        "extent": corner_max - corner_min})
        print(f"chunk {name}: {int(valid.sum())} cams, "
              f"{n_in} points")

    if blending_dict is not None:
        with open(os.path.join(base_dir, "blending_dict.json"), "w") as f:
            json.dump(blending_dict, f, indent=2)
    return written


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--base_dir", required=True)
    p.add_argument("--images_dir", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--chunk_size", type=float, default=100)
    p.add_argument("--min_padd", type=float, default=0.2)
    p.add_argument("--lapla_thresh", type=float, default=1)
    p.add_argument("--min_n_cams", type=int, default=100)
    p.add_argument("--max_n_cams", type=int, default=1500)
    p.add_argument("--device", default=None,
                   help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)
    make_chunks(a.base_dir, a.images_dir, a.output_path, a.chunk_size,
                a.min_padd, a.lapla_thresh, a.min_n_cams, a.max_n_cams,
                device=a.device)


if __name__ == "__main__":
    main()
