"""Re-anchor a bundle-adjusted chunk to the original coordinate frame.

The port's own copy of ``h3dgs_tpu/preprocess/transform.py``
(host numpy, float64).

Equivalent of the reference's preprocess/transform_colmap.py: a sim(3)
Procrustes alignment on camera centers (outliers trimmed at 5x the median
displacement), applied to the refined cameras and to points filtered by
reprojection error < 1.5 and >= 3 observing views; copies center/extent.
"""
from __future__ import annotations

import dataclasses
import os
import shutil
from typing import NamedTuple

import numpy as np

from ..io import colmap as C


class Sim3(NamedTuple):
    t0: np.ndarray
    t1: np.ndarray
    s0: float
    s1: float
    R: np.ndarray

    def apply(self, x: np.ndarray) -> np.ndarray:
        """Align frame-1 points into frame 0."""
        return (x - self.t1) / self.s1 @ self.R.T * self.s0 + self.t0


def procrustes_analysis(x0: np.ndarray, x1: np.ndarray) -> Sim3:
    """sim(3) aligning x1 -> x0 (least squares over paired points)."""
    t0 = x0.mean(axis=0)
    t1 = x1.mean(axis=0)
    x0c = x0 - t0
    x1c = x1 - t1
    s0 = np.sqrt((x0c ** 2).sum(-1).mean())
    s1 = np.sqrt((x1c ** 2).sum(-1).mean())
    u, _, vt = np.linalg.svd((x0c / s0).T @ (x1c / s1))
    r = u @ vt
    if np.linalg.det(r) < 0:
        r[2] *= -1
    return Sim3(t0, t1, float(s0), float(s1), r)


def transform_colmap(in_dir: str, new_colmap_dir: str, out_dir: str,
                     max_err: float = 1.5, min_views: int = 3) -> None:
    _, old_images, _ = C.read_model(os.path.join(in_dir, "sparse", "0"))
    cams, new_images, pts = C.read_model(
        os.path.join(new_colmap_dir, "sparse", "0"))

    by_name = {im.name: im for im in old_images.values()}
    keys = [k for k in new_images if new_images[k].name in by_name]
    old_c = np.array([
        -C.qvec2rotmat(by_name[new_images[k].name].qvec).T
        @ by_name[new_images[k].name].tvec for k in keys])
    new_c = np.array([
        -C.qvec2rotmat(new_images[k].qvec).T @ new_images[k].tvec
        for k in keys])

    dists = np.linalg.norm(old_c - new_c, axis=-1)
    ok = dists <= np.median(dists) * 5 + 1e-8
    sim3 = procrustes_analysis(old_c[ok], new_c[ok])
    centers_aligned = sim3.apply(new_c)

    # Re-pose cameras: refined rotations composed into the old frame
    # (R' = R @ sim3.R^T, t' = -R' c'); outlier cameras are dropped.
    images_out = {}
    for k, center, valid in zip(keys, centers_aligned, ok):
        if not valid:
            continue
        im = new_images[k]
        R_aligned = C.qvec2rotmat(im.qvec) @ sim3.R.T
        tvec = -R_aligned @ center
        images_out[k] = dataclasses.replace(
            im, qvec=C.rotmat2qvec(R_aligned), tvec=tvec)

    # Filter + align points.
    n_views = pts.track_offsets[1:] - pts.track_offsets[:-1]
    mask = (pts.error < max_err) & (n_views > min_views)
    xyz_aligned = sim3.apply(pts.xyz[mask])
    n = int(mask.sum())
    # Tracks are dropped (downstream stages re-triangulate if needed).
    pts_out = C.ColmapPoints3D(
        ids=pts.ids[mask], xyz=xyz_aligned, rgb=pts.rgb[mask],
        error=pts.error[mask],
        track_offsets=np.zeros(n + 1, np.int64),
        track_image_ids=np.zeros(0, np.int32),
        track_point2d_idxs=np.zeros(0, np.int32))

    out_sparse = os.path.join(out_dir, "sparse", "0")
    C.write_model_binary(out_sparse, cams, images_out, pts_out)
    for f in ("center.txt", "extent.txt"):
        src = os.path.join(in_dir, f)
        if os.path.exists(src):
            shutil.copyfile(src, os.path.join(out_dir, f))
    print(f"transform_colmap: {len(images_out)} cams, {n} points "
          f"-> {out_sparse}")


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--in_dir", required=True)
    p.add_argument("--new_colmap_dir", required=True)
    p.add_argument("--out_dir", required=True)
    a = p.parse_args(argv)
    transform_colmap(a.in_dir, a.new_colmap_dir, a.out_dir)


if __name__ == "__main__":
    main()
