"""Scene auto-reorientation + metric rescale.

The port's own copy of ``h3dgs_tpu/preprocess/reorient.py`` (host numpy,
float64). Equivalent of the reference's preprocess/auto_reorient.py: align
the global COLMAP model so that up = least-squares plane normal of the
camera centers, right = direction between the two farthest-apart cameras
(convex hull), and rescale so the median camera-to-SfM-point distance
equals ``target_med_dist`` (default 20) — the "metric" unit every later
stage (chunk size 100, skybox radius, LOD thresholds) assumes.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from ..io import colmap as C


def fit_plane_normal(points: np.ndarray) -> np.ndarray:
    """Least-squares plane z = ax + by + c; returns the unit normal."""
    A = np.c_[points[:, 0], points[:, 1], np.ones(len(points))]
    coeffs, *_ = np.linalg.lstsq(A, points[:, 2], rcond=None)
    a, b, _ = coeffs
    n = np.array([a, b, -1.0])
    return n / np.linalg.norm(n)


def camera_centers(images: dict) -> np.ndarray:
    return np.array([
        -C.qvec2rotmat(im.qvec).T @ im.tvec for im in images.values()])


def compute_rotation_scale(cams: dict, images: dict, pts: C.ColmapPoints3D,
                           target_med_dist: float = 20.0,
                           upscale: float = 0.0,
                           manual_up=None, manual_right=None):
    """(rotation_matrix [3,3] with target axes as columns, upscale).

    ``manual_up``/``manual_right`` override the automatic axes (the
    reference's manual reorient.py variant)."""
    from scipy import spatial

    centers = camera_centers(images)
    up = (np.asarray(manual_up, float) if manual_up is not None
          else fit_plane_normal(centers))
    up = up / np.linalg.norm(up)

    if manual_right is not None:
        right = np.asarray(manual_right, float)
    else:
        # QJ joggles degenerate (e.g. perfectly coplanar) camera layouts.
        hull_pts = centers[spatial.ConvexHull(centers,
                                              qhull_options="QJ").vertices]
        dmat = spatial.distance_matrix(hull_pts, hull_pts)
        i, j = np.unravel_index(dmat.argmax(), dmat.shape)
        right = hull_pts[i] - hull_pts[j]
    right = right / np.linalg.norm(right)

    forward = np.cross(up, right)
    forward /= np.linalg.norm(forward)
    right = np.cross(forward, up)
    right /= np.linalg.norm(right)
    rot = np.stack([right, forward, up], axis=1)

    if upscale == 0.0:
        id_to_row = np.full(int(pts.ids.max()) + 1, -1, np.int64)
        id_to_row[pts.ids] = np.arange(pts.ids.shape[0])
        dists = []
        for im in images.values():
            center = -C.qvec2rotmat(im.qvec).T @ im.tvec
            pid = im.point3d_ids
            pid = pid[(pid >= 0) & (pid < id_to_row.shape[0])]
            rows = id_to_row[pid]
            rows = rows[rows >= 0]
            if rows.size:
                dists.append(np.linalg.norm(pts.xyz[rows] - center, axis=1))
        med = np.median(np.concatenate(dists)) if dists else 1.0
        upscale = target_med_dist / med
    return rot, float(upscale)


def apply_rotation_scale(cams: dict, images: dict, pts: C.ColmapPoints3D,
                         rot: np.ndarray, upscale: float):
    """Transform points and cameras (auto_reorient.py:143-181 semantics)."""
    new_pts = dataclasses.replace(pts, xyz=upscale * (pts.xyz @ rot))
    new_images = {}
    inv_rot = np.linalg.inv(rot)
    for k, im in images.items():
        R = C.qvec2rotmat(im.qvec)
        Rt = np.eye(4)
        Rt[:3, :3] = R
        Rt[:3, 3] = im.tvec
        C2W = np.linalg.inv(Rt)
        center = C2W[:3, 3] @ rot
        C2W[:3, 3] = upscale * center
        C2W[:3, :3] = inv_rot @ C2W[:3, :3]
        W2C = np.linalg.inv(C2W)
        new_images[k] = dataclasses.replace(
            im, qvec=C.rotmat2qvec(W2C[:3, :3]), tvec=W2C[:3, 3])
    return cams, new_images, new_pts


def auto_reorient(input_path: str, output_path: str,
                  target_med_dist: float = 20.0, upscale: float = 0.0,
                  manual_up=None, manual_right=None):
    cams, images, pts = C.read_model(input_path)
    rot, scale = compute_rotation_scale(cams, images, pts,
                                        target_med_dist, upscale,
                                        manual_up, manual_right)
    cams, images, pts = apply_rotation_scale(cams, images, pts, rot, scale)
    C.write_model_binary(output_path, cams, images, pts)
    return rot, scale


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--input_path", required=True)
    p.add_argument("--output_path", required=True)
    p.add_argument("--upscale", type=float, default=0)
    p.add_argument("--target_med_dist", type=float, default=20)
    p.add_argument("--manual_up", nargs=3, type=float, default=None,
                   help="override the up axis (manual reorient variant)")
    p.add_argument("--manual_right", nargs=3, type=float, default=None)
    a = p.parse_args(argv)
    rot, scale = auto_reorient(a.input_path, a.output_path,
                               a.target_med_dist, a.upscale,
                               a.manual_up, a.manual_right)
    print(f"reoriented (upscale {scale:.4f}) -> {a.output_path}")


if __name__ == "__main__":
    main()
