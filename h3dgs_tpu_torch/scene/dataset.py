"""COLMAP scene metadata: camera records, splits, normalization.

Equivalent of the reference's readColmapSceneInfo
(the reference's scene/dataset_readers.py:180-268): pinhole-only intrinsics
with principal-point offsets, depth_params.json with median-scale
augmentation, test split from test.txt or LLFF hold-out, NeRF++-style
normalization radius. Image pixels are NOT loaded in this module — CameraInfo is
metadata; decoding happens in scene/loader.py (streaming).

The port's own copy of ``h3dgs_tpu/scene/dataset.py``.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, List, Optional

import numpy as np

from ..io import colmap as colmap_io
from ..io import meta as meta_io
from ..utils.camera_math import focal2fov


@dataclasses.dataclass
class CameraInfo:
    uid: int
    R: np.ndarray          # [3,3] cam-to-world rotation (COLMAP transposed)
    T: np.ndarray          # [3]
    fovx: float
    fovy: float
    primx: float
    primy: float
    width: int
    height: int
    image_path: str
    image_name: str
    mask_path: str = ""
    depth_path: str = ""
    depth_params: Optional[dict] = None
    is_test: bool = False


@dataclasses.dataclass
class SceneInfo:
    point_cloud_xyz: Optional[np.ndarray]
    point_cloud_rgb: Optional[np.ndarray]   # [N,3] in [0,1]
    train_cameras: List[CameraInfo]
    test_cameras: List[CameraInfo]
    translate: np.ndarray
    radius: float
    ply_path: str


def nerfpp_norm(cam_infos: List[CameraInfo]):
    """translate/radius from camera centers
    (dataset_readers.py:52-73: radius = 1.1 x 90th-percentile distance)."""
    centers = []
    for c in cam_infos:
        # world-to-view R^T | -R^T... reference uses getWorld2View2 inverse.
        W2C = np.eye(4)
        W2C[:3, :3] = c.R.T
        W2C[:3, 3] = c.T
        C2W = np.linalg.inv(W2C)
        centers.append(C2W[:3, 3])
    centers = np.stack(centers)
    avg = centers.mean(axis=0)
    dist = np.linalg.norm(centers - avg, axis=1)
    diagonal = np.quantile(dist, 0.9)
    return -avg, float(diagonal * 1.1)


def _intrinsics_to_fov(intr: colmap_io.ColmapCamera):
    if intr.model == "SIMPLE_PINHOLE":
        f = intr.params[0]
        primx = float(intr.params[1]) / intr.width
        primy = float(intr.params[2]) / intr.height
        return (focal2fov(f, intr.width), focal2fov(f, intr.height),
                primx, primy)
    if intr.model == "PINHOLE":
        fx, fy = intr.params[0], intr.params[1]
        primx = float(intr.params[2]) / intr.width
        primy = float(intr.params[3]) / intr.height
        return (focal2fov(fx, intr.width), focal2fov(fy, intr.height),
                primx, primy)
    raise ValueError(
        f"COLMAP camera model {intr.model} not handled: only undistorted "
        "datasets (PINHOLE or SIMPLE_PINHOLE) are supported")


def _find_image(images_folder: str, name: str):
    """Reference fallback: try the recorded name, then .jpg/.png with the
    same stem (dataset_readers.py:117-124 pattern)."""
    p = os.path.join(images_folder, name)
    if os.path.exists(p):
        return p, name
    stem = os.path.splitext(name)[0]
    for ext in (".jpg", ".png", ".jpeg", ".JPG", ".PNG"):
        alt = stem + ext
        if os.path.exists(os.path.join(images_folder, alt)):
            return os.path.join(images_folder, alt), alt
    return p, name  # let the loader raise on open


def read_colmap_scene(
    path: str,
    images: str = "images",
    masks: str = "",
    depths: str = "",
    eval_split: bool = False,
    train_test_exp: bool = False,
    llffhold: Optional[int] = None,
) -> SceneInfo:
    sparse = os.path.join(path, "sparse", "0")
    cams, imgs, pts3d = colmap_io.read_model(sparse)

    depths_params: Optional[Dict[str, dict]] = None
    if depths:
        depths_params = meta_io.read_depth_params(
            os.path.join(sparse, "depth_params.json"))

    # --- point cloud: xyz.pt/rgb.pt > points3D.ply > points3D.bin/txt ---
    xyz = rgb = None
    ply_path = os.path.join(sparse, "points3D.ply")
    pt_path = os.path.join(sparse, "xyz.pt")
    if os.path.exists(pt_path):
        xyz = np.asarray(_load_pt_tensor(pt_path), np.float32)
        rgb = np.asarray(_load_pt_tensor(os.path.join(sparse, "rgb.pt")),
                         np.float32)
        if rgb.max() > 1.5:
            rgb = rgb / 255.0
    elif os.path.exists(ply_path):
        from ..io.ply import read_points3d_ply
        xyz, rgb = read_points3d_ply(ply_path)
    else:
        pts = pts3d
        if pts is not None and pts.ids.size:
            xyz = pts.xyz.astype(np.float32)
            rgb = pts.rgb.astype(np.float32) / 255.0
            from ..io.ply import write_points3d_ply
            try:
                write_points3d_ply(ply_path, xyz, rgb)
            except OSError:
                pass  # read-only source dir: keep going without the cache

    # --- eval split (dataset_readers.py:233-245) ---
    test_names: List[str] = []
    if eval_split:
        if "360" in path:
            llffhold = 8
        if llffhold:
            names = sorted(im.name for im in imgs.values())
            test_names = names[::llffhold]
        else:
            with open(os.path.join(sparse, "test.txt")) as f:
                test_names = [ln.strip() for ln in f if ln.strip()]
    test_set = set(test_names)

    images_folder = os.path.join(path, images or "images")
    cam_infos = []
    for im in imgs.values():
        intr = cams[im.camera_id]
        fovx, fovy, primx, primy = _intrinsics_to_fov(intr)
        image_path, image_name = _find_image(images_folder, im.name)
        stem = os.path.splitext(im.name)[0]
        dp = None
        if depths_params is not None:
            dp = depths_params.get(stem)
        cam_infos.append(CameraInfo(
            uid=im.camera_id,
            R=im.rotmat().T,
            T=np.asarray(im.tvec, np.float64),
            fovx=fovx, fovy=fovy, primx=primx, primy=primy,
            width=intr.width, height=intr.height,
            image_path=image_path, image_name=image_name,
            mask_path=(os.path.join(path, masks, stem + ".png")
                       if masks else ""),
            depth_path=(os.path.join(path, depths, stem + ".png")
                        if depths else ""),
            depth_params=dp,
            is_test=im.name in test_set,
        ))
    cam_infos.sort(key=lambda c: c.image_name)

    train = [c for c in cam_infos if train_test_exp or not c.is_test]
    test = [c for c in cam_infos if c.is_test]
    translate, radius = nerfpp_norm(train if train else cam_infos)
    return SceneInfo(
        point_cloud_xyz=xyz, point_cloud_rgb=rgb,
        train_cameras=train, test_cameras=test,
        translate=translate, radius=radius, ply_path=ply_path)


def _load_pt_tensor(path: str) -> np.ndarray:
    """xyz.pt/rgb.pt are torchscript-traced tensor containers in the
    reference (dataset_readers.py:215-222); accept plain tensor saves too."""
    import torch
    try:
        mod = torch.jit.load(path, map_location="cpu")
        sd = mod.state_dict()
        if sd:
            return next(iter(sd.values())).numpy()
        # traced Module exposing .forward() returning the tensor
        return mod().numpy()
    except Exception:
        return torch.load(path, map_location="cpu",
                          weights_only=True).numpy()
