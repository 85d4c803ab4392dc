"""Camera record used by the renderer (counterpart of
``h3dgs_tpu/scene/camera.py``).

The matrix and scalar fields are float32 tensors; ``height`` and ``width``
are plain ints. Constructors build on the CPU; ``Camera.to(device)`` moves
the tensors (the rasterizer moves the camera to its Gaussians' device).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional

import numpy as np
import torch

from ..utils import camera_math


@dataclasses.dataclass(frozen=True)
class Camera:
    """A single view."""
    view: torch.Tensor        # [4,4] world->camera (column-vector convention)
    full_proj: torch.Tensor   # [4,4] proj @ view
    cam_center: torch.Tensor  # [3] world-space camera position
    tanfovx: torch.Tensor     # [] f32
    tanfovy: torch.Tensor     # [] f32
    height: int
    width: int

    @property
    def focal_x(self):
        return self.width / (2.0 * self.tanfovx)

    @property
    def focal_y(self):
        return self.height / (2.0 * self.tanfovy)

    def to(self, device) -> "Camera":
        device = torch.device(device)
        if self.view.device == device:
            return self
        return dataclasses.replace(
            self, view=self.view.to(device),
            full_proj=self.full_proj.to(device),
            cam_center=self.cam_center.to(device),
            tanfovx=self.tanfovx.to(device), tanfovy=self.tanfovy.to(device))


def camera_from_arrays(view, full_proj, cam_center, tanfovx, tanfovy,
                       height: int, width: int) -> Camera:
    """Camera from host arrays/scalars (f32 on the CPU)."""
    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32))
    return Camera(view=f32(view), full_proj=f32(full_proj),
                  cam_center=f32(cam_center), tanfovx=f32(tanfovx),
                  tanfovy=f32(tanfovy), height=int(height), width=int(width))


def make_camera(R: np.ndarray, T: np.ndarray, fovx: float, fovy: float,
                width: int, height: int, primx: float = 0.5, primy: float = 0.5,
                znear: float = 0.01, zfar: float = 100.0,
                trans=np.array([0.0, 0.0, 0.0]), scale: float = 1.0) -> Camera:
    """Build a Camera from COLMAP-style extrinsics (znear/zfar defaults of
    the reference)."""
    view = camera_math.world_to_view(R, T, trans, scale)
    proj = camera_math.projection_matrix(znear, zfar, fovx, fovy, primx, primy)
    full_proj = (proj @ view).astype(np.float32)
    center = camera_math.camera_center_from_view(view)
    return camera_from_arrays(
        view, full_proj, center, np.float32(math.tan(fovx * 0.5)),
        np.float32(math.tan(fovy * 0.5)), height, width)


def look_at_camera(eye, target, up=(0.0, 1.0, 0.0), fovx: float = 1.0,
                   fovy: Optional[float] = None, width: int = 64,
                   height: int = 64, **kw) -> Camera:
    """Convenience constructor for tests and synthetic scenes."""
    eye = np.asarray(eye, np.float64)
    target = np.asarray(target, np.float64)
    up = np.asarray(up, np.float64)
    fwd = target - eye
    fwd = fwd / np.linalg.norm(fwd)
    right = np.cross(fwd, up)
    right = right / np.linalg.norm(right)
    down = np.cross(fwd, right)
    # Camera looks down +z in camera space (the projection assumes z > 0).
    R_w2c = np.stack([right, down, fwd], axis=0)
    t = -R_w2c @ eye
    # make_camera expects R = camera-to-world rotation (R_w2c.T).
    if fovy is None:
        fovy = 2.0 * math.atan(math.tan(fovx / 2.0) * height / width)
    return make_camera(R_w2c.T, t, fovx, fovy, width, height, **kw)
