"""Camera math: world/view/projection transforms and FoV helpers.

Conventions match the reference pipeline (cf. upstream utils/
graphics_utils.py:31-83 and scene/cameras.py:95-98) but we keep matrices in
the standard column-vector convention internally: ``p_cam = V @ p_world``.
The reference stores transposed matrices because its CUDA rasterizer
multiplies row vectors; a from-scratch JAX renderer has no such constraint.

All functions are numpy (host-side); copied unchanged from
``h3dgs_tpu/utils/camera_math.py``.
"""
from __future__ import annotations

import math

import numpy as np


def fov2focal(fov: float, pixels: float) -> float:
    return pixels / (2.0 * math.tan(fov / 2.0))


def focal2fov(focal: float, pixels: float) -> float:
    return 2.0 * math.atan(pixels / (2.0 * focal))


def world_to_view(R: np.ndarray, t: np.ndarray,
                  translate=np.array([0.0, 0.0, 0.0]), scale: float = 1.0) -> np.ndarray:
    """4x4 world->camera matrix (column-vector convention).

    ``R`` is the camera-to-world rotation as stored by COLMAP readers
    (i.e. the reference keeps ``R = qvec2rotmat(...).T``); ``t`` is the
    world-to-camera translation. ``translate``/``scale`` recentre and rescale
    the scene the same way the reference does (graphics_utils.py:38-49).
    """
    Rt = np.zeros((4, 4), dtype=np.float64)
    Rt[:3, :3] = R.T
    Rt[:3, 3] = t
    Rt[3, 3] = 1.0
    C2W = np.linalg.inv(Rt)
    C2W[:3, 3] = (C2W[:3, 3] + translate) * scale
    return np.linalg.inv(C2W).astype(np.float32)


def projection_matrix(znear: float, zfar: float, fovx: float, fovy: float,
                      primx: float = 0.5, primy: float = 0.5) -> np.ndarray:
    """Off-center perspective projection (column-vector convention).

    primx/primy are the principal point as a fraction of the image; 0.5 is
    centered. Depth maps to ``z_clip = zfar/(zfar-znear) * z - zfar*znear/
    (zfar-znear)`` with ``w_clip = z`` (matches graphics_utils.py:51-77).
    """
    tan_half_fovy = math.tan(fovy / 2.0)
    tan_half_fovx = math.tan(fovx / 2.0)

    top = tan_half_fovy * znear
    bottom = (1.0 - primy) * 2.0 * -top
    top = primy * 2.0 * top

    right = tan_half_fovx * znear
    left = (1.0 - primx) * 2.0 * -right
    right = primx * 2.0 * right

    P = np.zeros((4, 4), dtype=np.float32)
    P[0, 0] = 2.0 * znear / (right - left)
    P[1, 1] = 2.0 * znear / (top - bottom)
    P[0, 2] = (right + left) / (right - left)
    P[1, 2] = (top + bottom) / (top - bottom)
    P[3, 2] = 1.0
    P[2, 2] = zfar / (zfar - znear)
    P[2, 3] = -(zfar * znear) / (zfar - znear)
    return P


def camera_center_from_view(view: np.ndarray) -> np.ndarray:
    """World-space camera position from a 4x4 world->camera matrix."""
    return (-view[:3, :3].T @ view[:3, 3]).astype(np.float32)
