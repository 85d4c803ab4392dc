"""Camera matrices of the 3DGS-family conventions (column vectors,
``p_cam = view @ p_world``; principal point centred; znear 0.01, zfar
100), in numpy, for the benchmark's generators, its viewer client and its
reference alike."""
from __future__ import annotations

import math

import numpy as np
import torch

from .render import Cam

ZNEAR, ZFAR = 0.01, 100.0


def look_at(eye, target, up=(0.0, 1.0, 0.0)):
    """World->camera rotation (rows right, down, forward) [3,3] and
    translation [3], float64."""
    eye = np.asarray(eye, np.float64)
    fwd = np.asarray(target, np.float64) - eye
    fwd /= np.linalg.norm(fwd)
    right = np.cross(fwd, np.asarray(up, np.float64))
    right /= np.linalg.norm(right)
    down = np.cross(fwd, right)
    rows = np.stack([right, down, fwd])
    return rows, -rows @ eye


def world_to_view(rows, t) -> np.ndarray:
    rt = np.eye(4)
    rt[:3, :3] = rows
    rt[:3, 3] = t
    return np.linalg.inv(np.linalg.inv(rt)).astype(np.float32)


def projection(fovx: float, fovy: float) -> np.ndarray:
    top = math.tan(fovy / 2.0) * ZNEAR
    right = math.tan(fovx / 2.0) * ZNEAR
    p = np.zeros((4, 4), np.float32)
    p[0, 0] = 2.0 * ZNEAR / (2 * right)
    p[1, 1] = 2.0 * ZNEAR / (2 * top)
    p[3, 2] = 1.0
    p[2, 2] = ZFAR / (ZFAR - ZNEAR)
    p[2, 3] = -(ZFAR * ZNEAR) / (ZFAR - ZNEAR)
    return p


def fovy_of(fovx: float, width: int, height: int) -> float:
    return 2.0 * math.atan(math.tan(fovx / 2.0) * height / width)


def matrices(rows, t, fovx: float, fovy: float):
    """(view, full_proj, centre) as float32 numpy arrays."""
    view = world_to_view(rows, t)
    full = (projection(fovx, fovy) @ view).astype(np.float32)
    centre = (-view[:3, :3].T @ view[:3, 3]).astype(np.float32)
    return view, full, centre


def make_cam(rows, t, fovx: float, fovy: float, width: int, height: int,
             device) -> Cam:
    view, full, centre = matrices(rows, t, fovx, fovy)

    def dev(a):
        return torch.as_tensor(a, device=device)

    return Cam(dev(view), dev(full), dev(centre),
               float(np.float32(math.tan(fovx * 0.5))),
               float(np.float32(math.tan(fovy * 0.5))), width, height)
