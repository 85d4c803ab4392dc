"""Seeded projection inputs that reach every branch of the projection, for
the CPU tests of ``ops/projection.py`` and the card tests of its kernels
(torch and numpy only: the card's machine has no JAX)."""
from __future__ import annotations

import math

import numpy as np
import torch

from h3dgs_tpu_torch.scene.camera import look_at_camera

EYE = (0.2, -0.3, -3.0)
FOVX = 1.0
WIDTH, HEIGHT = 96, 64


def projection_camera():
    return look_at_camera(eye=EYE, target=(0.0, 0.0, 0.0), fovx=FOVX,
                          width=WIDTH, height=HEIGHT)


def projection_case(degree: int, seed: int, n: int = 3000, extra_k: int = 0,
                    long_axis=(1.0, 4.0)):
    """(means [n,3], scales [n,3], quats [n,4], opacities [n], shs [n, K,
    3] with K = (degree+1)^2 + extra_k) as float64 numpy, and the
    camera. A sixth of the rows each: ordinary rows in a box around the
    target; rows near the eye on the view axis, at depths -1 to 0.35
    (behind the near plane, some behind the camera); rows beside the view
    axis up to three times the clamp's tangent (past the tan clamp); long
    thin splats close to the eye with axis-aligned quaternions (long
    axis 10^long_axis[0] to 10^long_axis[1]), whose 2D determinant rounds
    to <= 0 for some (in float32 at the default; in float64 from 10^14
    up); rows whose SH colour is negative (DC far below -0.5 / C0); rows
    under the opacity cull."""
    rng = np.random.default_rng(seed)
    cam = projection_camera()
    view = cam.view.double().numpy()
    eye = np.asarray(EYE)
    fwd, right, down = view[2, :3], view[0, :3], view[1, :3]
    k = (max(degree, 0) + 1) ** 2 + extra_k
    means = rng.uniform(-1.5, 1.5, (n, 3))
    scales = np.exp(rng.uniform(np.log(0.01), np.log(0.5), (n, 3)))
    quats = rng.normal(size=(n, 4))
    opac = rng.uniform(0.02, 1.0, n)
    shs = rng.normal(0.0, 0.4, (n, k, 3))
    shs[:, 0] = rng.uniform(-1.0, 1.5, (n, 3))
    q = n // 6
    near = slice(0, q)
    means[near] = (eye + fwd * rng.uniform(-1.0, 0.35, (q, 1))
                   + rng.normal(0.0, 0.05, (q, 3)))
    side = slice(q, 2 * q)
    depth = rng.uniform(1.0, 4.0, (q, 1))
    lim = math.tan(FOVX / 2)
    means[side] = (eye + fwd * depth
                   + right * depth * rng.uniform(-3, 3, (q, 1)) * lim
                   + down * depth * rng.uniform(-3, 3, (q, 1)) * lim)
    thin = slice(2 * q, 3 * q)
    means[thin] = (eye + fwd * rng.uniform(0.3, 1.0, (q, 1))
                   + rng.normal(0.0, 0.05, (q, 3)))
    scales[thin] = np.stack([10.0 ** rng.uniform(*long_axis, q),
                             10.0 ** rng.uniform(-6, -3, q),
                             10.0 ** rng.uniform(-6, -3, q)], 1)
    quats[thin] = 0.0
    quats[np.arange(2 * q, 3 * q), rng.integers(0, 4, q)] = 1.0
    shs[3 * q:4 * q, 0] = -3.0
    opac[4 * q:5 * q] = rng.uniform(0.0, 2.0 / 255.0, q)
    return (means, scales, quats, opac, shs), cam


def as_tensors(arrays, dtype=torch.float32, device="cpu"):
    return [torch.as_tensor(np.asarray(a), dtype=dtype, device=device)
            for a in arrays]
