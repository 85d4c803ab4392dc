"""Quaternion helpers and inverse_sigmoid (counterpart of
``h3dgs_tpu/utils/transforms.py``)."""
from __future__ import annotations

import torch


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize [..., 4] (w, x, y, z) quaternions."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)
    return q / norm


def quat_to_rotmat(q: torch.Tensor) -> torch.Tensor:
    """[..., 4] (w, x, y, z) quaternion -> [..., 3, 3] rotation; the
    quaternion is normalized first."""
    q = normalize_quat(q)
    w, x, y, z = q[..., 0], q[..., 1], q[..., 2], q[..., 3]
    row0 = torch.stack([1 - 2 * (y * y + z * z), 2 * (x * y - w * z),
                        2 * (x * z + w * y)], dim=-1)
    row1 = torch.stack([2 * (x * y + w * z), 1 - 2 * (x * x + z * z),
                        2 * (y * z - w * x)], dim=-1)
    row2 = torch.stack([2 * (x * z - w * y), 2 * (y * z + w * x),
                        1 - 2 * (x * x + y * y)], dim=-1)
    return torch.stack([row0, row1, row2], dim=-2)


def inverse_sigmoid(x):
    return torch.log(x / (1.0 - x))
