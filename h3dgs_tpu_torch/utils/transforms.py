"""Quaternion helpers (counterpart of ``h3dgs_tpu/utils/transforms.py``)."""
from __future__ import annotations

import torch


def normalize_quat(q: torch.Tensor, eps: float = 1e-12) -> torch.Tensor:
    """Normalize [..., 4] (w, x, y, z) quaternions."""
    norm = torch.sqrt(torch.sum(q * q, dim=-1, keepdim=True) + eps)
    return q / norm
