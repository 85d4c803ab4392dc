"""Training-step helpers the serving path shares (counterpart of part of
``h3dgs_tpu/train/step.py``; the training step itself is a later slice)."""
from __future__ import annotations

import torch


def apply_exposure(image: torch.Tensor, exposure: torch.Tensor) -> torch.Tensor:
    """3x4 affine color transform of a [3,H,W] image. Summed per channel
    in float32 (no matmul, so no TF32 whatever the backend settings)."""
    m = exposure[:3, :3]
    out = (image[:, None] * m[:, :, None, None]).sum(dim=0)
    return out + exposure[:3, 3][:, None, None]
