"""Device selection for the port's entry points."""
from __future__ import annotations

from typing import Optional, Union

import torch

from ..parallel import multihost

DeviceLike = Union[str, torch.device, None]


def resolve_device(device: DeviceLike = None) -> torch.device:
    """The device an entry point runs on.

    ``None`` means the card: it raises when CUDA is missing instead of
    falling back to the CPU, so a run that was meant for the GPU never
    quietly measures the CPU. Pass ``device="cpu"`` to run on the CPU.
    In a process group of more than one process, ``None`` and ``"cuda"``
    mean this process's card, ``cuda:<LOCAL_RANK>``.
    """
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "CUDA is not available; pass device='cpu' to run on the CPU")
        device = "cuda"
    device = torch.device(device)
    if device.type == "cuda" and device.index is None and \
            multihost.process_count() > 1:
        device = torch.device("cuda",
                              multihost.local_rank(multihost.process_index()))
    return device


def as_tensor(x, device: Optional[torch.device] = None,
              dtype: Optional[torch.dtype] = None) -> torch.Tensor:
    """numpy array / scalar / tensor -> tensor on ``device``."""
    if isinstance(x, torch.Tensor):
        return x.to(device=device, dtype=dtype)
    return torch.as_tensor(x, device=device, dtype=dtype)
