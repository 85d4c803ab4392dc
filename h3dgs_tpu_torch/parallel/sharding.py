"""Device lists for the port's two kinds of parallelism (counterpart of
``h3dgs_tpu/parallel/sharding.py``).

The JAX package builds a (data, tile) mesh and lets its SPMD partitioner
place the work. The port has no mesh. It keeps the two things a mesh
gave the rest of the package:

* the devices of one frame's pixel bands (``band_devices``), used by
  ``parallel/band_render.py``;
* the view-data group: the processes of the ``torch.distributed`` group,
  one card each, that share each step's views (``parallel/step.py``); its
  size is ``parallel/multihost.process_count()``.
"""
from __future__ import annotations

from typing import List, Optional, Sequence

import torch


def visible_devices(device_type: str = "cuda") -> List[torch.device]:
    """Every visible card (``cuda``), or the one CPU device."""
    if device_type == "cuda":
        return [torch.device("cuda", i)
                for i in range(torch.cuda.device_count())]
    return [torch.device(device_type)]


def band_devices(n_bands: int = 0,
                 devices: Optional[Sequence] = None) -> List[torch.device]:
    """The first ``n_bands`` of ``devices`` (default: every visible card);
    ``0`` takes them all. Asking for more devices than there are raises
    ``ValueError``, as ``make_mesh`` does in the JAX package."""
    devices = [torch.device(d) for d in
               (devices if devices is not None else visible_devices())]
    n = len(devices) if n_bands == 0 else n_bands
    if n > len(devices):
        raise ValueError(
            f"{n} pixel bands need {n} devices but only {len(devices)} "
            f"are available")
    if n < 1:
        raise ValueError(f"n_bands must be >= 0, got {n_bands}")
    return devices[:n]
