"""Multi-process runtime: ``torch.distributed`` bootstrap and the
process-role helpers (counterpart of ``h3dgs_tpu/parallel/multihost.py``).

One process per card. ``initialize()`` joins the processes into one
group: NCCL when the device is a card, gloo on the CPU. After it, the
data-parallel train steps (``parallel/step.py``) all-reduce each step's
gradients over the group, and ``resolve_device`` maps ``cuda`` to
``cuda:<LOCAL_RANK>``. Artifact writes (checkpoints, point clouds,
``cfg_args``) happen on one process: guard them with ``is_primary()`` /
``primary_only``.

The JAX package's ``global_batch`` has no counterpart: there one array
spans every host's devices, here each process keeps its own views on its
own card and the step all-reduces the gradients itself.
"""
from __future__ import annotations

import functools
import os
from typing import Optional

import torch
import torch.distributed as dist

# Env-var bootstrap, as in the JAX package:
ENV_COORD = "H3DGS_COORDINATOR"      # e.g. "10.0.0.1:8476"
ENV_NPROC = "H3DGS_NUM_PROCESSES"
ENV_PID = "H3DGS_PROCESS_ID"


def _env_int(*names) -> Optional[int]:
    for name in names:
        if os.environ.get(name):
            return int(os.environ[name])
    return None


def initialize(coordinator: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None, device=None) -> None:
    """Idempotent ``torch.distributed`` bootstrap.

    Resolution order: explicit arguments > ``H3DGS_*`` variables >
    ``torchrun``'s (``WORLD_SIZE``, ``RANK``, ``MASTER_ADDR``,
    ``MASTER_PORT``) > SLURM with more than one task (``SLURM_NTASKS``,
    ``SLURM_PROCID``; the coordinator from ``MASTER_ADDR`` /
    ``MASTER_PORT``). A single-process run (none of these, or a world of
    one) is a no-op, so the CLIs call this unconditionally. ``device``
    picks the backend: gloo for ``"cpu"``, NCCL otherwise.
    """
    if dist.is_initialized():
        return
    coordinator = coordinator or os.environ.get(ENV_COORD)
    if num_processes is None:
        num_processes = _env_int(ENV_NPROC, "WORLD_SIZE")
    if process_id is None:
        process_id = _env_int(ENV_PID, "RANK")
    multi_slurm = (os.environ.get("SLURM_JOB_ID")
                   and int(os.environ.get("SLURM_NTASKS", "1")) > 1)
    if multi_slurm:
        if num_processes is None:
            num_processes = int(os.environ["SLURM_NTASKS"])
        if process_id is None:
            process_id = int(os.environ["SLURM_PROCID"])
    if coordinator is None and os.environ.get("MASTER_ADDR"):
        coordinator = (f"{os.environ['MASTER_ADDR']}:"
                       f"{os.environ.get('MASTER_PORT', '29500')}")
    if not num_processes or num_processes <= 1:
        return  # single process
    if coordinator is None or process_id is None:
        raise ValueError(
            f"{num_processes} processes need a coordinator address and a "
            f"process id: set {ENV_COORD} and {ENV_PID} (or run under "
            f"torchrun)")
    cpu = device is not None and torch.device(device).type == "cpu"
    if not cpu:
        torch.cuda.set_device(local_rank(process_id))
    dist.init_process_group(backend="gloo" if cpu else "nccl",
                            init_method=f"tcp://{coordinator}",
                            world_size=num_processes, rank=process_id)


def local_rank(process_id: int) -> int:
    """The card of process ``process_id`` on its host: ``LOCAL_RANK`` /
    ``SLURM_LOCALID`` when set, else the rank modulo the visible cards."""
    local = _env_int("LOCAL_RANK", "SLURM_LOCALID")
    if local is None:
        local = process_id % max(torch.cuda.device_count(), 1)
    return local


def process_index() -> int:
    return dist.get_rank() if dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_initialized() else 1


def is_primary() -> bool:
    """True on the process that owns artifact writes (rank 0)."""
    return process_index() == 0


def primary_only(fn):
    """Run fn on process 0 only; the others get None."""
    @functools.wraps(fn)
    def wrapper(*args, **kwargs):
        if is_primary():
            return fn(*args, **kwargs)
        return None
    return wrapper


def barrier() -> None:
    """Block until every process reaches this point (no-op for one
    process)."""
    if process_count() > 1:
        dist.barrier()
