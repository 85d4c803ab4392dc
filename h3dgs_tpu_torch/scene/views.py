"""A training view and its transport from the decode workers to the
device.

The wire format: the camera's tensors, ``image_idx`` (int64) and
``depth_reliable`` (bool) as they are, ``invdepth`` as f16, the image and
masks as uint8 (the PNG and JPEG sources are 8-bit), all in one uint8
record a view, each leaf at a multiple of 256 bytes. A decode worker
packs a host view into it (``stage_view``); ``staged_to_device`` copies
the record to the device and decodes it there, so the steps receive
float32 ``ViewBatch``es.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from .camera import Camera


class ViewBatch(NamedTuple):
    """One training view's data."""
    camera: Camera
    gt_image: torch.Tensor       # [3, H, W], already alpha-masked
    alpha_mask: torch.Tensor     # [1, H, W]
    invdepth: torch.Tensor       # [1, H, W] scaled mono inverse depth (or 0s)
    depth_mask: torch.Tensor     # [1, H, W]
    depth_reliable: torch.Tensor  # [] bool
    image_idx: torch.Tensor      # [] int64 (exposure row)


def _q8(x, out: np.ndarray) -> np.ndarray:
    """``x`` (in [0, 1]) into the uint8 array ``out``: clip(x * 255 +
    0.5) truncated, in ``x``'s own precision."""
    t = np.asarray(x) * 255.0
    t += 0.5
    np.clip(t, 0, 255, out=t)
    np.copyto(out, t, casting="unsafe")
    return out


_CAMERA = ("view", "full_proj", "cam_center", "tanfovx", "tanfovy")
_IMAGES = ("gt_image", "alpha_mask", "depth_mask")
_STAGE_ALIGN = 256   # bytes; every field of a record starts at a multiple


class StagedView(NamedTuple):
    """A host view (``host``) in the wire format, packed into one uint8
    ``record`` (pinned for a CUDA device). ``fields``: (name, dtype,
    shape, byte offset) of each leaf in the record."""
    host: ViewBatch
    record: torch.Tensor
    fields: tuple


def stage_view(batch: ViewBatch, pin: bool) -> StagedView:
    """Encode a host view straight into one record: the camera's tensors,
    ``image_idx`` (int64), ``depth_reliable`` (bool), ``invdepth`` (f16),
    then the uint8 image and masks, the record's size following the
    view's own shape. Runs on a decode worker; ``pin`` allocates the
    record in pinned memory, which PyTorch's host allocator reuses once
    the record's copy has run."""
    cam = batch.camera
    leaves = [(k, getattr(cam, k).numpy(), getattr(cam, k).dtype)
              for k in _CAMERA]
    leaves += [("image_idx", batch.image_idx, torch.int64),
               ("depth_reliable", batch.depth_reliable, torch.bool),
               ("invdepth", batch.invdepth, torch.float16)]
    leaves += [(k, getattr(batch, k), torch.uint8) for k in _IMAGES]
    fields, size = [], 0
    for k, a, dtype in leaves:
        size = -(-size // _STAGE_ALIGN) * _STAGE_ALIGN
        fields.append((k, dtype, np.shape(a), size))
        size += dtype.itemsize * int(np.prod(np.shape(a)))
    record = torch.empty(size, dtype=torch.uint8, pin_memory=pin)
    for (k, a, _), field in zip(leaves, fields):
        out = _field(record, *field[1:]).numpy()
        if k in _IMAGES:
            _q8(a, out)
        else:
            np.copyto(out, a, casting="unsafe")
    return StagedView(batch, record, tuple(fields))


def _field(buf: torch.Tensor, dtype, shape, off: int) -> torch.Tensor:
    """The leaf of a record (host or device) at byte ``off``."""
    n = dtype.itemsize * int(np.prod(shape))
    return buf[off:off + n].view(dtype).view(shape)


def staged_to_device(staged: StagedView, device) -> ViewBatch:
    """The float32 device ViewBatch of a staged view: one
    ``non_blocking`` copy of the record on the current stream, then the
    decode on the device (uint8 leaves / 255, ``invdepth`` to float32)
    on the same stream, with no synchronising call. The camera,
    ``depth_reliable`` and ``image_idx`` stay views into the copied
    record."""
    buf = staged.record.to(device, non_blocking=True)
    t = {k: _field(buf, *rest) for k, *rest in staged.fields}
    for k in _IMAGES:
        t[k] = t[k].to(torch.float32) / 255.0
    cam = staged.host.camera
    return ViewBatch(
        camera=Camera(*(t[k] for k in _CAMERA), height=cam.height,
                      width=cam.width),
        gt_image=t["gt_image"], alpha_mask=t["alpha_mask"],
        invdepth=t["invdepth"].to(torch.float32),
        depth_mask=t["depth_mask"], depth_reliable=t["depth_reliable"],
        image_idx=t["image_idx"])
