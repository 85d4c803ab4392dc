"""Streaming view loader: decode images on host threads, feed the card
(counterpart of ``h3dgs_tpu/scene/loader.py``).

A small thread pool decodes views ahead while the card trains on the
previous one; pixel preprocessing (resolution policy, alpha masking,
exposure-eval half-masking, mono-depth scaling + reliability) follows the
reference. Images are read with ``io/image.py`` (PNG and baseline JPEG
without any library, as stored: no EXIF rotation, as PIL gives the JAX
loader; other formats through PIL) and resized on the host with
``torch.nn.functional.interpolate(mode="area")``: equal to OpenCV's
INTER_AREA, which the JAX loader uses, at integer downscale factors; at
other factors the two differ by up to a few 1/255 per value.
"""
from __future__ import annotations

import concurrent.futures as cf
from typing import List, Sequence

import numpy as np
import torch
import torch.nn.functional as F

from ..io.image import read_image
from ..train.step import ViewBatch
from .camera import make_camera
from .dataset import CameraInfo


def _resolution(orig_w: int, orig_h: int, resolution: int,
                resolution_scale: float = 1.0):
    """The reference's resolution policy (utils/camera_utils.py:57-74):
    -1 = cap width at 1600, {1,2,4,8} = divide, else target width."""
    if resolution in (1, 2, 4, 8):
        return (round(orig_w / (resolution_scale * resolution)),
                round(orig_h / (resolution_scale * resolution)))
    if resolution == -1:
        down = orig_w / 1600 if orig_w > 1600 else 1
    else:
        down = orig_w / resolution
    scale = float(down) * float(resolution_scale)
    return int(orig_w / scale), int(orig_h / scale)


def _resize(arr: np.ndarray, w: int, h: int) -> np.ndarray:
    """[H, W] or [H, W, C] float32 -> the same at (h, w), area-averaged."""
    if arr.shape[1] == w and arr.shape[0] == h:
        return arr
    t = torch.from_numpy(np.ascontiguousarray(arr, np.float32))
    chw = t[None, None] if t.dim() == 2 else t.permute(2, 0, 1)[None]
    out = F.interpolate(chw, size=(h, w), mode="area")[0]
    out = out[0] if t.dim() == 2 else out.permute(1, 2, 0)
    return out.numpy()


def _to_float(img: np.ndarray) -> np.ndarray:
    scale = 65535.0 if img.dtype == np.uint16 else 255.0
    return img.astype(np.float32) / scale


def _rgb_or_rgba(img: np.ndarray) -> np.ndarray:
    """Decoded pixels -> [H, W, 3] or [H, W, 4] (what PIL's
    convert("RGBA" if RGBA else "RGB") gives the JAX loader)."""
    if img.ndim == 2:
        return np.repeat(img[..., None], 3, axis=2)
    if img.shape[2] == 2:                        # gray + alpha -> RGB
        return np.repeat(img[..., :1], 3, axis=2)
    return img


def load_view(info: CameraInfo, resolution: int = -1,
              resolution_scale: float = 1.0, train_test_exp: bool = False,
              is_test_dataset: bool = False, image_idx: int = 0,
              trans=np.array([0.0, 0.0, 0.0]), scale: float = 1.0
              ) -> ViewBatch:
    """Decode one view into a host-side ViewBatch (numpy leaves)."""
    img = _rgb_or_rgba(read_image(info.image_path))
    orig_h, orig_w = img.shape[:2]
    w, h = _resolution(orig_w, orig_h, resolution, resolution_scale)

    rgba = _resize(_to_float(img), w, h)
    rgb = rgba[..., :3]

    if info.mask_path:
        mask_img = read_image(info.mask_path).astype(np.float32)
        if mask_img.ndim == 3:
            mask_img = mask_img[..., 0]
        alpha = _resize(mask_img / max(mask_img.max(), 1.0), w, h)[None]
    elif rgba.shape[-1] == 4:
        alpha = rgba[..., 3][None]
    else:
        alpha = np.ones((1, h, w), np.float32)

    # Exposure-eval protocol: mask out one half of test views.
    if train_test_exp and info.is_test:
        if is_test_dataset:
            alpha[..., : w // 2] = 0
        else:
            alpha[..., w // 2:] = 0

    gt = np.clip(rgb, 0.0, 1.0).transpose(2, 0, 1) * alpha

    invdepth = np.zeros((1, h, w), np.float32)
    depth_mask = np.zeros((1, h, w), np.float32)
    depth_reliable = False
    dp = info.depth_params
    if info.depth_path and dp is not None and dp.get("scale", 0) > 0:
        raw = read_image(info.depth_path).astype(np.float32) / float(2 ** 16)
        if raw.ndim == 3:
            # OpenCV reads color as BGR and the reference keeps channel 0:
            # the last channel in RGB order.
            raw = raw[..., 2]
        scaled = _resize(raw * dp["scale"] + dp["offset"], w, h)
        scaled[scaled < 0] = 0
        invdepth = scaled[None]
        med = dp.get("med_scale", 0.0)
        if med > 0 and (dp["scale"] < 0.2 * med or dp["scale"] > 5 * med):
            depth_mask = np.zeros_like(alpha)
        else:
            depth_mask = alpha.copy()
            depth_reliable = True

    cam = make_camera(info.R, info.T, info.fovx, info.fovy, w, h,
                      primx=info.primx, primy=info.primy,
                      trans=trans, scale=scale)
    return ViewBatch(
        camera=cam,
        gt_image=gt.astype(np.float32),
        alpha_mask=alpha.astype(np.float32),
        invdepth=invdepth.astype(np.float32),
        depth_mask=depth_mask.astype(np.float32),
        depth_reliable=np.asarray(depth_reliable),
        image_idx=np.asarray(image_idx, np.int64),
    )


class ViewStream:
    """Endless shuffled prefetching iterator over training views.

    Epochs are re-shuffled with a seeded numpy generator; ``prefetch``
    decode jobs run ahead on a thread pool.
    """

    def __init__(self, infos: Sequence[CameraInfo], resolution: int = -1,
                 train_test_exp: bool = False, num_workers: int = 8,
                 prefetch: int = 8, seed: int = 0, shuffle: bool = True,
                 keep_fn=None):
        self.infos = list(infos)
        self.resolution = resolution
        self.train_test_exp = train_test_exp
        self.rng = np.random.default_rng(seed)
        self.shuffle = shuffle
        self.pool = cf.ThreadPoolExecutor(max_workers=num_workers)
        self.prefetch = prefetch
        # keep_fn(position) -> bool over the GLOBAL consumption sequence:
        # with a shared seed every process walks the same shuffled
        # sequence and loads only its own positions (multi-process data
        # parallelism; skipped views are never decoded).
        self.keep_fn = keep_fn
        self._queue: List[cf.Future] = []
        self._perm: List[int] = []
        self._pos = 0
        self._gpos = 0

    def _next_index(self) -> int:
        while True:
            if self._pos >= len(self._perm):
                idx = np.arange(len(self.infos))
                if self.shuffle:
                    self.rng.shuffle(idx)
                self._perm = list(idx)
                self._pos = 0
            i = self._perm[self._pos]
            self._pos += 1
            pos = self._gpos
            self._gpos += 1
            if self.keep_fn is None or self.keep_fn(pos):
                return int(i)

    def _submit(self):
        i = self._next_index()
        self._queue.append(self.pool.submit(
            load_view, self.infos[i], self.resolution, 1.0,
            self.train_test_exp, False, i))

    def __iter__(self):
        return self

    def __next__(self) -> ViewBatch:
        while len(self._queue) < self.prefetch:
            self._submit()
        fut = self._queue.pop(0)
        return fut.result()

    def close(self):
        self.pool.shutdown(wait=False, cancel_futures=True)
