"""Streaming view loader: decode images on host threads, feed the card
(counterpart of ``h3dgs_tpu/scene/loader.py``).

A small thread pool decodes views ahead while the card trains on the
previous one; pixel preprocessing (resolution policy, alpha masking,
exposure-eval half-masking, mono-depth scaling + reliability) follows the
reference. Each file is read as the JAX loader reads it, by the port's own
decoders (``io/image.py``: PNG of every kind and the JPEG kinds of
``io/jpeg.py``, as stored, no EXIF rotation; other formats through PIL):

- the view as PIL's ``convert("RGBA" if mode == "RGBA" else "RGB")``
  gives it, divided by 255 (a 16-bit gray view is clipped at 255 by PIL,
  so it reads almost white: H22 in ``ROADMAP.md``; the port follows);
- the mask as ``np.asarray(PIL.Image.open(path))`` (1-bit -> 0/1, palette
  -> its indices), divided by its largest value;
- the depth map as ``cv2.imread(path, -1)`` (``imgproc.load_unchanged``:
  BGR(A) order, gray+alpha as 4 channels, channel 0 kept after the
  resize); a missing depth file leaves the view without depth, and a file
  that exists but cannot be decoded raises with its name.

All three are resized on the host by ``imgproc.resize_area``, OpenCV's
INTER_AREA, equal to ``cv2.resize`` bit for bit at every factor but
integer shrinks (within 1e-6 there).
"""
from __future__ import annotations

import concurrent.futures as cf
from typing import List, Sequence

import numpy as np
import torch

from ..io.image import read_image
from ..preprocess.imgproc import load_unchanged, resize_area
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
    """[H, W] or [H, W, C] float32 -> the same at (h, w), by OpenCV's
    INTER_AREA (``resize_area``)."""
    return resize_area(torch.from_numpy(
        np.ascontiguousarray(arr, np.float32)), h, w).numpy()


def load_view(info: CameraInfo, resolution: int = -1,
              resolution_scale: float = 1.0, train_test_exp: bool = False,
              is_test_dataset: bool = False, image_idx: int = 0,
              trans=np.array([0.0, 0.0, 0.0]), scale: float = 1.0
              ) -> ViewBatch:
    """Decode one view into a host-side ViewBatch (numpy leaves)."""
    img = read_image(info.image_path, "rgb")
    orig_h, orig_w = img.shape[:2]
    w, h = _resolution(orig_w, orig_h, resolution, resolution_scale)

    rgba = _resize(img.astype(np.float32) / 255.0, w, h)
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
        raw = load_unchanged(info.depth_path)
        if raw is not None:
            raw = raw.astype(np.float32) / float(2 ** 16)
            scaled = _resize(raw * dp["scale"] + dp["offset"], w, h)
            if scaled.ndim == 3:
                scaled = scaled[..., 0]
            scaled[scaled < 0] = 0
            invdepth = scaled[None]
            med = dp.get("med_scale", 0.0)
            if med > 0 and (dp["scale"] < 0.2 * med
                            or dp["scale"] > 5 * med):
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
