"""The image work of preprocessing, in place of the OpenCV calls of the JAX
package (``h3dgs_tpu/preprocess/{chunk,depth_scale,masks}.py``).

The card's machine has neither OpenCV nor PIL, so the port decodes through
its own PNG codec (``io/image.py``) and JPEG decoder (``io/jpeg.py``) and
computes with torch on any device. Each function keeps the contract of the
OpenCV call it replaces, down to the integer arithmetic, so that a decision
taken on its result (a blurred view, a mask pixel) is the one the JAX
package takes.

Loaders return numpy arrays in OpenCV's channel order (BGR, BGRA), so an
index that the JAX code takes on ``cv2.imread``'s array takes the same
channel here. A missing file gives ``None``, as ``cv2.imread`` does; a file
that cannot be decoded raises with its name (``cv2.imread`` would give
``None`` and the caller would read it as missing). PNG follows OpenCV's
libpng decoder exactly and JPEG its libjpeg-turbo decoder (the kinds
``io/jpeg.py`` reads), including OpenCV's EXIF rotation: ``imread`` turns a
JPEG upright by its Orientation tag in every mode but
``IMREAD_UNCHANGED``. Another format goes through PIL where it is
installed, and its pixels may differ from OpenCV's decoder.
"""
from __future__ import annotations

import os
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..io.exif import orientation
from ..io.image import read_image
from ..io.jpeg import UnsupportedJpeg, read_jpeg


def _decode(path: str, gray: bool = False
            ) -> Tuple[Optional[np.ndarray], bool]:
    """(``read_image`` ([H, W] or [H, W, C] in RGB order), or ``None`` for a
    missing file; whether the file is a JPEG). With ``gray``, a JPEG is
    decoded to gray as libjpeg does for OpenCV (``io/jpeg.py``)."""
    if not os.path.isfile(path):
        return None, False
    with open(path, "rb") as f:
        jpeg = f.read(2) == b"\xff\xd8"
    if jpeg and gray:
        try:
            return read_jpeg(path, gray=True), True
        except UnsupportedJpeg:
            pass                        # read_image: through PIL, or raise
    return read_image(path), jpeg


def _upright(img: np.ndarray, path: str) -> np.ndarray:
    """OpenCV's EXIF transform of a JPEG: orientations 5-8 transpose the
    image, then 2 and 6 mirror its columns, 4 and 8 its rows, 3 and 7
    both; other values leave it as stored."""
    o = orientation(path)
    if not 1 <= o <= 8:
        return img
    if o >= 5:
        img = img.swapaxes(0, 1)
    flip = (o - 1) % 4
    if flip in (1, 2):
        img = img[:, ::-1]
    if flip in (2, 3):
        img = img[::-1]
    return np.ascontiguousarray(img)


def _to8(img: np.ndarray) -> np.ndarray:
    """16-bit samples to 8 by keeping the high byte (libpng's
    ``png_set_strip_16``)."""
    return (img >> 8).astype(np.uint8) if img.dtype == np.uint16 else img


def load_unchanged(path: str) -> Optional[np.ndarray]:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)``: the file's depth (uint8
    or uint16); gray stays [H, W]; gray+alpha becomes 4 channels (gray,
    gray, gray, alpha); RGB becomes BGR and RGBA becomes BGRA. A JPEG is
    not turned by its EXIF orientation."""
    img, _ = _decode(path)
    if img is None or img.ndim == 2:
        return img
    order = {2: [0, 0, 0, 1], 3: [2, 1, 0], 4: [2, 1, 0, 3]}[img.shape[2]]
    return np.ascontiguousarray(img[..., order])


def load_bgr8(path: str) -> Optional[np.ndarray]:
    """``cv2.imread(path)`` (``IMREAD_COLOR``): [H, W, 3] uint8 in BGR
    order. 16-bit samples keep their high byte, alpha is dropped, gray is
    repeated into the three channels; a JPEG is turned upright by its EXIF
    orientation."""
    img, jpeg = _decode(path)
    if img is None:
        return None
    if jpeg:
        img = _upright(img, path)
    img = _to8(img)
    if img.ndim == 2:
        img = img[..., None]
    order = {1: [0, 0, 0], 2: [0, 0, 0], 3: [2, 1, 0],
             4: [2, 1, 0]}[img.shape[2]]
    return np.ascontiguousarray(img[..., order])


def load_gray8(path: str) -> Optional[np.ndarray]:
    """``cv2.imread(path, cv2.IMREAD_GRAYSCALE)``: [H, W] uint8. Colour is
    reduced by libpng's ``png_set_rgb_to_gray(0.299, 0.587)`` at the file's
    depth: ``(9797 R + 19234 G + 3737 B) >> 15`` on 8-bit samples and the
    same plus 16384 before the shift on 16-bit ones (then the high byte);
    a pixel with R = G = B keeps its value. Alpha is dropped. A JPEG is
    reduced by libjpeg instead (its Y plane; ``io/jpeg.py``) and turned
    upright by its EXIF orientation."""
    img, jpeg = _decode(path, gray=True)
    if img is None:
        return None
    if jpeg:
        img = _upright(img, path)
    if img.ndim == 3 and img.shape[2] >= 3:
        r, g, b = (img[..., i].astype(np.int64) for i in range(3))
        rnd = 16384 if img.dtype == np.uint16 else 0
        gray = (9797 * r + 19234 * g + 3737 * b + rnd) >> 15
        img = np.where((r == g) & (g == b), r, gray).astype(img.dtype)
    elif img.ndim == 3:
        img = img[..., 0]
    return _to8(img)


def gray_bgr2gray(u8: torch.Tensor) -> torch.Tensor:
    """``cv2.cvtColor(u8, cv2.COLOR_BGR2GRAY)`` on [H, W, 3] uint8 BGR:
    OpenCV's fixed point ``(9798 R + 19235 G + 3735 B + 16384) >> 15``,
    exactly (the 14-bit and 16-bit constants and a rounded float form are
    each off by one on some pixels)."""
    x = u8.to(torch.int32)
    gray = (9798 * x[..., 2] + 19235 * x[..., 1] + 3735 * x[..., 0]
            + 16384) >> 15
    return gray.to(torch.uint8)


def laplacian_var(gray: torch.Tensor) -> float:
    """``cv2.Laplacian(gray, cv2.CV_32F).var()`` on [H, W] uint8: the
    4-neighbour kernel over a reflect-101 border (torch's ``reflect``; a
    side of one pixel repeats it), whose values are exact integers, then
    the population variance in float64 (numpy's float32 ``var`` of the JAX
    package agrees within 1e-5 relative)."""
    x = gray.to(torch.float32)[None, None]
    h, w = gray.shape
    x = F.pad(x, (0, 0, 1, 1), mode="reflect" if h > 1 else "replicate")
    x = F.pad(x, (1, 1, 0, 0), mode="reflect" if w > 1 else "replicate")
    x = x[0, 0]
    lap = (x[:-2, 1:-1] + x[2:, 1:-1] + x[1:-1, :-2] + x[1:-1, 2:]
           - 4 * x[1:-1, 1:-1])
    return float(lap.to(torch.float64).var(unbiased=False))


def erode(binary: torch.Tensor, k: int) -> torch.Tensor:
    """``cv2.erode(binary, np.ones((k, k), np.uint8))`` on [H, W] uint8:
    the minimum over the k x k window anchored at (k // 2, k // 2), that
    is k // 2 pixels before and k - 1 - k // 2 after on each axis. OpenCV's
    default border never erodes (it reads as the largest value). ``k <= 0``
    returns the input: the JAX masks skip the call then (``cv2.erode``
    would take an empty kernel as 3 x 3)."""
    if k <= 0:
        return binary
    lo, hi = k // 2, k - 1 - k // 2
    x = F.pad(-binary.to(torch.float32)[None, None], (lo, hi, lo, hi),
              value=-256.0)
    return (-F.max_pool2d(x, k, stride=1))[0, 0].to(binary.dtype)


def sample_bilinear_replicate(img: torch.Tensor, x: torch.Tensor,
                              y: torch.Tensor) -> torch.Tensor:
    """``cv2.remap(img, x, y, cv2.INTER_LINEAR,
    borderMode=cv2.BORDER_REPLICATE)`` for a [H, W] float32 image and [N]
    float32 coordinates: plain bilinear weights with the four neighbours'
    indices clamped into the image (OpenCV does not quantise float maps to
    1/32 here; it agrees within 2e-7). Returns [N] float32."""
    h, w = img.shape
    x0f = torch.floor(x)
    y0f = torch.floor(y)
    fx = x - x0f
    fy = y - y0f
    x0 = x0f.to(torch.int64)
    y0 = y0f.to(torch.int64)
    xa, xb = x0.clamp(0, w - 1), (x0 + 1).clamp(0, w - 1)
    ya, yb = y0.clamp(0, h - 1), (y0 + 1).clamp(0, h - 1)
    top = (1 - fx) * img[ya, xa] + fx * img[ya, xb]
    bot = (1 - fx) * img[yb, xa] + fx * img[yb, xb]
    return (1 - fy) * top + fy * bot


def resize_nearest(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_NEAREST)`` on
    [H, W, ...]: source index ``min(floor(i * (1 / (dst / src))), src -
    1)`` on each axis, in float64 as OpenCV computes it."""
    def index(dst, src):
        i = torch.arange(dst, dtype=torch.float64, device=img.device)
        return torch.floor(i * (1.0 / (dst / src))).to(
            torch.int64).clamp(max=src - 1)

    return img[index(h, img.shape[0])][:, index(w, img.shape[1])]
