"""The image work of preprocessing and of the view loader, in place of the
OpenCV calls of the JAX package (``h3dgs_tpu/preprocess/{chunk,
depth_scale,masks}.py``, ``h3dgs_tpu/scene/loader.py``).

The card's machine has neither OpenCV nor PIL, so the port decodes through
its own PNG codec (``io/image.py``) and JPEG decoder (``io/jpeg.py``) and
computes with torch on any device, or in host C++. Each function keeps the
contract of the OpenCV call it replaces, down to the integer arithmetic and
float32 rounding, so that a decision taken on its result (a blurred view, a
mask pixel, a training target) is the one the JAX package takes.

Loaders return numpy arrays in OpenCV's channel order (BGR, BGRA), so an
index that the JAX code takes on ``cv2.imread``'s array takes the same
channel here. A missing file gives ``None``, as ``cv2.imread`` does; a file
that cannot be decoded raises with its name (``cv2.imread`` would give
``None`` and the caller would read it as missing). PNG follows OpenCV's
libpng decoder exactly on every kind (``io/image.as_opencv``: gray below
8 bits scaled to 0..255, palette to BGR, or BGRA with ``tRNS``; RGB with
``tRNS`` gains alpha, gray does not; gray+alpha as 4 channels), and JPEG
its libjpeg-turbo decoder (the kinds ``io/jpeg.py`` reads), including
OpenCV's EXIF rotation: ``imread`` turns a JPEG upright by its Orientation
tag in every mode but ``IMREAD_UNCHANGED``. Another format goes through
PIL where it is installed, and its pixels may differ from OpenCV's
decoder.

``resize_area`` is ``cv2.resize(..., INTER_AREA)`` on float32, bit for bit
but at integer shrink factors (within 1e-6 there): the taps of OpenCV's
area table (or, where an axis grows, of its linear filter with area
coefficients) applied to columns and then rows in host C++
(``csrc/resize_area.cpp``, built by ``native.build``; the GIL released),
or in torch (the plain version) where no C++ compiler is found.
"""
from __future__ import annotations

import ctypes
import os
import threading
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from ..io.exif import orientation
from ..io.image import read_image
from ..io.jpeg import UnsupportedJpeg, read_jpeg

_DBL_EPSILON = float(np.finfo(np.float64).eps)
RESIZE_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
    "resize_area.cpp")
# The C++ tap filter once loaded; False where no C++ compiler is found.
_NATIVE = None
_NATIVE_LOCK = threading.Lock()


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
    return read_image(path, "opencv"), jpeg


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


def _area_taps(src: int, dst: int, scale: float):
    """OpenCV's ``computeResizeAreaTab`` along one axis of a shrink:
    destination pixel d covers source ``[d * scale, d * scale + scale)``;
    a partial source pixel at either end (a sliver) weighs its covered
    share, and is dropped when that share is 1e-3 or less, so the weights
    of a pixel need not sum to 1. Returns [dst, K] source indices and
    float32 weights, taps in source order; a pixel with fewer than K taps
    ends with taps of weight 0 on the last source pixel."""
    fsx1 = np.arange(dst, dtype=np.float64) * scale
    fsx2 = fsx1 + scale
    cell = np.minimum(scale, src - fsx1)
    sx2 = np.minimum(np.floor(fsx2), src - 1)
    sx1 = np.minimum(np.ceil(fsx1), sx2)
    left = sx1 - fsx1 > 1e-3
    right = fsx2 - sx2 > 1e-3
    first = (sx1 - left).astype(np.int64)
    count = left + (sx2 - sx1).astype(np.int64) + right
    j = np.arange(count.max())[None]
    pos = first[:, None] + j                       # the taps' source pixels
    w = np.where(pos < sx2[:, None], 1.0 / cell[:, None], 0.0)
    w = np.where(left[:, None] & (j == 0),
                 ((sx1 - fsx1) / cell)[:, None], w)
    w = np.where(right[:, None] & (pos == sx2[:, None]),
                 (np.minimum(np.minimum(fsx2 - sx2, 1.0), cell)
                  / cell)[:, None], w)
    w = np.where(j < count[:, None], w, 0.0)
    return np.minimum(pos, src - 1), w.astype(np.float32)


def _linear_taps(src: int, dst: int, scale: float):
    """The taps of OpenCV's INTER_AREA when an axis grows: its linear
    filter with area coefficients. Destination pixel d reads source
    ``sx = floor(d * scale)`` and the next one with weights ``1 - fx`` and
    ``fx``, ``fx = float32((d + 1) - (sx + 1) * dst / src)`` (0 if not
    positive, else its fraction); at either border ``fx = 0`` and ``sx``
    is clamped into the image. Returns [dst, 2] indices and float32
    weights."""
    d = np.arange(dst, dtype=np.float64)
    sx = np.floor(d * scale)
    fx = ((d + 1) - (sx + 1) * (dst / src)).astype(np.float32)
    fx = np.where(fx <= 0, np.float32(0), fx - np.floor(fx))
    border = (sx < 0) | (sx >= src - 1)
    fx = np.where(border, np.float32(0), fx).astype(np.float32)
    sx = np.clip(sx, 0, src - 1).astype(np.int64)
    idx = np.stack([sx, np.minimum(sx + 1, src - 1)], 1)
    return idx, np.stack([np.float32(1) - fx, fx], 1)


def _apply_taps(x: torch.Tensor, dim: int, idx: np.ndarray,
                w: np.ndarray) -> torch.Tensor:
    """Sum over taps k, in order and in float32, of ``x`` gathered at
    ``idx[:, k]`` along ``dim`` times ``w[:, k]``: one product and one add
    each, as OpenCV accumulates."""
    shape = [1] * x.dim()
    shape[dim] = -1
    idx = torch.from_numpy(idx).to(x.device)
    w = torch.from_numpy(w).to(x.device)
    out = None
    for k in range(idx.shape[1]):
        term = x.index_select(dim, idx[:, k]) * w[:, k].reshape(shape)
        out = term if out is None else out.add_(term)
    return out


def _native_resize():
    """The C++ tap filter (a ctypes function), built and loaded at first
    use, or ``None`` where no C++ compiler is found."""
    global _NATIVE
    with _NATIVE_LOCK:
        if _NATIVE is None:
            from .. import native
            if native.compiler() is None:
                _NATIVE = False
            else:
                lib = ctypes.CDLL(native.build(RESIZE_SOURCE,
                                               "libh3dgs_resize",
                                               openmp=False))
                fn = lib.h3dgs_resize_taps
                fn.restype = ctypes.c_int64
                fn.argtypes = ([ctypes.c_void_p] + [ctypes.c_int64] * 3
                               + [ctypes.c_void_p, ctypes.c_void_p,
                                  ctypes.c_int64, ctypes.c_int64] * 2
                               + [ctypes.c_void_p])
                _NATIVE = fn
    return _NATIVE or None


def _filter(img: torch.Tensor, xtaps, ytaps) -> torch.Tensor:
    """Columns through ``xtaps``, then rows through ``ytaps``: in C++
    (``csrc/resize_area.cpp``, one pass over the image, the GIL released)
    for a tensor on the CPU where a compiler is found, else by
    ``_apply_taps`` (the plain version, on any device)."""
    fn = _native_resize() if img.device.type == "cpu" else None
    if fn is None:
        return _apply_taps(_apply_taps(img, 1, *xtaps), 0, *ytaps)
    src = img.contiguous()
    sh, sw = src.shape[:2]
    cn = src[0, 0].numel()
    (xi, xw), (yi, yw) = [(np.ascontiguousarray(i, np.int64),
                           np.ascontiguousarray(w, np.float32))
                          for i, w in (xtaps, ytaps)]
    out = torch.empty((len(yi), len(xi)) + tuple(src.shape[2:]),
                      dtype=torch.float32)
    bad = fn(src.data_ptr(), sh, sw, cn,
             xi.ctypes.data, xw.ctypes.data, xi.shape[0], xi.shape[1],
             yi.ctypes.data, yw.ctypes.data, yi.shape[0], yi.shape[1],
             out.data_ptr())
    if bad:
        raise ValueError("resize_area: a tap lies outside the image")
    return out


def resize_area(img: torch.Tensor, h: int, w: int) -> torch.Tensor:
    """``cv2.resize(img, (w, h), interpolation=cv2.INTER_AREA)`` on [H, W]
    or [H, W, C] float32, with OpenCV's scale ``1 / (dst / src)`` per axis
    in float64. Three branches, as ``modules/imgproc/src/resize.cpp``:

    - both axes shrink by integer factors: the block mean (torch's area
      pooling, within 1e-6 of OpenCV's sum times the reciprocal);
    - both axes shrink, one by another factor: ``_area_taps``, applied to
      columns and then to rows, in float32 (equal to OpenCV);
    - either axis grows: ``_linear_taps`` on both axes, likewise.

    A destination pixel reads at most ``ceil(scale) + 1`` source pixels a
    pass (no dense [dst, src] product)."""
    if img.dtype != torch.float32 or img.dim() not in (2, 3):
        raise ValueError("resize_area: want [H, W] or [H, W, C] float32, "
                         f"got {tuple(img.shape)} {img.dtype}")
    src_h, src_w = img.shape[:2]
    if (src_h, src_w) == (h, w):
        return img
    sx, sy = 1.0 / (w / src_w), 1.0 / (h / src_h)
    if sx >= 1 and sy >= 1:
        if abs(sx - round(sx)) < _DBL_EPSILON and \
                abs(sy - round(sy)) < _DBL_EPSILON:
            chw = img[None, None] if img.dim() == 2 else \
                img.permute(2, 0, 1)[None]
            out = F.avg_pool2d(chw, (round(sy), round(sx)))[0]
            out = out[0] if img.dim() == 2 else out.permute(1, 2, 0)
            return out.contiguous()
        taps = _area_taps
    else:
        taps = _linear_taps
    return _filter(img, taps(src_w, w, sx), taps(src_h, h, sy))
