"""Image files: a PNG codec of its own (zlib + numpy), the JPEG decoder
of ``io/jpeg.py`` and encoder of ``io/jpeg_encode.py``, and PIL for other
formats where it is installed.

The JAX package decodes with PIL and OpenCV; the port's loader reads every
image through ``read_image``. PNG is read and written by this module: 8- and 16-bit
samples, gray / gray+alpha / RGB / RGBA, non-interlaced, all five
scanline filter types on read. JPEG is read by ``io/jpeg.py``: baseline,
extended-sequential and progressive Huffman JPEG, 8-bit, gray or three
components, bit-equal to libjpeg-turbo's decode (PIL's and OpenCV's),
never through PIL; and written by ``io/jpeg_encode.py``, bit-equal to
``cv2.imwrite``. A JPEG of another kind (arithmetic, 12-bit, CMYK,
progressive with unfinished scans) and other formats go through PIL when
it is importable; otherwise ``read_image`` raises an error naming the file
and what it holds.

Undoing the scanline filters is a byte-serial loop (Average and Paeth
read the reconstructed left neighbour). It runs in C++
(``csrc/png_unfilter.cpp``, built at first use by ``native.build`` with
the host's compiler; the call releases the GIL, so decoding threads run
in parallel), and in numpy (``unfilter_plain``, the plain version) only
where no C++ compiler is found. A failed build raises.
"""
from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib

import numpy as np

from .jpeg import UnsupportedJpeg, read_jpeg
from .jpeg_encode import write_jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG color type -> samples per pixel (palette images are not read)
_CHANNELS = {0: 1, 2: 3, 4: 2, 6: 4}
UNFILTER_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
    "png_unfilter.cpp")
# The C++ routine once loaded; False where no C++ compiler is found.
_NATIVE = None
_NATIVE_LOCK = threading.Lock()


def _paeth(a, b, c):
    p = a + b - c
    pa = np.abs(p - a)
    pb = np.abs(p - b)
    pc = np.abs(p - c)
    return np.where((pa <= pb) & (pa <= pc), a, np.where(pb <= pc, b, c))


def _native_unfilter():
    """The C++ unfilter (a ctypes function), built and loaded at first
    use, or ``None`` where no C++ compiler is found."""
    global _NATIVE
    with _NATIVE_LOCK:
        if _NATIVE is None:
            from .. import native
            if native.compiler() is None:
                _NATIVE = False
            else:
                lib = ctypes.CDLL(native.build(UNFILTER_SOURCE,
                                               "libh3dgs_png", openmp=False))
                fn = lib.h3dgs_png_unfilter
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_void_p]
                _NATIVE = fn
    return _NATIVE or None


def _unfilter(data: np.ndarray, height: int, width: int,
              bpp: int) -> np.ndarray:
    """Undo the per-scanline filters. ``data``: the inflated stream,
    ``height`` rows of 1 filter byte + width * bpp bytes. Returns
    [height, width * bpp] uint8."""
    fn = _native_unfilter()
    if fn is None:
        return unfilter_plain(data, height, width, bpp)
    row_bytes = width * bpp
    if data.size != height * (1 + row_bytes):
        raise ValueError(f"PNG data of {data.size} bytes, want "
                         f"{height} rows of {1 + row_bytes}")
    data = np.ascontiguousarray(data, np.uint8)
    out = np.empty((height, row_bytes), np.uint8)
    bad = fn(data.ctypes.data, height, row_bytes, bpp, out.ctypes.data)
    if bad == -2:
        raise ValueError(f"PNG pixels of {bpp} bytes are not read")
    if bad >= 0:
        raise ValueError(
            f"bad PNG filter type {int(data[bad * (1 + row_bytes)])}")
    return out


def unfilter_plain(data: np.ndarray, height: int, width: int,
                   bpp: int) -> np.ndarray:
    """``_unfilter`` in numpy: a vector operation per row where only
    None / Sub / Up occur, else a sweep over anti-diagonals."""
    rows = data.reshape(height, 1 + width * bpp)
    ftype = rows[:, 0]
    filt = rows[:, 1:].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    out = np.zeros((height, width * bpp), np.int32)
    if ftype.max(initial=0) <= 2:
        # None / Sub / Up only: each row is one vector operation.
        prev = np.zeros(width * bpp, np.int32)
        for r in range(height):
            row = filt[r]
            if ftype[r] == 1:
                row = np.cumsum(row.reshape(width, bpp), axis=0).reshape(-1)
            elif ftype[r] == 2:
                row = row + prev
            prev = row & 255
            out[r] = prev
        return out.astype(np.uint8)
    # Average / Paeth read the reconstructed left, up and up-left pixels:
    # sweep anti-diagonals (row + column = t), all rows of a diagonal at
    # once, each with its own filter type.
    filt = filt.reshape(height, width, bpp)
    out = out.reshape(height, width, bpp)
    zero = np.zeros((1, bpp), np.int32)
    for t in range(height + width - 1):
        rs = np.arange(max(0, t - width + 1), min(height - 1, t) + 1)
        xs = t - rs
        has_l = (xs > 0)[:, None]
        has_u = (rs > 0)[:, None]
        a = np.where(has_l, out[rs, np.maximum(xs - 1, 0)], zero)
        b = np.where(has_u, out[np.maximum(rs - 1, 0), xs], zero)
        c = np.where(has_l & has_u,
                     out[np.maximum(rs - 1, 0), np.maximum(xs - 1, 0)], zero)
        ft = ftype[rs][:, None]
        pred = np.select([ft == 1, ft == 2, ft == 3, ft == 4],
                         [a, b, (a + b) >> 1, _paeth(a, b, c)], 0)
        out[rs, xs] = (filt[rs, xs] + pred) & 255
    return out.reshape(height, width * bpp).astype(np.uint8)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file (``decode_png``)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(raw: bytes, path: str = "<bytes>") -> np.ndarray:
    """Decode PNG bytes: [H, W] or [H, W, C] uint8 / uint16 (C = 2, 3 or
    4: gray+alpha, RGB, RGBA). ``path`` names the source in errors."""
    if raw[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = []
    ihdr = None
    while pos < len(raw):
        (length,) = struct.unpack_from(">I", raw, pos)
        kind = raw[pos + 4:pos + 8]
        body = raw[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _comp, _filter, interlace = ihdr
    if interlace:
        raise ValueError(f"{path}: interlaced PNG is not supported")
    if ctype not in _CHANNELS or depth not in (8, 16):
        raise ValueError(f"{path}: PNG color type {ctype} at {depth} bits "
                         "is not supported")
    chans = _CHANNELS[ctype]
    nbytes = depth // 8
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    px = _unfilter(data, height, width, chans * nbytes)
    if depth == 16:
        img = px.reshape(height, width * chans, 2).copy().view(">u2")
        img = img.astype(np.uint16).reshape(height, width, chans)
    else:
        img = px.reshape(height, width, chans)
    return img[..., 0] if img.shape[-1] == 1 else img


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xffffffff))


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of [H, W] or [H, W, C] (C = 1..4) uint8 or uint16 samples
    (filter type None on every row)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png: want uint8 or uint16, got {img.dtype}")
    if img.ndim == 2:
        img = img[..., None]
    height, width, chans = img.shape
    ctype = {1: 0, 2: 4, 3: 2, 4: 6}[chans]
    depth = 8 * img.dtype.itemsize
    px = img.astype(">u2") if depth == 16 else img
    rows = np.ascontiguousarray(px).view(np.uint8).reshape(height, -1)
    data = np.concatenate([np.zeros((height, 1), np.uint8), rows], axis=1)
    return b"".join((
        PNG_SIGNATURE,
        _chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth,
                                    ctype, 0, 0, 0)),
        _chunk(b"IDAT", zlib.compress(data.tobytes(), level)),
        _chunk(b"IEND", b"")))


def write_png(path: str, img: np.ndarray, level: int = 6) -> None:
    """Write ``encode_png(img, level)`` to ``path``."""
    body = encode_png(img, level)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(body)


def _format(head: bytes) -> str:
    if head[:4] in (b"II*\x00", b"MM\x00*"):
        return "TIFF"
    if head[:2] == b"BM":
        return "BMP"
    if head[:4] == b"RIFF" and head[8:12] == b"WEBP":
        return "WEBP"
    return "unknown"


def read_image(path: str) -> np.ndarray:
    """Decode an image file to a numpy array ([H, W] or [H, W, C], uint8 or
    uint16). PNG and JPEG (baseline, extended-sequential and progressive:
    the kinds ``io/jpeg.py`` reads) are decoded by the port; other formats
    and the JPEG kinds ``io/jpeg.py`` refuses need PIL."""
    with open(path, "rb") as f:
        head = f.read(16)
    if head.startswith(PNG_SIGNATURE):
        return read_png(path)
    if head.startswith(b"\xff\xd8"):
        try:
            return read_jpeg(path)
        except UnsupportedJpeg as e:
            unsupported = e
    else:
        unsupported = ValueError(
            f"{path}: {_format(head)} image, and only PNG and JPEG are read "
            "without PIL (install Pillow or convert the dataset to PNG)")
    try:
        from PIL import Image
    except ImportError:
        raise unsupported from None
    with Image.open(path) as im:
        return np.asarray(im)


def write_image(path: str, img: np.ndarray) -> None:
    """Write ``img`` (as ``write_png`` takes it, RGB order) in the format
    the path's extension names, with ``cv2.imwrite``'s defaults: PNG by
    this module at zlib level 1, JPEG (``.jpg``, ``.jpeg``; uint8 RGB or
    gray) by ``io/jpeg_encode.py`` at quality 95, the bytes ``cv2.imwrite``
    writes; other formats through PIL, raising without it."""
    lower = path.lower()
    if lower.endswith(".png"):
        write_png(path, img, level=1)
        return
    if lower.endswith((".jpg", ".jpeg")):
        write_jpeg(path, img, 95)
        return
    try:
        from PIL import Image
    except ImportError:
        raise ValueError(
            f"{path}: only PNG and JPEG are written without PIL (install "
            "Pillow or convert the dataset to PNG)") from None
    Image.fromarray(np.ascontiguousarray(img)).save(path, quality=95)
