"""Image files: a PNG codec of its own (zlib + numpy), the JPEG decoder
of ``io/jpeg.py`` and encoder of ``io/jpeg_encode.py``, and PIL for other
formats where it is installed.

The JAX package decodes with PIL and OpenCV; the port reads every image
through ``read_image``, which gives what the caller's JAX counterpart
sees (its ``contract``: PIL's array, PIL's RGB / RGBA conversion, or
``cv2.imread``'s unchanged read in RGB order). PNG is read by this module,
every kind the specification allows: gray at 1, 2, 4, 8 and 16 bits, RGB,
gray+alpha and RGBA at 8 and 16, palette at 1, 2, 4 and 8 bits with
``PLTE`` and ``tRNS``, non-interlaced or Adam7, all five scanline filter
types. One decode (``decode_png_image``: samples, palette, transparency)
feeds the three contracts (``as_array``, ``as_rgb``, ``as_opencv``),
each bit-equal to PIL 12 or to OpenCV 5 over libpng 1.6 on every kind.
PNG is written by ``encode_png_samples`` (any of those kinds) and
``write_png`` (8 and 16 bits, filter None). JPEG is read by
``io/jpeg.py``: baseline, extended-sequential and progressive Huffman
JPEG, 8-bit, gray or three components, bit-equal to libjpeg-turbo's
decode (PIL's and OpenCV's), never through PIL; and written by
``io/jpeg_encode.py``, bit-equal to ``cv2.imwrite``. A JPEG of another
kind (arithmetic, 12-bit, CMYK, progressive with unfinished scans) and
other formats go through PIL when it is importable; otherwise
``read_image`` raises an error naming the file and what it holds.

Undoing the scanline filters is a byte-serial loop (Average and Paeth
read the reconstructed left neighbour). It runs in C++
(``csrc/png_unfilter.cpp``, built at first use by ``native.build`` with
the host's compiler; the call releases the GIL, so decoding threads run
in parallel), and in numpy (``unfilter_plain``, the plain version) only
where no C++ compiler is found. A failed build raises. An Adam7 file is
seven sub-images, each unfiltered with its own row width; below 8 bits a
pixel, a row is ``ceil(width * bits / 8)`` bytes and the filters' left
neighbour is the byte before.
"""
from __future__ import annotations

import ctypes
import os
import struct
import threading
import zlib
from typing import NamedTuple, Optional

import numpy as np

from .jpeg import UnsupportedJpeg, read_jpeg
from .jpeg_encode import write_jpeg

PNG_SIGNATURE = b"\x89PNG\r\n\x1a\n"
# PNG colour type -> samples per pixel, and the bit depths it allows
_CHANNELS = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}
_DEPTHS = {0: (1, 2, 4, 8, 16), 2: (8, 16), 3: (1, 2, 4, 8), 4: (8, 16),
           6: (8, 16)}
# Adam7: (first row, first column, row step, column step) of each pass
_ADAM7 = ((0, 0, 8, 8), (0, 4, 8, 8), (4, 0, 8, 4), (0, 2, 4, 4),
          (2, 0, 4, 2), (0, 1, 2, 2), (1, 0, 2, 1))
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


def _unfilter(data: np.ndarray, height: int, row_bytes: int,
              bpp: int) -> np.ndarray:
    """Undo the per-scanline filters. ``data``: ``height`` rows of 1
    filter byte + ``row_bytes`` bytes; ``bpp``: the bytes of a pixel, the
    distance to the left neighbour (1 below 8 bits a pixel). Returns
    [height, row_bytes] uint8."""
    if data.size != height * (1 + row_bytes):
        raise ValueError(f"PNG data of {data.size} bytes, want "
                         f"{height} rows of {1 + row_bytes}")
    fn = _native_unfilter()
    if fn is None:
        return unfilter_plain(data, height, row_bytes, bpp)
    data = np.ascontiguousarray(data, np.uint8)
    out = np.empty((height, row_bytes), np.uint8)
    bad = fn(data.ctypes.data, height, row_bytes, bpp, out.ctypes.data)
    if bad == -2:
        raise ValueError(f"PNG pixels of {bpp} bytes are not read")
    if bad >= 0:
        raise ValueError(
            f"bad PNG filter type {int(data[bad * (1 + row_bytes)])}")
    return out


def unfilter_plain(data: np.ndarray, height: int, row_bytes: int,
                   bpp: int) -> np.ndarray:
    """``_unfilter`` in numpy: a vector operation per row where only
    None / Sub / Up occur, else a sweep over anti-diagonals."""
    width = row_bytes // bpp
    rows = data.reshape(height, 1 + row_bytes)
    ftype = rows[:, 0]
    filt = rows[:, 1:].astype(np.int32)
    if ftype.max(initial=0) > 4:
        raise ValueError(f"bad PNG filter type {int(ftype.max())}")
    out = np.zeros((height, row_bytes), np.int32)
    if ftype.max(initial=0) <= 2:
        # None / Sub / Up only: each row is one vector operation.
        prev = np.zeros(row_bytes, np.int32)
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
    return out.reshape(height, row_bytes).astype(np.uint8)


class PngImage(NamedTuple):
    """One PNG file decoded once: what each caller's contract
    (``as_array``, ``as_rgb``, ``as_opencv``) is made from."""
    samples: np.ndarray     # [H, W, C] uint8 (depth <= 8, values as
    #                         stored: 0 .. 2**depth - 1) or uint16
    depth: int              # bits a sample: 1, 2, 4, 8 or 16
    ctype: int              # colour type: 0, 2, 3, 4 or 6
    palette: Optional[np.ndarray]   # [N, 3] uint8 (PLTE), colour type 3
    trns: Optional[np.ndarray]      # tRNS: the alpha of each palette
    #                                 entry ([M] uint8), or the key
    #                                 sample(s) of gray / RGB ([C] uint16)


def _unpack(rows: np.ndarray, width: int, depth: int,
            chans: int) -> np.ndarray:
    """[h, row_bytes] unfiltered bytes -> [h, width, chans] samples."""
    h = rows.shape[0]
    if depth == 16:
        img = rows.reshape(h, width * chans, 2).copy().view(">u2")
        return img.astype(np.uint16).reshape(h, width, chans)
    if depth == 8:
        return rows.reshape(h, width, chans)
    # 1, 2 or 4 bits (one channel): samples from the high bits down.
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    img = (rows[:, :, None] >> shifts) & np.uint8((1 << depth) - 1)
    return img.reshape(h, -1)[:, :width, None]


def decode_png_image(raw: bytes, path: str = "<bytes>") -> PngImage:
    """Decode PNG bytes of any kind the specification allows: gray at 1,
    2, 4, 8 and 16 bits, RGB, gray+alpha and RGBA at 8 and 16, palette at
    1, 2, 4 and 8 with ``PLTE`` and ``tRNS``, non-interlaced or Adam7
    (each of the seven passes a sub-image of its own, unfiltered with its
    own row width). ``path`` names the source in errors."""
    if raw[:8] != PNG_SIGNATURE:
        raise ValueError(f"{path}: not a PNG file")
    pos = 8
    idat = []
    ihdr = palette = trns = None
    while pos < len(raw):
        (length,) = struct.unpack_from(">I", raw, pos)
        kind = raw[pos + 4:pos + 8]
        body = raw[pos + 8:pos + 8 + length]
        pos += 12 + length
        if kind == b"IHDR":
            ihdr = struct.unpack(">IIBBBBB", body)
        elif kind == b"PLTE":
            palette = np.frombuffer(body, np.uint8)[:len(body) // 3 * 3]
        elif kind == b"tRNS":
            trns = body
        elif kind == b"IDAT":
            idat.append(body)
        elif kind == b"IEND":
            break
    if ihdr is None:
        raise ValueError(f"{path}: PNG without IHDR")
    width, height, depth, ctype, _comp, _filter, interlace = ihdr
    if depth not in _DEPTHS.get(ctype, ()):
        raise ValueError(f"{path}: PNG color type {ctype} at {depth} bits "
                         "is not supported")
    if interlace > 1:
        raise ValueError(f"{path}: PNG interlace method {interlace} is not "
                         "supported")
    if ctype == 3:
        if palette is None:
            raise ValueError(f"{path}: palette PNG without PLTE")
        palette = palette.reshape(-1, 3)
        if trns is not None:
            trns = np.frombuffer(trns, np.uint8)
    elif trns is not None and ctype in (0, 2):
        trns = np.frombuffer(trns[:len(trns) // 2 * 2], ">u2").astype(
            np.uint16)
    else:
        trns = None         # not allowed with an alpha channel: ignored
    chans = _CHANNELS[ctype]
    bpp = max(1, chans * depth // 8)
    data = np.frombuffer(zlib.decompress(b"".join(idat)), np.uint8)
    dtype = np.uint16 if depth == 16 else np.uint8
    if not interlace:
        row_bytes = (width * chans * depth + 7) // 8
        rows = _unfilter(data, height, row_bytes, bpp)
        return PngImage(_unpack(rows, width, depth, chans), depth, ctype,
                        palette, trns)
    img = np.zeros((height, width, chans), dtype)
    pos = 0
    for y0, x0, dy, dx in _ADAM7:
        pw = max(0, (width - x0 + dx - 1) // dx)
        ph = max(0, (height - y0 + dy - 1) // dy)
        if pw == 0 or ph == 0:
            continue                    # an empty pass holds no bytes
        row_bytes = (pw * chans * depth + 7) // 8
        n = ph * (1 + row_bytes)
        rows = _unfilter(data[pos:pos + n], ph, row_bytes, bpp)
        img[y0::dy, x0::dx] = _unpack(rows, pw, depth, chans)
        pos += n
    return PngImage(img, depth, ctype, palette, trns)


def read_png(path: str) -> np.ndarray:
    """Decode a PNG file (``decode_png``)."""
    with open(path, "rb") as f:
        return decode_png(f.read(), path)


def decode_png(raw: bytes, path: str = "<bytes>") -> np.ndarray:
    """The samples of PNG bytes as stored: [H, W] or [H, W, C] uint8 /
    uint16 (C = 2, 3 or 4: gray+alpha, RGB, RGBA); a palette image gives
    its indices, gray below 8 bits its values 0 .. 2**depth - 1. For what
    PIL or OpenCV give a caller, see ``as_array``, ``as_rgb`` and
    ``as_opencv``."""
    img = decode_png_image(raw, path).samples
    return img[..., 0] if img.shape[-1] == 1 else img


def _gray8(png: PngImage) -> np.ndarray:
    """Gray below 8 bits scaled to 0..255 (x 255, 85 or 17, as libpng's
    ``png_set_expand_gray_1_2_4_to_8`` and PIL's ``L;2`` / ``L;4``)."""
    return png.samples[..., 0] * np.uint8(255 // ((1 << png.depth) - 1))


def _high_byte(img: np.ndarray) -> np.ndarray:
    return (img >> 8).astype(np.uint8) if img.dtype == np.uint16 else img


def _palette(png: PngImage) -> np.ndarray:
    """[256, 4] uint8: the ``PLTE`` colours, black past their end (as
    libpng and PIL both read an index past the palette), with the alpha of
    ``tRNS`` (255 past its end)."""
    pal = np.zeros((256, 4), np.uint8)
    pal[:len(png.palette), :3] = png.palette[:256]
    pal[:, 3] = 255
    if png.trns is not None:
        pal[:len(png.trns), 3] = png.trns[:256]
    return pal


def as_array(png: PngImage) -> np.ndarray:
    """``np.asarray(PIL.Image.open(path))`` (PIL 12): 1-bit gray -> bool;
    2- and 4-bit gray -> uint8 0..255; 8-bit gray -> uint8, 16-bit gray ->
    uint16 (``I;16``); palette -> the indices; RGB / RGBA -> uint8, 16-bit
    keeping the high byte; gray+alpha -> [H, W, 2] at 8 bits, and at 16
    bits RGBA (gray repeated) keeping the high byte. ``tRNS`` is not
    applied."""
    s = png.samples
    if png.ctype == 0:
        if png.depth == 1:
            return s[..., 0].astype(bool)
        return _gray8(png) if png.depth < 8 else s[..., 0]
    if png.ctype == 3:
        return s[..., 0]
    if png.ctype == 4 and png.depth == 16:
        s = s[..., [0, 0, 0, 1]]
    return _high_byte(s)


def as_rgb(png: PngImage) -> np.ndarray:
    """``np.asarray(im.convert("RGBA" if im.mode == "RGBA" else "RGB"))``
    of ``im = PIL.Image.open(path)``, what the JAX loader reads a view as:
    [H, W, 3] uint8, or [H, W, 4] where PIL opens the file as ``RGBA``
    (RGBA at 8 or 16 bits, gray+alpha at 16). Palette -> the ``PLTE``
    colours, alpha dropped even with ``tRNS`` (``_palette``); gray and 8-bit
    gray+alpha -> gray repeated (alpha dropped); 16-bit gray ->
    ``min(v, 255)``, PIL's clip of ``I;16``; 16-bit colour keeps the high
    byte."""
    if png.ctype == 3:
        return _palette(png)[png.samples[..., 0], :3]
    if png.ctype == 0 and png.depth == 16:
        gray = np.minimum(png.samples[..., 0], 255).astype(np.uint8)
    elif png.ctype == 0 or (png.ctype == 4 and png.depth == 8):
        gray = _gray8(png) if png.depth < 8 else png.samples[..., 0]
    else:
        return as_array(png)
    return np.repeat(gray[..., None], 3, axis=2)


def as_opencv(png: PngImage) -> np.ndarray:
    """``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` (OpenCV 5 over libpng
    1.6) in RGB order, before OpenCV's swap to BGR: the file's depth,
    gray below 8 bits scaled to 0..255, gray [H, W] and gray+alpha
    [H, W, 2] as stored; palette -> the ``PLTE`` colours, and RGBA with
    ``tRNS`` (``_palette``); RGB with ``tRNS`` -> RGBA, alpha 0 where the pixel
    equals the key and the largest value elsewhere. Gray keeps no alpha
    from ``tRNS``."""
    s = png.samples
    if png.ctype == 0:
        return _gray8(png) if png.depth < 8 else s[..., 0]
    if png.ctype == 3:
        return _palette(png)[s[..., 0], :3 if png.trns is None else 4]
    if png.ctype == 2 and png.trns is not None:
        key = png.trns[:3] if png.depth == 16 else png.trns[:3] & 255
        top = np.iinfo(s.dtype).max
        alpha = np.where((s == key.astype(s.dtype)).all(-1), 0, top)
        return np.concatenate([s, alpha[..., None].astype(s.dtype)], -1)
    return s


def _chunk(kind: bytes, body: bytes) -> bytes:
    return (struct.pack(">I", len(body)) + kind + body
            + struct.pack(">I", zlib.crc32(kind + body) & 0xffffffff))


def _filter_rows(raw: np.ndarray, bpp: int, types) -> np.ndarray:
    """Rows of unfiltered bytes [h, n] -> [h, 1 + n] filtered, row r with
    filter ``types[r]`` (0-4), its left neighbour ``bpp`` bytes back."""
    if not any(types):
        return np.concatenate([np.zeros((raw.shape[0], 1), np.uint8), raw],
                              axis=1)
    raw = raw.astype(np.int32)
    rows = []
    for r, ft in enumerate(types):
        cur = raw[r]
        prev = raw[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ft == 4:
            pred = _paeth(left, prev, ul)
        else:
            pred = (0 * cur, left, prev, (left + prev) >> 1)[ft]
        rows.append(np.concatenate([[ft], (cur - pred) & 255]))
    return np.stack(rows).astype(np.uint8)


def _pack(samples: np.ndarray, depth: int) -> np.ndarray:
    """[h, w, c] samples -> [h, row_bytes] bytes (``_unpack``'s inverse)."""
    h = samples.shape[0]
    flat = samples.reshape(h, -1)
    if depth == 16:
        return flat.astype(">u2").view(np.uint8)
    if depth == 8:
        return flat.astype(np.uint8)
    per = 8 // depth
    n = flat.shape[1]
    padded = np.zeros((h, -(-n // per) * per), np.uint8)
    padded[:, :n] = flat
    shifts = np.arange(8 - depth, -1, -depth, dtype=np.uint8)
    return np.bitwise_or.reduce(
        padded.reshape(h, -1, per) << shifts, axis=2).astype(np.uint8)


def encode_png_samples(samples: np.ndarray, depth: int, ctype: int,
                       palette=None, trns=None, interlace: bool = False,
                       filters=(0,), level: int = 6) -> bytes:
    """PNG bytes of samples as stored (``decode_png_image``'s inverse):
    [H, W] or [H, W, C] values below ``2 ** depth`` of colour type
    ``ctype``; ``palette`` [N, 3] (``PLTE``); ``trns`` the alpha of each
    palette entry or the key sample(s) of gray / RGB (``tRNS``); Adam7
    passes when ``interlace``; row r of the stream (passes in order)
    filtered with ``filters[r % len(filters)]``."""
    samples = np.asarray(samples)
    if samples.ndim == 2:
        samples = samples[..., None]
    height, width, chans = samples.shape
    if chans != _CHANNELS.get(ctype) or depth not in _DEPTHS[ctype]:
        raise ValueError(f"encode_png_samples: {chans} samples a pixel at "
                         f"{depth} bits for colour type {ctype}")
    bpp = max(1, chans * depth // 8)
    parts, row = [], 0
    for y0, x0, dy, dx in (_ADAM7 if interlace else ((0, 0, 1, 1),)):
        sub = samples[y0::dy, x0::dx]
        if sub.size:
            types = [filters[(row + r) % len(filters)]
                     for r in range(sub.shape[0])]
            parts.append(_filter_rows(_pack(sub, depth), bpp, types)
                         .reshape(-1))
            row += sub.shape[0]
    chunks = [_chunk(b"IHDR", struct.pack(">IIBBBBB", width, height, depth,
                                          ctype, 0, 0, int(interlace)))]
    if palette is not None:
        chunks.append(_chunk(b"PLTE",
                             np.asarray(palette, np.uint8).tobytes()))
    if trns is not None:
        chunks.append(_chunk(b"tRNS", np.asarray(
            trns, np.uint8 if ctype == 3 else ">u2").tobytes()))
    chunks.append(_chunk(b"IDAT", zlib.compress(
        np.concatenate(parts).tobytes(), level)))
    return PNG_SIGNATURE + b"".join(chunks) + _chunk(b"IEND", b"")


def encode_png(img: np.ndarray, level: int = 6) -> bytes:
    """PNG bytes of [H, W] or [H, W, C] (C = 1..4) uint8 or uint16 samples
    (filter type None on every row)."""
    img = np.asarray(img)
    if img.dtype not in (np.uint8, np.uint16):
        raise ValueError(f"write_png: want uint8 or uint16, got {img.dtype}")
    chans = img.shape[2] if img.ndim == 3 else 1
    return encode_png_samples(img, 8 * img.dtype.itemsize,
                              {1: 0, 2: 4, 3: 2, 4: 6}[chans], level=level)


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


def read_png_image(path: str) -> PngImage:
    """Decode a PNG file (``decode_png_image``)."""
    with open(path, "rb") as f:
        return decode_png_image(f.read(), path)


# What read_image gives, by the contract its caller holds (the functions
# take a decoded PNG).
_CONTRACTS = {"array": as_array, "rgb": as_rgb, "opencv": as_opencv}


def read_image(path: str, contract: str = "array") -> np.ndarray:
    """Decode an image file to a numpy array ([H, W] or [H, W, C]), as
    ``contract`` names:

    - ``"array"``: ``np.asarray(PIL.Image.open(path))`` (``as_array``);
    - ``"rgb"``: that image converted to ``"RGBA"`` if its mode is RGBA,
      else to ``"RGB"`` (``as_rgb``), how the JAX loader reads a view;
    - ``"opencv"``: ``cv2.imread(path, cv2.IMREAD_UNCHANGED)`` in RGB
      order (``as_opencv``), not turned by a JPEG's EXIF orientation.

    PNG of every kind and JPEG (baseline, extended-sequential and
    progressive: the kinds ``io/jpeg.py`` reads; gray or RGB under every
    contract, gray repeated under ``"rgb"``) are decoded by the port; other
    formats and the JPEG kinds ``io/jpeg.py`` refuses need PIL."""
    if contract not in _CONTRACTS:
        raise ValueError(f"read_image: unknown contract {contract!r}")
    with open(path, "rb") as f:
        head = f.read(16)
    if head.startswith(PNG_SIGNATURE):
        return _CONTRACTS[contract](read_png_image(path))
    if head.startswith(b"\xff\xd8"):
        try:
            img = read_jpeg(path)
        except UnsupportedJpeg as e:
            unsupported = e
        else:
            if contract == "rgb" and img.ndim == 2:
                img = np.repeat(img[..., None], 3, axis=2)
            return img
    else:
        unsupported = ValueError(
            f"{path}: {_format(head)} image, and only PNG and JPEG are read "
            "without PIL (install Pillow or convert the dataset to PNG)")
    try:
        from PIL import Image
    except ImportError:
        raise unsupported from None
    with Image.open(path) as im:
        if contract == "rgb":
            return np.asarray(im.convert("RGBA" if im.mode == "RGBA"
                                         else "RGB"))
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
