"""JPEG encoding without PIL: baseline (SOF0) Huffman JPEG, 8-bit, RGB
as YCbCr 4:2:0 or one gray component, bit-equal to libjpeg-turbo's
compressor at the settings PIL's ``save(..., "JPEG", quality=q)`` and
OpenCV's ``imwrite`` / ``imencode`` use (both give the same bytes).

The JAX package encodes JPEG through PIL (the web viewer's frames) and
OpenCV (``masks black`` writing a ``.jpg`` back); the card's machine has
neither. The contract (H21 in ``ROADMAP.md``), libjpeg-turbo's:

- the stream: SOI, a JFIF 1.01 APP0 (density 1:1, no unit), one DQT per
  table, SOF0, the four standard Huffman tables of JPEG Annex K (no
  optimised tables) each in its own DHT, one interleaved SOS, EOI; no
  restart interval, no EXIF, no comment;
- colour: ``jccolor.c``'s 16-bit fixed-point RGB -> YCbCr; Y sampled
  2x2, Cb and Cr 1x1; gray is one component;
- ``jcsample.c``'s ``h2v2_downsample`` (the four samples' sum plus a bias
  alternating 1, 2 along the row, shifted by 2) on rows padded by edge
  replication on the right to twice the chroma width in blocks and at the
  bottom to an even count; each component's rows padded at the bottom by
  replicating its last row;
- ``jfdctint.c``'s ISLOW forward DCT of the samples minus 128, and
  quantisation dividing by 8 Q, rounded half away from zero;
- the tables of ``jpeg_set_quality(q, force_baseline=TRUE)``: q <= 0 is
  1 and q > 100 is 100, scale ``5000 / q`` below 50 and ``200 - 2q``
  from 50 on, each entry ``(basic * scale + 50) / 100`` clamped to
  1..255; ``quality=-1`` is PIL's default, 75;
- the dummy blocks of the last MCU column and row (blocks of the MCU grid
  past a component's own blocks) are all zero but for a DC copied from
  the block before them, as ``jccoefct.c`` makes them;
- Huffman coding with 0xFF 0x00 stuffing, the last byte padded with 1s.

The headers are written here; the samples' path (colour, downsampling,
DCT, quantisation, Huffman coding) runs in C++ (``csrc/jpeg_encode.cpp``,
built at first use by ``native.build`` with the host's compiler; the call
releases the GIL). A failed build raises. ``encode_jpeg_plain`` is the
same encoder in numpy, used where no C++ compiler is found and by the
tests.
"""
from __future__ import annotations

import ctypes
import os
import threading

import numpy as np

from .jpeg import MAX_DIMENSION, NATURAL

ENCODE_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
    "jpeg_encode.cpp")
# The C++ encoder once loaded; False where no C++ compiler is found.
_NATIVE = None
_NATIVE_LOCK = threading.Lock()

DEFAULT_QUALITY = 75            # PIL's quality=-1 and libjpeg's default
ZIGZAG = NATURAL[:64]           # zigzag index -> natural index

# JPEG Annex K.1: the basic quantisation tables, natural order.
LUMA_QUANT = np.array([
    16, 11, 10, 16, 24, 40, 51, 61, 12, 12, 14, 19, 26, 58, 60, 55,
    14, 13, 16, 24, 40, 57, 69, 56, 14, 17, 22, 29, 51, 87, 80, 62,
    18, 22, 37, 56, 68, 109, 103, 77, 24, 35, 55, 64, 81, 104, 113, 92,
    49, 64, 78, 87, 103, 121, 120, 101, 72, 92, 95, 98, 112, 100, 103, 99],
    np.int64)
CHROMA_QUANT = np.array([
    17, 18, 24, 47, 99, 99, 99, 99, 18, 21, 26, 66, 99, 99, 99, 99,
    24, 26, 56, 99, 99, 99, 99, 99, 47, 66, 99, 99, 99, 99, 99, 99]
    + [99] * 32, np.int64)

# JPEG Annex K.3: the standard Huffman tables as DHT bodies (16 code
# counts, then the symbols): DC luma, AC luma, DC chroma, AC chroma.
HUFF_TABLES = tuple(bytes.fromhex(h) for h in (
    "00010501010101010100000000000000000102030405060708090a0b",
    "0002010303020403050504040000017d01020300041105122131410613516107"
    "227114328191a1082342b1c11552d1f02433627282090a161718191a25262728"
    "292a3435363738393a434445464748494a535455565758595a63646566676869"
    "6a737475767778797a838485868788898a92939495969798999aa2a3a4a5a6a7"
    "a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9dae1e2"
    "e3e4e5e6e7e8e9eaf1f2f3f4f5f6f7f8f9fa",
    "00030101010101010101010000000000000102030405060708090a0b",
    "0002010204040304070504040001027700010203110405213106124151076171"
    "1322328108144291a1b1c109233352f0156272d10a162434e125f11718191a26"
    "2728292a35363738393a434445464748494a535455565758595a636465666768"
    "696a737475767778797a82838485868788898a92939495969798999aa2a3a4a5"
    "a6a7a8a9aab2b3b4b5b6b7b8b9bac2c3c4c5c6c7c8c9cad2d3d4d5d6d7d8d9da"
    "e2e3e4e5e6e7e8e9eaf2f3f4f5f6f7f8f9fa"))


def quality_scale(quality: int) -> int:
    """``jpeg_quality_scaling``, with PIL's -1 read as 75."""
    q = DEFAULT_QUALITY if quality == -1 else int(quality)
    q = min(max(q, 1), 100)
    return 5000 // q if q < 50 else 200 - 2 * q


def quant_tables(quality: int) -> np.ndarray:
    """[2, 64] uint16, natural order: luma and chroma tables of
    ``jpeg_set_quality(quality, force_baseline=TRUE)``."""
    scale = quality_scale(quality)
    t = (np.stack([LUMA_QUANT, CHROMA_QUANT]) * scale + 50) // 100
    return np.clip(t, 1, 255).astype(np.uint16)


def huffman_codes(table: bytes):
    """(code [256] uint32, length [256] uint8) of each symbol of a DHT
    body: the canonical codes of T.81 annex C (length 0: no code)."""
    code_of = np.zeros(256, np.uint32)
    size_of = np.zeros(256, np.uint8)
    code, k = 0, 16
    for length in range(1, 17):
        for _ in range(table[length - 1]):
            code_of[table[k]] = code
            size_of[table[k]] = length
            code += 1
            k += 1
        code <<= 1
    return code_of, size_of


# Each Huffman table's codes and lengths, [4, 256]: DC luma, AC luma, DC
# chroma, AC chroma.
CODES, SIZES = (np.stack(a) for a in zip(*map(huffman_codes, HUFF_TABLES)))


def _check(img) -> np.ndarray:
    img = np.ascontiguousarray(np.asarray(img))
    if img.dtype != np.uint8:
        raise ValueError(f"encode_jpeg: want uint8 samples, got {img.dtype}")
    if not (img.ndim == 2 or (img.ndim == 3 and img.shape[2] == 3)):
        raise ValueError(f"encode_jpeg: want [H, W, 3] RGB or [H, W] gray, "
                         f"got {list(img.shape)}")
    h, w = img.shape[:2]
    if not (1 <= h <= MAX_DIMENSION and 1 <= w <= MAX_DIMENSION):
        raise ValueError(f"encode_jpeg: {w}x{h} pixels (JPEG holds 1 to "
                         f"{MAX_DIMENSION} a side)")
    return img


def _segment(marker: int, body: bytes) -> bytes:
    return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") + body


def _headers(width: int, height: int, gray: bool, quant: np.ndarray) -> bytes:
    """SOI through SOS, as libjpeg's jcmarker.c writes them."""
    out = [b"\xff\xd8", _segment(0xE0, b"JFIF\x00\x01\x01\x00\x00\x01\x00\x01"
                                 b"\x00\x00")]
    n_tables = 1 if gray else 2
    for t in range(n_tables):
        out.append(_segment(0xDB, bytes([t]) + quant[t][ZIGZAG].astype(
            np.uint8).tobytes()))
    comps = [(1, 0x11, 0)] if gray else [(1, 0x22, 0), (2, 0x11, 1),
                                         (3, 0x11, 1)]
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") \
        + bytes([len(comps)]) + b"".join(bytes(c) for c in comps)
    out.append(_segment(0xC0, sof))
    for t in range(n_tables):
        out.append(_segment(0xC4, bytes([t]) + HUFF_TABLES[2 * t]))
        out.append(_segment(0xC4, bytes([0x10 | t]) + HUFF_TABLES[2 * t + 1]))
    sos = bytes([len(comps)]) + b"".join(
        bytes([cid, (tq << 4) | tq]) for cid, _, tq in comps) + b"\x00\x3f\x00"
    out.append(_segment(0xDA, sos))
    return b"".join(out)


def _native_encoder():
    """The C++ encoder (a ctypes function), built and loaded at first use,
    or ``None`` where no C++ compiler is found."""
    global _NATIVE
    with _NATIVE_LOCK:
        if _NATIVE is None:
            from .. import native
            if native.compiler() is None:
                _NATIVE = False
            else:
                lib = ctypes.CDLL(native.build(ENCODE_SOURCE,
                                               "libh3dgs_jpeg_encode",
                                               openmp=False))
                fn = lib.h3dgs_jpeg_encode
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_int64, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64]
                _NATIVE = fn
    return _NATIVE or None


def _capacity(width: int, height: int) -> int:
    """Bytes the entropy-coded data can take at most: per block a DC code
    and symbol (16 + 11 bits) and 63 AC codes and symbols (16 + 10 bits
    each), every byte stuffed."""
    blocks = (-(-width // 16) * -(-height // 16)) * 6
    return blocks * 2 * (27 + 63 * 26) // 8 + 64


def encode_jpeg(img, quality: int = DEFAULT_QUALITY) -> bytes:
    """JPEG bytes of ``img``, uint8 [H, W, 3] RGB (YCbCr 4:2:0) or [H, W]
    gray, at ``quality`` (libjpeg's 1-100; -1 is 75): what PIL's
    ``Image.fromarray(img).save(f, "JPEG", quality=quality)`` writes. Runs
    the C++ encoder, or ``encode_jpeg_plain`` where no C++ compiler is
    found."""
    img = _check(img)
    fn = _native_encoder()
    if fn is None:
        return encode_jpeg_plain(img, quality)
    height, width = img.shape[:2]
    gray = img.ndim == 2
    quant = quant_tables(quality)
    out = np.empty(_capacity(width, height), np.uint8)
    n = fn(img.ctypes.data, width, height, 1 if gray else 3,
           quant.ctypes.data, CODES.ctypes.data, SIZES.ctypes.data,
           out.ctypes.data, out.size)
    if n < 0:
        raise ValueError(f"JPEG encoder refused its arguments ({n})")
    return (_headers(width, height, gray, quant) + out[:n].tobytes()
            + b"\xff\xd9")


def write_jpeg(path: str, img, quality: int = 95) -> None:
    """Write ``encode_jpeg(img, quality)`` to ``path``; the default is
    ``cv2.imwrite``'s quality."""
    body = encode_jpeg(img, quality)
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "wb") as f:
        f.write(body)


# ---------------------------------------------------------------- plain ---

def _fix(x: float) -> int:
    return int(x * 65536 + 0.5)


def _rgb_to_ycc(img: np.ndarray):
    """jccolor.c's rgb_ycc_convert: three [H, W] int64 planes."""
    r, g, b = (img[..., i].astype(np.int64) for i in range(3))
    half, offset = 1 << 15, 128 << 16
    y = (_fix(0.299) * r + _fix(0.587) * g + _fix(0.114) * b + half) >> 16
    cb = (-_fix(0.16874) * r - _fix(0.33126) * g + _fix(0.5) * b
          + offset + half - 1) >> 16
    cr = (_fix(0.5) * r - _fix(0.41869) * g - _fix(0.08131) * b
          + offset + half - 1) >> 16
    return y, cb, cr


def _pad(x: np.ndarray, rows: int, cols: int) -> np.ndarray:
    """Edge replication at the bottom and the right up to [rows, cols]."""
    return np.pad(x, ((0, rows - x.shape[0]), (0, cols - x.shape[1])),
                  mode="edge")


def _downsample_h2v2(x: np.ndarray, out_cols: int) -> np.ndarray:
    """jcsample.c's h2v2_downsample to ``out_cols`` columns, rows padded
    to an even count first."""
    x = _pad(x, x.shape[0] + x.shape[0] % 2, 2 * out_cols)
    s = x[0::2, 0::2] + x[0::2, 1::2] + x[1::2, 0::2] + x[1::2, 1::2]
    bias = np.where(np.arange(out_cols) % 2 == 0, 1, 2)
    return (s + bias) >> 2


_C = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
          f1175=9633, f1501=12299, f1847=15137, f1961=16069, f2053=16819,
          f2562=20995, f3072=25172)


def _fdct_pass(d: np.ndarray, first: bool) -> np.ndarray:
    """One pass of jfdctint.c's jpeg_fdct_islow along the last axis of
    ``d`` [..., 8] int64: rows (``first``) or columns."""
    c = _C

    def descale(x, n):
        return (x + (1 << (n - 1))) >> n

    tmp0, tmp7 = d[..., 0] + d[..., 7], d[..., 0] - d[..., 7]
    tmp1, tmp6 = d[..., 1] + d[..., 6], d[..., 1] - d[..., 6]
    tmp2, tmp5 = d[..., 2] + d[..., 5], d[..., 2] - d[..., 5]
    tmp3, tmp4 = d[..., 3] + d[..., 4], d[..., 3] - d[..., 4]
    tmp10, tmp13 = tmp0 + tmp3, tmp0 - tmp3
    tmp11, tmp12 = tmp1 + tmp2, tmp1 - tmp2
    out = [None] * 8
    if first:
        out[0], out[4] = (tmp10 + tmp11) << 2, (tmp10 - tmp11) << 2
        n = 13 - 2
    else:
        out[0], out[4] = descale(tmp10 + tmp11, 2), descale(tmp10 - tmp11, 2)
        n = 13 + 2
    z1 = (tmp12 + tmp13) * c["f0541"]
    out[2] = descale(z1 + tmp13 * c["f0765"], n)
    out[6] = descale(z1 - tmp12 * c["f1847"], n)
    z1, z2, z3, z4 = tmp4 + tmp7, tmp5 + tmp6, tmp4 + tmp6, tmp5 + tmp7
    z5 = (z3 + z4) * c["f1175"]
    tmp4, tmp5 = tmp4 * c["f0298"], tmp5 * c["f2053"]
    tmp6, tmp7 = tmp6 * c["f3072"], tmp7 * c["f1501"]
    z1, z2 = z1 * -c["f0899"], z2 * -c["f2562"]
    z3, z4 = z3 * -c["f1961"] + z5, z4 * -c["f0390"] + z5
    out[7] = descale(tmp4 + z1 + z3, n)
    out[5] = descale(tmp5 + z2 + z4, n)
    out[3] = descale(tmp6 + z2 + z3, n)
    out[1] = descale(tmp7 + z1 + z4, n)
    return np.stack(out, -1)


def _quantised_blocks(plane: np.ndarray, bh: int, bw: int,
                      quant: np.ndarray) -> np.ndarray:
    """The [bh, bw] blocks of ``plane`` (at least bh * 8 x bw * 8
    samples): ISLOW forward DCT, quantised, [bh, bw, 64] zigzag order."""
    x = plane[:bh * 8, :bw * 8].reshape(bh, 8, bw, 8).transpose(0, 2, 1, 3)
    x = _fdct_pass(x - 128, True)                       # rows
    x = _fdct_pass(x.swapaxes(-1, -2), False).swapaxes(-1, -2)  # columns
    x = x.reshape(bh, bw, 64)[..., ZIGZAG]
    q = 8 * quant[ZIGZAG].astype(np.int64)
    return np.sign(x) * ((np.abs(x) + q // 2) // q)


def _with_dummies(blocks: np.ndarray, mh: int, mw: int) -> np.ndarray:
    """A 2x2-sampled component's [bh, bw, 64] blocks on its MCU grid [mh,
    mw] (bh and bw at most one short): the blocks past its own are zero,
    with the DC of the block before them in the MCU (jccoefct.c
    compress_data)."""
    bh, bw = blocks.shape[:2]
    out = np.zeros((mh, mw, 64), np.int64)
    out[:bh, :bw] = blocks
    out[:bh, bw:, 0] = blocks[:, bw - 1:bw, 0]
    if mh > bh:
        # every block of a row past the component's own: the DC of the
        # MCU's last block in the row above
        out[bh:, :, 0] = np.repeat(out[bh - 1, 1::2, 0], 2)[None, :]
    return out


def _bits_of(values: np.ndarray, lengths: np.ndarray) -> np.ndarray:
    """The concatenated MSB-first bits of each value at its length."""
    lengths = lengths.astype(np.int64)
    total = int(lengths.sum())
    starts = np.cumsum(lengths) - lengths
    owner = np.repeat(np.arange(len(lengths)), lengths)
    k = np.arange(total) - starts[owner]
    return ((values.astype(np.int64)[owner] >> (lengths[owner] - 1 - k)) & 1
            ).astype(np.uint8)


def _entropy_plain(blocks: np.ndarray, comp: np.ndarray, table: np.ndarray,
                   n_comps: int) -> bytes:
    """Huffman-code [n, 64] quantised blocks (zigzag order) in scan order:
    ``comp`` [n] their component (the DC predictor's), ``table`` [n] their
    table set (0 luma, 1 chroma)."""
    n = len(blocks)
    dc = blocks[:, 0]
    diff = np.empty(n, np.int64)
    for c in range(n_comps):
        at = np.nonzero(comp == c)[0]
        diff[at] = np.diff(dc[at], prepend=0)

    def category(v):                # bits of |v| (0 for 0)
        return np.frexp(np.abs(v).astype(np.float64))[1].astype(np.int64)

    def extra(v, s):
        return np.where(v < 0, v - 1, v) & ((1 << s) - 1)

    # items: (sort key, code, code length, extra bits, extra length)
    keys, vals, lens = [], [], []
    blk_key = np.arange(n, dtype=np.int64) * 4096
    s = category(diff)
    dc_code, dc_len = CODES[0::2][table, s], SIZES[0::2][table, s]
    keys.append(blk_key)
    vals.append((dc_code.astype(np.int64) << s) | extra(diff, s))
    lens.append(dc_len.astype(np.int64) + s)
    ac = blocks[:, 1:]
    bi, ki = np.nonzero(ac)                     # row-major: scan order
    v = ac[bi, ki]
    k = ki + 1
    first = np.r_[True, bi[1:] != bi[:-1]]
    prev = np.where(first, 0, np.r_[0, k[:-1]])
    run = k - prev - 1
    ac_code, ac_len = CODES[1::2], SIZES[1::2]
    t = table[bi]
    n_zrl = run // 16
    zb = np.repeat(np.arange(len(k)), n_zrl)
    keys.append(blk_key[bi[zb]] + k[zb] * 8)
    vals.append(ac_code[t[zb], 0xF0].astype(np.int64))
    lens.append(ac_len[t[zb], 0xF0].astype(np.int64))
    sz = category(v)
    sym = ((run % 16) << 4) | sz
    keys.append(blk_key[bi] + k * 8 + 1)
    vals.append((ac_code[t, sym].astype(np.int64) << sz) | extra(v, sz))
    lens.append(ac_len[t, sym].astype(np.int64) + sz)
    last = np.zeros(n, np.int64)
    np.maximum.at(last, bi, k)                   # the last nonzero's index
    eob = np.nonzero(last < 63)[0]
    keys.append(blk_key[eob] + 64 * 8)
    vals.append(ac_code[table[eob], 0].astype(np.int64))
    lens.append(ac_len[table[eob], 0].astype(np.int64))
    order = np.argsort(np.concatenate(keys), kind="stable")
    bits = _bits_of(np.concatenate(vals)[order], np.concatenate(lens)[order])
    bits = np.concatenate([bits, np.ones(-len(bits) % 8, np.uint8)])
    return np.packbits(bits).tobytes().replace(b"\xff", b"\xff\x00")


def encode_jpeg_plain(img, quality: int = DEFAULT_QUALITY) -> bytes:
    """``encode_jpeg`` in numpy: the same integer formulas, vectorised
    (the Huffman items sorted into scan order and packed at once)."""
    img = _check(img)
    height, width = img.shape[:2]
    gray = img.ndim == 2
    quant = quant_tables(quality)
    if gray:
        bh, bw = -(-height // 8), -(-width // 8)
        plane = _pad(img.astype(np.int64), bh * 8, bw * 8)
        blocks = _quantised_blocks(plane, bh, bw, quant[0]).reshape(-1, 64)
        comp = np.zeros(len(blocks), np.int64)
        table = comp
        n_comps = 1
    else:
        y, cb, cr = _rgb_to_ycc(img)
        mh, mw = -(-height // 16), -(-width // 16)
        bh, bw = -(-height // 8), -(-width // 8)
        luma = _quantised_blocks(_pad(y, bh * 8, bw * 8), bh, bw, quant[0])
        luma = _with_dummies(luma, 2 * mh, 2 * mw)
        luma = luma.reshape(mh, 2, mw, 2, 64).transpose(0, 2, 1, 3, 4)
        chroma = []
        for p in (cb, cr):
            d = _downsample_h2v2(p, mw * 8)
            chroma.append(_quantised_blocks(_pad(d, mh * 8, mw * 8), mh, mw,
                                            quant[1]))
        mcus = np.concatenate([luma.reshape(mh, mw, 4, 64),
                               chroma[0][:, :, None], chroma[1][:, :, None]],
                              axis=2)
        blocks = mcus.reshape(-1, 64)
        comp = np.tile(np.array([0, 0, 0, 0, 1, 2]), mh * mw)
        table = np.minimum(comp, 1)
        n_comps = 3
    data = _entropy_plain(blocks, comp, table, n_comps)
    return _headers(width, height, gray, quant) + data + b"\xff\xd9"
