"""JPEG decoding without PIL: baseline (SOF0), extended-sequential (SOF1)
and progressive (SOF2) Huffman JPEG with 8-bit samples, 1 or 3
components and any sampling factors from 1 to 4 whose ratios are
integers.

The JAX package reads JPEG through PIL and OpenCV, which both decode with
libjpeg-turbo; the card's machine has neither. This module gives the same
pixels, bit for bit: libjpeg's ISLOW integer IDCT, libjpeg-turbo's default
upsampling (the "fancy" triangle filters for 2x horizontal, 2x2 and 2x
vertical factors, replication for the other integer factors; not the DCT
scaling of IJG libjpeg 7 and later) and its fixed-point YCbCr -> RGB.

The markers are parsed here, in Python; everything after them (Huffman
decoding of every scan into one coefficient buffer, IDCT, upsampling,
colour) runs in C++ (``csrc/jpeg_decode.cpp``,
built at first use by ``native.build`` with the host's compiler; the call
releases the GIL, so the loader's decoding threads run in parallel). A
failed build raises. ``decode_jpeg_plain`` is the same decode in numpy
(the bit reader a Python loop), used where no C++ compiler is found and
by the tests.

Colour follows libjpeg's ``default_decompress_parms``: one component is
gray; three are YCbCr when a JFIF marker is present, else RGB when an
Adobe APP14 marker says transform 0, else YCbCr for any other Adobe
transform, else RGB for component ids 'R', 'G', 'B' and YCbCr otherwise.
RGB is returned as stored. ``gray=True`` gives what libjpeg gives for a
gray output (OpenCV's ``IMREAD_GRAYSCALE``): the Y plane of a YCbCr file,
``(19595 R + 38470 G + 7471 B + 32768) >> 16`` of an RGB one.

Damaged files, as PIL (with its default ``LOAD_TRUNCATED_IMAGES =
False``) takes them:

- a truncated file, cut anywhere before its EOI marker (inside the
  headers, the entropy-coded data, or just before EOI), raises a
  ``ValueError`` naming the file;
- a file of full length whose entropy-coded data or restart markers are
  corrupt decodes on, as libjpeg does with a warning: an image of the
  right shape, with a ``RuntimeWarning`` naming the file. Its pixels need
  not equal libjpeg's recovery. The decoder never reads past the buffer
  and ends after a bounded number of blocks.

A progressive file's scans follow libjpeg's checks (a DC scan may hold
several components, an AC scan one, with 1 <= Ss <= Se <= 63; Al <= 13;
a refinement's Al is its Ah - 1) and each scan refines what the scan
before it left (Ah is the previous Al). Where the scans leave one of the
first ten coefficients of a component unfinished, libjpeg-turbo smooths
the blocks (``jdcoefct.c`` ``decompress_smooth_data``); such a file is
refused (H20 in ``ROADMAP.md``), and PIL reads it where installed. The
scripts of PIL's and OpenCV's encoders always finish.

Arithmetic-coded, lossless and hierarchical JPEG, 12-bit samples, 2 or 4
components (CMYK / YCCK), a DNL marker, non-integer sampling ratios, MCUs
of more than 10 blocks (which libjpeg refuses) and progressive files with
unfinished or inconsistent scans raise ``UnsupportedJpeg``, a
``ValueError`` naming the file and the feature.
"""
from __future__ import annotations

import ctypes
import dataclasses
import os
import re
import threading
import warnings
from typing import List, Optional, Tuple

import numpy as np

DECODE_SOURCE = os.path.join(
    os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc",
    "jpeg_decode.cpp")
# The C++ decoder once loaded; False where no C++ compiler is found.
_NATIVE = None
_NATIVE_LOCK = threading.Lock()

# Start-of-frame markers -> the process they announce.
SOF_KINDS = {
    0xC0: "baseline", 0xC1: "extended sequential", 0xC2: "progressive",
    0xC3: "lossless", 0xC5: "differential sequential (hierarchical)",
    0xC6: "differential progressive (hierarchical)",
    0xC7: "differential lossless (hierarchical)",
    0xC9: "arithmetic-coded extended sequential",
    0xCA: "arithmetic-coded progressive", 0xCB: "arithmetic-coded lossless",
    0xCD: "arithmetic-coded differential sequential",
    0xCE: "arithmetic-coded differential progressive",
    0xCF: "arithmetic-coded differential lossless"}
SUPPORTED_SOF = (0xC0, 0xC1, 0xC2)
PROGRESSIVE = 0xC2
MAX_BLOCKS_IN_MCU = 10          # libjpeg's D_MAX_BLOCKS_IN_MCU
SMOOTHED_COEFS = 10             # libjpeg-turbo's SAVED_COEFS
SCAN_ROW = 16                   # int64 values per scan for the C++ code
_NO_TABLE = bytes(272)          # a Huffman table a scan does not use
MAX_DIMENSION = 65500           # libjpeg's JPEG_MAX_DIMENSION

# Zigzag index -> natural index, padded with 63 (libjpeg's
# jpeg_natural_order: a corrupt run past the block's end stays inside).
NATURAL = np.array([
    0, 1, 8, 16, 9, 2, 3, 10, 17, 24, 32, 25, 18, 11, 4, 5,
    12, 19, 26, 33, 40, 48, 41, 34, 27, 20, 13, 6, 7, 14, 21, 28,
    35, 42, 49, 56, 57, 50, 43, 36, 29, 22, 15, 23, 30, 37, 44, 51,
    58, 59, 52, 45, 38, 31, 39, 46, 53, 60, 61, 54, 47, 55, 62, 63]
    + [63] * 16)

# Status bits of a decode (the C++ routine's, and the plain version's).
SHORT_DATA = 1      # entropy-coded data ran out: zeros were read
BAD_CODE = 2        # a bit pattern that is no Huffman code

# The end of a scan's entropy-coded bytes: a marker that is not RSTn
# (0xFF 0x00 is a stuffed data byte; the 0xFF fill bytes before a marker
# belong to it).
_SCAN_END = re.compile(rb"\xff[^\x00\xd0-\xd7\xff]")
_RESTART = re.compile(rb"\xff+[\xd0-\xd7]")
_STUFFED = re.compile(rb"\xff+\x00")


class UnsupportedJpeg(ValueError):
    """A JPEG of a kind this decoder does not read (arithmetic, 12-bit,
    CMYK, progressive with unfinished scans, ...)."""


@dataclasses.dataclass
class Scan:
    start: int                  # entropy-coded bytes [start, end)
    end: int
    comps: Tuple[int, ...]      # indices into the frame's components
    tables: Tuple[Tuple[bytes, bytes], ...]   # (DC, AC) per component,
    #                             each 16 code counts + 256 symbols
    #                             (zeros where the scan uses none)
    restart: int                # MCUs per restart interval (0: none)
    progressive: bool = False
    ss: int = 0                 # spectral selection, zigzag [ss, se]
    se: int = 63
    ah: int = 0                 # successive approximation: bits from al;
    al: int = 0                 # ah > 0 refines from bit ah


@dataclasses.dataclass
class JpegHeader:
    width: int
    height: int
    sof: int                    # the SOF marker's second byte
    ids: List[int]              # component ids
    sampling: List[Tuple[int, int]]   # (h, v) per component
    quant: np.ndarray           # [n_components, 64] uint16, natural order
    scans: List[Scan]
    colour: str                 # "gray", "ycc" or "rgb"
    jfif: bool
    adobe_transform: Optional[int]
    precision: int


def _u16(buf: bytes, at: int) -> int:
    return (buf[at] << 8) | buf[at + 1]


def _colour(ids, jfif: bool, adobe: Optional[int]) -> str:
    """libjpeg's default_decompress_parms for 1 or 3 components."""
    if len(ids) == 1:
        return "gray"
    if jfif:
        return "ycc"
    if adobe is not None:
        return "rgb" if adobe == 0 else "ycc"
    return "rgb" if list(ids) == [82, 71, 66] else "ycc"


def parse_jpeg(buf: bytes, path: str = "<bytes>",
               headers_only: bool = False) -> JpegHeader:
    """Walk the markers of a JPEG file. Collects the frame, the
    quantisation and Huffman tables in force at each scan and each scan's
    entropy-coded bytes; with ``headers_only``, stops at the first scan.
    Raises ``ValueError`` naming ``path`` for a file that is not a JPEG,
    is truncated (no EOI after the last scan) or is malformed, and
    ``UnsupportedJpeg`` for a kind ``decode_jpeg`` does not read (the
    frame's kind is only checked without ``headers_only``)."""
    def bad(what: str) -> ValueError:
        return ValueError(f"{path}: {what}")

    if buf[:2] != b"\xff\xd8":
        raise bad("not a JPEG file (no SOI marker)")
    n = len(buf)
    pos = 2
    qt: List[Optional[np.ndarray]] = [None] * 4
    huff = {}                   # (class, id) -> 272 bytes
    restart = 0
    frame = None
    comp_q = {}                 # component index -> its latched table
    scans: List[Scan] = []
    jfif, adobe = False, None
    while True:
        # Skip garbage up to a 0xFF, then fill bytes (libjpeg's
        # next_marker does the same, warning of extraneous bytes).
        while pos < n and buf[pos] != 0xFF:
            pos += 1
        while pos < n and buf[pos] == 0xFF:
            pos += 1
        if pos >= n:
            raise bad("truncated JPEG (the file ends before its EOI "
                      "marker)")
        marker = buf[pos]
        pos += 1
        if marker == 0xD9:                      # EOI
            break
        if 0xD0 <= marker <= 0xD7 or marker == 0x01:
            continue                            # RSTn, TEM: no body
        if marker == 0xD8:
            raise bad("a second SOI marker")
        if pos + 2 > n:
            raise bad("truncated JPEG (inside a marker segment)")
        length = _u16(buf, pos)
        if length < 2:
            raise bad(f"marker 0xFF{marker:02X} of length {length}")
        if pos + length > n:
            raise bad("truncated JPEG (inside a marker segment)")
        body = buf[pos + 2:pos + length]
        pos += length
        if marker in SOF_KINDS:
            if frame is not None:
                raise bad("two SOF markers")
            if len(body) < 6:
                raise bad("short SOF segment")
            prec, height, width, nc = (body[0], _u16(body, 1),
                                       _u16(body, 3), body[5])
            if len(body) < 6 + 3 * nc or nc == 0:
                raise bad("short SOF segment")
            comps = [tuple(body[6 + 3 * i:9 + 3 * i]) for i in range(nc)]
            frame = (marker, prec, width, height, comps)
        elif marker == 0xC4:                    # DHT
            at = 0
            while at < len(body):
                if at + 17 > len(body):
                    raise bad("short DHT segment")
                tc, th = body[at] >> 4, body[at] & 15
                counts = body[at + 1:at + 17]
                total = sum(counts)
                if tc > 1 or th > 3 or total > 256 or \
                        at + 17 + total > len(body):
                    raise bad("bad Huffman table")
                vals = body[at + 17:at + 17 + total]
                huff[(tc, th)] = bytes(counts) + vals.ljust(256, b"\0")
                at += 17 + total
        elif marker == 0xDB:                    # DQT
            at = 0
            while at < len(body):
                pq, tq = body[at] >> 4, body[at] & 15
                size = 128 if pq else 64
                if pq > 1 or tq > 3 or at + 1 + size > len(body):
                    raise bad("bad quantisation table")
                zz = np.frombuffer(body, ">u2" if pq else np.uint8, 64,
                                   at + 1).astype(np.uint16)
                table = np.zeros(64, np.uint16)
                table[NATURAL[:64]] = zz
                qt[tq] = table
                at += 1 + size
        elif marker == 0xDD:                    # DRI
            if len(body) < 2:
                raise bad("short DRI segment")
            restart = _u16(body, 0)
        elif marker == 0xDC:
            raise UnsupportedJpeg(f"{path}: JPEG with a DNL marker is not "
                                  "read by the port's decoder")
        elif marker == 0xDA:                    # SOS
            if frame is None:
                raise bad("SOS before SOF")
            if headers_only:
                break
            _check_frame(frame, path)
            ids = [c[0] for c in frame[4]]
            ns = body[0] if body else 0
            if ns < 1 or ns > len(ids) or len(body) < 4 + 2 * ns:
                raise bad("bad SOS segment")
            progressive = frame[0] == PROGRESSIVE
            ss, se, ahl = body[1 + 2 * ns:4 + 2 * ns]
            ah, al = ahl >> 4, ahl & 15
            if progressive:
                _check_scan(ss, se, ah, al, ns, path)
            # A progressive scan reads the DC table (first DC scans) or
            # the AC table (AC scans), a DC refinement none.
            uses = ((True, True) if not progressive else
                    (ss == 0 and ah == 0, ss > 0))
            comps, tables = [], []
            for i in range(ns):
                cid, sel = body[1 + 2 * i], body[2 + 2 * i]
                if cid not in ids or ids.index(cid) in comps:
                    raise bad(f"scan component id {cid} not in the frame")
                ci = ids.index(cid)
                pair = []
                for used, key in zip(uses, ((0, sel >> 4), (1, sel & 15))):
                    if not used:
                        pair.append(_NO_TABLE)
                        continue
                    if key not in huff:
                        raise bad(f"Huffman table {key[1]} not defined")
                    _check_huffman(huff[key], path, dc=key[0] == 0)
                    pair.append(huff[key])
                comps.append(ci)
                tables.append(tuple(pair))
                if ci not in comp_q:            # latched at first use
                    tq = frame[4][ci][2]
                    if qt[tq] is None:
                        raise bad(f"quantisation table {tq} not defined")
                    comp_q[ci] = qt[tq].copy()
            if ns > 1:
                blocks = sum((frame[4][c][1] >> 4) * (frame[4][c][1] & 15)
                             for c in comps)
                if blocks > MAX_BLOCKS_IN_MCU:
                    raise UnsupportedJpeg(
                        f"{path}: an MCU of {blocks} blocks (libjpeg reads "
                        f"at most {MAX_BLOCKS_IN_MCU})")
            if not progressive and scans and \
                    len(scans[0].comps) == len(ids):
                raise bad("a second scan after one that held every "
                          "component")
            m = _SCAN_END.search(buf, pos)
            end = m.start() if m else n
            while end > pos and buf[end - 1] == 0xFF:    # fill bytes
                end -= 1
            scans.append(Scan(pos, end, tuple(comps), tuple(tables),
                              restart, progressive, ss, se, ah, al))
            pos = end
        elif marker == 0xE0 and body[:5] == b"JFIF\x00" and len(body) >= 14:
            jfif = True
        elif marker == 0xEE and body[:5] == b"Adobe" and len(body) >= 12:
            adobe = body[11]
        elif 0xE0 <= marker <= 0xEF or marker in (0xFE, 0xCC):
            pass                                # APPn, COM, DAC
        else:
            raise bad(f"unknown JPEG marker 0xFF{marker:02X}")
    if frame is None:
        raise bad("no SOF marker")
    sof, prec, width, height, comps = frame
    if not headers_only and not scans:
        raise bad("no scan")
    ids = [c[0] for c in comps]
    quant = np.zeros((len(comps), 64), np.uint16)
    for ci, table in comp_q.items():
        quant[ci] = table
    if sof == PROGRESSIVE and not headers_only:
        _check_progression(scans, len(comps), comp_q, path)
    return JpegHeader(
        width=width, height=height, sof=sof, ids=ids,
        sampling=[(c[1] >> 4, c[1] & 15) for c in comps], quant=quant,
        scans=scans, colour=_colour(ids, jfif, adobe) if len(ids) in (1, 3)
        else "other", jfif=jfif, adobe_transform=adobe, precision=prec)


def _check_frame(frame, path: str) -> None:
    """Refuse the kinds this decoder does not read."""
    sof, prec, width, height, comps = frame
    if sof not in SUPPORTED_SOF:
        raise UnsupportedJpeg(
            f"{path}: {SOF_KINDS[sof]} JPEG (SOF{sof - 0xC0}) is not read "
            "by the port's decoder")
    if prec != 8:
        raise UnsupportedJpeg(f"{path}: {prec}-bit JPEG is not read by the "
                              "port's decoder")
    if len(comps) not in (1, 3):
        raise UnsupportedJpeg(
            f"{path}: JPEG with {len(comps)} components (CMYK / YCCK) is "
            "not read by the port's decoder")
    if height == 0:
        raise UnsupportedJpeg(f"{path}: JPEG with its height in a DNL "
                              "marker is not read by the port's decoder")
    if width == 0 or max(width, height) > MAX_DIMENSION:
        raise ValueError(f"{path}: JPEG of {width}x{height} pixels (libjpeg "
                         f"reads 1 to {MAX_DIMENSION} a side)")
    hs = [c[1] >> 4 for c in comps]
    vs = [c[1] & 15 for c in comps]
    if min(hs + vs) < 1 or max(hs + vs) > 4:
        raise ValueError(f"{path}: JPEG sampling factors {list(zip(hs, vs))}"
                         " outside 1-4")
    if any(max(hs) % h or max(vs) % v for h, v in zip(hs, vs)):
        raise UnsupportedJpeg(
            f"{path}: JPEG sampling factors {list(zip(hs, vs))} with a "
            "non-integer ratio (libjpeg does not read them either)")
    if any(c[2] > 3 for c in comps):
        raise ValueError(f"{path}: bad quantisation table index")


def _check_scan(ss: int, se: int, ah: int, al: int, ns: int,
                path: str) -> None:
    """libjpeg's checks of a progressive scan (jdphuff.c
    start_pass_phuff_decoder): a DC scan is Ss = Se = 0, an AC scan holds
    one component with 1 <= Ss <= Se <= 63, a refinement has Al = Ah - 1,
    and Al <= 13."""
    ok = se == 0 if ss == 0 else (ss <= se <= 63 and ns == 1)
    if (ah and al != ah - 1) or al > 13 or not ok:
        raise ValueError(f"{path}: bad progressive scan (Ss {ss}, Se {se}, "
                         f"Ah {ah}, Al {al}, {ns} components)")


def _check_progression(scans: List[Scan], n_comps: int, comp_q: dict,
                       path: str) -> None:
    """Refuse what libjpeg decodes with a warning (a scan whose Ah is not
    the Al its coefficients were left at) and what it smooths: its
    ``smoothing_ok`` over the coefficient bits after the last scan (every
    component's table latched and nonzero at the first ten coefficients,
    every DC sent, and one of zigzag 1-9 unfinished somewhere)."""
    bits = np.full((n_comps, 64), -1, np.int64)    # libjpeg's coef_bits
    for s in scans:
        for c in s.comps:
            band = bits[c, s.ss:s.se + 1]
            if np.any(np.maximum(band, 0) != s.ah):
                raise UnsupportedJpeg(
                    f"{path}: progressive JPEG whose scan refines "
                    f"coefficients {s.ss}-{s.se} of component {c} from bit "
                    f"{s.ah}, where earlier scans left "
                    f"{sorted(set(band.tolist()))} (libjpeg decodes it with "
                    "a warning)")
            band[:] = s.al
    first = NATURAL[:SMOOTHED_COEFS]
    for c in range(n_comps):
        if c not in comp_q or not comp_q[c][first].all() or bits[c, 0] < 0:
            return                              # libjpeg does not smooth
    if np.any(bits[:, 1:SMOOTHED_COEFS] != 0):
        raise UnsupportedJpeg(
            f"{path}: progressive JPEG with incomplete scans (coefficients "
            f"of the first {SMOOTHED_COEFS} unfinished, which libjpeg-turbo "
            "smooths across blocks) is not read by the port's decoder")


def _check_huffman(table: bytes, path: str, dc: bool) -> None:
    """libjpeg's jpeg_make_d_derived_tbl checks: the canonical codes fit
    their lengths (no code of all ones), DC categories at most 15."""
    code = 0
    for length in range(1, 17):
        code += table[length - 1]
        if code >= 1 << length:
            raise ValueError(f"{path}: bad Huffman table")
        code <<= 1
    if dc and max(table[16:16 + sum(table[:16])], default=0) > 15:
        raise ValueError(f"{path}: bad DC Huffman table")


def jpeg_info(buf: bytes, path: str = "<bytes>") -> dict:
    """The frame of a JPEG (any kind): size, components, sampling factors,
    the SOF kind, JFIF / Adobe markers and the colour space libjpeg
    infers. Reads the headers up to the first scan only."""
    h = parse_jpeg(buf, path, headers_only=True)
    return {"width": h.width, "height": h.height, "components": len(h.ids),
            "sampling": h.sampling, "sof": SOF_KINDS[h.sof],
            "precision": h.precision, "jfif": h.jfif,
            "adobe_transform": h.adobe_transform, "colour": h.colour}


def _native_decoder():
    """The C++ decoder (a ctypes function), built and loaded at first use,
    or ``None`` where no C++ compiler is found."""
    global _NATIVE
    with _NATIVE_LOCK:
        if _NATIVE is None:
            from .. import native
            if native.compiler() is None:
                _NATIVE = False
            else:
                lib = ctypes.CDLL(native.build(DECODE_SOURCE,
                                               "libh3dgs_jpeg", openmp=False))
                fn = lib.h3dgs_jpeg_decode
                fn.restype = ctypes.c_int64
                fn.argtypes = [ctypes.c_void_p, ctypes.c_int64,
                               ctypes.c_void_p, ctypes.c_void_p,
                               ctypes.c_int64, ctypes.c_void_p,
                               ctypes.c_void_p, ctypes.c_void_p]
                _NATIVE = fn
    return _NATIVE or None


def _out_shape(h: JpegHeader, gray: bool):
    return ((h.height, h.width) if gray or len(h.ids) == 1
            else (h.height, h.width, 3))


def _decode_native(fn, buf: bytes, h: JpegHeader, gray: bool):
    colour = {"gray": 0, "ycc": 1, "rgb": 2}[h.colour]
    frame = np.array([h.width, h.height, len(h.ids), colour, int(gray)]
                     + [f for hv in h.sampling for f in hv], np.int32)
    scans = np.zeros((len(h.scans), SCAN_ROW), np.int64)
    tables = np.zeros((len(h.scans), 4, 2, 272), np.uint8)
    for i, s in enumerate(h.scans):
        scans[i, :4] = (s.start, s.end, s.restart, len(s.comps))
        scans[i, 4:4 + len(s.comps)] = s.comps
        scans[i, 8:13] = (s.progressive, s.ss, s.se, s.ah, s.al)
        for j, (dc, ac) in enumerate(s.tables):
            tables[i, j, 0] = np.frombuffer(dc, np.uint8)
            tables[i, j, 1] = np.frombuffer(ac, np.uint8)
    data = np.frombuffer(buf, np.uint8)
    quant = np.ascontiguousarray(h.quant)
    out = np.empty(_out_shape(h, gray), np.uint8)
    status = fn(data.ctypes.data, data.size, frame.ctypes.data,
                quant.ctypes.data, len(h.scans), scans.ctypes.data,
                tables.ctypes.data, out.ctypes.data)
    if status < 0:
        raise ValueError(f"JPEG decoder refused its arguments ({status})")
    return out, int(status)


def decode_jpeg(buf: bytes, path: str = "<bytes>",
                gray: bool = False) -> np.ndarray:
    """Decode JPEG bytes: [H, W] uint8 for one component (or ``gray``),
    else [H, W, 3] uint8 RGB. ``path`` names the source in errors and
    warnings. Runs the C++ decoder, or ``decode_jpeg_plain`` where no C++
    compiler is found."""
    h = parse_jpeg(buf, path)
    fn = _native_decoder()
    if fn is None:
        out, status = _decode_plain(buf, h, gray)
    else:
        out, status = _decode_native(fn, buf, h, gray)
    _warn(status, path)
    return out


def _warn(status: int, path: str) -> None:
    if status:
        what = [w for bit, w in ((SHORT_DATA, "entropy-coded data ran out"),
                                 (BAD_CODE, "bad Huffman code"))
                if status & bit]
        warnings.warn(f"{path}: corrupt JPEG data ({', '.join(what)}); "
                      "decoded on", RuntimeWarning, stacklevel=3)


def read_jpeg(path: str, gray: bool = False) -> np.ndarray:
    """Decode a JPEG file (``decode_jpeg``)."""
    with open(path, "rb") as f:
        return decode_jpeg(f.read(), path, gray)


# ---------------------------------------------------------------- plain ---

class _Bits:
    """MSB-first bits of one restart interval's unstuffed bytes, zeros
    after them (the C++ reader's zeros after a marker)."""

    def __init__(self, data: bytes):
        self.nbits = 8 * len(data)
        b = np.frombuffer(data + b"\0\0\0", np.uint8).astype(np.int64)
        tri = (b[:-2] << 16) | (b[1:-1] << 8) | b[2:]
        at = np.arange(self.nbits)
        # the 16 bits from every bit position on
        self.win = ((tri[at >> 3] >> (8 - (at & 7))) & 0xFFFF).tolist()
        self.pos = 0

    def peek16(self) -> int:
        return self.win[self.pos] if self.pos < self.nbits else 0

    def bits(self, n: int) -> int:
        if n == 0:
            return 0
        v = self.peek16() >> (16 - n)
        self.pos += n
        return v


def _lookup(table: bytes):
    """[65536] (length, symbol) lists for a 16-bit lookahead; length 17
    where no code matches (libjpeg consumes 17 bits and reads 0)."""
    lengths = np.full(65536, 17, np.int64)
    symbols = np.zeros(65536, np.int64)
    code, k = 0, 0
    for length in range(1, 17):
        for _ in range(table[length - 1]):
            lo = code << (16 - length)
            hi = (code + 1) << (16 - length)
            lengths[lo:hi] = length
            symbols[lo:hi] = table[16 + k]
            code += 1
            k += 1
        code <<= 1
    return lengths.tolist(), symbols.tolist()


def _extend(v: int, s: int) -> int:
    return v - (1 << s) + 1 if v < (1 << (s - 1)) else v


def _geometry(h: JpegHeader):
    """(largest h and v sampling factors, MCUs across, MCUs down)."""
    hmax = max(hv[0] for hv in h.sampling)
    vmax = max(hv[1] for hv in h.sampling)
    return hmax, vmax, -(-h.width // (8 * hmax)), -(-h.height // (8 * vmax))


def _i16(v: int) -> int:
    """``v`` stored as a 16-bit JCOEF."""
    return (v + 2 ** 15) % 2 ** 16 - 2 ** 15


class _Symbols:
    """Huffman symbols of one table from a ``_Bits`` reader; a pattern
    that is no code consumes 17 bits and reads 0, as in libjpeg."""

    def __init__(self, table: bytes, stat):
        self.lengths, self.symbols = _lookup(table)
        self.stat = stat

    def __call__(self, br: "_Bits") -> int:
        look = br.peek16()
        br.pos += self.lengths[look]
        if self.lengths[look] == 17:
            self.stat[0] |= BAD_CODE
        return self.symbols[look]


def _sequential_block(br, dc, ac, block, last, i, natural):
    """One baseline block: the DC difference, then the AC run/size
    pairs."""
    s = dc(br)
    diff = _extend(br.bits(s), s) if s else 0
    # an int predictor stored as a 16-bit JCOEF
    last[i] = (last[i] + diff + 2 ** 31) % 2 ** 32 - 2 ** 31
    block[0] = _i16(last[i])
    k = 1
    while k < 64:
        rs = ac(br)
        r, s = rs >> 4, rs & 15
        if s:
            k += r
            block[natural[k]] = _extend(br.bits(s), s)
        elif r != 15:
            break
        else:
            k += 15
        k += 1


def _progressive_block(br, scan, dc, ac, block, last, i, eobrun, natural):
    """One block of a progressive scan (jdphuff.c's decode_mcu_DC_first,
    _DC_refine, _AC_first, _AC_refine); ``eobrun`` a one-item list."""
    al = scan.al
    if scan.ss == 0:
        if scan.ah == 0:
            s = dc(br)
            diff = _extend(br.bits(s), s) if s else 0
            last[i] = (last[i] + diff + 2 ** 31) % 2 ** 32 - 2 ** 31
            block[0] = _i16(last[i] << al)
        elif br.bits(1):
            block[0] = _i16(int(block[0]) | (1 << al))
        return
    if scan.ah == 0:
        if eobrun[0] > 0:
            eobrun[0] -= 1
            return
        k = scan.ss
        while k <= scan.se:
            rs = ac(br)
            r, s = rs >> 4, rs & 15
            if s:
                k += r
                block[natural[k]] = _i16(_extend(br.bits(s), s) << al)
            elif r == 15:
                k += 15
            else:
                eobrun[0] = (1 << r) + br.bits(r) - 1
                break
            k += 1
        return
    p1, m1 = 1 << al, -(1 << al)

    def correct(at):
        """A correction bit for a nonzero coefficient."""
        v = int(block[at])
        if br.bits(1) and not v & p1:
            block[at] = _i16(v + (p1 if v >= 0 else m1))

    k = scan.ss
    if eobrun[0] == 0:
        while k <= scan.se:
            rs = ac(br)
            r, s = rs >> 4, rs & 15
            if s:
                s = p1 if br.bits(1) else m1
            elif r != 15:
                eobrun[0] = (1 << r) + br.bits(r)
                break
            # past the nonzero coefficients (correcting them) and r zeros
            while True:
                if block[natural[k]] != 0:
                    correct(natural[k])
                else:
                    r -= 1
                    if r < 0:
                        break
                k += 1
                if k > scan.se:
                    break
            if s:
                block[natural[k]] = s
            k += 1
    if eobrun[0] > 0:
        for kk in range(k, scan.se + 1):
            if block[natural[kk]] != 0:
                correct(natural[kk])
        eobrun[0] -= 1


def _decode_scan(buf: bytes, h: JpegHeader, scan: Scan, coef, stat):
    """Huffman-decode one scan into ``coef`` (per component [blocks_y,
    blocks_x, 64] int16, natural order)."""
    hmax, vmax, mcux, mcuy = _geometry(h)
    seg = buf[scan.start:scan.end]
    pieces = (_RESTART.split(seg) if scan.restart else
              [_RESTART.split(seg, 1)[0]])
    luts = [(_Symbols(dc, stat), _Symbols(ac, stat))
            for dc, ac in scan.tables]
    if len(scan.comps) == 1:
        c = scan.comps[0]
        dw = -(-h.width * h.sampling[c][0] // hmax)
        dh = -(-h.height * h.sampling[c][1] // vmax)
        units_x, units = -(-dw // 8), -(-dw // 8) * -(-dh // 8)
    else:
        units_x, units = mcux, mcux * mcuy
    interval = scan.restart or units
    natural = NATURAL.tolist()
    for first in range(0, units, interval):
        piece = first // interval
        br = _Bits(_STUFFED.sub(b"\xff", pieces[piece])
                   if piece < len(pieces) else b"")
        last = [0] * len(scan.comps)
        eobrun = [0]
        for m in range(first, min(first + interval, units)):
            my, mx = divmod(m, units_x)
            for i, c in enumerate(scan.comps):
                hs, vs = ((1, 1) if len(scan.comps) == 1
                          else h.sampling[c])
                dc, ac = luts[i]
                for yy in range(vs):
                    for xx in range(hs):
                        block = coef[c][my * vs + yy, mx * hs + xx]
                        if scan.progressive:
                            _progressive_block(br, scan, dc, ac, block, last,
                                               i, eobrun, natural)
                        else:
                            _sequential_block(br, dc, ac, block, last, i,
                                              natural)
        if br.pos > br.nbits:
            stat[0] |= SHORT_DATA


_FIX = dict(f0298=2446, f0390=3196, f0541=4433, f0765=6270, f0899=7373,
            f1175=9633, f1501=12299, f1847=15137, f1961=16069,
            f2053=16819, f2562=20995, f3072=25172)


def _idct_1d(x, shift: int):
    """jidctint.c's butterfly along the last-but-one axis of ``x`` [...,
    8, k] int64 (pass 1 on columns, pass 2 on the transposed rows)."""
    f = _FIX
    z2, z3 = x[..., 2, :], x[..., 6, :]
    z1 = (z2 + z3) * f["f0541"]
    tmp2 = z1 + z3 * -f["f1847"]
    tmp3 = z1 + z2 * f["f0765"]
    z2, z3 = x[..., 0, :], x[..., 4, :]
    tmp0 = (z2 + z3) << 13
    tmp1 = (z2 - z3) << 13
    t10, t13, t11, t12 = tmp0 + tmp3, tmp0 - tmp3, tmp1 + tmp2, tmp1 - tmp2
    o0, o1, o2, o3 = x[..., 7, :], x[..., 5, :], x[..., 3, :], x[..., 1, :]
    z1, z2, z3, z4 = o0 + o3, o1 + o2, o0 + o2, o1 + o3
    z5 = (z3 + z4) * f["f1175"]
    o0, o1 = o0 * f["f0298"], o1 * f["f2053"]
    o2, o3 = o2 * f["f3072"], o3 * f["f1501"]
    z1, z2 = z1 * -f["f0899"], z2 * -f["f2562"]
    z3 = z3 * -f["f1961"] + z5
    z4 = z4 * -f["f0390"] + z5
    o0, o1, o2, o3 = o0 + z1 + z3, o1 + z2 + z4, o2 + z2 + z3, o3 + z1 + z4
    rnd = 1 << (shift - 1)
    out = [t10 + o3, t11 + o2, t12 + o1, t13 + o0,
           t13 - o0, t12 - o1, t11 - o2, t10 - o3]
    return np.stack([(v + rnd) >> shift for v in out], axis=-2)


def _idct_plane(coef: np.ndarray, quant: np.ndarray) -> np.ndarray:
    """[by, bx, 64] int16 coefficients -> [by * 8, bx * 8] uint8 samples:
    dequantise, ISLOW IDCT, libjpeg's range limit."""
    by, bx = coef.shape[:2]
    x = (coef.astype(np.int64) * quant.astype(np.int64)).reshape(
        by, bx, 8, 8)
    ws = _idct_1d(x, 13 - 2)                           # columns
    out = _idct_1d(ws.swapaxes(-1, -2), 13 + 2 + 3)    # rows
    out = out.swapaxes(-1, -2)                          # [.., row, col]
    out = np.clip(((out + 512) & 1023) - 512 + 128, 0, 255)
    return out.transpose(0, 2, 1, 3).reshape(by * 8, bx * 8).astype(
        np.int64)


def _upsample(px: np.ndarray, dw: int, dh: int, rh: int, rv: int,
              width: int, height: int) -> np.ndarray:
    """A component's [dh, dw] samples (of the padded plane ``px``) at
    the full size, as libjpeg-turbo's jdsample.c upsamples them."""
    x = px[:dh, :dw]
    if (rh, rv) == (1, 1):
        return x[:height, :width]
    if (rh, rv) in ((2, 1), (2, 2)) and dw > 2:
        if rv == 2:     # column sums of the nearer and next nearer rows
            rows = np.empty((2 * dh, dw), np.int64)
            rows[0::2] = 3 * x + np.concatenate([x[:1], x[:-1]])
            rows[1::2] = 3 * x + np.concatenate([x[1:], x[-1:]])
            bias_even, bias_odd, shift = 8, 7, 4
        else:
            rows, bias_even, bias_odd, shift = x, 1, 2, 2
        # Edge columns repeated: 3a + a is libjpeg's 4a at both edges.
        left = np.concatenate([rows[:, :1], rows[:, :-1]], 1)
        right = np.concatenate([rows[:, 1:], rows[:, -1:]], 1)
        out = np.empty((rows.shape[0], 2 * dw), np.int64)
        out[:, 0::2] = (3 * rows + left + bias_even) >> shift
        out[:, 1::2] = (3 * rows + right + bias_odd) >> shift
        return out[:height, :width]
    if (rh, rv) == (1, 2):
        up = np.concatenate([x[:1], x[:-1]])
        down = np.concatenate([x[1:], x[-1:]])
        out = np.empty((2 * dh, dw), np.int64)
        out[0::2] = (3 * x + up + 1) >> 2
        out[1::2] = (3 * x + down + 2) >> 2
        return out[:height, :width]
    return np.repeat(np.repeat(x, rv, 0), rh, 1)[:height, :width]


def _tables():
    fix = lambda v: int(v * 65536.0 + 0.5)  # noqa: E731
    x = np.arange(256, dtype=np.int64) - 128
    half = 1 << 15
    return ((fix(1.40200) * x + half) >> 16,
            (fix(1.77200) * x + half) >> 16,
            -fix(0.71414) * x, -fix(0.34414) * x + half)


def _decode_plain(buf: bytes, h: JpegHeader, gray: bool):
    hmax, vmax, mcux, mcuy = _geometry(h)
    coef = [np.zeros((mcuy * v, mcux * hh, 64), np.int16)
            for hh, v in h.sampling]
    stat = [0]
    for scan in h.scans:
        _decode_scan(buf, h, scan, coef, stat)
    used = 1 if gray and h.colour == "ycc" else len(h.ids)
    planes = []
    for c in range(used):
        hh, v = h.sampling[c]
        dw = -(-h.width * hh // hmax)
        dh = -(-h.height * v // vmax)
        planes.append(_upsample(_idct_plane(coef[c], h.quant[c]), dw, dh,
                                hmax // hh, vmax // v, h.width, h.height))
    if used == 1:
        return planes[0].astype(np.uint8), stat[0]
    a, b, c = planes
    if h.colour == "rgb" and gray:
        out = (19595 * a + 38470 * b + 7471 * c + 32768) >> 16
    elif h.colour == "rgb":
        out = np.stack([a, b, c], -1)
    else:
        cr_r, cb_b, cr_g, cb_g = _tables()
        out = np.stack([a + cr_r[c], a + ((cb_g[b] + cr_g[c]) >> 16),
                        a + cb_b[b]], -1)
    return np.clip(out, 0, 255).astype(np.uint8), stat[0]


def decode_jpeg_plain(buf: bytes, path: str = "<bytes>",
                      gray: bool = False) -> np.ndarray:
    """``decode_jpeg`` in numpy: the same parse, the same status, the same
    integer formulas (bit reader and Huffman decoding a Python loop, the
    IDCT, upsampling and colour vectorised)."""
    h = parse_jpeg(buf, path)
    out, status = _decode_plain(buf, h, gray)
    _warn(status, path)
    return out
