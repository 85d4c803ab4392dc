"""The port's JPEG decoder (``h3dgs_tpu_torch/io/jpeg.py``, C++ in
``csrc/jpeg_decode.cpp``, numpy in ``decode_jpeg_plain``) and encoder
(``io/jpeg_encode.py``, C++ in ``csrc/jpeg_encode.cpp``, numpy in
``encode_jpeg_plain``) against PIL and OpenCV, which decode and encode
with libjpeg-turbo for the JAX package: decodes bit-equal on every
baseline and progressive kind of the fixture list at small sizes, encodes
byte-equal at every quality, sampling and odd size, the committed
fixtures' digests, damaged, unfinished and unsupported files, and the JAX
package's JPEG reads (``load_view``, the Laplacian variance, the OpenCV
loaders, one flat train step on a baseline and on a progressive view).
Tolerances are stated per test."""
from __future__ import annotations

import hashlib
import io
import json
import os
import sys
import warnings

import cv2
import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from h3dgs_tpu.preprocess import chunk as jchunk
from h3dgs_tpu.scene import dataset as jdataset
from h3dgs_tpu.scene import loader as jloader
from h3dgs_tpu.train import step as jstep
from h3dgs_tpu_torch.config import OptimizationConfig as TOptCfg
from h3dgs_tpu_torch.io import exif as texif
from h3dgs_tpu_torch.io import image as timage
from h3dgs_tpu_torch.io import jpeg as tjpeg
from h3dgs_tpu_torch.io import jpeg_encode as tenc
from h3dgs_tpu_torch.model import state as tstate
from h3dgs_tpu_torch.ops import rasterize as tras
from h3dgs_tpu_torch.preprocess import chunk as tchunk
from h3dgs_tpu_torch.preprocess import imgproc
from h3dgs_tpu_torch.scene import dataset as tdataset
from h3dgs_tpu_torch.scene import loader as tloader
from h3dgs_tpu_torch.scene import views as tviews
from h3dgs_tpu_torch.train import step as tstep

from .test_torch_common import cut_progressive, t_
from .test_torch_train import (XCFG, JOptCfg, _assert_state_close,
                               _opt_arrays, _step_setup, _tstate_of, jadam)

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "torch_jpeg")
with open(os.path.join(FIXTURES, "manifest.json")) as _f:
    MANIFEST = json.load(_f)


def _texture(rng, h: int, w: int, channels: int = 3) -> np.ndarray:
    """Gradients, an edge and noise: every 8x8 block has AC energy."""
    yy, xx = np.mgrid[:h, :w]
    base = np.stack([(xx * 5 + yy * 2) % 256, (yy * 7) % 256,
                     ((xx - yy) * 3) % 256], -1)[..., :channels]
    img = base + 60 * ((xx + yy) % 23 < 11)[..., None] \
        + rng.integers(-30, 30, base.shape)
    return np.clip(img, 0, 255).astype(np.uint8)


def _pil_jpeg(img: np.ndarray, **kw) -> bytes:
    b = io.BytesIO()
    Image.fromarray(img[..., 0] if img.shape[-1] == 1 else img).save(
        b, "JPEG", **kw)
    return b.getvalue()


def _cv2_jpeg(img: np.ndarray, sampling: int,
              progressive: bool = False) -> bytes:
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(img[..., ::-1]), [
        cv2.IMWRITE_JPEG_QUALITY, 90, cv2.IMWRITE_JPEG_SAMPLING_FACTOR,
        sampling, cv2.IMWRITE_JPEG_RST_INTERVAL, 2,
        cv2.IMWRITE_JPEG_PROGRESSIVE, int(progressive)])
    assert ok
    return buf.tobytes()


def _exif(orientation: int, gps: bool = False) -> bytes:
    ex = Image.Exif()
    ex[0x0112] = orientation
    if gps:
        ex[0x8825] = {1: "N", 2: (48.0, 51.0, 29.5), 3: "E",
                      4: (2.0, 17.0, 40.2)}
    return ex.tobytes()


# kind -> (channels, writer of [H, W, C] uint8 to JPEG bytes)
KINDS = {
    "pil_444_q90": (3, lambda x: _pil_jpeg(x, quality=90, subsampling=0)),
    "pil_422_q50": (3, lambda x: _pil_jpeg(x, quality=50, subsampling=1)),
    "pil_420_q100": (3, lambda x: _pil_jpeg(x, quality=100, subsampling=2)),
    "pil_420_optimize": (3, lambda x: _pil_jpeg(x, quality=90,
                                                optimize=True)),
    "pil_420_restart": (3, lambda x: _pil_jpeg(x, quality=90,
                                               restart_marker_blocks=2)),
    "cv2_411_restart": (3, lambda x: _cv2_jpeg(
        x, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411)),
    "cv2_440_restart": (3, lambda x: _cv2_jpeg(
        x, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440)),
    "gray": (1, lambda x: _pil_jpeg(x, quality=90)),
    "adobe_rgb": (3, lambda x: _pil_jpeg(x, quality=90, keep_rgb=True)),
    "exif_gps_orientation6": (3, lambda x: _pil_jpeg(
        x, quality=90, exif=_exif(6, gps=True))),
    "dqt16_sof1": (3, lambda x: _pil_jpeg(
        x, qtables=[list(range(256, 320)), list(range(300, 364))])),
}


# progressive kind -> (channels, writer): PIL's and OpenCV's
# jpeg_simple_progression scripts (YCbCr, gray, and RGB's own script)
PROGRESSIVE_KINDS = {
    "pil_444_q90": (3, lambda x: _pil_jpeg(x, quality=90, subsampling=0,
                                           progressive=True)),
    "pil_422_q50": (3, lambda x: _pil_jpeg(x, quality=50, subsampling=1,
                                           progressive=True)),
    "pil_420_q100": (3, lambda x: _pil_jpeg(x, quality=100, subsampling=2,
                                            progressive=True)),
    "pil_420_optimize": (3, lambda x: _pil_jpeg(x, quality=90, optimize=True,
                                                progressive=True)),
    "pil_420_restart": (3, lambda x: _pil_jpeg(x, quality=90,
                                               restart_marker_blocks=2,
                                               progressive=True)),
    "cv2_411_restart": (3, lambda x: _cv2_jpeg(
        x, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_411, progressive=True)),
    "cv2_440_restart": (3, lambda x: _cv2_jpeg(
        x, cv2.IMWRITE_JPEG_SAMPLING_FACTOR_440, progressive=True)),
    "gray": (1, lambda x: _pil_jpeg(x, quality=90, progressive=True)),
    "adobe_rgb": (3, lambda x: _pil_jpeg(x, quality=90, keep_rgb=True,
                                         progressive=True)),
}


def _pil_decode(buf: bytes) -> np.ndarray:
    with Image.open(io.BytesIO(buf)) as im:
        return np.asarray(im)


def _cv2_rgb(buf: bytes) -> np.ndarray:
    """OpenCV's default read in RGB order, gray repeated to three."""
    bgr = cv2.imdecode(np.frombuffer(buf, np.uint8), cv2.IMREAD_COLOR)
    return bgr[..., ::-1]


def _both(buf: bytes):
    """(C++ decode, plain decode)."""
    assert tjpeg._native_decoder() is not None
    return tjpeg.decode_jpeg(buf), tjpeg.decode_jpeg_plain(buf)


def _digest(a: np.ndarray) -> str:
    return hashlib.sha256(np.ascontiguousarray(a).tobytes()).hexdigest()


def _hide_pil(monkeypatch):
    for name in [m for m in sys.modules if m == "PIL"
                 or m.startswith("PIL.")]:
        monkeypatch.setitem(sys.modules, name, None)


# ------------------------------------------------------ the decoder ---

@pytest.mark.parametrize("size", [(1, 1), (13, 17), (61, 97)])
@pytest.mark.parametrize("kind", sorted(KINDS))
def test_decoder_matches_pil_and_cv2(kind, size):
    """Bit-equal: the C++ decoder and the plain version give PIL's array,
    and OpenCV's where the orientation is 1."""
    channels, write = KINDS[kind]
    rng = np.random.default_rng(sum(size) + len(kind))
    buf = write(_texture(rng, *size, channels))
    want = _pil_decode(buf)
    native, plain = _both(buf)
    np.testing.assert_array_equal(native, want)
    np.testing.assert_array_equal(plain, want)
    assert native.dtype == np.uint8 and native.shape == want.shape
    if "orientation" not in kind:
        rgb = want if want.ndim == 3 else np.repeat(want[..., None], 3, -1)
        np.testing.assert_array_equal(_cv2_rgb(buf), rgb)


@pytest.mark.parametrize("seed", range(6))
def test_decoder_random_sizes(seed):
    """Random sizes from 1 to 70 pixels a side, subsamplings and
    qualities: both decoders bit-equal to PIL and OpenCV."""
    rng = np.random.default_rng(100 + seed)
    for _ in range(4):
        h, w = (int(v) for v in rng.integers(1, 71, 2))
        buf = _pil_jpeg(rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
                        quality=int(rng.integers(20, 101)),
                        subsampling=int(rng.integers(0, 3)))
        want = _pil_decode(buf)
        for got in _both(buf):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(_cv2_rgb(buf), want)


@pytest.mark.parametrize("size", [(1, 1), (13, 17), (61, 97)])
@pytest.mark.parametrize("kind", sorted(PROGRESSIVE_KINDS))
def test_progressive_matches_pil_and_cv2(kind, size):
    """Progressive files (SOF2: DC first and refine, AC first with EOB
    runs, AC refine, restart intervals; interleaved DC scans and AC scans
    over each component's own blocks): the C++ decoder and the plain
    version bit-equal to PIL's array and to OpenCV's."""
    channels, write = PROGRESSIVE_KINDS[kind]
    rng = np.random.default_rng(sum(size) + 3 * len(kind))
    buf = write(_texture(rng, *size, channels))
    assert tjpeg.jpeg_info(buf)["sof"] == "progressive"
    want = _pil_decode(buf)
    native, plain = _both(buf)
    np.testing.assert_array_equal(native, want)
    np.testing.assert_array_equal(plain, want)
    rgb = want if want.ndim == 3 else np.repeat(want[..., None], 3, -1)
    np.testing.assert_array_equal(_cv2_rgb(buf), rgb)


@pytest.mark.parametrize("seed", range(4))
def test_progressive_random_sizes(seed):
    """Random sizes from 1 to 70 pixels a side, subsamplings, qualities
    and restart intervals, progressive: both decoders bit-equal to PIL and
    OpenCV."""
    rng = np.random.default_rng(200 + seed)
    for _ in range(3):
        h, w = (int(v) for v in rng.integers(1, 71, 2))
        buf = _pil_jpeg(rng.integers(0, 256, (h, w, 3)).astype(np.uint8),
                        quality=int(rng.integers(20, 101)),
                        subsampling=int(rng.integers(0, 3)),
                        restart_marker_blocks=int(rng.integers(0, 4)),
                        progressive=True)
        want = _pil_decode(buf)
        for got in _both(buf):
            np.testing.assert_array_equal(got, want)
        np.testing.assert_array_equal(_cv2_rgb(buf), want)


@pytest.mark.parametrize("scans", range(1, 10))
def test_unfinished_progressive_is_refused(tmp_path, monkeypatch, scans):
    """PIL's progressive 4:2:0 file (10 scans) cut after each of its first
    9 scans: every cut leaves a coefficient of the first ten unfinished in
    some component, which libjpeg-turbo smooths; the port refuses it from
    both decoders (UnsupportedJpeg naming the file), ``read_image`` hands
    it to PIL, and without PIL raises. The whole file decodes."""
    img = _texture(np.random.default_rng(12), 29, 43)
    cut = cut_progressive(img, scans)
    full = _pil_jpeg(img, quality=90, progressive=True)
    assert len(tjpeg.parse_jpeg(full).scans) == 10
    for fn in (tjpeg.decode_jpeg, tjpeg.decode_jpeg_plain):
        with pytest.raises(tjpeg.UnsupportedJpeg,
                           match=r"cut\.jpg: progressive JPEG with "
                                 "incomplete scans"):
            fn(cut, "cut.jpg")
    path = str(tmp_path / "cut.jpg")
    with open(path, "wb") as f:
        f.write(cut)
    np.testing.assert_array_equal(timage.read_image(path), _pil_decode(cut))
    np.testing.assert_array_equal(tjpeg.decode_jpeg(full), _pil_decode(full))
    _hide_pil(monkeypatch)
    with pytest.raises(ValueError, match="incomplete scans"):
        timage.read_image(path)


def _patch_scan(buf: bytes, index: int, ss=None, se=None, ah=None,
                al=None) -> bytes:
    """``buf`` with the band of its scan ``index`` rewritten."""
    b = bytearray(buf)
    at = -1
    for _ in range(index + 1):
        at = b.index(b"\xff\xda", at + 1)
    ns = b[at + 4]
    band = at + 5 + 2 * ns
    b[band] = b[band] if ss is None else ss
    b[band + 1] = b[band + 1] if se is None else se
    old_ah, old_al = b[band + 2] >> 4, b[band + 2] & 15
    b[band + 2] = ((old_ah if ah is None else ah) << 4) | (
        old_al if al is None else al)
    return bytes(b)


@pytest.mark.parametrize("what", ["al", "se", "dc_band", "ah_chain"])
def test_bad_progression(what):
    """libjpeg's errors (an Al past 13, an AC band past 63, a DC scan with
    an AC band) raise ValueError; a refinement from a bit that earlier
    scans did not leave (libjpeg's warning) raises UnsupportedJpeg, which
    hands the file to PIL where installed."""
    full = _pil_jpeg(_texture(np.random.default_rng(13), 24, 32),
                     quality=90, progressive=True)
    if what == "ah_chain":      # scan 5 refines Y 1-63 from bit 2 to 1
        buf = _patch_scan(full, 5, ah=3, al=2)
        with pytest.raises(tjpeg.UnsupportedJpeg, match="refines"):
            tjpeg.decode_jpeg(buf)
        assert _pil_decode(buf).shape == (24, 32, 3)
        return
    buf = {"al": lambda: _patch_scan(full, 1, al=14),
           "se": lambda: _patch_scan(full, 1, se=64),
           "dc_band": lambda: _patch_scan(full, 0, se=5)}[what]()
    with pytest.raises(ValueError, match="bad progressive scan"):
        tjpeg.decode_jpeg(buf)


def _bits(value: int, n: int):
    return [(value >> (n - 1 - i)) & 1 for i in range(n)]


def _scans_jpeg(coef, sampling, width, height, interleaved, restart):
    """A baseline JPEG of the given quantised coefficients ([by, bx, 64]
    per component, zigzag order), written here: one DQT of 2s, DC codes of
    4 bits (categories 0-11) and AC codes of 8 bits (all 162 symbols); one
    interleaved scan, or one scan per component (not interleaved: the
    component's own ceil(size / 8) blocks), with ``restart`` MCUs per
    restart interval."""
    ac_syms = [0x00, 0xF0] + [(r << 4) | s for r in range(16)
                              for s in range(1, 11)]
    dht = (bytes([0x00] + [0, 0, 0, 12] + [0] * 12) + bytes(range(12))
           + bytes([0x10] + [0] * 7 + [162] + [0] * 8) + bytes(ac_syms))

    def seg(marker, body):
        return bytes([0xFF, marker]) + (len(body) + 2).to_bytes(2, "big") \
            + body

    hmax = max(h for h, _ in sampling)
    vmax = max(v for _, v in sampling)
    sof = bytes([8]) + height.to_bytes(2, "big") + width.to_bytes(2, "big") \
        + bytes([len(sampling)])
    for i, (h, v) in enumerate(sampling):
        sof += bytes([i + 1, (h << 4) | v, 0])
    out = [b"\xff\xd8", seg(0xDB, bytes([0]) + bytes([2] * 64)),
           seg(0xC0, sof), seg(0xC4, dht)]
    if restart:
        out.append(seg(0xDD, restart.to_bytes(2, "big")))

    def encode(units):
        """units: per MCU, the (component, block) list in order."""
        bits, pred, data = [], {}, bytearray()

        def flush():
            bits.extend([1] * (-len(bits) % 8))
            for i in range(0, len(bits), 8):
                byte = int("".join(map(str, bits[i:i + 8])), 2)
                data.extend([byte, 0] if byte == 0xFF else [byte])
            bits.clear()
        for m, blocks in enumerate(units):
            if restart and m and m % restart == 0:
                flush()
                data.extend([0xFF, 0xD0 + (m // restart - 1) % 8])
                pred = {}
            for c, z in blocks:
                diff = int(z[0]) - pred.get(c, 0)
                pred[c] = int(z[0])
                s = abs(diff).bit_length()
                bits += _bits(s, 4) + _bits(diff if diff >= 0
                                            else diff + (1 << s) - 1, s)
                run = 0
                for k in range(1, 64):
                    if z[k] == 0:
                        run += 1
                        continue
                    while run > 15:
                        bits += _bits(ac_syms.index(0xF0), 8)
                        run -= 16
                    v = int(z[k])
                    s = abs(v).bit_length()
                    bits += _bits(ac_syms.index((run << 4) | s), 8)
                    bits += _bits(v if v >= 0 else v + (1 << s) - 1, s)
                    run = 0
                if run:
                    bits += _bits(0, 8)
        flush()
        return bytes(data)

    if interleaved:
        my, mx = coef[0].shape[0] // sampling[0][1], \
            coef[0].shape[1] // sampling[0][0]
        units = [[(c, coef[c][y * v + yy, x * h + xx])
                  for c, (h, v) in enumerate(sampling)
                  for yy in range(v) for xx in range(h)]
                 for y in range(my) for x in range(mx)]
        sos = bytes([len(sampling)]) + b"".join(
            bytes([c + 1, 0]) for c in range(len(sampling))) + b"\x00\x3f\x00"
        out += [seg(0xDA, sos), encode(units)]
    else:
        for c, (h, v) in enumerate(sampling):
            bw = -(-(-(-width * h // hmax)) // 8)
            bh = -(-(-(-height * v // vmax)) // 8)
            units = [[(c, coef[c][y, x])] for y in range(bh)
                     for x in range(bw)]
            out += [seg(0xDA, bytes([1, c + 1, 0, 0, 63, 0])), encode(units)]
    return b"".join(out) + b"\xff\xd9"


@pytest.mark.parametrize("restart", [0, 2])
def test_scans_not_interleaved(restart):
    """Baseline files with one scan per component (each scan over the
    component's own ceil(size / 8) blocks, not the MCU-padded grid) decode
    like the same coefficients in one interleaved scan, in PIL and in
    both of the port's decoders; restart intervals in both layouts."""
    rng = np.random.default_rng(7)
    width, height = 37, 29
    sampling = [(2, 2), (1, 1), (1, 1)]
    mcux, mcuy = -(-width // 16), -(-height // 16)
    coef = []
    for h, v in sampling:
        z = np.zeros((mcuy * v, mcux * h, 64), np.int64)
        z[..., 0] = rng.integers(-60, 60, z.shape[:2])
        ac = rng.integers(-12, 13, z.shape[:2] + (63,))
        z[..., 1:] = np.where(rng.random(ac.shape) < 0.3, ac, 0)
        coef.append(z)
    one = _scans_jpeg(coef, sampling, width, height, True, restart)
    three = _scans_jpeg(coef, sampling, width, height, False, restart)
    want = _pil_decode(one)
    np.testing.assert_array_equal(_pil_decode(three), want)
    for buf in (one, three):
        for got in _both(buf):
            np.testing.assert_array_equal(got, want)


def test_plain_runs_without_a_compiler(monkeypatch):
    """Where no C++ compiler is found, ``decode_jpeg`` runs the plain
    version; the C++ decoder is built otherwise."""
    buf = KINDS["pil_420_restart"][1](_texture(np.random.default_rng(1),
                                               21, 35))
    native = tjpeg.decode_jpeg(buf)
    assert tjpeg._native_decoder() is not None
    monkeypatch.setattr(tjpeg, "_NATIVE", None)
    monkeypatch.setattr("h3dgs_tpu_torch.native.compiler", lambda: None)
    assert tjpeg._native_decoder() is None
    np.testing.assert_array_equal(tjpeg.decode_jpeg(buf), native)
    np.testing.assert_array_equal(native, _pil_decode(buf))


# ------------------------------------------------------- fixtures ---

@pytest.mark.parametrize("name", sorted(MANIFEST))
def test_fixture_manifest_is_honest(name):
    """Each committed fixture decodes in PIL to its recorded digest and
    in the port to the same (the plain version too under 300x300); where
    OpenCV's default read differs (orientation), ``cv2.imread`` and
    ``imgproc.load_bgr8`` give the recorded digest. The refused one (a
    progressive file with unfinished scans) is refused by the port and
    read by PIL. Each decoded fixture's JPEG at every recorded quality,
    from PIL, from the C++ encoder and (under 300x300) the plain one,
    has the recorded digest. The fixtures hold two 1600x900 views (a
    baseline one and its progressive twin) and stay under 1.5 MiB."""
    entry = MANIFEST[name]
    path = os.path.join(FIXTURES, name)
    with open(path, "rb") as f:
        buf = f.read()
    want = _pil_decode(buf)
    assert list(want.shape) == entry["shape"]
    assert _digest(want) == entry["pil_sha256"]
    info = tjpeg.jpeg_info(buf, name)
    assert (info["height"], info["width"]) == tuple(entry["shape"][:2])
    assert (info["sof"] == "progressive") == entry["progressive"]
    if entry["refused"]:
        with pytest.raises(tjpeg.UnsupportedJpeg, match="incomplete scans"):
            tjpeg.decode_jpeg(buf, name)
        assert _digest(timage.read_image(path)) == entry["pil_sha256"]
        return
    assert _digest(tjpeg.read_jpeg(path)) == entry["pil_sha256"]
    small = want.shape[0] * want.shape[1] < 300 * 300
    if small:
        assert _digest(tjpeg.decode_jpeg_plain(buf)) == entry["pil_sha256"]
    if "cv2_bgr_sha256" in entry:
        assert _digest(cv2.imread(path)) == entry["cv2_bgr_sha256"]
        assert _digest(imgproc.load_bgr8(path)) == entry["cv2_bgr_sha256"]
    for q, sha in entry["encoded_sha256"].items():
        encoders = [lambda x, q: _pil_jpeg(x, quality=q), tenc.encode_jpeg]
        for encode in encoders + ([tenc.encode_jpeg_plain] if small else []):
            got = hashlib.sha256(encode(want, int(q))).hexdigest()
            assert got == sha, (name, q, encode)
    assert sum(os.path.getsize(os.path.join(FIXTURES, n))
               for n in os.listdir(FIXTURES)) <= 3 << 19


def test_progressive_twin_decodes_to_the_view():
    """The 1600x900 progressive twin decodes, in the port, to the pixels
    of the baseline view it was made beside."""
    twin, view = (tjpeg.read_jpeg(os.path.join(FIXTURES, n)) for n in (
        "view_420_1600x900_progressive.jpg", "view_420_1600x900.jpg"))
    np.testing.assert_array_equal(twin, view)


# ------------------------------------------------------- the encoder ---

QUALITIES = [1, 50, 75, 85, 95, 100]


def _cv2_encode(img: np.ndarray, quality: int) -> bytes:
    """OpenCV's JPEG (its default 4:2:0) of RGB or gray ``img``."""
    bgr = img[..., ::-1] if img.ndim == 3 else img
    ok, buf = cv2.imencode(".jpg", np.ascontiguousarray(bgr),
                           [cv2.IMWRITE_JPEG_QUALITY, quality])
    assert ok
    return buf.tobytes()


@pytest.mark.parametrize("quality", QUALITIES)
@pytest.mark.parametrize("size", [(1, 1), (13, 17), (17, 13), (16, 32),
                                  (61, 97)])
@pytest.mark.parametrize("gray", [False, True])
def test_encoder_matches_pil_and_cv2(gray, size, quality):
    """Byte-equal: the C++ encoder, the plain version, PIL's ``save(...,
    "JPEG", quality=q)`` and ``cv2.imencode`` (RGB as YCbCr 4:2:0 with
    dummy blocks past odd block counts, and gray), and the result decodes
    in the port to PIL's decode."""
    rng = np.random.default_rng(quality + 7 * size[0] + size[1] + gray)
    img = _texture(rng, *size, 1 if gray else 3)
    img = img[..., 0] if gray else img
    want = _pil_jpeg(img, quality=quality)
    assert _cv2_encode(img, quality) == want
    assert tenc.encode_jpeg(img, quality) == want
    assert tenc.encode_jpeg_plain(img, quality) == want
    np.testing.assert_array_equal(tjpeg.decode_jpeg(want), _pil_decode(want))


@pytest.mark.parametrize("seed", range(6))
def test_encoder_random_sizes(seed):
    """Random sizes from 1 to 70 pixels a side, qualities and colour /
    gray: C++ and plain byte-equal to PIL."""
    rng = np.random.default_rng(300 + seed)
    for _ in range(4):
        h, w = (int(v) for v in rng.integers(1, 71, 2))
        shape = (h, w) if rng.random() < 0.3 else (h, w, 3)
        img = rng.integers(0, 256, shape).astype(np.uint8)
        q = int(rng.integers(1, 101))
        want = _pil_jpeg(img[..., None] if img.ndim == 2 else img,
                         quality=q)
        assert tenc.encode_jpeg(img, q) == want, (shape, q)
        assert tenc.encode_jpeg_plain(img, q) == want, (shape, q)


@pytest.mark.parametrize("quality", [-5, 0, 1, -1, 100, 101])
def test_encoder_quality_clamps(quality):
    """libjpeg's clamps as PIL passes them: q <= 0 is 1, q > 100 is 100,
    and PIL's -1 is its default 75 (the same bytes as no quality)."""
    img = _texture(np.random.default_rng(14), 21, 34)
    want = _pil_jpeg(img, quality=quality)
    same = {-5: 1, 0: 1, 1: 1, -1: 75, 100: 100, 101: 100}[quality]
    assert want == _pil_jpeg(img, quality=same)
    if quality == -1:
        assert want == _pil_jpeg(img)
    assert tenc.encode_jpeg(img, quality) == want
    assert tenc.encode_jpeg_plain(img, quality) == want


def test_encoder_without_a_compiler(monkeypatch):
    """Where no C++ compiler is found, ``encode_jpeg`` runs the plain
    version; the C++ encoder is built otherwise."""
    img = _texture(np.random.default_rng(15), 23, 37)
    native = tenc.encode_jpeg(img, 85)
    assert tenc._native_encoder() is not None
    monkeypatch.setattr(tenc, "_NATIVE", None)
    monkeypatch.setattr("h3dgs_tpu_torch.native.compiler", lambda: None)
    assert tenc._native_encoder() is None
    assert tenc.encode_jpeg(img, 85) == native == _pil_jpeg(img, quality=85)


@pytest.mark.parametrize("bad", ["float", "rgba", "empty", "wide"])
def test_encoder_refuses_bad_input(bad):
    """Samples other than uint8 [H, W, 3] / [H, W], and sizes JPEG cannot
    hold, raise ValueError from both encoders."""
    img = {"float": np.zeros((4, 4, 3), np.float32),
           "rgba": np.zeros((4, 4, 4), np.uint8),
           "empty": np.zeros((0, 4, 3), np.uint8),
           "wide": np.zeros((1, 65501), np.uint8)}[bad]
    for fn in (tenc.encode_jpeg, tenc.encode_jpeg_plain):
        with pytest.raises(ValueError, match="encode_jpeg"):
            fn(img)


def test_write_image_jpeg_without_pil(tmp_path, monkeypatch):
    """``write_image`` writes ``.jpg`` and ``.jpeg`` without PIL, the bytes
    ``cv2.imwrite`` writes at its default quality (95); other formats but
    PNG still need PIL."""
    img = _texture(np.random.default_rng(16), 27, 45)
    want = str(tmp_path / "cv2.jpg")
    assert cv2.imwrite(want, np.ascontiguousarray(img[..., ::-1]))
    _hide_pil(monkeypatch)
    for name in ("a.jpg", "b.JPEG"):
        timage.write_image(str(tmp_path / name), img)
        assert (tmp_path / name).read_bytes() == open(want, "rb").read()
    with pytest.raises(ValueError, match="only PNG and JPEG"):
        timage.write_image(str(tmp_path / "c.bmp"), img)


# ----------------------------------------------- damaged and refused ---

def _restart_file(rng) -> bytes:
    return _pil_jpeg(_texture(rng, 61, 97), quality=90,
                     restart_marker_blocks=1)


@pytest.mark.parametrize("where", ["header", "before_scan", "scan_start",
                                   "half", "before_eoi", "eoi_cut"])
def test_truncated_file_raises(tmp_path, where):
    """PIL raises on a file cut anywhere before the end of its EOI
    marker; the port raises a ValueError naming the file, from every
    reader, and no reader takes it for a missing file."""
    buf = _restart_file(np.random.default_rng(3))
    sos = buf.index(b"\xff\xda")
    cut = {"header": 10, "before_scan": sos - 5, "scan_start": sos + 20,
           "half": len(buf) // 2, "before_eoi": len(buf) - 2,
           "eoi_cut": len(buf) - 1}[where]
    with pytest.raises(OSError):
        with Image.open(io.BytesIO(buf[:cut])) as im:
            im.load()
    path = str(tmp_path / "cut.jpg")
    with open(path, "wb") as f:
        f.write(buf[:cut])
    for fn in (tjpeg.read_jpeg, timage.read_image, imgproc.load_bgr8,
               imgproc.load_gray8, imgproc.load_unchanged):
        with pytest.raises(ValueError, match=r"cut\.jpg: truncated"):
            fn(path)
    with pytest.raises(ValueError, match="truncated"):
        tjpeg.decode_jpeg_plain(buf[:cut])


@pytest.mark.parametrize("damage", ["xor", "restart_renumbered",
                                    "restart_removed"])
def test_corrupt_file_decodes_on(damage):
    """A file of full length with corrupt entropy-coded data or a damaged
    restart marker: PIL decodes it at full shape (libjpeg warns); so do
    both of the port's decoders, with a RuntimeWarning where data went
    missing, and the two agree."""
    rng = np.random.default_rng(4)
    buf = bytearray(_restart_file(rng))
    sos = buf.index(b"\xff\xda")
    if damage == "xor":             # no 0xFF made or unmade
        at = [i for i in range(sos + 20, len(buf) - 4)
              if 0xFF not in (buf[i - 1], buf[i], buf[i] ^ 0x5A)]
        for i in rng.choice(at, 40, replace=False):
            buf[i] ^= 0x5A
    else:
        rst = [i for i in range(sos, len(buf) - 1)
               if buf[i] == 0xFF and 0xD0 <= buf[i + 1] <= 0xD7]
        buf[rst[5] + 1] = (0x00 if damage == "restart_removed"
                           else 0xD0 + (buf[rst[5] + 1] + 3) % 8)
    buf = bytes(buf)
    want = _pil_decode(buf)
    with warnings.catch_warnings():
        warnings.simplefilter("ignore", RuntimeWarning)
        native, plain = _both(buf)
    assert native.shape == plain.shape == want.shape == (61, 97, 3)
    np.testing.assert_array_equal(native, plain)
    if damage == "restart_removed":
        with pytest.warns(RuntimeWarning, match="corrupt JPEG data"):
            tjpeg.decode_jpeg(buf, "damaged.jpg")


def _patched(buf: bytes, what: str) -> bytes:
    """A baseline file turned into a kind the port refuses."""
    b = bytearray(buf)
    sof = b.index(b"\xff\xc0")
    if what == "arithmetic":
        b[sof + 1] = 0xC9
    elif what == "lossless":
        b[sof + 1] = 0xC3
    elif what == "12-bit":
        b[sof + 4] = 12
    elif what == "DNL":
        b[sof + 5:sof + 7] = b"\x00\x00"
    return bytes(b)


@pytest.mark.parametrize("what", ["progressive", "arithmetic", "lossless",
                                  "12-bit", "4 components", "DNL"])
def test_unsupported_kinds_raise_without_pil(tmp_path, monkeypatch, what):
    """With PIL unimportable, a kind the port does not read raises a
    ValueError naming the file and the feature; a baseline file decodes.
    With PIL, ``read_image`` hands the refused kinds that PIL reads to
    it."""
    rng = np.random.default_rng(5)
    img = _texture(rng, 24, 40)
    base = _pil_jpeg(img, quality=90)
    if what == "progressive":   # unfinished scans: libjpeg smooths them
        buf = cut_progressive(img)
    elif what == "4 components":
        b = io.BytesIO()
        Image.fromarray(img).convert("CMYK").save(b, "JPEG", quality=90)
        buf = b.getvalue()
    else:
        buf = _patched(base, what)
    path, ok = str(tmp_path / "odd.jpg"), str(tmp_path / "base.jpg")
    for p, body in ((path, buf), (ok, base)):
        with open(p, "wb") as f:
            f.write(body)
    if what in ("progressive", "4 components"):
        np.testing.assert_array_equal(timage.read_image(path),
                                      _pil_decode(buf))
    _hide_pil(monkeypatch)
    with pytest.raises(ValueError, match=rf"odd\.jpg: .*{what}"):
        timage.read_image(path)
    with pytest.raises(tjpeg.UnsupportedJpeg, match=what):
        tjpeg.decode_jpeg_plain(buf, "odd.jpg")
    np.testing.assert_array_equal(timage.read_image(ok), tjpeg.decode_jpeg(
        base))


def test_baseline_never_goes_through_pil(tmp_path, monkeypatch):
    """``read_image`` decodes a baseline JPEG itself even where PIL is
    installed."""
    path = str(tmp_path / "v.jpg")
    img = _texture(np.random.default_rng(6), 20, 30)
    with open(path, "wb") as f:
        f.write(_pil_jpeg(img, quality=80))

    def no_open(*a, **k):
        raise AssertionError("PIL was asked to decode a baseline JPEG")
    monkeypatch.setattr(Image, "open", no_open)
    got = timage.read_image(path)
    monkeypatch.undo()
    np.testing.assert_array_equal(got, np.asarray(Image.open(path)))


# ------------------------------------------------ the JAX package ---

def _views(root: str, rng, wide: bool):
    """JPEG views of five kinds and a JPEG mask: (image, mask) paths."""
    w, h = (3200, 16) if wide else (48, 32)
    out = []
    for name, kw, channels in (("ycc420.jpg", {"quality": 90}, 3),
                               ("gray.jpg", {"quality": 90}, 1),
                               ("rgb.jpg", {"keep_rgb": True}, 3),
                               ("progressive.jpg", {"progressive": True}, 3),
                               ("masked.jpg", {"subsampling": 1}, 3)):
        p = os.path.join(root, name)
        with open(p, "wb") as f:
            f.write(_pil_jpeg(_texture(rng, h, w, channels), **kw))
        out.append((p, ""))
    mask = os.path.join(root, "mask.jpg")
    m = np.where(_texture(rng, h, w, 1)[..., 0] > 128, 255, 0)
    with open(mask, "wb") as f:
        f.write(_pil_jpeg(m.astype(np.uint8)[..., None], quality=95))
    out[-1] = (out[-1][0], mask)
    return out


def _infos(image_path: str, mask_path: str, w: int, h: int):
    kw = dict(uid=0, R=np.eye(3), T=np.array([0.0, 0.0, 4.0]), fovx=1.0,
              fovy=1.0 * h / w, primx=0.5, primy=0.5, width=w, height=h,
              image_path=image_path, image_name="v", mask_path=mask_path)
    return jdataset.CameraInfo(**kw), tdataset.CameraInfo(**kw)


@pytest.mark.parametrize("resolution", [1, 2, -1])
def test_load_view_matches_jax(tmp_path, resolution):
    """``load_view`` of both packages on JPEG views (4:2:0, gray, Adobe
    RGB, progressive, 4:2:2 with a JPEG mask): gt and alpha within 1e-6
    (the scene test's tolerance; resolution 2 and -1 at a width of 3200
    resize by an integer factor, where area resizing equals OpenCV's
    INTER_AREA)."""
    rng = np.random.default_rng(8)
    for image, mask in _views(str(tmp_path), rng, resolution == -1):
        h, w = _pil_decode(open(image, "rb").read()).shape[:2]
        jinfo, tinfo = _infos(image, mask, w, h)
        jv = jloader.load_view(jinfo, resolution)
        tv = tloader.load_view(tinfo, resolution)
        for f in ("gt_image", "alpha_mask"):
            assert getattr(tv, f).shape == getattr(jv, f).shape
            np.testing.assert_allclose(getattr(tv, f), getattr(jv, f),
                                       rtol=1e-6, atol=1e-6, err_msg=f)
        assert (tv.camera.width, tv.camera.height) == (jv.camera.width,
                                                       jv.camera.height)


@pytest.mark.parametrize("orientation", [1, 6, 8])
def test_laplacian_variance_matches_jax(tmp_path, orientation):
    """The JAX package's ``cv2.imread`` turns the view by its EXIF
    orientation before the Laplacian; so does the port: within 1e-5
    relative (float32 variance there, float64 here)."""
    path = str(tmp_path / f"o{orientation}.jpg")
    img = _texture(np.random.default_rng(orientation), 37, 58)
    with open(path, "wb") as f:
        f.write(_pil_jpeg(img, quality=85, exif=_exif(orientation)))
    assert texif.orientation(path) == orientation
    want = jchunk.laplacian_variance(path)
    got = tchunk.laplacian_variance(path, device="cpu")
    assert got == pytest.approx(want, rel=1e-5)
    assert imgproc.load_bgr8(path).shape[:2] == (
        (58, 37) if orientation != 1 else (37, 58))


@pytest.mark.parametrize("orientation", [None, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9])
@pytest.mark.parametrize("kind", ["ycc", "gray", "rgb"])
def test_imgproc_reads_match_cv2(tmp_path, kind, orientation):
    """``load_bgr8``, ``load_gray8`` and ``load_unchanged`` bit-equal to
    ``cv2.imread`` in IMREAD_COLOR, IMREAD_GRAYSCALE (libjpeg's Y plane
    for YCbCr, not BGR2GRAY of the colours) and IMREAD_UNCHANGED on JPEG:
    the first two turned by the EXIF orientation (values outside 1-8 leave
    the image as stored), the last never."""
    path = str(tmp_path / "v.jpg")
    img = _texture(np.random.default_rng(9), 30, 44, 1 if kind == "gray"
                   else 3)
    kw = {"quality": 90, "keep_rgb": kind == "rgb"}
    if orientation is not None:
        kw["exif"] = _exif(orientation)
    with open(path, "wb") as f:
        f.write(_pil_jpeg(img, **kw))
    assert texif.orientation(path) == (1 if orientation is None
                                       else orientation)
    for fn, flag in ((imgproc.load_bgr8, cv2.IMREAD_COLOR),
                     (imgproc.load_gray8, cv2.IMREAD_GRAYSCALE),
                     (imgproc.load_unchanged, cv2.IMREAD_UNCHANGED)):
        want = cv2.imread(path, flag)
        got = fn(path)
        assert got.shape == want.shape, (fn.__name__, got.shape)
        np.testing.assert_array_equal(got, want, err_msg=fn.__name__)


def _train_step_on_jpeg(tmp_path, progressive: bool) -> None:
    """One flat train step of both packages on a view both loaders read
    from a 4:2:0 JPEG (with a JPEG mask): losses within 1e-5 and the
    state as ``test_torch_train.test_train_step_matches_jax`` holds it,
    from its setup."""
    st, exposure, _, _ = _step_setup()
    rng = np.random.default_rng(11)
    image = str(tmp_path / "view.jpg")
    mask = str(tmp_path / "mask.jpg")
    with open(image, "wb") as f:
        f.write(_pil_jpeg(_texture(rng, 48, 64), quality=90,
                          progressive=progressive))
    assert (tjpeg.jpeg_info(open(image, "rb").read())["sof"]
            == "progressive") == progressive
    m = np.where(_texture(rng, 48, 64, 1)[..., 0] > 40, 255, 0)
    with open(mask, "wb") as f:
        f.write(_pil_jpeg(m.astype(np.uint8)[..., None], quality=95))
    jinfo, tinfo = _infos(image, mask, 64, 48)
    jv = jloader.load_view(jinfo, 1, image_idx=1)
    tv = tloader.load_view(tinfo, 1, image_idx=1)
    tb = tviews.staged_to_device(tviews.stage_view(tv, pin=False), "cpu")
    opt_kw = dict(iterations=100, densify_grad_threshold=1e9)
    j_step = jstep.make_train_step(JOptCfg(**opt_kw), XCFG)
    t_step = tstep.make_train_step(TOptCfg(**opt_kw), tras.RasterizeConfig())
    t_st = _tstate_of(st)
    jo = jadam.init(st.trainable_dict())
    t_o = tstate.adam_from_jax_arrays(*_opt_arrays(jo), device="cpu")
    je = jnp.asarray(exposure)
    jeo = jadam.init({"exposure": je})
    t_eo = tstate.adam_from_jax_arrays(*_opt_arrays(jeo), device="cpu")
    bg = np.zeros(3, np.float32)
    jout = j_step(st, jo, je, jeo, jv, jnp.asarray(7.0), jnp.asarray(bg),
                  jnp.asarray(2.0), jnp.asarray(3.0), 1)
    tout = t_step(t_st, t_o, t_(exposure), t_eo, tb, 7, t_(bg), 2.0, 3.0, 1)
    assert float(jout.photo_loss) > 0
    np.testing.assert_allclose(float(tout.photo_loss),
                               float(jout.photo_loss), rtol=1e-5)
    assert int(tout.n_visible) == int(jout.n_visible) > 0
    _assert_state_close(tout.state, jout.state, rtol=1e-5, atol=2e-6,
                        fields=tstate.TENSOR_FIELDS)


def test_train_step_on_jpeg_view_matches_jax(tmp_path):
    """``_train_step_on_jpeg`` on a baseline view."""
    _train_step_on_jpeg(tmp_path, progressive=False)


def test_train_step_on_progressive_view_matches_jax(tmp_path):
    """``_train_step_on_jpeg`` on a progressive view (the JAX loader reads
    it through PIL, the port through its own decoder)."""
    _train_step_on_jpeg(tmp_path, progressive=True)
