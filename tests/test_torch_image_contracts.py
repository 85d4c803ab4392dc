"""The views' pixels as the JAX package sees them: the port's PNG decode
of every kind under the three contracts its callers hold (PIL's
``np.asarray(Image.open(p))``, PIL's ``convert("RGB"/"RGBA")`` and
``cv2.imread``'s three modes), OpenCV's INTER_AREA resize
(``imgproc.resize_area``) and ``load_view`` of both packages on views,
masks and depth maps of those kinds. Exact unless a test states a
tolerance."""
from __future__ import annotations

import hashlib
import json
import os
import struct
import zlib

import cv2
import jax  # noqa: F401  (the JAX loader below runs beside torch)
import numpy as np
import pytest
import torch
from PIL import Image

from h3dgs_tpu.scene import loader as jloader
from h3dgs_tpu.scene.dataset import CameraInfo as JInfo
from h3dgs_tpu_torch.io import image as timage
from h3dgs_tpu_torch.preprocess import imgproc
from h3dgs_tpu_torch.scene import loader as tloader
from h3dgs_tpu_torch.scene.dataset import CameraInfo as TInfo

torch.set_num_threads(2)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURES = os.path.join(REPO, "tests", "data", "torch_png")

# (colour type, bit depth, with tRNS): every kind the specification
# allows, each written non-interlaced and Adam7.
KINDS = ([(0, d, t) for d in (1, 2, 4, 8, 16) for t in (False, True)]
         + [(2, d, t) for d in (8, 16) for t in (False, True)]
         + [(3, d, t) for d in (1, 2, 4, 8) for t in (False, True)]
         + [(c, d, False) for c in (4, 6) for d in (8, 16)])
SIZES = [(13, 11), (1, 1), (2, 9), (9, 2), (17, 23), (5, 3), (8, 8)]


def kind_id(kind, interlace):
    c, d, t = kind
    return f"c{c}d{d}{'t' if t else ''}{'i' if interlace else ''}"


def make_kind(kind, interlace, seed):
    """(PNG bytes, samples) of one kind: random samples (smooth rows too,
    so that Paeth picks each neighbour), a palette shorter than the depth
    allows, a tRNS shorter than the palette or a key that occurs, and
    every filter type."""
    ctype, depth, trns = kind
    rng = np.random.default_rng(seed)
    h, w = SIZES[seed % len(SIZES)]
    chans = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}[ctype]
    top = (1 << depth) - 1
    palette = tr = None
    if ctype == 3:
        n = max(2, min(top + 1, 200) - 3)
        palette = rng.integers(0, 256, (n, 3))
        top = n - 1
        if trns:
            tr = rng.integers(0, 256, max(1, n - 2))
    s = rng.integers(0, top + 1, (h, w, chans))
    ramp = np.linspace(0, top, w).astype(np.int64)[:, None]
    s[: h // 2] = np.clip(ramp + 3 * np.arange(h // 2)[:, None, None], 0,
                          top)
    if trns and ctype in (0, 2):
        tr = s[0, 0]
    s = s.astype(np.uint16 if depth == 16 else np.uint8)
    body = timage.encode_png_samples(s, depth, ctype, palette, tr,
                                     interlace, filters=(0, 1, 2, 3, 4, 4))
    return body, s


def pil_arrays(path):
    with Image.open(path) as im:
        arr = np.asarray(im)
        rgb = np.asarray(im.convert("RGBA" if im.mode == "RGBA" else "RGB"))
    return arr, rgb


OPENCV = ((imgproc.load_unchanged, cv2.IMREAD_UNCHANGED),
          (imgproc.load_bgr8, cv2.IMREAD_COLOR),
          (imgproc.load_gray8, cv2.IMREAD_GRAYSCALE))


def assert_same(got, want, what):
    assert got.dtype == want.dtype and got.shape == want.shape, \
        (what, got.dtype, got.shape, want.dtype, want.shape)
    assert np.array_equal(got, want), what


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
@pytest.mark.parametrize("interlace", [False, True])
@pytest.mark.parametrize("kind", KINDS, ids=[kind_id(k, 0) for k in KINDS])
def test_png_kind_contracts(tmp_path, kind, interlace):
    """Every PNG kind decodes to its samples, and under each contract to
    PIL's and OpenCV's arrays bit for bit (dtype and shape included)."""
    seed = KINDS.index(kind) * 2 + interlace
    body, samples = make_kind(kind, interlace, seed)
    path = str(tmp_path / "k.png")
    with open(path, "wb") as f:
        f.write(body)
    png = timage.decode_png_image(body, path)
    assert_same(png.samples, samples, "samples")
    arr, rgb = pil_arrays(path)
    assert_same(timage.read_image(path), arr, "array")
    assert_same(timage.read_image(path, "rgb"), rgb, "rgb")
    for fn, flag in OPENCV:
        assert_same(fn(path), cv2.imread(path, flag), fn.__name__)


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
@pytest.mark.parametrize("depth", [1, 2, 4, 8])
def test_png_palette_index_past_plte(tmp_path, depth):
    """An index past the end of ``PLTE`` (an invalid file both decoders
    read): PIL and libpng both give black, alpha 255 past ``tRNS``."""
    n = 1 if depth == 1 else 2
    s = np.array([[0, (1 << depth) - 1, n - 1, n]]).astype(np.uint8)
    body = timage.encode_png_samples(s, depth, 3, [[9, 99, 199]] * n,
                                     [17] * n)
    path = str(tmp_path / "p.png")
    with open(path, "wb") as f:
        f.write(body)
    arr, rgb = pil_arrays(path)
    assert_same(timage.read_image(path), arr, "array")
    assert_same(timage.read_image(path, "rgb"), rgb, "rgb")
    for fn, flag in OPENCV:
        assert_same(fn(path), cv2.imread(path, flag), fn.__name__)


@pytest.mark.parametrize("row_bytes,bpp", [(1, 1), (2, 1), (7, 1), (13, 1),
                                           (6, 2), (9, 3), (8, 4), (12, 6),
                                           (16, 8)])
def test_unfilter_native_matches_plain(row_bytes, bpp):
    """The C++ unfilter equals ``unfilter_plain`` on rows of every width a
    sub-byte or Adam7 pass gives (one byte to a few pixels), each row
    under a random filter type, on smooth bytes and noise."""
    rng = np.random.default_rng(row_bytes * 10 + bpp)
    height = 11
    data = rng.integers(0, 256, (height, 1 + row_bytes)).astype(np.uint8)
    data[::2, 1:] = np.arange(row_bytes, dtype=np.uint8) * 3
    data[:, 0] = rng.integers(0, 5, height)
    data[:5, 0] = np.arange(5)
    assert timage._native_unfilter() is not None
    np.testing.assert_array_equal(
        timage._unfilter(data.reshape(-1), height, row_bytes, bpp),
        timage.unfilter_plain(data.reshape(-1), height, row_bytes, bpp))


@pytest.mark.parametrize("kind", [(0, 1, False), (0, 4, False),
                                  (3, 2, True), (2, 16, False),
                                  (4, 8, False), (6, 16, False)],
                         ids=["c0d1", "c0d4", "c3d2t", "c2d16", "c4d8",
                              "c6d16"])
def test_adam7_native_and_plain(tmp_path, monkeypatch, kind):
    """Adam7 files (sub-byte and multi-byte pixels) decode to the same
    samples through the C++ unfilter and through the numpy one."""
    body, samples = make_kind(kind, True, 4)
    native = timage.decode_png_image(body).samples
    monkeypatch.setattr(timage, "_NATIVE", None)
    monkeypatch.setattr("h3dgs_tpu_torch.native.compiler", lambda: None)
    assert timage._native_unfilter() is None
    np.testing.assert_array_equal(timage.decode_png_image(body).samples,
                                  native)
    np.testing.assert_array_equal(native, samples)


def test_png_bad_kinds_raise():
    """A bit depth a colour type does not allow, an unknown interlace
    method and a palette file without PLTE raise naming the source."""
    ok = timage.encode_png_samples(np.zeros((2, 2), np.uint8), 8, 0)

    def with_ihdr(depth, ctype, interlace):
        body = struct.pack(">IIBBBBB", 2, 2, depth, ctype, 0, 0, interlace)
        chunk = (struct.pack(">I", 13) + b"IHDR" + body
                 + struct.pack(">I", zlib.crc32(b"IHDR" + body)))
        return ok[:8] + chunk + ok[8 + 25:]
    with pytest.raises(ValueError, match="x.png: PNG color type 2 at 4"):
        timage.decode_png_image(with_ihdr(4, 2, 0), "x.png")
    with pytest.raises(ValueError, match="x.png: PNG interlace method 2"):
        timage.decode_png_image(with_ihdr(8, 0, 2), "x.png")
    with pytest.raises(ValueError, match="x.png: palette PNG without PLTE"):
        timage.decode_png_image(with_ihdr(8, 3, 0), "x.png")


# -------------------------------------------------------------- resize ---

RESIZE = [((225, 400), (180, 320)),      # 1.25
          ((225, 400), (140, 250)),      # 1.6
          ((225, 400), (90, 160)),       # 2.5
          ((225, 400), (65, 117)),       # 3.42
          ((225, 400), (270, 480)),      # enlargement
          ((6, 4001), (3, 2000)),        # slivers under 1e-3
          ((225, 1), (90, 1)),           # a one-pixel-wide side
          ((1, 400), (1, 117)),
          ((3, 1), (7, 1)),              # one pixel wide, enlarged
          ((90, 160), (61, 200)),        # one axis shrinks, one grows
          ((225, 400), (75, 100))]       # integer factors (3, 4)


@pytest.mark.parametrize("chans", [1, 3, 4])
@pytest.mark.parametrize("src,dst", RESIZE,
                         ids=[f"{s[1]}x{s[0]}-{d[1]}x{d[0]}"
                              for s, d in RESIZE])
def test_resize_area_matches_cv2(src, dst, chans):
    """``resize_area`` equals ``cv2.resize(INTER_AREA)`` bit for bit on
    float32 in [0, 1] (tolerance 0) at every non-integer factor, the
    enlargement and the sliver case, in C++ and in the plain version;
    within 1e-6 at integer factors (torch's block mean against OpenCV's
    sum times the reciprocal)."""
    shape = src if chans == 1 else src + (chans,)
    img = np.random.default_rng(sum(src) + chans).uniform(
        0, 1, shape).astype(np.float32)
    want = cv2.resize(img, (dst[1], dst[0]), interpolation=cv2.INTER_AREA)
    integer = src[0] % dst[0] == 0 and src[1] % dst[1] == 0 and \
        src != dst and dst[0] <= src[0] and dst[1] <= src[1]
    tol = 1e-6 if integer else 0.0
    assert imgproc._native_resize() is not None
    got = imgproc.resize_area(torch.from_numpy(img), *dst).numpy()
    assert got.shape == want.shape and got.dtype == np.float32
    np.testing.assert_allclose(got, want, rtol=0, atol=tol)
    taps = imgproc._linear_taps if dst[0] > src[0] or dst[1] > src[1] \
        else imgproc._area_taps
    if not integer:
        xt = taps(src[1], dst[1], 1.0 / (dst[1] / src[1]))
        yt = taps(src[0], dst[0], 1.0 / (dst[0] / src[0]))
        plain = imgproc._apply_taps(imgproc._apply_taps(
            torch.from_numpy(img), 1, *xt), 0, *yt).numpy()
        np.testing.assert_array_equal(plain, want)


def test_resize_area_taps_are_banded():
    """At most ``ceil(scale) + 1`` taps a destination pixel, and a
    sliver of 1e-3 or less is dropped (the weights of pixel 0 at scale
    2.0005 sum to 2 / 2.0005, not 1)."""
    for src, dst in ((4032, 1600), (4000, 1600), (5472, 1600),
                     (1600, 1000), (400, 117)):
        idx, w = imgproc._area_taps(src, dst, 1.0 / (dst / src))
        assert idx.shape[1] <= int(np.ceil(src / dst)) + 1
        assert (idx >= 0).all() and (idx < src).all()
    idx, w = imgproc._area_taps(4001, 2000, 1.0 / (2000 / 4001))
    assert w[0].sum(dtype=np.float64) == pytest.approx(2 / 2.0005, rel=1e-6)


def test_resize_area_plain_without_compiler(monkeypatch):
    """Where no C++ compiler is found, ``resize_area`` runs the plain
    version, with the same result."""
    img = np.random.default_rng(0).uniform(0, 1, (45, 80, 3)).astype(
        np.float32)
    native = imgproc.resize_area(torch.from_numpy(img), 28, 50).numpy()
    monkeypatch.setattr(imgproc, "_NATIVE", None)
    monkeypatch.setattr("h3dgs_tpu_torch.native.compiler", lambda: None)
    assert imgproc._native_resize() is None
    np.testing.assert_array_equal(
        imgproc.resize_area(torch.from_numpy(img), 28, 50).numpy(), native)


# ----------------------------------------------------------- load_view ---

def _infos(root, image, mask="", depth="", params=None):
    kw = dict(uid=0, R=np.eye(3), T=np.array([0.1, -0.2, 3.0]), fovx=1.1,
              fovy=0.7, primx=0.5, primy=0.5, width=0, height=0,
              image_path=os.path.join(root, image), image_name="v",
              mask_path=os.path.join(root, mask) if mask else "",
              depth_path=os.path.join(root, depth) if depth else "",
              depth_params=params)
    return JInfo(**kw), TInfo(**kw)


def _write(root, name, body):
    with open(os.path.join(root, name), "wb") as f:
        f.write(body)
    return name


def assert_views_match(jinfo, tinfo, resolution):
    jv = jloader.load_view(jinfo, resolution, image_idx=3)
    tv = tloader.load_view(tinfo, resolution, image_idx=3)
    for f in ("gt_image", "alpha_mask", "invdepth", "depth_mask"):
        a, b = getattr(tv, f), getattr(jv, f)
        assert a.shape == b.shape, f
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-6, err_msg=f)
    assert bool(tv.depth_reliable) == bool(jv.depth_reliable)
    assert (tv.camera.height, tv.camera.width) == (jv.camera.height,
                                                   jv.camera.width)
    return tv


def _view(rng, h, w, chans=3, depth=8):
    top = (1 << depth) - 1
    yy, xx = np.mgrid[0:h, 0:w]
    smooth = (np.sin(xx / 17.0) * np.cos(yy / 11.0) + 1) / 2 * top
    img = smooth[..., None] + rng.normal(0, top / 10, (h, w, chans))
    return np.clip(img, 0, top).astype(np.uint16 if depth == 16
                                       else np.uint8)


@pytest.mark.parametrize("resolution", [250, 320, 480, -1])
def test_load_view_factors_match_jax(tmp_path, resolution):
    """A 400x225 view with a 16-bit depth map at half size: 1.6, 1.25 and
    an enlargement (480 wide) on view, mask and depth, within 1e-6."""
    root = str(tmp_path)
    rng = np.random.default_rng(abs(resolution))
    Image.fromarray(_view(rng, 225, 400)).save(os.path.join(root, "v.png"))
    Image.fromarray(_view(rng, 225, 400, 1)[..., 0]).save(
        os.path.join(root, "m.png"))
    cv2.imwrite(os.path.join(root, "d.png"), _view(rng, 112, 200, 1, 16))
    jinfo, tinfo = _infos(root, "v.png", "m.png", "d.png",
                          {"scale": 0.8, "offset": -0.05})
    tv = assert_views_match(jinfo, tinfo, resolution)
    assert tv.camera.width == (400 if resolution == -1 else resolution)


def test_load_view_4000_wide_matches_jax(tmp_path):
    """A 4000x2250 PNG view at ``-r -1``: shrunk by 2.5 to 1600x900,
    within 1e-6 of the JAX loader."""
    root = str(tmp_path)
    rng = np.random.default_rng(7)
    cv2.imwrite(os.path.join(root, "big.png"), _view(rng, 2250, 4000),
                [cv2.IMWRITE_PNG_COMPRESSION, 1])
    jinfo, tinfo = _infos(root, "big.png")
    tv = assert_views_match(jinfo, tinfo, -1)
    assert (tv.camera.width, tv.camera.height) == (1600, 900)


VIEW_CASES = ["mask1", "mask_palette", "rgb16", "gray16", "ga16_view",
              "depth_ga", "depth_ga16", "depth_rgb", "depth_missing",
              "palette_view"]


@pytest.mark.filterwarnings("ignore:Palette images with Transparency")
@pytest.mark.parametrize("case", VIEW_CASES)
def test_load_view_kinds_match_jax(tmp_path, case):
    """Views, masks and depth maps of the repaired kinds, at 1.25
    (``-r 320`` on 400x225): a 1-bit mask, a palette mask, 16-bit RGB and
    gray views (gray clipped at 255 by PIL in both), 16-bit gray+alpha
    (RGBA to PIL) and palette views, gray+alpha and BGR depth maps
    (channel 0 after the resize) and a missing depth file (no depth)."""
    root = str(tmp_path)
    rng = np.random.default_rng(VIEW_CASES.index(case))
    h, w = 225, 400
    image, mask, depth = "v.png", "", "d.png"
    view = timage.encode_png_samples(_view(rng, h, w), 8, 2)
    if case == "mask1":
        mask = _write(root, "m.png", timage.encode_png_samples(
            (_view(rng, h, w, 1) > 128).astype(np.uint8), 1, 0))
    elif case == "mask_palette":
        mask = _write(root, "m.png", timage.encode_png_samples(
            _view(rng, h, w, 1) // 64, 2, 3, [[0, 0, 0], [80, 80, 80],
                                              [160, 0, 9], [255, 255, 255]],
            [0, 255]))
    elif case == "rgb16":
        view = timage.encode_png_samples(_view(rng, h, w, 3, 16), 16, 2)
    elif case == "gray16":
        g = _view(rng, h, w, 1, 16)
        g[: h // 3] //= 300            # some values under 255 survive
        view = timage.encode_png_samples(g, 16, 0)
    elif case == "ga16_view":
        view = timage.encode_png_samples(_view(rng, h, w, 2, 16), 16, 4)
    elif case == "palette_view":
        view = timage.encode_png_samples(
            _view(rng, h, w, 1) // 16, 4, 3,
            rng.integers(0, 256, (16, 3)), rng.integers(0, 256, 10))
    _write(root, image, view)
    if case in ("depth_ga", "depth_ga16"):
        d = 8 if case == "depth_ga" else 16
        _write(root, depth, timage.encode_png_samples(
            _view(rng, h // 2, w // 2, 2, d), d, 4))
    elif case == "depth_rgb":
        _write(root, depth, timage.encode_png_samples(
            _view(rng, h // 2, w // 2, 3, 16), 16, 2))
    elif case != "depth_missing":
        _write(root, depth, timage.encode_png_samples(
            _view(rng, h // 2, w // 2, 1, 16), 16, 0))
    jinfo, tinfo = _infos(root, image, mask, depth,
                          {"scale": 1.5, "offset": 0.01, "med_scale": 1.2})
    tv = assert_views_match(jinfo, tinfo, 320)
    assert bool(tv.depth_reliable) == (case != "depth_missing")
    if case == "depth_missing":
        assert not tv.invdepth.any() and not tv.depth_mask.any()


def test_load_view_undecodable_depth_raises(tmp_path):
    """A depth file that exists but cannot be decoded raises with its
    name (``cv2.imread`` would give ``None`` and the JAX loader would
    drop the view's depth)."""
    root = str(tmp_path)
    _write(root, "v.png", timage.encode_png_samples(
        np.zeros((9, 16, 3), np.uint8), 8, 2))
    _write(root, "d.png", timage.PNG_SIGNATURE + b"\0" * 40)
    _, tinfo = _infos(root, "v.png", "", "d.png", {"scale": 1.0,
                                                    "offset": 0.0})
    with pytest.raises(ValueError, match="d.png"):
        tloader.load_view(tinfo, -1)


# ------------------------------------------------------------ fixtures ---

def _digest(a):
    head = f"{a.dtype.str}{a.shape}".encode()
    # PIL's bool arrays hold True as byte 255: hash the values, 0 or 1.
    a = np.ascontiguousarray(a, np.uint8 if a.dtype == bool else a.dtype)
    return hashlib.sha256(head + a.tobytes()).hexdigest()


def test_committed_fixtures_match_manifest():
    """The committed PNG fixtures decode under every contract to the
    digests PIL and cv2 gave when they were made, and the committed
    resize cases match ``resize_area`` within their stated tolerance (the
    check ``chip_smoke.py`` runs on the card's machine, which has
    neither library)."""
    with open(os.path.join(FIXTURES, "manifest.json")) as f:
        manifest = json.load(f)
    assert len(manifest["png"]) >= 2 * len(KINDS)
    for name, entry in manifest["png"].items():
        path = os.path.join(FIXTURES, name)
        assert _digest(timage.read_image(path)) == entry["pil_array"], name
        assert _digest(timage.read_image(path, "rgb")) == entry["pil_rgb"]
        for fn, flag in OPENCV:
            key = {cv2.IMREAD_UNCHANGED: "cv2_unchanged",
                   cv2.IMREAD_COLOR: "cv2_color",
                   cv2.IMREAD_GRAYSCALE: "cv2_gray"}[flag]
            assert _digest(fn(path)) == entry[key], (name, key)
    for name, entry in manifest["resize"].items():
        src = np.load(os.path.join(FIXTURES, entry["src"]))
        want = np.load(os.path.join(FIXTURES, entry["want"]))
        got = imgproc.resize_area(torch.from_numpy(src), *want.shape[:2])
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=entry["atol"], err_msg=name)
