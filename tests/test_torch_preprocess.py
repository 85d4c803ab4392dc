"""Preprocessing in the port (``h3dgs_tpu_torch.preprocess``) against the
JAX package's (``h3dgs_tpu.preprocess``, with OpenCV and PIL): the same
seeded inputs through both, the port on ``device="cpu"``.

OpenCV's contracts (``imgproc``) are held bit for bit where they are
integer (gray, erosion, nearest resize, channel picks) and within stated
tolerances where they are float (Laplacian variance 1e-5 relative,
bilinear 1e-6). Chunk trees, host-module outputs and match lists are held
byte for byte, masks pixel for pixel, depth parameters within 1e-6
relative, and the COLMAP command lines argument for argument.
"""
from __future__ import annotations

import ast
import dataclasses
import json
import os
import random
import shutil
import sqlite3
import struct
import sys
import warnings

import cv2
import jax  # noqa: F401  (both frameworks in one process, JAX on the CPU)
import numpy as np
import pytest
import torch
from PIL import Image, TiffImagePlugin

from h3dgs_tpu.io import colmap as JC
from h3dgs_tpu.preprocess import chunk as jchunk
from h3dgs_tpu.preprocess import colmap_db as jdb
from h3dgs_tpu.preprocess import depth_scale as jdepth
from h3dgs_tpu.preprocess import drivers as jdrivers
from h3dgs_tpu.preprocess import masks as jmasks
from h3dgs_tpu.preprocess import matchers as jmatch
from h3dgs_tpu.preprocess import reorient as jreorient
from h3dgs_tpu.preprocess import simplify as jsimplify
from h3dgs_tpu.preprocess import transform as jtransform
from h3dgs_tpu_torch.io.image import write_png
from h3dgs_tpu_torch.preprocess import chunk as tchunk
from h3dgs_tpu_torch.preprocess import colmap_db as tdb
from h3dgs_tpu_torch.preprocess import depth_scale as tdepth
from h3dgs_tpu_torch.preprocess import drivers as tdrivers
from h3dgs_tpu_torch.preprocess import imgproc
from h3dgs_tpu_torch.preprocess import masks as tmasks
from h3dgs_tpu_torch.preprocess import matchers as tmatch
from h3dgs_tpu_torch.preprocess import reorient as treorient
from h3dgs_tpu_torch.preprocess import simplify as tsimplify
from h3dgs_tpu_torch.preprocess import transform as ttransform

from .test_torch_common import PORT_DIR, REPO, cut_progressive

torch.set_num_threads(2)

CPU = "cpu"


# ------------------------------------------------------------- helpers ---

def files_under(root) -> list:
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def sqlite_rows(path) -> dict:
    conn = sqlite3.connect(path)
    try:
        tables = [r[0] for r in conn.execute(
            "SELECT name FROM sqlite_master WHERE type='table' "
            "ORDER BY name")]
        return {t: conn.execute(f"SELECT * FROM {t} ORDER BY 1").fetchall()
                for t in tables}
    finally:
        conn.close()


def assert_depth_params_close(got: dict, want: dict):
    """Same views; scale and offset within 1e-6 relative (the bilinear
    samples agree with ``cv2.remap`` within 2e-7)."""
    assert sorted(got) == sorted(want)
    for k in want:
        for q in ("scale", "offset"):
            np.testing.assert_allclose(got[k][q], want[k][q], rtol=1e-6,
                                       atol=1e-9, err_msg=k)


def assert_trees_equal(a, b):
    """Same files; equal bytes, except PNGs (equal decoded pixels: OpenCV's
    encoder and the port's write other bytes), sqlite databases (equal
    rows) and depth_params.json (``assert_depth_params_close``)."""
    fa, fb = files_under(a), files_under(b)
    assert fa == fb
    for rel in fa:
        pa, pb = os.path.join(a, rel), os.path.join(b, rel)
        if rel.endswith(".png"):
            ia = cv2.imread(pa, cv2.IMREAD_UNCHANGED)
            ib = cv2.imread(pb, cv2.IMREAD_UNCHANGED)
            assert ia.shape == ib.shape and np.array_equal(ia, ib), rel
        elif rel.endswith(".db"):
            assert sqlite_rows(pa) == sqlite_rows(pb), rel
        elif rel.endswith("depth_params.json"):
            assert_depth_params_close(*(json.load(open(q)) for q in (pb, pa)))
        else:
            with open(pa, "rb") as f, open(pb, "rb") as g:
                assert f.read() == g.read(), rel


def textured(rng, h, w, blur=0) -> np.ndarray:
    """[h, w, 3] uint8 noise, box-blurred ``blur`` times by 5 x 5."""
    img = rng.integers(0, 256, (h, w, 3)).astype(np.float64)
    for _ in range(blur):
        img = cv2.blur(img, (5, 5))
    return np.clip(img, 0, 255).astype(np.uint8)


def look_rotation(look_dir) -> np.ndarray:
    z = np.asarray(look_dir, float) / np.linalg.norm(look_dir)
    up = np.array([0.0, 1.0, 0.0]) if abs(z[1]) < 0.9 else np.array(
        [1.0, 0.0, 0.0])
    x = np.cross(up, z)
    x /= np.linalg.norm(x)
    return np.stack([x, np.cross(z, x), z])


def jimage(iid, center, look_dir, name, xys, pids) -> JC.ColmapImage:
    R = look_rotation(look_dir)
    return JC.ColmapImage(iid, JC.rotmat2qvec(R),
                          -R @ np.asarray(center, float), 1, name,
                          np.asarray(xys, float), np.asarray(pids, np.int64))


def jpoints(xyz, error=None) -> JC.ColmapPoints3D:
    n = len(xyz)
    return JC.ColmapPoints3D(
        ids=np.arange(1, n + 1), xyz=np.asarray(xyz, float),
        rgb=np.full((n, 3), 120, np.uint8),
        error=np.zeros(n) if error is None else error,
        track_offsets=np.zeros(n + 1, np.int64),
        track_image_ids=np.zeros(0, np.int32),
        track_point2d_idxs=np.zeros(0, np.int32))


def pinhole(w=64, h=48, f=50.0) -> JC.ColmapCamera:
    return JC.ColmapCamera(1, "PINHOLE", w, h, np.asarray([f, f, w / 2,
                                                             h / 2]))


def write_png_rgb(path, rng, kind, h=24, w=32):
    """Write a seeded image of one PNG kind (gray / ga / rgb / rgba, with
    16 for 16 bits) in the port's RGB order."""
    depth16 = kind.endswith("16")
    top = 65536 if depth16 else 256
    dtype = np.uint16 if depth16 else np.uint8
    chans = {"gray": 1, "ga": 2, "rgb": 3, "rgba": 4}[kind.rstrip("16")]
    img = rng.integers(0, top, (h, w, chans)).astype(dtype)
    if chans >= 3:      # some pixels with R = G = B (libpng's gray rule)
        img[:3, :3, 1] = img[:3, :3, 0]
        img[:3, :3, 2] = img[:3, :3, 0]
    write_png(str(path), img[..., 0] if chans == 1 else img)


# ------------------------------------------------------------- imgproc ---

KINDS = ["gray", "ga", "rgb", "rgba", "gray16", "ga16", "rgb16", "rgba16"]


@pytest.mark.parametrize("kind", KINDS)
def test_loaders_keep_opencv_channels(tmp_path, kind):
    """load_unchanged / load_bgr8 / load_gray8 equal cv2.imread with
    IMREAD_UNCHANGED / IMREAD_COLOR / IMREAD_GRAYSCALE on every PNG kind
    (gray+alpha gives 4 channels, RGB comes back BGR, 16 bits keep their
    high byte in 8-bit reads)."""
    path = str(tmp_path / f"{kind}.png")
    write_png_rgb(path, np.random.default_rng(KINDS.index(kind)), kind)
    for mine, flag in ((imgproc.load_unchanged, cv2.IMREAD_UNCHANGED),
                       (imgproc.load_bgr8, cv2.IMREAD_COLOR),
                       (imgproc.load_gray8, cv2.IMREAD_GRAYSCALE)):
        want = cv2.imread(path, flag)
        got = mine(path)
        assert got.dtype == want.dtype and got.shape == want.shape, mine
        assert np.array_equal(got, want), mine
    assert imgproc.load_bgr8(str(tmp_path / "missing.png")) is None


def test_gray_matches_cvtcolor():
    rng = np.random.default_rng(0)
    bgr = rng.integers(0, 256, (61, 83, 3)).astype(np.uint8)
    got = imgproc.gray_bgr2gray(torch.from_numpy(bgr)).numpy()
    assert np.array_equal(got, cv2.cvtColor(bgr, cv2.COLOR_BGR2GRAY))


@pytest.mark.parametrize("k", [0, 4, 5])
def test_erode_matches_cv2(k):
    """k > 0: cv2.erode with an all-ones k x k kernel, border never
    eroded; k = 0: the input, as the JAX masks skip the call."""
    rng = np.random.default_rng(k)
    binary = (rng.uniform(size=(37, 45)) > 0.2).astype(np.uint8) * 255
    binary[:, :3] = 255                  # a border that must not erode
    got = imgproc.erode(torch.from_numpy(binary), k).numpy()
    want = cv2.erode(binary, np.ones((k, k), np.uint8)) if k else binary
    assert np.array_equal(got, want)


@pytest.mark.parametrize("kind", ["rgb", "rgba", "gray", "rgb16", "missing"])
def test_laplacian_variance_matches_jax(tmp_path, kind):
    path = str(tmp_path / "v.png")
    if kind != "missing":
        rng = np.random.default_rng(len(kind))
        write_png_rgb(path, rng, kind, h=48, w=64)
    want = jchunk.laplacian_variance(path)
    got = tchunk.laplacian_variance(path, device=CPU)
    if kind == "missing":
        assert want == got == 0.0
    else:
        assert want > 0
        np.testing.assert_allclose(got, want, rtol=1e-5)


def test_bilinear_matches_remap():
    rng = np.random.default_rng(3)
    img = rng.uniform(0, 1, (45, 80)).astype(np.float32)
    x = rng.uniform(-3, 83, 4000).astype(np.float32)
    y = rng.uniform(-3, 48, 4000).astype(np.float32)
    # on and past the border, on pixel centres, just inside the last one
    x[:12] = [0, 79, 79.5, 80, -1, 0.5, 78.99999, 79.00001, 40, 3, -0.5, 81]
    y[:12] = [0, 44, 44.5, 45, -1, 0.5, 43.99999, 44.00001, 0, 44, 22, -2]
    want = cv2.remap(img, x, y, interpolation=cv2.INTER_LINEAR,
                     borderMode=cv2.BORDER_REPLICATE).reshape(-1)
    got = imgproc.sample_bilinear_replicate(
        torch.from_numpy(img), torch.from_numpy(x), torch.from_numpy(y))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)


@pytest.mark.parametrize("src,dst", [((7, 9), (20, 31)), ((40, 50), (13, 17)),
                                     ((30, 10), (21, 7)), ((10, 6), (6, 10)),
                                     ((3, 5), (7, 11))])
def test_resize_nearest_matches_cv2(src, dst):
    m = np.random.default_rng(sum(src)).integers(0, 256, src).astype(
        np.uint8)
    want = cv2.resize(m, (dst[1], dst[0]), interpolation=cv2.INTER_NEAREST)
    got = imgproc.resize_nearest(torch.from_numpy(m), *dst).numpy()
    assert np.array_equal(got, want)


def test_undecodable_image_raises(tmp_path, monkeypatch):
    """A JPEG the port does not read (progressive with unfinished scans),
    with PIL unimportable, raises with the file's name, from the loaders,
    the Laplacian and the depth map reader: it is not read as a missing
    file (which gives 0.0 / None)."""
    path = str(tmp_path / "view.jpg")
    with open(path, "wb") as f:
        f.write(cut_progressive(np.full((12, 16, 3), (40, 80, 120),
                                        np.uint8)))
    monkeypatch.setitem(sys.modules, "PIL", None)
    for fn in (imgproc.load_bgr8, imgproc.load_unchanged,
               imgproc.load_gray8):
        with pytest.raises(ValueError, match="view.jpg"):
            fn(path)
    with pytest.raises(ValueError, match="view.jpg"):
        tchunk.laplacian_variance(path, device=CPU)
    depth_dir = tmp_path / "depths"
    depth_dir.mkdir()
    shutil.copy(path, depth_dir / "v.png")      # a JPEG under a PNG name
    im = JC.ColmapImage(1, np.array([1.0, 0, 0, 0]), np.zeros(3), 1,
                        "v.jpg", np.zeros((0, 2)), np.zeros(0, np.int64))
    with pytest.raises(ValueError, match="v.png"):
        tdepth.get_scale(im, pinhole(), np.zeros((1, 3)), str(depth_dir),
                         device=CPU)


# ------------------------------------------------------------ chunking ---

def write_chunk_scene(base, rng, n_cam=64, n_pts=600):
    """Cameras along a 30 x 1 strip (four 10-unit chunks in a row), each
    seeing the points within 8 units, plus -1 ids, ids of points filtered
    by their error and ids past the last point; 64 x 48 PNG views, every
    seventh heavily blurred; a test.txt of 6 names."""
    centers = np.c_[rng.uniform(0, 30, n_cam), rng.uniform(0, 1, n_cam),
                    rng.uniform(0, 6, n_cam)]
    xyz = np.c_[rng.uniform(-2, 32, n_pts), rng.uniform(-3, 3, n_pts),
                rng.uniform(0, 6, n_pts)]
    error = rng.uniform(0, 1.2, n_pts)
    error[rng.uniform(size=n_pts) < 0.1] = 12.0       # dropped (>= 10)
    images = {}
    img_dir = os.path.join(base, "images")
    os.makedirs(img_dir)
    for i, c in enumerate(centers):
        near = np.nonzero(np.linalg.norm(xyz - c, axis=1) < 8)[0] + 1
        pids = np.concatenate([near, [-1, -1, n_pts + 5]])
        rng.shuffle(pids)
        name = f"im_{i:03d}.png"
        images[i + 1] = jimage(i + 1, c, rng.normal(size=3), name,
                               rng.uniform(0, 60, (len(pids), 2)), pids)
        write_png(os.path.join(img_dir, name),
                  textured(rng, 48, 64, blur=3 if i % 7 == 0 else 0))
    JC.write_model_binary(os.path.join(base, "sparse", "0"), {1: pinhole()},
                          images, jpoints(xyz, error))
    with open(os.path.join(base, "test.txt"), "w") as f:
        f.write("".join(f"im_{i:03d}.png\n" for i in (1, 5, 7, 20, 33, 50)))
    return img_dir


class CountingRandom(random.Random):
    """``random.Random`` that counts its draws by kind."""
    draws: dict = {}

    def uniform(self, a, b):
        key = f"uniform({a}, {b})"
        self.draws[key] = self.draws.get(key, 0) + 1
        return super().uniform(a, b)

    def randint(self, a, b):
        self.draws["randint"] = self.draws.get("randint", 0) + 1
        return super().randint(a, b)


def test_make_chunks_byte_equal(tmp_path, capsys, monkeypatch):
    """Every random draw happens (2x-box cams, far cams, trimming to
    max_n_cams), blurred views are rejected, and both packages write the
    same bytes and the same blending_dict.json."""
    monkeypatch.setattr(random, "Random", CountingRandom)
    monkeypatch.setattr(CountingRandom, "draws", {})
    base = str(tmp_path / "scene")
    img_dir = write_chunk_scene(base, np.random.default_rng(7))
    kw = dict(chunk_size=10.0, lapla_thresh=1.0, min_n_cams=5,
              max_n_cams=24)
    written = {}
    blend = {}
    for pkg, fn, extra in (("jax", jchunk.make_chunks, {}),
                           ("torch", tchunk.make_chunks, {"device": CPU})):
        out = str(tmp_path / pkg)
        written[pkg] = fn(base, img_dir, out, **kw, **extra)
        with open(os.path.join(base, "blending_dict.json")) as f:
            blend[pkg] = json.load(f)
    said = capsys.readouterr().out
    assert_trees_equal(str(tmp_path / "jax"), str(tmp_path / "torch"))
    assert blend["jax"] == blend["torch"]
    assert [c["name"] for c in written["jax"]] == \
        [c["name"] for c in written["torch"]]
    assert len(written["torch"]) == 4
    assert said.count(" 24 cams") == 4           # two chunks trimmed
    assert sorted(CountingRandom.draws) == [
        "randint", "uniform(0, 0.5)", "uniform(0, 1)"]
    blurred = {f"im_{i:03d}.png" for i in range(0, 64, 7)}
    for c in written["torch"]:
        imgs = tchunk.C.read_images_binary(
            str(tmp_path / "torch" / c["name"] / "sparse/0/images.bin"))
        assert not blurred & {im.name for im in imgs.values()}
    assert any(blend["torch"][n] for n in blend["torch"])


def test_visible_counts_match_numpy():
    """The counts per (box, image) equal the JAX package's numpy test,
    also for points on a box's faces (strict inequalities)."""
    rng = np.random.default_rng(2)
    pts = np.round(rng.uniform(0, 4, (500, 3)), 0)      # many on faces
    owner = rng.integers(0, 7, 500)
    boxes = [(np.array([-1e12, 0.0, -1e12]), np.array([2.0, 3.0, 1e12])),
             (np.array([1.0, -1e12, 0.0]), np.array([1e12, 2.0, 3.0]))]
    got = tchunk.visible_counts(torch.from_numpy(pts),
                                torch.from_numpy(owner), 7, boxes)
    for b, (lo, hi) in enumerate(boxes):
        inside = np.all(pts < hi, -1) & np.all(pts > lo, -1)
        assert np.array_equal(got[b], np.bincount(owner[inside],
                                                  minlength=7))


# --------------------------------------------------------------- depth ---

def write_depth_scene(base, depths, rng, w=64, h=48, f=50.0):
    """Views of the JAX test's analytic scene (inverse depth affine in the
    pixel) with maps a * inv_depth + b: v0 full size, v1 a non-affine map,
    v2 at half resolution, v3 a 3-channel 16-bit map (the calibrated
    channel is blue, OpenCV's 0), v4 without a map. Each view has points
    behind the camera and outside the frame."""
    n = 200
    all_xyz, images = [], {}
    for v in range(5):
        cx, cy, ax, ay = 0.1, 0.002 * (1 + v), 0.001, 0.0005 * v
        xys = np.c_[rng.uniform(1, w - 2, n), rng.uniform(1, h - 2, n)]
        inv = cx + cy * xys[:, 0] + ax * xys[:, 1] + ay * xys[:, 0] / w
        z = 1.0 / inv
        p_cam = np.c_[(xys[:, 0] - w / 2) * z / f,
                      (xys[:, 1] - h / 2) * z / f, z]
        p_cam[:8, 2] *= -1                          # behind the camera
        xys[8:16, 0] = rng.choice([-3.0, w + 4.0], 8)   # outside the frame
        base_id = n * v + 1
        images[v + 1] = JC.ColmapImage(
            v + 1, np.array([1.0, 0, 0, 0]), np.zeros(3), 1, f"v{v}.png",
            xys, np.arange(base_id, base_id + n))
        all_xyz.append(p_cam)
        a, b = 0.4 + 0.1 * v, 0.05 + 0.02 * v
        s = 0.5 if v == 2 else 1.0
        mx, my = np.meshgrid(np.arange(int(w * s)), np.arange(int(h * s)))
        inv_map = cx + cy * mx / s + ax * my / s + ay * mx / s / w
        if v == 1:
            inv_map = inv_map + 0.01 * np.sin(mx / 3.0) * np.cos(my / 5.0)
        mono = (inv_map * a + b) * 2 ** 16
        mono = np.clip(mono, 0, 65535).astype(np.uint16)
        if v == 3:                   # RGB file: blue = the map
            mono = np.stack([mono // 3, mono // 2, mono], -1)
        if v != 4:
            write_png(os.path.join(depths, f"v{v}.png"), mono)
    JC.write_model_binary(os.path.join(base, "sparse", "0"),
                          {1: pinhole(w, h, f)}, images,
                          jpoints(np.concatenate(all_xyz)))


def test_depth_scale_matches_jax(tmp_path):
    base, depths = str(tmp_path / "scene"), str(tmp_path / "depths")
    os.makedirs(depths)
    write_depth_scene(base, depths, np.random.default_rng(0))
    want = jdepth.make_depth_scale(base, depths)
    got = tdepth.make_depth_scale(base, depths, device=CPU)
    with open(os.path.join(base, "sparse/0/depth_params.json")) as f:
        assert json.load(f) == got
    assert sorted(want) == ["v0", "v1", "v2", "v3"]
    assert_depth_params_close(got, want)
    # the affine views recover 1/a and -b/a
    for v in (0, 2, 3):
        a, b = 0.4 + 0.1 * v, 0.05 + 0.02 * v
        np.testing.assert_allclose(got[f"v{v}"]["scale"], 1 / a, rtol=1e-3)
        np.testing.assert_allclose(got[f"v{v}"]["offset"], -b / a,
                                   rtol=1e-2)


# --------------------------------------------------------------- masks ---

def write_mask_inputs(root, rng, h=30, w=40):
    """RGBA, gray+alpha, gray and RGB masks in nested folders (8 and
    16 bits)."""
    kinds = {"a/rgba.png": "rgba", "a/b/ga.png": "ga", "gray.png": "gray",
             "a/b/rgb.png": "rgb", "c/rgba16.png": "rgba16"}
    for rel, kind in kinds.items():
        os.makedirs(os.path.dirname(os.path.join(root, rel)) or root,
                    exist_ok=True)
        write_png_rgb(os.path.join(root, rel), rng, kind, h, w)
    return kinds


@pytest.mark.parametrize("erode", [0, 4, 5])
def test_masks_uint8_match_jax(tmp_path, erode):
    src = str(tmp_path / "in")
    kinds = write_mask_inputs(src, np.random.default_rng(erode))
    n_j = jmasks.make_masks_uint8(src, str(tmp_path / "jax"), erode)
    n_t = tmasks.make_masks_uint8(src, str(tmp_path / "torch"), erode,
                                  device=CPU)
    assert n_j == n_t == len(kinds)
    assert_trees_equal(str(tmp_path / "jax"), str(tmp_path / "torch"))


def test_black_mask_matches_jax(tmp_path):
    """8-bit and 16-bit RGBA images; a mask of the image's size, one of
    another size (nearest resize), an RGB mask (libpng's gray); JPEG
    images (``.jpg`` and ``.jpeg``, one with EXIF orientation 6, which
    OpenCV turns upright and writes back without EXIF) come back byte for
    byte as ``cv2.imwrite`` writes them; an image without a mask stays
    untouched."""
    rng = np.random.default_rng(5)
    images = tmp_path / "images"
    masks = tmp_path / "masks"
    write_png_rgb(images / "a.png", rng, "rgba16", 30, 40)
    write_png_rgb(images / "sub" / "b.png", rng, "rgb", 30, 40)
    write_png_rgb(images / "c.png", rng, "rgba", 30, 40)
    write_png_rgb(images / "d.png", rng, "rgb", 30, 40)
    write_png(str(masks / "a.png"),
              (rng.uniform(size=(30, 40)) > 0.5).astype(np.uint8) * 255)
    write_png(str(masks / "sub" / "b.png"),
              rng.integers(0, 256, (13, 57)).astype(np.uint8))
    write_png_rgb(masks / "c.png", rng, "rgb", 30, 40)
    exif = Image.Exif()
    exif[0x0112] = 6
    for rel, kw in (("e.jpg", {}), ("sub/f.jpg", {"exif": exif.tobytes()}),
                    ("g.jpeg", {"quality": 75}), ("h.jpg", {})):
        jpg = textured(rng, 30, 42, blur=1).astype(np.uint8)
        Image.fromarray(jpg).save(images / rel, "JPEG", **kw)
    for rel, shape in (("e.png", (30, 42)), ("sub/f.png", (13, 57)),
                       ("g.png", (30, 42))):
        write_png(str(masks / rel),
                  (rng.uniform(size=shape) > 0.4).astype(np.uint8) * 255)
    runs = {}
    for pkg, fn, extra in (("jax", jmasks.black_mask_images, {}),
                           ("torch", tmasks.black_mask_images,
                            {"device": CPU})):
        dst = tmp_path / pkg
        shutil.copytree(images, dst)
        runs[pkg] = fn(str(dst), str(masks), **extra)
    assert runs["jax"] == runs["torch"] == 6
    assert_trees_equal(str(tmp_path / "jax"), str(tmp_path / "torch"))
    assert np.array_equal(cv2.imread(str(tmp_path / "torch" / "d.png")),
                          cv2.imread(str(images / "d.png")))
    assert (tmp_path / "torch" / "h.jpg").read_bytes() == \
        (images / "h.jpg").read_bytes()
    assert cv2.imread(str(tmp_path / "torch" / "sub" / "f.jpg")).shape == \
        (42, 30, 3)


# --------------------------------------------------------- host modules ---

def plane_model(n=40, seed=0):
    rng = np.random.default_rng(seed)
    g = int(np.ceil(np.sqrt(n)))
    centers = np.array([[(i % g) * 2.0, 0.1 * (i % g) + 0.05 * (i // g),
                         (i // g) * 2.0] for i in range(n)])
    xyz = centers + rng.normal(0, 0.3, centers.shape) + [0, -5.0, 0]
    images = {i + 1: jimage(i + 1, c, rng.normal(size=3) + [0, 0, 2],
                            f"im_{i:03d}.png", rng.uniform(0, 40, (n + 2, 2)),
                            np.r_[np.arange(1, n + 1), -1, 10 * n])
              for i, c in enumerate(centers)}
    return {1: pinhole()}, images, jpoints(xyz)


def test_reorient_byte_equal(tmp_path):
    src = str(tmp_path / "in")
    JC.write_model_binary(src, *plane_model())
    rj, sj = jreorient.auto_reorient(src, str(tmp_path / "jax"))
    rt, st = treorient.auto_reorient(src, str(tmp_path / "torch"))
    assert np.array_equal(rj, rt) and sj == st
    assert_trees_equal(str(tmp_path / "jax"), str(tmp_path / "torch"))
    rj, sj = jreorient.auto_reorient(src, str(tmp_path / "jm"), 10.0, 0.0,
                                     [0.1, 1.0, 0.2], [1.0, 0.0, 0.3])
    rt, st = treorient.auto_reorient(src, str(tmp_path / "tm"), 10.0, 0.0,
                                     [0.1, 1.0, 0.2], [1.0, 0.0, 0.3])
    assert np.array_equal(rj, rt) and sj == st
    assert_trees_equal(str(tmp_path / "jm"), str(tmp_path / "tm"))


def test_simplify_byte_equal(tmp_path):
    rng = np.random.default_rng(0)
    images = {i + 1: jimage(i + 1, [i * 1.0, 0, 0], [0, 0, 1],
                            f"im_{i:03d}.png", rng.uniform(0, 40, (3, 2)),
                            [1, -1, 2]) for i in range(10)}
    images[11] = jimage(11, [500.0, 0, 0], [0, 0, 1], "far.png",
                        np.zeros((3, 2)), [1, 2, 3])
    images[12] = jimage(12, [5.0, 0, 0], [0, 0, 1], "none.png",
                        np.zeros((0, 2)), [])
    images[13] = jimage(13, [5.5, 0, 0], [0, 0, 1], "neg.png",
                        np.zeros((2, 2)), [-1, -1])
    for pkg in ("jax", "torch"):
        os.makedirs(tmp_path / pkg)
        JC.write_images_binary(str(tmp_path / pkg / "images.bin"), images)
    assert jsimplify.simplify_images(str(tmp_path / "jax")) == \
        tsimplify.simplify_images(str(tmp_path / "torch")) == 10
    assert_trees_equal(str(tmp_path / "jax"), str(tmp_path / "torch"))


def test_transform_byte_equal(tmp_path):
    rng = np.random.default_rng(3)
    n = 30
    centers = rng.uniform(0, 10, (n, 3))
    xyz = rng.uniform(-5, 15, (3 * n, 3))
    images = {i + 1: jimage(i + 1, c, rng.normal(size=3) + 0.1,
                            f"im_{i:03d}.png", np.zeros((0, 2)), [])
              for i, c in enumerate(centers)}
    src = str(tmp_path / "orig")
    JC.write_model_binary(os.path.join(src, "sparse/0"), {1: pinhole()},
                          images, jpoints(xyz))
    for f in ("center.txt", "extent.txt"):
        with open(os.path.join(src, f), "w") as fh:
            fh.write("1.0 2.0 3.0\n")
    ang, s, t = 0.3, 1.7, np.array([5.0, 0, 0])
    R = np.array([[np.cos(ang), 0, np.sin(ang)], [0, 1, 0],
                  [-np.sin(ang), 0, np.cos(ang)]])
    moved = {}
    for k, im in images.items():
        c = -JC.qvec2rotmat(im.qvec).T @ im.tvec
        c_new = s * (R @ c) + t + (40.0 if k == 3 else 0.0)  # one outlier
        R_new = JC.qvec2rotmat(im.qvec) @ R.T
        moved[k] = dataclasses.replace(im, qvec=JC.rotmat2qvec(R_new),
                                       tvec=-R_new @ c_new)
    tracks = rng.integers(0, 6, 3 * n)
    pts = dataclasses.replace(
        jpoints(s * (xyz @ R.T) + t, rng.uniform(0, 2, 3 * n)),
        track_offsets=np.r_[0, np.cumsum(tracks)],
        track_image_ids=np.ones(tracks.sum(), np.int32),
        track_point2d_idxs=np.arange(tracks.sum(), dtype=np.int32))
    new = str(tmp_path / "refined")
    JC.write_model_binary(os.path.join(new, "sparse/0"), {1: pinhole()},
                          moved, pts)
    jtransform.transform_colmap(src, new, str(tmp_path / "jax"))
    ttransform.transform_colmap(src, new, str(tmp_path / "torch"))
    assert_trees_equal(str(tmp_path / "jax"), str(tmp_path / "torch"))
    x0 = rng.normal(size=(50, 3))
    a = jtransform.procrustes_analysis(x0, x0 @ R.T * 2 + 1)
    b = ttransform.procrustes_analysis(x0, x0 @ R.T * 2 + 1)
    for u, v in zip(a, b):
        assert np.array_equal(u, v)


def test_colmap_db_rows_equal(tmp_path):
    sparse = str(tmp_path / "sparse")
    cams, images, pts = plane_model(n=7)
    cams[2] = JC.ColmapCamera(2, "OPENCV", 80, 60,
                              np.arange(1.0, 9.0))
    images[3] = dataclasses.replace(images[3], camera_id=2)
    JC.write_model_binary(sparse, cams, images, pts)
    jdb.fill_database(str(tmp_path / "j" / "database.db"), sparse)
    tdb.fill_database(str(tmp_path / "t" / "database.db"), sparse)
    rows = sqlite_rows(str(tmp_path / "t" / "database.db"))
    assert rows == sqlite_rows(str(tmp_path / "j" / "database.db"))
    assert len(rows["images"]) == 7 and len(rows["cameras"]) == 2
    assert tdb.SCHEMA == jdb.SCHEMA


def gps_jpeg(path, lat, lon, endian):
    R = TiffImagePlugin.IFDRational

    def dms(v):
        d = abs(v)
        return (R(int(d), 1), R(int(d * 60) % 60, 1),
                R(round((d * 3600) % 60 * 1000), 1000))

    exif = Image.Exif()
    exif.endian = endian
    exif[0x0110] = "model"
    exif[0x8825] = {1: "N" if lat >= 0 else "S", 2: dms(lat),
                    3: "E" if lon >= 0 else "W", 4: dms(lon)}
    Image.new("RGB", (8, 8), (90, 90, 90)).save(path, exif=exif)


@pytest.mark.parametrize("endian", ["<", ">"])
def test_gps_coords_match_pil(tmp_path, endian):
    """The port's EXIF reader gives PIL's decimal pair in all four
    hemispheres and both byte orders; None without EXIF, without GPS, and
    for a PNG."""
    for i, (lat, lon) in enumerate([(48.85, 2.35), (-33.86, 151.21),
                                    (40.71, -74.0), (-22.9, -43.17)]):
        path = str(tmp_path / f"g{i}.jpg")
        gps_jpeg(path, lat, lon, endian)
        got = tmatch._gps_coords(path)
        assert got == jmatch._gps_coords(path)
        assert np.sign(got[0]) == np.sign(lat)
        assert np.sign(got[1]) == np.sign(lon)
    Image.new("RGB", (8, 8)).save(tmp_path / "plain.jpg")
    exif = Image.Exif()
    exif[0x0110] = "model"
    Image.new("RGB", (8, 8)).save(tmp_path / "nogps.jpg", exif=exif)
    Image.new("RGB", (8, 8)).save(tmp_path / "p.png")
    for f in ("plain.jpg", "nogps.jpg", "p.png"):
        assert jmatch._gps_coords(str(tmp_path / f)) is None
        assert tmatch._gps_coords(str(tmp_path / f)) is None


def _tiff_ifd(o, entries, at, next_at=0):
    """An IFD at ``at``: entries (tag, type, count, 4-byte field) and the
    next-IFD pointer."""
    body = struct.pack(o + "H", len(entries))
    for tag, typ, count, field in entries:
        body += struct.pack(o + "HHI", tag, typ, count) + field
    return body + struct.pack(o + "I", next_at)


def _corrupt_gps_exif(o: str, case: str) -> bytes:
    """A TIFF block: header, the GPS IFD at 8 (N 10 1/2 deg, W 20 deg),
    its rationals, then IFD0 with Model and the GPS pointer, broken as
    ``case`` says."""
    def rat(*vals):
        return b"".join(struct.pack(o + "II", n, d) for n, d in vals)

    def at(v):
        return struct.pack(o + "I", v)
    past = 1 << 20
    n_gps = 5 if case == "gps_tag_after_lat_lon_past_block" else 4
    lat_at = 8 + 2 + 12 * n_gps + 4
    lon_at = lat_at + 24
    gps = [(1, 2, 2, b"N\0\0\0"), (2, 5, 3, at(lat_at)),
           (3, 2, 2, b"W\0\0\0"), (4, 5, 3, at(lon_at))]
    if case == "gps_tag_past_block":
        gps[1] = (2, 5, 3, at(past))
    if n_gps == 5:          # GPSAltitude's rational past the block
        gps.append((6, 5, 1, at(past)))
    data = rat((10, 1), (30, 1), (0, 1)) + rat((20, 1), (0, 1), (0, 1))
    ifd0_at = lon_at + 24
    ifd0 = [(0x0110, 2, 4, b"cam\0"),
            (0x8825, 4, 1, at(past if case == "gps_pointer_past_block"
                               else 8))]
    if case == "tag_before_gps_past_block":
        ifd0.insert(1, (0x0132, 2, 20, at(past)))
    if case == "tag_after_gps_past_block":
        ifd0.append((0x9003, 2, 20, at(past)))
    if case == "gps_pointer_not_a_long":
        ifd0[1] = (0x8825, 5, 1, at(lat_at))
    ifd0_bytes = _tiff_ifd(o, ifd0, ifd0_at)
    if case == "ifd0_cut_short":
        # IFD0 claims four entries; the block ends after the two it has.
        ifd0_bytes = struct.pack(o + "H", 4) + ifd0_bytes[2:-4]
    head = (b"II" if o == "<" else b"MM") + struct.pack(o + "HI", 42,
                                                        ifd0_at)
    if case == "bad_header":
        head = b"XX" + head[2:]
    return head + _tiff_ifd(o, gps, 8) + data + ifd0_bytes


GPS_CASES = ["intact", "tag_before_gps_past_block",
             "tag_after_gps_past_block", "ifd0_cut_short",
             "gps_pointer_past_block", "gps_pointer_not_a_long",
             "gps_tag_past_block", "gps_tag_after_lat_lon_past_block",
             "bad_header"]


@pytest.mark.parametrize("endian", ["<", ">"])
@pytest.mark.parametrize("case", GPS_CASES)
def test_gps_coords_on_damaged_exif(tmp_path, endian, case):
    """EXIF blocks damaged as camera files can be (a tag's data past the
    block before or after the GPS pointer, IFD0 cut short, the GPS
    pointer past the block or of another type, a GPS tag past the block,
    a bad header): the port's reader gives what the JAX package gives
    through PIL, and never raises."""
    path = str(tmp_path / "d.jpg")
    Image.new("RGB", (8, 8)).save(
        path, exif=b"Exif\x00\x00" + _corrupt_gps_exif(endian, case))
    with warnings.catch_warnings():
        warnings.simplefilter("ignore")
        want = jmatch._gps_coords(path)
        got = tmatch._gps_coords(path)
    assert got == want
    if case in ("intact", "tag_after_gps_past_block", "ifd0_cut_short",
                "gps_tag_after_lat_lon_past_block"):
        assert got == [10.5, -20.0]


def test_matcher_files_text_equal(tmp_path):
    """Quadratic, sequential, loop-closure and GPS pairs over two camera
    folders (some views with GPS, one without); the distance matcher."""
    root = tmp_path / "images"
    rng = np.random.default_rng(1)
    for cam, n in (("cam0", 14), ("cam1", 9)):
        os.makedirs(root / cam)
        for i in range(n):
            path = str(root / cam / f"f{i:03d}.jpg")
            if i == 4:
                Image.new("RGB", (8, 8)).save(path)
            else:
                gps_jpeg(path, 45 + rng.uniform(0, 0.01),
                         7 + rng.uniform(0, 0.01), "<" if i % 2 else ">")
    kw = dict(n_seq_matches_per_view=2, n_quad_matches_per_view=4,
              n_loop_closure_match_per_view=2, loop_matches=[1, 10, 3, 12],
              n_gps_neighbours=5)
    nj = jmatch.make_matcher_file(str(root), str(tmp_path / "j.txt"), **kw)
    nt = tmatch.make_matcher_file(str(root), str(tmp_path / "t.txt"), **kw)
    assert nj == nt > 0
    assert (tmp_path / "j.txt").read_text() == (tmp_path / "t.txt").read_text()
    sparse = str(tmp_path / "sparse")
    JC.write_model_binary(sparse, *plane_model(n=25, seed=4))
    nj = jmatch.make_distance_matcher_file(sparse, str(tmp_path / "dj.txt"),
                                           n_neighbours=6)
    nt = tmatch.make_distance_matcher_file(sparse, str(tmp_path / "dt.txt"),
                                           n_neighbours=6)
    assert nj == nt > 0
    assert (tmp_path / "dj.txt").read_text() == \
        (tmp_path / "dt.txt").read_text()


# ------------------------------------------------------------- drivers ---

class ColmapRecorder:
    """Stands in for the COLMAP binary: records each command line with the
    project root replaced by ``<P>`` and writes what the next step reads
    (the mapper a model, the undistorter the model and the images, the
    triangulator its input model with tracks of 4 views, the adjuster a
    copy of its input)."""

    def __init__(self, root, model):
        self.root, self.model, self.cmds = str(root), model, []

    def __call__(self, cmd, what):
        self.cmds.append([c.replace(self.root, "<P>") for c in cmd])
        arg = dict(zip(cmd[2::2], cmd[3::2]))
        if cmd[1] == "hierarchical_mapper":
            JC.write_model_binary(os.path.join(arg["--output_path"], "0"),
                                  *self.model)
        elif cmd[1] == "image_undistorter":
            out = arg["--output_path"]
            shutil.copytree(arg["--input_path"],
                            os.path.join(out, "sparse"), dirs_exist_ok=True,
                            ignore=shutil.ignore_patterns("masks"))
            shutil.copytree(arg["--image_path"], os.path.join(out, "images"),
                            dirs_exist_ok=True)
        elif cmd[1] == "point_triangulator":       # 4 views per point
            cams, images, pts = JC.read_model(arg["--input_path"])
            n = len(pts.ids)
            pts = dataclasses.replace(
                pts, track_offsets=4 * np.arange(n + 1),
                track_image_ids=np.ones(4 * n, np.int32),
                track_point2d_idxs=np.arange(4 * n, dtype=np.int32))
            JC.write_model_binary(arg["--output_path"], cams, images, pts)
        elif cmd[1] == "bundle_adjuster":
            shutil.copytree(arg["--input_path"], arg["--output_path"],
                            dirs_exist_ok=True)


def write_project(proj, rng):
    """inputs/images (64 x 48 PNG views, some blurred), inputs/masks
    (RGBA), and the model the recorded mapper writes: 64 cameras along a
    strip, each seeing the points near it."""
    base = str(proj / "scene")
    img_dir = write_chunk_scene(base, rng)
    shutil.copytree(img_dir, proj / "inputs" / "images")
    model = JC.read_model(os.path.join(base, "sparse", "0"))
    shutil.rmtree(base)
    for im in model[1].values():
        write_png_rgb(proj / "inputs" / "masks" / im.name, rng, "rgba", 48,
                      64)
        write_png(str(proj / "maps" / im.name), rng.integers(
            20000, 40000, (24, 32)).astype(np.uint16))
    return model


@pytest.mark.parametrize("skip_ba", [True, False])
def test_drivers_match_jax(tmp_path, monkeypatch, skip_ba):
    """``colmap`` (with masks), ``chunks``, ``depth`` (through a depth
    tool command), ``concat_chunks_info`` and ``copy_file_to_chunks`` in
    both packages: equal COLMAP command lines and equal trees."""
    trees = {}
    cmds = {}
    for pkg, drv in (("jax", jdrivers), ("torch", tdrivers)):
        proj = tmp_path / pkg
        model = write_project(proj, np.random.default_rng(11))
        rec = ColmapRecorder(proj, model)
        monkeypatch.setattr(drv, "_run", rec)
        dev = ["--device", CPU] if pkg == "torch" else []
        p = str(proj)
        drv.main(["colmap", "--project_dir", p] + dev)
        chunk_args = ["chunks", "--project_dir", p, "--chunk_size", "10",
                      "--min_n_cams", "5", "--max_n_cams", "30",
                      "--n_jobs", "1"]
        drv.main(chunk_args + (["--skip_bundle_adjustment"] if skip_ba
                               else []) + dev)
        drv.main(["depth", "--project_dir", p, "--depth_tool_cmd",
                  f"cp -r {p}/maps/. {{out}}"] + dev)
        chunks = os.path.join(p, "camera_calibration", "chunks")
        drv.concat_chunks_info(chunks, os.path.join(p, "chunks_again.txt"))
        with open(os.path.join(p, "test.txt"), "w") as f:
            f.write("im_001.png\n")
        drv.copy_file_to_chunks(os.path.join(p, "test.txt"), chunks)
        cmds[pkg] = rec.cmds
        trees[pkg] = p
    assert cmds["jax"] == cmds["torch"]
    n_chunks = len(os.listdir(os.path.join(
        trees["torch"], "camera_calibration", "chunks"))) - 1
    assert n_chunks >= 2
    assert len(cmds["torch"]) == 5 + (0 if skip_ba else 6 * n_chunks)
    assert_trees_equal(trees["jax"], trees["torch"])
    with open(os.path.join(trees["torch"], "chunks_again.txt")) as f, \
            open(os.path.join(trees["torch"], "camera_calibration",
                              "chunks", "chunks.txt")) as g:
        assert sorted(ln.split()[0] for ln in f) == \
            sorted(ln.split()[0] for ln in g)


def test_drivers_run_exits_on_failure(tmp_path, capsys):
    """``_run`` exits 1 when the tool fails or is missing, as the JAX
    one does."""
    for cmd in ([sys.executable, "-c", "import sys; sys.exit(3)"],
                [str(tmp_path / "no_such_colmap")]):
        for drv in (jdrivers, tdrivers):
            with pytest.raises(SystemExit) as e:
                drv._run(cmd, "colmap thing")
            assert e.value.code == 1
    assert capsys.readouterr().out.count("Error executing colmap thing") == 4


# -------------------------------------------------------------- guards ---

def test_port_imports_no_opencv():
    """No module of the port, nor chip_smoke.py, imports cv2; the
    preprocessing modules, the EXIF reader, the JPEG decoder and encoder,
    the web viewer and chip_smoke.py import no PIL either (PIL stays
    behind ``io/image.py``)."""
    files = [os.path.join(REPO, "chip_smoke.py")]
    for root, _, names in os.walk(PORT_DIR):
        files += [os.path.join(root, f) for f in names if f.endswith(".py")]
    no_pil = os.path.join(PORT_DIR, "preprocess")
    bad = []
    for path in files:
        with open(path) as f:
            tree = ast.parse(f.read(), path)
        for node in ast.walk(tree):
            names = ([a.name for a in node.names]
                     if isinstance(node, ast.Import) else
                     [node.module or ""] if isinstance(node, ast.ImportFrom)
                     else [])
            for name in names:
                root_name = name.split(".")[0]
                if root_name == "cv2" or (root_name == "PIL" and (
                        path.startswith(no_pil) or path.endswith((
                            os.path.join("io", "exif.py"),
                            os.path.join("io", "jpeg.py"),
                            os.path.join("io", "jpeg_encode.py"),
                            os.path.join("viewer", "web.py"),
                            "chip_smoke.py")))):
                    bad.append(f"{os.path.relpath(path, REPO)}:"
                               f"{node.lineno} imports {name}")
    assert len(files) > 20 and not bad, bad
