"""Parity of the port's data path with the JAX package: the PNG codec
(``io/image.py``) against PIL and OpenCV, COLMAP / PLY / exposure.json
files written by one package and read by the other, ``Scene`` +
``load_view`` on the same COLMAP directory, the training viewer's
``poll``, and ``train_single.main`` on the CPU. Tolerances are stated per
test."""
from __future__ import annotations

import json
import os
import socket
import struct
import threading
import time
import zlib

import cv2
import numpy as np
import pytest
import torch
from PIL import Image

from h3dgs_tpu.config import ModelConfig as JModelCfg
from h3dgs_tpu.config import RuntimeConfig as JRuntimeCfg
from h3dgs_tpu.io import colmap as jcolmap
from h3dgs_tpu.io import meta as jmeta
from h3dgs_tpu.io import ply as jply
from h3dgs_tpu.scene import loader as jloader
from h3dgs_tpu.scene.scene import Scene as JScene
from h3dgs_tpu_torch.cli import train_single
from h3dgs_tpu_torch.config import ModelConfig as TModelCfg
from h3dgs_tpu_torch.config import RuntimeConfig as TRuntimeCfg
from h3dgs_tpu_torch.io import colmap as tcolmap
from h3dgs_tpu_torch.io import image as timage
from h3dgs_tpu_torch.io import meta as tmeta
from h3dgs_tpu_torch.io import ply as tply
from h3dgs_tpu_torch.model import state as tstate
from h3dgs_tpu_torch.scene import loader as tloader
from h3dgs_tpu_torch.scene.scene import Scene as TScene
from h3dgs_tpu_torch.train.step import render_for_training
from h3dgs_tpu_torch.viewer.network_gui import NetworkGUI

from .synthetic_scene import make_gaussian_scene, ring_cameras, \
    write_colmap_scene
from .test_torch_common import cut_progressive, np_

torch.set_num_threads(2)


# ----------------------------------------------------------------- PNG ---

@pytest.mark.parametrize("mode,shape,dtype", [
    ("L", (37, 53), np.uint8), ("RGB", (37, 53, 3), np.uint8),
    ("RGBA", (29, 41, 4), np.uint8), (None, (30, 40), np.uint16)])
def test_png_codec_matches_pil(tmp_path, mode, shape, dtype):
    """Exact: PIL-written files decode to PIL's arrays, and files the port
    writes decode in PIL (and OpenCV, 16-bit) to the same arrays."""
    rng = np.random.default_rng(sum(shape))
    a = rng.integers(0, np.iinfo(dtype).max + 1, shape).astype(dtype)
    # Smooth rows too, so PIL's encoder picks several filter types.
    ramp = np.linspace(0, np.iinfo(dtype).max, shape[1]).astype(dtype)
    a[: shape[0] // 2] = ramp.reshape((1, -1) + (1,) * (a.ndim - 2))
    p = str(tmp_path / "pil.png")
    Image.fromarray(a, mode).save(p)
    np.testing.assert_array_equal(timage.read_image(p),
                                  np.asarray(Image.open(p)))
    q = str(tmp_path / "own.png")
    timage.write_png(q, a)
    np.testing.assert_array_equal(np.asarray(Image.open(q)), a)
    if dtype == np.uint16:
        np.testing.assert_array_equal(cv2.imread(q, -1), a)


def _filtered_png(raw: np.ndarray, width: int, bpp: int, depth: int,
                  ctype: int, types) -> bytes:
    """PNG bytes of the [h, width * bpp] sample bytes ``raw``, row r
    filtered with ``types[r]`` (0-4; others are written as they are)."""
    raw = raw.astype(np.int32)
    rows = []
    for r, ft in enumerate(types):
        cur = raw[r]
        prev = raw[r - 1] if r else np.zeros_like(cur)
        left = np.concatenate([np.zeros(bpp, np.int32), cur[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int32), prev[:-bpp]])
        if ft == 4:
            p = left + prev - ul
            pa, pb, pc = np.abs(p - left), np.abs(p - prev), np.abs(p - ul)
            pred = np.where((pa <= pb) & (pa <= pc), left,
                            np.where(pb <= pc, prev, ul))
        elif ft < 4:
            pred = [0 * cur, left, prev, (left + prev) >> 1][ft]
        else:
            pred = 0 * cur
        rows.append(np.concatenate([[ft], (cur - pred) & 255]))
    data = np.stack(rows).astype(np.uint8).tobytes()

    def chunk(kind, body):
        return (struct.pack(">I", len(body)) + kind + body
                + struct.pack(">I", zlib.crc32(kind + body)))
    return (timage.PNG_SIGNATURE
            + chunk(b"IHDR", struct.pack(">IIBBBBB", width, len(types),
                                         depth, ctype, 0, 0, 0))
            + chunk(b"IDAT", zlib.compress(data)) + chunk(b"IEND", b""))


def test_png_all_filter_types(tmp_path):
    """Every scanline filter (None, Sub, Up, Average, Paeth), mixed within
    one 16-bit RGB image, decodes exactly."""
    rng = np.random.default_rng(3)
    h, w, bpp = 23, 19, 6
    img = rng.integers(0, 65536, (h, w, 3)).astype(">u2")
    raw = img.view(np.uint8).reshape(h, w * bpp)
    p = str(tmp_path / "filters.png")
    with open(p, "wb") as f:
        f.write(_filtered_png(raw, w, bpp, 16, 2, [r % 5 for r in range(h)]))
    np.testing.assert_array_equal(timage.read_png(p), img.astype(np.uint16))
    np.testing.assert_array_equal(cv2.imread(p, -1)[..., ::-1],
                                  img.astype(np.uint16))


@pytest.mark.parametrize("ctype,depth", [(0, 8), (4, 8), (2, 8), (6, 8),
                                         (0, 16), (4, 16), (2, 16), (6, 16)])
def test_png_unfilter_native_and_plain(tmp_path, monkeypatch, ctype, depth):
    """The C++ unfilter and the numpy one (where no compiler is found)
    decode every filter type at every pixel size (1-8 bytes) to OpenCV's
    samples, on smooth rows (Paeth picks each neighbour) and noise; a bad
    filter type raises in both."""
    chans = {0: 1, 2: 3, 4: 2, 6: 4}[ctype]
    bpp = chans * depth // 8
    h, w = 40, 33
    rng = np.random.default_rng(ctype * 100 + depth)
    dtype = np.uint8 if depth == 8 else np.dtype(">u2")
    img = rng.integers(0, 1 << depth, (h, w, chans)).astype(dtype)
    ramp = np.linspace(0, (1 << depth) - 1, w)[:, None]
    img[: h // 2] = (ramp + 7 * np.arange(h // 2)[:, None, None]).clip(
        0, (1 << depth) - 1).astype(dtype)
    raw = np.ascontiguousarray(img).view(np.uint8).reshape(h, w * bpp)
    body = _filtered_png(raw, w, bpp, depth, ctype,
                         rng.integers(0, 5, h).tolist())
    p = str(tmp_path / "f.png")
    with open(p, "wb") as f:
        f.write(body)
    want = cv2.imread(p, cv2.IMREAD_UNCHANGED)
    if want.ndim == 3:      # OpenCV's BGR(A) -> RGB(A)
        want = np.concatenate([want[..., 2::-1], want[..., 3:]], -1)
    if ctype == 4:          # gray+alpha: OpenCV expands to BGRA
        want = want[..., 2:]
    broken = _filtered_png(raw, w, bpp, depth, ctype, [0] * (h - 1) + [5])
    native = timage.decode_png(body)
    assert timage._native_unfilter() is not None
    np.testing.assert_array_equal(native, want.astype(native.dtype))
    with pytest.raises(ValueError, match="bad PNG filter type 5"):
        timage.decode_png(broken)
    monkeypatch.setattr(timage, "_NATIVE", None)
    monkeypatch.setattr("h3dgs_tpu_torch.native.compiler", lambda: None)
    assert timage._native_unfilter() is None
    np.testing.assert_array_equal(timage.decode_png(body), native)
    with pytest.raises(ValueError, match="bad PNG filter type 5"):
        timage.decode_png(broken)


def test_read_image_without_pil_names_the_file(tmp_path, monkeypatch):
    """Without PIL a baseline JPEG is read by the port's own decoder, and a
    progressive one with unfinished scans (which only PIL reads) raises
    naming the file."""
    p = str(tmp_path / "photo.jpg")
    with open(p, "wb") as f:
        f.write(cut_progressive(np.zeros((8, 8, 3), np.uint8)))
    q = str(tmp_path / "base.jpg")
    Image.fromarray(np.full((8, 8, 3), 90, np.uint8)).save(q)
    np.testing.assert_array_equal(timage.read_image(p).shape, (8, 8, 3))
    import builtins
    real_import = builtins.__import__

    def no_pil(name, *a, **kw):
        if name == "PIL" or name.startswith("PIL."):
            raise ImportError(name)
        return real_import(name, *a, **kw)
    monkeypatch.setattr(builtins, "__import__", no_pil)
    with pytest.raises(ValueError, match=r"photo\.jpg: progressive JPEG"):
        timage.read_image(p)
    np.testing.assert_array_equal(timage.read_image(q),
                                  np.full((8, 8, 3), 90, np.uint8))


# ---------------------------------------------------- files across both ---

def test_files_cross_packages(tmp_path):
    """points3D.bin, point_cloud.ply, points3D.ply and exposure.json
    written by one package read back exactly by the other."""
    rng = np.random.default_rng(4)
    n = 300
    tl = rng.integers(0, 4, n)
    offs = np.concatenate([[0], np.cumsum(tl)]).astype(np.int64)
    pts = jcolmap.ColmapPoints3D(
        ids=np.arange(1, n + 1, dtype=np.int64), xyz=rng.normal(size=(n, 3)),
        rgb=rng.integers(0, 256, (n, 3)).astype(np.uint8),
        error=rng.random(n), track_offsets=offs,
        track_image_ids=rng.integers(0, 9, offs[-1]).astype(np.int32),
        track_point2d_idxs=rng.integers(0, 99, offs[-1]).astype(np.int32))
    a, b = str(tmp_path / "a.bin"), str(tmp_path / "b.bin")
    jcolmap.write_points3d_binary(a, pts)
    tcolmap.write_points3d_binary(b, pts)
    with open(a, "rb") as fa, open(b, "rb") as fb:
        assert fa.read() == fb.read()
    got = tcolmap.read_points3d_binary(a)
    for f in ("ids", "xyz", "rgb", "error", "track_offsets",
              "track_image_ids", "track_point2d_idxs"):
        np.testing.assert_array_equal(getattr(got, f), getattr(pts, f), f)

    g = dict(xyz=rng.normal(size=(n, 3)), features_dc=rng.normal(
        size=(n, 1, 3)), features_rest=rng.normal(size=(n, 15, 3)),
        opacity=rng.normal(size=(n, 1)), scaling=rng.normal(size=(n, 3)),
        rotation=rng.normal(size=(n, 4)))
    for writer, reader in ((jply, tply), (tply, jply)):
        p = str(tmp_path / "pc.ply")
        writer.write_gaussian_ply(p, **g)
        back = reader.read_gaussian_ply(p, sh_degree=3)
        for k, v in g.items():
            np.testing.assert_array_equal(back[k], np.float32(v), k)
        writer.write_points3d_ply(p, g["xyz"], rng.random((n, 3)))
        x1, c1 = reader.read_points3d_ply(p)
        x2, c2 = writer.read_points3d_ply(p)
        np.testing.assert_array_equal(x1, x2)
        np.testing.assert_array_equal(c1, c2)
        e = {f"img_{i}.png": rng.normal(size=(3, 4)) for i in range(3)}
        writer_meta = jmeta if writer is jply else tmeta
        reader_meta = tmeta if writer is jply else jmeta
        writer_meta.write_exposure_json(str(tmp_path / "e.json"), e)
        back = reader_meta.read_exposure_json(str(tmp_path / "e.json"))
        for k, v in e.items():
            np.testing.assert_array_equal(back[k], np.float32(v))


# ----------------------------------------------------- Scene + loader ---

@pytest.fixture(scope="module")
def colmap_dir(tmp_path_factory):
    """A synthetic COLMAP chunk written by the JAX package (PIL images),
    plus 16-bit inverse-depth PNGs with depth_params.json."""
    root = str(tmp_path_factory.mktemp("chunk"))
    means, scales, quats, opac, shs, rgb = make_gaussian_scene(n=80, seed=2)
    cams = ring_cameras(4, width=64, height=48)
    write_colmap_scene(root, means, scales, quats, opac, shs, rgb, cams)
    os.makedirs(os.path.join(root, "depths"))
    rng = np.random.default_rng(5)
    params = {}
    for i in range(len(cams)):
        d = rng.integers(0, 65536, (48, 64)).astype(np.uint16)
        cv2.imwrite(os.path.join(root, "depths", f"img_{i:03d}.png"), d)
        params[f"img_{i:03d}"] = {"scale": 0.5 + 0.1 * i, "offset": 0.01}
    with open(os.path.join(root, "sparse/0/depth_params.json"), "w") as f:
        json.dump(params, f)
    return root


@pytest.mark.parametrize("resolution", [-1, 2])
def test_scene_and_load_view_match_jax(colmap_dir, tmp_path, resolution):
    """Same COLMAP dir: cameras, extent, initial state exact (to float32
    rounding); ViewBatch arrays within 1e-6 (resolution 2 resizes by an
    integer factor, where the port's block mean is within 1e-6 of
    OpenCV's INTER_AREA; non-integer factors, enlargements and every PNG
    kind of view, mask and depth map are held in
    ``tests/test_torch_image_contracts.py``)."""
    kw = dict(source_path=colmap_dir, depths="depths", skybox_num=10,
              resolution=resolution)
    js = JScene(JModelCfg(model_path=str(tmp_path / "j"), **kw),
                JRuntimeCfg(capacity_factor=2.0))
    ts = TScene(TModelCfg(model_path=str(tmp_path / "t"), **kw),
                TRuntimeCfg(capacity_factor=2.0), device="cpu")
    assert ts.cameras_extent == pytest.approx(js.cameras_extent, rel=1e-12)
    assert ts.image_names == js.image_names
    np.testing.assert_array_equal(ts.exposures, js.exposures)
    for f in tstate.ALL_FIELDS:
        np.testing.assert_allclose(np_(getattr(ts.state, f)),
                                   np.asarray(getattr(js.state, f)),
                                   rtol=1e-6, atol=1e-6, err_msg=f)
    with open(str(tmp_path / "j" / "cameras.json")) as fj, \
            open(str(tmp_path / "t" / "cameras.json")) as ft:
        assert json.load(fj) == json.load(ft)
    for jinfo, tinfo in zip(js.info.train_cameras, ts.info.train_cameras):
        jv = jloader.load_view(jinfo, resolution, image_idx=1)
        tv = tloader.load_view(tinfo, resolution, image_idx=1)
        for f in ("gt_image", "alpha_mask", "invdepth", "depth_mask"):
            np.testing.assert_allclose(getattr(tv, f), getattr(jv, f),
                                       rtol=1e-6, atol=1e-6, err_msg=f)
        assert bool(tv.depth_reliable) == bool(jv.depth_reliable)
        assert int(tv.image_idx) == int(jv.image_idx) == 1
        for f in ("view", "full_proj", "cam_center"):
            np.testing.assert_array_equal(np_(getattr(tv.camera, f)),
                                          np.asarray(getattr(jv.camera, f)))
        assert (tv.camera.height, tv.camera.width) == (jv.camera.height,
                                                       jv.camera.width)


def test_train_single_cpu_and_artifacts(colmap_dir, tmp_path, monkeypatch):
    """``train_single.main`` on the CPU: it trains, writes the reference's
    artifacts and the checkpoint it is asked for, and the JAX Scene reads
    the saved point cloud back; without CUDA and without --device it
    raises."""
    out = str(tmp_path / "out")
    argv = ["-s", colmap_dir, "-m", out, "--depths", "depths",
            "--iterations", "3", "--skybox_num", "8", "--skybox_locked",
            "--disable_viewer"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_single.main(argv)
    train_single.main(argv + ["--device", "cpu",
                              "--checkpoint_iterations", "2"])
    assert os.path.exists(os.path.join(out, "chkpnt2.npz"))
    # The default (viewer on) listens and trains on without a client.
    train_single.main([a for a in argv if a != "--disable_viewer"]
                      + ["--device", "cpu", "--port", "0", "-m",
                         str(tmp_path / "viewer_on")])
    pc = os.path.join(out, "point_cloud", "iteration_3")
    assert sorted(os.listdir(pc)) == ["pc_info.txt", "point_cloud.ply"]
    for f in ("cameras.json", "cfg_args", "exposure.json", "input.ply"):
        assert os.path.exists(os.path.join(out, f)), f
    exp = jmeta.read_exposure_json(os.path.join(out, "exposure.json"))
    assert len(exp) == 4
    js = JScene(JModelCfg(source_path=colmap_dir, model_path=out),
                JRuntimeCfg(capacity_factor=1.0), load_iteration=3)
    g = tply.read_gaussian_ply(os.path.join(pc, "point_cloud.ply"), 3)
    assert js.state.n_skybox == 8
    np.testing.assert_array_equal(np.asarray(js.state.xyz), g["xyz"])


def test_viewer_poll_renders_the_training_state():
    """A viewer connected during training gets the state rendered by
    ``render_for_training`` (equal bytes), and the verify string."""
    from .test_network_gui import _client_request

    rng = np.random.default_rng(0)
    n = 16
    state = tstate.from_arrays(
        rng.uniform(-1, 1, (n, 3)), rng.normal(0, 0.5, (n, 1, 3)),
        np.zeros((n, 0, 3)), np.full((n, 1), 0.5), np.full((n, 3),
                                                           np.log(0.2)),
        np.tile([1.0, 0, 0, 0], (n, 1)), max_sh_degree=0, device="cpu")
    gui = NetworkGUI(host="127.0.0.1", port=0, model_path="/m")
    port = gui.listener.getsockname()[1]
    w, h = 48, 32
    req = _client_request(w, h)
    result = {}

    def client():
        s = socket.create_connection(("127.0.0.1", port), timeout=60)
        msg = json.dumps(req).encode("utf-8")
        s.sendall(len(msg).to_bytes(4, "little") + msg)
        buf = b""
        while len(buf) < h * w * 3:
            buf += s.recv(h * w * 3 - len(buf))
        vlen = int.from_bytes(s.recv(4), "little")
        result["verify"] = s.recv(vlen).decode("ascii")
        result["img"] = np.frombuffer(buf, np.uint8).reshape(h, w, 3)
        s.close()

    t = threading.Thread(target=client)
    t.start()
    bg = torch.zeros(3)
    from h3dgs_tpu_torch.ops.rasterize import RasterizeConfig
    deadline = time.time() + 60
    while "img" not in result and time.time() < deadline:
        gui.poll(state, 0, RasterizeConfig(), bg)
        time.sleep(0.01)
    t.join(timeout=30)
    gui.close()
    assert result["verify"] == "/m"
    cam = NetworkGUI._camera_from_msg(req)
    with torch.no_grad():
        want = render_for_training(state, cam, 0, bg, RasterizeConfig())
    want = (want["render"] * 255).to(torch.uint8).permute(1, 2, 0).numpy()
    np.testing.assert_array_equal(result["img"], want)
    assert result["img"].max() > 30
