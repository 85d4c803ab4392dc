"""Pixel bands (``parallel/band_render.py``) and the browser viewer
(``viewer/web.py``) of the port, on the CPU.

Bands: ``render_banded`` on two and three bands of repeated CPU devices
equals the port's full frame bit for bit (the same tiles, the same entries
in the same order, the same pixel coordinates), on a scene with splats
across band edges, one of them centred far above the band its footprint
reaches, and a frame height that is not a multiple of ``bands x 16``; the
full frame lies within 1/255 of the JAX single-device frame. Web: ``/``,
``/info`` and ``/frame`` over HTTP; each frame is PIL's JPEG of
``renderer.render(...)`` at the request's ``q``, byte for byte, and the
render lies within 1/255 of the JAX renderer's frame for the same camera.
"""
from __future__ import annotations

import http.client
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch
from PIL import Image

from h3dgs_tpu.ops.rasterize import RasterizeConfig as JRasterCfg
from h3dgs_tpu.ops.rasterize import rasterize as jrasterize
from h3dgs_tpu.viewer.service import HierarchyRenderer as JRenderer
from h3dgs_tpu_torch.io.image import decode_png
from h3dgs_tpu_torch.io.jpeg import decode_jpeg
from h3dgs_tpu_torch.ops import binning as tbin
from h3dgs_tpu_torch.ops import projection as tproj
from h3dgs_tpu_torch.ops.rasterize import rasterize as trasterize
from h3dgs_tpu_torch.parallel import band_render
from h3dgs_tpu_torch.viewer import service as tservice
from h3dgs_tpu_torch.viewer.web import WebViewer

from .test_torch_common import camera_pair, np_, scene_tensors, \
    write_hier_pair
from .utils import random_scene

torch.set_num_threads(2)

XCFG = JRasterCfg(max_entries=1 << 15, max_per_tile=512, chunk=16,
                  backend="xla")
W, H = 64, 88            # 88 rows: 2 bands of 48, 3 bands of 32 (+ trim)


def _band_scene():
    """A random scene plus large splats that straddle the band edges at
    rows 32, 48 and 64, and one centred near the top row whose footprint
    reaches the lowest band."""
    means, scales, quats, opac, shs = random_scene(150, 11, sh_degree=1,
                                                   spread=0.9)
    shs[:, 0] = np.clip(shs[:, 0], -0.6, 0.6)
    big = np.array([[0.0, -0.4, 0.0], [0.3, 0.0, 0.2], [-0.2, 0.5, 0.1],
                    [0.1, 1.3, -0.5]], np.float32)
    means = np.concatenate([means, big])
    scales = np.concatenate([scales, np.array(
        [[0.5, 0.25, 0.05], [0.3, 0.35, 0.05], [0.3, 0.3, 0.05],
         [0.15, 0.9, 0.05]], np.float32)])
    quats = np.concatenate([quats, np.tile(np.array([1, 0, 0, 0],
                                                    np.float32), (4, 1))])
    opac = np.concatenate([opac, np.full(4, 0.45, np.float32)])
    shs = np.concatenate([shs, np.zeros((4,) + shs.shape[1:], np.float32)])
    return means, scales, quats, opac, shs


@pytest.fixture(scope="module")
def banded():
    scene = _band_scene()
    jc, tc = camera_pair((0.2, -0.3, -3.0), fovx=1.0, width=W, height=H)
    bg = np.array([0.2, 0.1, 0.3], np.float32)
    tensors = scene_tensors(*scene)
    full = trasterize(*tensors, tc, 1, torch.as_tensor(bg))
    ref = jrasterize(*scene, jc, 1, jnp.asarray(bg), config=XCFG)
    return dict(scene=scene, tensors=tensors, cam=tc, bg=bg, full=full,
                ref=ref)


@pytest.mark.parametrize("n_bands", [2, 3])
def test_bands_equal_full_frame(banded, n_bands):
    """Every output of the bands equals the full frame bit for bit, and
    splats centred in one band (or above the frame) have entries in
    another band's tiles."""
    out = band_render.render_banded(*banded["tensors"], banded["cam"], 1,
                                    banded["bg"], ["cpu"] * n_bands)
    full = banded["full"]
    for k in ("render", "invdepth", "final_transmittance", "radii",
              "visibility_filter"):
        assert out[k].shape == full[k].shape, k
        assert torch.equal(out[k], full[k]), k

    # Band-edge coverage: the full frame's tile rows of each splat.
    proj = tproj.project_gaussians(*banded["tensors"], banded["cam"], 1)
    rmin_x, rmin_y, span_x, span_y, counts = tbin._tight_rects(
        proj, *tbin.num_tiles(H, W), tbin.TILE)
    hb = band_render.band_height(H, n_bands, tbin.TILE) // tbin.TILE
    ok = counts > 0
    top, bottom = rmin_y[ok], rmin_y[ok] + span_y[ok] - 1
    centre_row = (proj.means2d[ok, 1] // tbin.TILE).long()
    crosses = (top // hb) != (bottom // hb)
    assert int(crosses.sum()) >= 4, int(crosses.sum())
    # A splat centred above the frame or in its top half-band whose
    # footprint reaches a lower band: where a shift of the means by the
    # band's row offset can round in float32 (H13).
    far = (centre_row < hb // 2) & (bottom // hb >= 1)
    assert bool(far.any())


def test_full_frame_matches_jax(banded):
    """The port's full frame (and so every banded frame) within 1/255 of
    the JAX single-device frame."""
    d = np.abs(np_(banded["full"]["render"])
               - np.asarray(banded["ref"]["render"]))
    assert d.max() <= 1 / 255, d.max()
    np.testing.assert_array_equal(
        np_(banded["full"]["visibility_filter"]),
        np.asarray(banded["ref"]["visibility_filter"]))


def test_renderer_with_bands(tmp_path):
    """HierarchyRenderer splitting its frames into bands renders what it
    renders whole; ``n_bands`` is cut to the visible devices."""
    path, h = write_hier_pair(tmp_path, n=150, seed=0)
    whole = tservice.HierarchyRenderer(path, budget=h.n_nodes, sh_degree=1,
                                       device="cpu", n_bands=0)
    assert whole.band_devices is None
    split = tservice.HierarchyRenderer(path, budget=h.n_nodes, sh_degree=1,
                                       device="cpu")
    split.band_devices = [torch.device("cpu")] * 3
    for eye, tau in (((0, -0.5, -18.0), 0.0), ((0.5, -0.2, -5.0), 3.0)):
        _, cam = camera_pair(eye, fovx=1.1, width=64, height=72)
        a, sa = whole.render(cam, tau)
        b, sb = split.render(cam, tau)
        assert sa == sb and a.max() > 0
        np.testing.assert_array_equal(a, b)


# ------------------------------------------------------------------ web ---

def _get(conn, url):
    conn.request("GET", url)
    resp = conn.getresponse()
    return resp, resp.read()


def test_web_viewer_frames(tmp_path):
    """``/``, ``/info``, ``/frame`` and its headers, the last-frame cache,
    errors; the JPEG at each ``q`` is PIL's JPEG of ``renderer.render``
    byte for byte (the viewer's default quality 85 without ``q``), and the
    render within 1/255 of the JAX renderer's frame for the same camera."""
    path, h = write_hier_pair(tmp_path, n=150, seed=3)
    r = tservice.HierarchyRenderer(path, budget=h.n_nodes, sh_degree=1,
                                   device="cpu")
    check = tservice.HierarchyRenderer(path, budget=h.n_nodes, sh_degree=1,
                                       device="cpu")
    jr = JRenderer(path, budget=h.n_nodes, sh_degree=1, n_bands=1,
                   raster_cfg=JRasterCfg(max_entries=1 << 14,
                                         max_per_tile=256, chunk=16,
                                         backend="xla"))
    v = WebViewer(r, port=0, tau=3.0).start()
    try:
        conn = http.client.HTTPConnection("127.0.0.1", v.port, timeout=120)
        resp, page = _get(conn, "/")
        assert resp.status == 200 and b"h3dgs viewer" in page
        assert b"r.blob()" in page
        resp, body = _get(conn, "/info")
        info = json.loads(body)
        assert info["n_nodes"] == h.n_nodes and info["budget"] == h.n_nodes
        assert len(info["center"]) == 3 and info["radius"] > 0
        c, rad = info["center"], info["radius"]
        frames = []
        for dx, tau, q in ((0.0, 0.0, 50), (0.4, 3.0, None), (0.4, 3.0, None),
                           (0.4, 3.0, 95)):
            eye = (c[0] + dx * rad, c[1], c[2] - rad)
            url = (f"/frame?ex={eye[0]}&ey={eye[1]}&ez={eye[2]}"
                   f"&tx={c[0]}&ty={c[1]}&tz={c[2]}&fovx=1.1&w=64&h=48"
                   f"&tau={tau}" + ("" if q is None else f"&q={q}"))
            resp, body = _get(conn, url)
            assert resp.status == 200, body
            assert resp.getheader("Content-Type") == "image/jpeg"
            jc, tc = camera_pair(eye, target=tuple(c), fovx=1.1, width=64,
                                 height=48)
            want, stats = check.render(tc, tau)
            pil = io.BytesIO()
            Image.fromarray(want).save(pil, "JPEG",
                                       quality=85 if q is None else q)
            assert body == pil.getvalue()
            np.testing.assert_array_equal(decode_jpeg(body),
                                          np.asarray(Image.open(pil)))
            assert int(resp.getheader("X-Cut-Size")) == stats["cut_size"]
            assert float(resp.getheader("X-Limit")) == pytest.approx(
                stats["limit"], rel=1e-5)
            ja, _ = jr.render(jc, tau)
            d = np.abs(want.astype(np.int32) - ja.astype(np.int32))
            assert d.max() <= 1, d.max()
            assert want.max() > 0
            frames.append(body)
        # The same pose and quality again: the cached bytes; another
        # quality: another encode.
        assert frames[2] == frames[1] != frames[3]
        for bad in ("/frame?w=8&h=48", "/frame?fovx=4", "/frame?ex=nan",
                    "/frame?q=nan"):
            resp, _ = _get(conn, bad)
            assert resp.status == 400, bad
        resp, _ = _get(conn, "/nothing")
        assert resp.status == 404
        conn.close()
    finally:
        v.stop()


def test_encode_png_round_trip():
    """The in-memory PNG encoder is what ``write_png`` writes."""
    from h3dgs_tpu_torch.io.image import encode_png, read_image, write_png

    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (17, 23, 3), dtype=np.uint8)
    body = encode_png(img, 1)
    np.testing.assert_array_equal(decode_png(body), img)
    path = os.path.join(os.environ.get("TMPDIR", "/tmp"),
                        f"encode_png_{os.getpid()}.png")
    try:
        write_png(path, img, 1)
        with open(path, "rb") as f:
            assert f.read() == body
        np.testing.assert_array_equal(read_image(path), img)
    finally:
        os.remove(path)
