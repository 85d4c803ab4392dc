"""The port's hierarchy render service against the JAX package's: the same
.hier rendered by both HierarchyRenderers, the cut-reuse behaviour of
tests/test_service.py, one serve() request over a socket, render_post and
the command line."""
from __future__ import annotations

import json
import os
import socket
import threading

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h3dgs_tpu.model import state as jstate
from h3dgs_tpu.ops.rasterize import RasterizeConfig
from h3dgs_tpu.render import render_post as jrender_post
from h3dgs_tpu.viewer.service import HierarchyRenderer as JRenderer
from h3dgs_tpu_torch.model import state as tstate
from h3dgs_tpu_torch.render import render_post as trender_post
from h3dgs_tpu_torch.viewer import service as tservice
from h3dgs_tpu_torch.viewer.network_gui import NetworkGUI as TGUI

from .test_network_gui import _client_request
from .test_torch_common import camera_pair, np_, write_hier_pair

torch.set_num_threads(2)

# The JAX service's XLA path on one device; the scenes stay far inside its
# entry budget and per-tile cap.
XCFG = RasterizeConfig(max_entries=1 << 14, max_per_tile=256, chunk=16,
                       backend="xla")


def _frames_close(a, b):
    """uint8 frames within +-1 on >= 99.9 % of values (truncation of
    float32 values that differ in the last bits)."""
    assert a.shape == b.shape and a.dtype == b.dtype == np.uint8
    d = np.abs(a.astype(np.int32) - b.astype(np.int32))
    assert (d <= 1).mean() >= 0.999, (d.max(), (d > 1).mean())


@pytest.fixture(scope="module")
def hier(tmp_path_factory):
    return write_hier_pair(tmp_path_factory.mktemp("hier"), n=150, seed=0)


def test_renderer_parity(hier):
    """Same frames, cut sizes and budget-fitted limits, unconstrained and
    under a budget that forces tau up the ladder."""
    path, h = hier
    for budget in (h.n_nodes, 40):
        jr = JRenderer(path, budget=budget, sh_degree=1, raster_cfg=XCFG,
                       n_bands=1)
        tr = tservice.HierarchyRenderer(path, budget=budget, sh_degree=1,
                                        device="cpu")
        for eye, tau in (((0, -0.5, -18.0), 0.0), ((3.0, 1.0, -9.0), 3.0),
                         ((0.5, -0.2, -5.0), 6.0)):
            jc, tc = camera_pair(eye, fovx=1.1, width=64, height=48)
            ja, js = jr.render(jc, tau)
            ta, ts = tr.render(tc, tau)
            _frames_close(ta, ja)
            assert ts == js, (budget, tau, ts, js)
            assert ta.max() > 0
            if budget < h.n_nodes:
                assert ts["cut_size"] <= budget


def test_cut_reuse_matches_reference(hier):
    """Rotating in place and tiny moves reuse the cut, large moves
    re-select, and the reused frames stay close to fresh ones — with the
    same reuse decisions as the JAX service."""
    path, h = hier
    jr = JRenderer(path, budget=h.n_nodes, sh_degree=1, raster_cfg=XCFG,
                   n_bands=1, reuse_margin=0.05)
    tr = tservice.HierarchyRenderer(path, budget=h.n_nodes, sh_degree=1,
                                    reuse_margin=0.05, device="cpu")
    steps = [((0, -0.5, -18.0), (0, 0, 0), False),
             ((0, -0.5, -18.0), (0.5, 0, 0), True),
             ((0.02, -0.5, -18.0), (0, 0, 0), True),
             ((0, -0.5, -9.0), (0, 0, 0), False)]
    frames = []
    for eye, target, reused in steps:
        jc, tc = camera_pair(eye, target=target, fovx=1.1, width=64,
                             height=48)
        ja, js = jr.render(jc, 3.0)
        ta, ts = tr.render(tc, 3.0)
        assert ts["cut_reused"] == js["cut_reused"] == reused
        assert ts["cut_size"] == js["cut_size"]
        _frames_close(ta, ja)
        frames.append(ta)
    assert np.isfinite(tr._cut_cache["d_min"])

    fresh = tservice.HierarchyRenderer(path, budget=h.n_nodes, sh_degree=1,
                                       reuse_margin=0.0, device="cpu")
    _, tc = camera_pair((0.02, -0.5, -18.0), fovx=1.1, width=64, height=48)
    img, s = fresh.render(tc, 3.0)
    assert not s["cut_reused"] and fresh._cut_cache is None
    err = np.abs(frames[2].astype(np.float32)
                 - img.astype(np.float32)).mean() / 255.0
    assert err < 0.02, err


def test_reuse_margin_bounds(hier):
    """The hysteresis cut is never coarser than the exact one, and never
    exceeds the budget."""
    path, h = hier
    _, cam = camera_pair((0, -0.5, -30.0), fovx=1.1, width=64, height=48)
    r_m = tservice.HierarchyRenderer(path, budget=h.n_nodes, sh_degree=1,
                                     reuse_margin=0.05, device="cpu")
    r_0 = tservice.HierarchyRenderer(path, budget=h.n_nodes, sh_degree=1,
                                     reuse_margin=0.0, device="cpu")
    assert (r_m.render(cam, 6.0)[1]["cut_size"]
            >= r_0.render(cam, 6.0)[1]["cut_size"])
    r_b = tservice.HierarchyRenderer(path, budget=40, sh_degree=1,
                                     reuse_margin=0.2, device="cpu")
    _, cam = camera_pair((0, -0.5, -18.0), fovx=1.1, width=64, height=48)
    for tau in (0.0, 3.0, 6.0):
        assert r_b.render(cam, tau)[1]["cut_size"] <= 40


def test_serve_one_request(hier):
    """serve() answers the wire protocol: the reply is the frame render()
    gives for the decoded camera, then the verify string; the JAX service
    renders the same frame."""
    path, h = hier
    r = tservice.HierarchyRenderer(path, budget=h.n_nodes, sh_degree=1,
                                   device="cpu")
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    stop = threading.Event()
    server = threading.Thread(target=tservice.serve,
                              args=(r, "127.0.0.1", port, 3.0),
                              kwargs={"stop": stop}, daemon=True)
    server.start()
    w, hh = 48, 32
    req = _client_request(w, hh)
    msg = json.dumps(req).encode("utf-8")
    try:
        for _ in range(200):
            try:
                c = socket.create_connection(("127.0.0.1", port), timeout=60)
                break
            except ConnectionRefusedError:
                stop.wait(0.05)
        with c:
            c.sendall(len(msg).to_bytes(4, "little") + msg)
            buf = b""
            while len(buf) < hh * w * 3 + 4:
                chunk = c.recv(hh * w * 3 + 4 - len(buf))
                assert chunk, "server closed early"
                buf += chunk
    finally:
        stop.set()
        server.join(timeout=30)
    assert not server.is_alive()
    img = np.frombuffer(buf[:hh * w * 3], np.uint8).reshape(hh, w, 3)
    assert int.from_bytes(buf[-4:], "little") == 0     # empty verify string
    cam = TGUI._camera_from_msg(req)
    want, _ = r.render(cam, 3.0)
    np.testing.assert_array_equal(img, want)
    assert img.max() > 0

    from h3dgs_tpu.viewer.network_gui import NetworkGUI as JGUI
    jcam = JGUI._camera_from_msg(None, req)
    jr = JRenderer(path, budget=h.n_nodes, sh_degree=1, raster_cfg=XCFG,
                   n_bands=1)
    _frames_close(img, jr.render(jcam, 3.0)[0])


def test_render_post_parity(hier):
    path, h = hier
    n_sky = 3
    rng = np.random.default_rng(1)
    xyz = np.concatenate([h.xyz, rng.normal(size=(n_sky, 3)) * 5])
    shs = np.concatenate([h.shs, rng.normal(size=(n_sky, 16, 3)) * 0.3])
    alpha = np.concatenate([h.alpha, np.full(n_sky, 0.6, np.float32)])
    scaling = np.concatenate([h.scaling, np.full((n_sky, 3), -1.0)])
    rot = np.concatenate([h.rotation, np.tile([1.0, 0, 0, 0], (n_sky, 1))])
    kw = dict(capacity=xyz.shape[0] + 4, n_skybox=n_sky, skybox_last=True,
              opacity_abs=True, max_sh_degree=1)
    js = jstate.from_arrays(xyz, shs[:, :1], shs[:, 1:], alpha, scaling,
                            rot, **kw)
    ts = tstate.from_arrays(xyz, shs[:, :1], shs[:, 1:], alpha, scaling,
                            rot, device="cpu", **kw)
    jc, tc = camera_pair((1.0, -0.5, -6.0), fovx=1.1, width=64, height=48)
    bg = np.array([0.2, 0.1, 0.0], np.float32)
    ex = np.concatenate([np.eye(3) * 0.9, np.full((3, 1), 0.05)], 1)
    jo = jax.jit(lambda c, st, e: jrender_post(
        c, st, jnp.asarray(h.nodes), jnp.asarray(h.boxes), 0.05, bg,
        max_cut=h.n_nodes, exposure=e, config=XCFG))(jc, js,
                                                       jnp.asarray(ex))
    to = trender_post(tc, ts, h.nodes, h.boxes, 0.05, bg, max_cut=h.n_nodes,
                      exposure=ex, device="cpu")
    assert int(to["cut"].count) == int(jo["cut"].count)
    np.testing.assert_array_equal(np_(to["cut"].indices),
                                  np.asarray(jo["cut"].indices))
    d = np.abs(np_(to["render"]) - np.asarray(jo["render"]))
    assert (d <= 1e-4).mean() >= 0.999, d.max()
    assert int(to["n_duplicates"]) == int(jo["n_duplicates"])


def test_main_orbit_on_cpu(hier, tmp_path):
    from PIL import Image

    path, _ = hier
    out = os.path.join(str(tmp_path), "frames")
    tservice.main(["--hierarchy", path, "--orbit_dir", out, "--n_frames",
                   "2", "--radius", "12", "--width", "64", "--device",
                   "cpu"])
    frames = sorted(os.listdir(out))
    assert frames == ["frame_0000.png", "frame_0001.png"]
    assert np.asarray(Image.open(os.path.join(out, frames[0]))).shape == (
        36, 64, 3)
    assert tservice.splats_for_mb(660.0) == int(
        660 * (1 << 20) / tservice.BYTES_PER_SPLAT)
