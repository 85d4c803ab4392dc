"""The port's spans and counters (``utils/profiling.py``): they record only
under a profiler, change no frame and no step, nest as the layers do,
and every host read of a device value on the frame path sits in a span
of its own whose name ends in ``.sync``."""
from __future__ import annotations

import json
import socket
import threading
import time

import jax  # noqa: F401  (the test suite's convention: both packages)
import numpy as np
import pytest
import torch
from torch.overrides import TorchFunctionMode

from h3dgs_tpu_torch.config import OptimizationConfig as TOptCfg
from h3dgs_tpu_torch.model import init as tinit
from h3dgs_tpu_torch.ops import adam as tadam
from h3dgs_tpu_torch.ops import binning as tbinning
from h3dgs_tpu_torch.ops import blend as tblend
from h3dgs_tpu_torch.ops.rasterize import RasterizeConfig
from h3dgs_tpu_torch.parallel import step as tdp
from h3dgs_tpu_torch.scene import views as tviews
from h3dgs_tpu_torch.train import loop as tloop
from h3dgs_tpu_torch.utils import profiling
from h3dgs_tpu_torch.viewer import service as tservice

from .test_network_gui import _client_request
from .test_torch_common import camera_pair, np_, t_, write_hier_pair
from .test_torch_train import _step_setup, _tstate_of

torch.set_num_threads(2)


@pytest.fixture(scope="module")
def hier(tmp_path_factory):
    return write_hier_pair(tmp_path_factory.mktemp("hier"), n=150, seed=0)


# --------------------------------------------------------------- drivers --
def _frame_fn(hier):
    """One fresh frame of a renderer whose cut cache is emptied first."""
    path, h = hier
    r = tservice.HierarchyRenderer(path, budget=h.n_nodes, sh_degree=1,
                                   device="cpu")
    _, cam = camera_pair((0.4, -0.5, -6.0), fovx=1.1, width=64, height=48)

    def run():
        r._cut_cache = None
        img, stats = r.render(cam, 3.0)
        return [img, stats]
    return run


def _flat_fn():
    """One dp flat step from the same state, moments and view."""
    st, exposure, _, tb = _step_setup()
    cfg = TOptCfg(iterations=100, densify_grad_threshold=1e9)
    step = tdp.make_dp_train_step(cfg, RasterizeConfig())
    state = _tstate_of(st)
    opt = tadam.init(state.trainable_dict())
    exp = t_(exposure)
    exp_opt = tadam.init({"exposure": exp})

    def run():
        out = step(state, opt, exp, exp_opt, [tb], 7, torch.zeros(3), 2.0,
                   2.0, 1)
        return [out.state.trainable_dict(), out.opt.mu, out.opt.nu,
                out.exposure, out.photo_loss, out.depth_loss]
    return run


def _post_fn(hier):
    """One dp post step over the hierarchy at a fixed limit."""
    _, h = hier
    state, anchor = tinit.state_from_hierarchy(h, "", max_sh_degree=1,
                                               device="cpu")
    opt = tadam.init(state.trainable_dict())
    step = tdp.make_dp_post_step(TOptCfg(iterations=60), RasterizeConfig())
    _, cam = camera_pair((0.3, -0.2, -4.0), fovx=1.0, width=48, height=32)
    rng = np.random.default_rng(3)
    view = tviews.ViewBatch(
        camera=cam, gt_image=t_(rng.random((3, 32, 48), np.float32)),
        alpha_mask=torch.ones(1, 32, 48), invdepth=torch.zeros(1, 32, 48),
        depth_mask=torch.zeros(1, 32, 48),
        depth_reliable=torch.tensor(False), image_idx=torch.tensor(0))

    def run():
        out = step(state, opt, [view], t_(h.nodes), t_(h.boxes),
                   torch.as_tensor(anchor), [torch.eye(3, 4)],
                   [torch.tensor(0.02)], 7, torch.zeros(3), 2.0, 1)
        return [out.state.trainable_dict(), out.opt.mu, out.opt.nu,
                out.photo_loss, out.cut_size]
    return run


def _leaves(x):
    if isinstance(x, dict):
        return [v for k in sorted(x) for v in _leaves(x[k])]
    if isinstance(x, (list, tuple)):
        return [v for i in x for v in _leaves(i)]
    return [x]


def _same(a, b):
    for x, y in zip(_leaves(a), _leaves(b), strict=True):
        if isinstance(x, torch.Tensor):
            assert torch.equal(x, y)
        elif isinstance(x, np.ndarray):
            np.testing.assert_array_equal(x, y)
        else:
            assert x == y


def _edges(snap) -> set:
    """The span tree as (parent name, name) pairs."""
    spans = snap["spans"]
    return {(spans[p][0] if p >= 0 else None, name)
            for name, p, *_ in spans}


RASTER = {("raster.bin", "raster.entries.sync"),
          ("raster.bin", "raster.tiles.sync")}
TREES = {
    "frame": RASTER | {
        (None, "serve.render"),
        ("serve.render", "serve.cut"), ("serve.cut", "serve.center.sync"),
        ("serve.cut", "serve.fit"), ("serve.fit", "serve.ladder.sync"),
        ("serve.cut", "cut.select"), ("cut.select", "cut.count.sync"),
        ("serve.render", "raster.project"), ("serve.render", "raster.bin"),
        ("serve.render", "raster.blend"), ("serve.render", "serve.finish"),
        ("serve.render", "serve.frame.sync"),
        ("serve.render", "serve.cache"), ("serve.cache", "serve.limit.sync"),
        ("serve.cache", "serve.hyst.sync"),
        ("serve.cache", "serve.dmin.sync")},
    "flat": RASTER | {
        (None, "train.step"), ("train.step", "train.forward"),
        ("train.step", "train.loss"), ("train.step", "train.backward"),
        ("train.step", "train.update"), ("train.forward", "raster.project"),
        ("train.forward", "raster.bin"), ("train.forward", "raster.blend"),
        ("train.update", "update.lock"), ("train.update", "update.stats"),
        ("train.update", "update.adam"), ("train.update", "update.shrink")},
    "post": RASTER | {
        (None, "post.step"), ("post.step", "post.forward"),
        ("post.step", "post.loss"), ("post.step", "post.backward"),
        ("post.step", "post.update"), ("post.forward", "cut.select"),
        ("cut.select", "cut.count.sync"), ("post.forward", "raster.project"),
        ("post.forward", "raster.bin"), ("post.forward", "raster.blend"),
        ("post.update", "update.lock"), ("post.update", "update.adam")},
}


def _driver(kind, hier):
    return {"frame": lambda: _frame_fn(hier), "flat": _flat_fn,
            "post": lambda: _post_fn(hier)}[kind]()


# ------------------------------------------------------------- recorder --
def test_recorder_off_is_one_shared_no_op():
    profiling.reset()
    assert not torch.autograd._profiler_enabled()
    a, b = profiling.span("x"), profiling.span("y", begins=True)
    assert a is b
    with a:
        profiling.count("c", 3)
    assert profiling.snapshot() == {"spans": [], "counters": {}}


def test_recorder_nesting_ordinals_and_stretches(tmp_path):
    with profiling.trace(str(tmp_path)):
        with profiling.span("a", begins=True):
            with profiling.span("b", begins=True):
                profiling.count("n", 2)
                profiling.count("n", 3)
        with profiling.span("c"):
            pass
        with profiling.span("a", begins=True):
            pass
    snap = profiling.snapshot()
    assert [(s[0], s[1], s[4]) for s in snap["spans"]] == [
        ("a", -1, 0), ("b", 0, 0), ("c", -1, 0), ("a", -1, 1)]
    for _, _, t0, t1, _ in snap["spans"]:
        assert t0 <= t1
    assert snap["spans"][0][2] <= snap["spans"][1][2] <= \
        snap["spans"][1][3] <= snap["spans"][0][3]
    assert snap["counters"] == {"n": {"total": 5, "samples": 2}}
    events = json.load(open(tmp_path / "trace.json"))["traceEvents"]
    assert sum(e.get("name") == "h3dgs.a" for e in events) == 2
    # A span made with recording off ends the stretch; the record stays
    # readable until the next recorded span starts a new one.
    with profiling.span("off"):
        pass
    assert len(profiling.snapshot()["spans"]) == 4
    with torch.profiler.profile():
        with profiling.span("z"):
            pass
    assert [s[0] for s in profiling.snapshot()["spans"]] == ["z"]


# ----------------------------------------------------------- the paths ---
@pytest.mark.parametrize("kind", ["frame", "flat", "post"])
def test_recording_changes_nothing(kind, hier, tmp_path):
    """Off, nothing is recorded; on, the frame or step is bit-equal to the
    one made off."""
    run = _driver(kind, hier)
    profiling.reset()
    off = run()
    assert profiling.snapshot() == {"spans": [], "counters": {}}
    with profiling.trace(str(tmp_path)):
        on = run()
    assert profiling.snapshot()["spans"]
    _same(off, on)


@pytest.mark.parametrize("kind", ["frame", "flat", "post"])
def test_span_tree(kind, hier, tmp_path):
    run = _driver(kind, hier)
    with profiling.trace(str(tmp_path)):
        run()
    assert _edges(profiling.snapshot()) == TREES[kind]


def test_post_cut_rows_counter(hier, tmp_path):
    """``cut.rows`` adds the post step's cut size, once a view."""
    run = _post_fn(hier)
    with profiling.trace(str(tmp_path)):
        out = run()
    assert profiling.snapshot()["counters"]["cut.rows"] == {
        "total": int(out[-1]), "samples": 1}


def _host_view():
    *_, tb = _step_setup()
    return tb._replace(**{k: np_(getattr(tb, k)) for k in
                          ("gt_image", "alpha_mask", "invdepth",
                           "depth_mask", "depth_reliable", "image_idx")})


def test_view_spans_and_ready_counter(tmp_path):
    """A stream of staged views with a ``ready`` method, as
    ``ViewStream`` has: ``view.next`` begins a step and holds the wait
    and the copy; ``view.ready`` counts the views the stream had
    decoded."""
    host = _host_view()

    class Stream:
        def __init__(self):
            self.n = 0

        def ready(self):
            return self.n % 2 == 0

        def __next__(self):
            self.n += 1
            return tviews.stage_view(host, pin=False)

    pf = tloop.BatchedPrefetcher(Stream(), 1, "cpu")
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            next(pf)
    snap = profiling.snapshot()
    assert _edges(snap) == {(None, "view.next"), ("view.next", "view.wait"),
                            ("view.next", "view.copy")}
    assert [s[4] for s in snap["spans"] if s[0] == "view.next"] == [0, 1, 2]
    assert snap["counters"]["view.ready"] == {"total": 1, "samples": 3}


def test_staged_view_spans_and_counter(tmp_path):
    """A stream of staged views without a ``ready`` method: ``view.next``
    holds only the wait and the copy, ``view.staged`` adds 1 a view, and
    ``view.ready`` is left out."""
    host = _host_view()

    class Stream:
        def __next__(self):
            return tviews.stage_view(host, pin=False)

    pf = tloop.BatchedPrefetcher(Stream(), 1, "cpu")
    with profiling.trace(str(tmp_path)):
        for _ in range(3):
            next(pf)
    snap = profiling.snapshot()
    assert _edges(snap) == {(None, "view.next"), ("view.next", "view.wait"),
                            ("view.next", "view.copy")}
    assert [s[4] for s in snap["spans"] if s[0] == "view.next"] == [0, 1, 2]
    assert snap["counters"]["view.staged"] == {"total": 3, "samples": 3}
    assert "view.ready" not in snap["counters"]


# ------------------------------------------------------- frame counters --
def _serve_once(renderer, req):
    """One request of ``serve()`` on this thread (where the profiler
    records); the client runs on another."""
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    stop = threading.Event()
    w, h = req["resolution_x"], req["resolution_y"]
    got = {}

    def client():
        msg = json.dumps(req).encode("utf-8")
        try:
            for _ in range(400):
                try:
                    c = socket.create_connection(("127.0.0.1", port),
                                                 timeout=60)
                    break
                except ConnectionRefusedError:
                    time.sleep(0.05)
            with c:
                c.sendall(len(msg).to_bytes(4, "little") + msg)
                buf = b""
                while len(buf) < h * w * 3 + 4:
                    chunk = c.recv(h * w * 3 + 4 - len(buf))
                    if not chunk:
                        break
                    buf += chunk
                got["buf"] = buf
                stop.set()
        finally:
            stop.set()

    th = threading.Thread(target=client, daemon=True)
    th.start()
    tservice.serve(renderer, "127.0.0.1", port, 3.0, stop=stop)
    th.join(timeout=60)
    assert not th.is_alive()
    return got["buf"]


def test_serve_request_spans_and_counters(hier, tmp_path, monkeypatch):
    """A request through ``serve()``: read, render and send inside
    ``serve.request``; ``cut.rows`` is the render's own cut size,
    ``raster.entries`` the binned entry count."""
    path, h = hier
    r = tservice.HierarchyRenderer(path, budget=h.n_nodes, sh_degree=1,
                                   device="cpu")
    stats, entries = [], []
    render, binned = r.render, tbinning.bin_gaussians

    def keep_stats(*a, **k):
        out = render(*a, **k)
        stats.append(out[1])
        return out

    def keep_entries(*a, **k):
        out = binned(*a, **k)
        entries.append(int(out.total_entries))
        return out

    monkeypatch.setattr(r, "render", keep_stats)
    monkeypatch.setattr(tbinning, "bin_gaussians", keep_entries)
    monkeypatch.setattr("h3dgs_tpu_torch.ops.rasterize.bin_gaussians",
                        keep_entries)
    with profiling.trace(str(tmp_path)):
        _serve_once(r, _client_request(48, 32))
    snap = profiling.snapshot()
    edges = _edges(snap)
    assert {(None, "serve.request"), ("serve.request", "serve.read"),
            ("serve.request", "serve.render"),
            ("serve.request", "serve.send")} <= edges
    assert (None, "serve.render") not in edges
    assert stats and stats[0]["cut_reused"] is False
    c = snap["counters"]
    assert c["cut.rows"] == {"total": stats[0]["cut_size"], "samples": 1}
    assert c["raster.entries"] == {"total": sum(entries),
                                   "samples": len(entries)}
    assert sum(entries) > 0


# -------------------------------------------------------- host reads ----
READS = {"item", "__bool__", "__float__", "__int__", "__index__", "tolist",
         "numpy", "cpu", "__array__", "nonzero", "bincount", "unique",
         "masked_select", "argwhere"}


class _Reads(TorchFunctionMode):
    """Times of the calls that read a device value on the host (or size
    a result by one: a boolean mask, a count of repeats; indexing by a
    0-d tensor reads it), leaving out reads of ``host`` tensors."""

    def __init__(self, host):
        super().__init__()
        self.host, self.times, self.plain = host, [], 0

    def __torch_function__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        name = getattr(func, "__name__", "")
        read = name in READS or (
            name == "repeat_interleave" and len(args) > 1
            and isinstance(args[1], torch.Tensor)
            and "output_size" not in kwargs) or (
            name == "__getitem__" and any(
                isinstance(i, torch.Tensor) and (
                    i.dtype == torch.bool or i.dim() == 0)
                for i in (args[1] if isinstance(args[1], tuple)
                          else (args[1],))))
        if read and not self.plain and not (
                args and any(args[0] is t for t in self.host)):
            self.times.append((time.perf_counter_ns(), name))
        return func(*args, **kwargs)


def test_frame_host_reads_lie_in_sync_spans(hier, tmp_path, monkeypatch):
    """Every read of a device value on a fresh frame's path, and on a
    reused one's, runs inside a ``.sync`` span. The camera's own tensors
    live on the host, and the CPU's plain blend stands in for K1, which
    reads nothing on the card: their reads are left out."""
    path, h = hier
    r = tservice.HierarchyRenderer(path, budget=h.n_nodes, sh_degree=1,
                                   device="cpu")
    _, cam = camera_pair((0.4, -0.5, -6.0), fovx=1.1, width=64, height=48)
    mode = _Reads([cam.view, cam.full_proj, cam.cam_center, cam.tanfovx,
                   cam.tanfovy])
    plain = tblend.blend_plain

    def blend_plain(*a, **k):
        mode.plain += 1
        try:
            return plain(*a, **k)
        finally:
            mode.plain -= 1
    monkeypatch.setattr(tblend, "blend_plain", blend_plain)
    with profiling.trace(str(tmp_path)):
        with mode:
            fresh = r.render(cam, 3.0)
            reused = r.render(cam, 3.0)
    assert not fresh[1]["cut_reused"] and reused[1]["cut_reused"]
    syncs = [(t0, t1) for name, _, t0, t1, _ in profiling.snapshot()["spans"]
             if name.endswith(".sync")]
    assert mode.times
    for t, what in mode.times:
        assert any(t0 <= t <= t1 for t0, t1 in syncs), what
