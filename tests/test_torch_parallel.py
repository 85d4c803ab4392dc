"""Parity of the port's view data parallelism with the JAX package, on the
same seeded numpy inputs: the dp flat step (``parallel/step.py``) against
both JAX builders (``make_dp_train_step`` on a one-device mesh and the
vmapped ``make_parallel_train_step``), the dp post step against the JAX
one, one view through the dp steps against the single-view steps, the
loops' dp wiring (``train_flat`` / ``train_post`` with several views a
step through their CLIs, the ``ValueError`` s, ``ViewStream``'s
``keep_fn``), two gloo processes against one process, and, port only,
the dp flat step on the rows below the store's high-water mark against
the step on every capacity row (bit for bit) and the mark against every
writer of ``alive``.

Tolerance for the dp steps: ``rtol=2e-4, atol=2e-5`` on parameters, both
Adam moments, exposure and densification stats (``tests/test_dp_loop.py``'s
tolerance: the views' gradients are summed in another order, and the JAX
XLA blend keeps transmittance in log space). Parity scenes keep off the
known ties (hazards H4-H6, H9, H10).
"""
from __future__ import annotations

import dataclasses
import os
import socket
import subprocess
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h3dgs_tpu.config import OptimizationConfig as JOptCfg
from h3dgs_tpu.model import init as jinit
from h3dgs_tpu.model import state as jstate
from h3dgs_tpu.ops import adam as jadam
from h3dgs_tpu.ops.rasterize import RasterizeConfig as JRasterCfg
from h3dgs_tpu.ops.rasterize import rasterize as jrasterize
from h3dgs_tpu.parallel import sharding as jshard
from h3dgs_tpu.parallel import step as jpar
from h3dgs_tpu.train import step as jstep
from h3dgs_tpu_torch.config import (FullConfig, ModelConfig,
                                    OptimizationConfig, RuntimeConfig)
from h3dgs_tpu_torch.model import densify as tdens
from h3dgs_tpu_torch.model import state as tstate
from h3dgs_tpu_torch.ops import adam as tadam
from h3dgs_tpu_torch.ops.rasterize import RasterizeConfig as TRasterCfg
from h3dgs_tpu_torch.parallel import step as tpar
from h3dgs_tpu_torch.scene import loader as tloader
from h3dgs_tpu_torch.scene import views as tviews
from h3dgs_tpu_torch.train import checkpoint as tckpt
from h3dgs_tpu_torch.train import loop as tloop
from h3dgs_tpu_torch.train import post_step as tpost
from h3dgs_tpu_torch.train import step as tstep

from .synthetic_scene import make_gaussian_scene, ring_cameras, \
    write_colmap_scene
from .test_torch_common import REPO, camera_pair, np_, t_
from .test_torch_post import _write_scaffold
from .test_torch_post import chunk  # noqa: F401  (a module fixture)
from .utils import random_scene

torch.set_num_threads(2)

XCFG = JRasterCfg(max_entries=1 << 13, max_per_tile=128, chunk=16,
                  backend="xla")
RTOL, ATOL = 2e-4, 2e-5
N_VIEWS = 4
PARAMS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
          "rotation")
STATS = ("xyz_gradient_accum", "denom", "max_radii2d")


def _static(st) -> dict:
    return dict(max_sh_degree=st.max_sh_degree, opacity_abs=st.opacity_abs,
                n_skybox=st.n_skybox, n_scaffold=st.n_scaffold,
                skybox_last=st.skybox_last)


def _arrays(st) -> dict:
    return {f: np.array(getattr(st, f)) for f in tstate.ALL_FIELDS}


def _opt_arrays(o):
    return ({k: np.array(v) for k, v in o.mu.items()},
            {k: np.array(v) for k, v in o.nu.items()}, np.array(o.step))


def view_batches(host: dict, cams):
    """Stacked host view arrays (leading axis = view) and camera pairs ->
    (the JAX ViewBatch stacked on a leading axis, the port's list of
    per-view ViewBatch)."""
    jcams = jax.tree.map(lambda *xs: jnp.stack(xs), *[c[0] for c in cams])
    jb = jstep.ViewBatch(camera=jcams,
                         **{k: jnp.asarray(v) for k, v in host.items()})
    tb = [tviews.ViewBatch(camera=cams[i][1],
                           **{k: t_(v[i]) for k, v in host.items()})
          for i in range(len(cams))]
    return jb, tb


def _flat_setup(n_views=N_VIEWS, n=32, h=32, w=32):
    """A state with 4 locked skybox rows over a random scene, views around
    it with their targets, exposures and depth maps, in both packages."""
    means, scales, quats, opac, shs = random_scene(n, 3, sh_degree=1,
                                                   spread=0.8)
    feats = np.zeros((n, 16, 3), np.float32)
    feats[:, :4] = shs
    feats[:, 0] = np.clip(feats[:, 0], -0.6, 0.6)
    st = jstate.from_arrays(
        means, feats[:, :1], feats[:, 1:],
        np.log(opac / (1 - opac))[:, None], np.log(scales), quats,
        capacity=n + 16, max_sh_degree=1, n_skybox=4, n_scaffold=4)
    cams = [camera_pair((3 * np.sin(a), -0.4, -3 * np.cos(a)), fovx=1.1,
                        width=w, height=h)
            for a in np.linspace(0, np.pi, n_views, endpoint=False)]
    rng = np.random.default_rng(5)
    tgt = feats[:, :4] + rng.normal(0, 0.1, (n, 4, 3)).astype(np.float32)
    gts = np.stack([np.asarray(jrasterize(
        means, scales, quats, opac, tgt, jc, 1, jnp.full(3, 0.5),
        config=XCFG)["render"]) for jc, _ in cams])
    alpha = np.ones((n_views, 1, h, w), np.float32)
    alpha[:, :, :2] = 0.0
    host = dict(gt_image=np.clip(gts, 0, 1) * alpha, alpha_mask=alpha,
                invdepth=(0.3 * rng.random((n_views, 1, h, w))
                          ).astype(np.float32),
                depth_mask=alpha, depth_reliable=np.ones(n_views, bool),
                image_idx=np.arange(n_views, dtype=np.int32))
    exposure = np.tile(np.eye(3, 4, dtype=np.float32)[None],
                       (n_views, 1, 1))
    exposure[:, :, 3] = rng.uniform(-0.02, 0.02, (n_views, 3))
    return st, exposure, cams, host


def _assert_close(got, want, what):
    np.testing.assert_allclose(np_(got), np.asarray(want), rtol=RTOL,
                               atol=ATOL, err_msg=what)


@pytest.fixture(scope="module")
def flat_dp():
    """One 4-view step from the same start through the port's dp step and
    both JAX builders, each JAX builder compiled once."""
    st, exposure, cams, host = _flat_setup()
    jb, tb = view_batches(host, cams)
    kw = dict(use_depth_loss=True, use_exposure=True, skybox_locked=True,
              skip_shrink=False)
    opt_kw = dict(iterations=100, densify_grad_threshold=1e9)
    mesh = jshard.make_mesh(n_data=1, n_tile=1)
    builders = {
        "dp": jpar.make_dp_train_step(JOptCfg(**opt_kw), XCFG, mesh, **kw),
        "vmapped": jpar.make_parallel_train_step(
            JOptCfg(**opt_kw), XCFG, shard_tiles=False, **kw)}
    rng = np.random.default_rng(8)
    jo = jadam.init(st.trainable_dict())
    jo = jadam.AdamState(
        mu={k: jnp.asarray(0.01 * rng.normal(size=v.shape), jnp.float32)
            for k, v in jo.mu.items()},
        nu={k: jnp.asarray(1e-4 * rng.random(v.shape), jnp.float32)
            for k, v in jo.nu.items()}, step=jnp.int32(3))
    start = dict(state=_arrays(st), opt=_opt_arrays(jo))
    bg = np.full(3, 0.5, np.float32)
    args = (jnp.asarray(7.0), jnp.asarray(bg), jnp.asarray(2.0),
            jnp.asarray(3.0), 1)
    outs = {}
    with jax.set_mesh(mesh):
        b_sh = jax.device_put(jb, jshard.data_sharded(mesh))
        for name, step in builders.items():
            je = jnp.asarray(exposure)
            outs[name] = step(jax.tree.map(jnp.copy, st),
                              jax.tree.map(jnp.copy, jo), je,
                              jadam.init({"exposure": je}), b_sh, *args)

    def port_inputs():
        t_st = tstate.state_from_jax_arrays(start["state"], device="cpu",
                                            **_static(st))
        t_o = tstate.adam_from_jax_arrays(*start["opt"], device="cpu")
        t_e = t_(exposure)
        return t_st, t_o, t_e, tadam.init({"exposure": t_e})

    t_dp = tpar.make_dp_train_step(OptimizationConfig(**opt_kw),
                                   TRasterCfg(), **kw)
    t_out = t_dp(*port_inputs(), tb, 7, t_(bg), 2.0, 3.0, 1)
    return dict(jax=outs, port=t_out, start=start, tb=tb,
                port_inputs=port_inputs, bg=bg, opt_kw=opt_kw, kw=kw)


@pytest.mark.parametrize("builder", ["dp", "vmapped"])
def test_dp_train_step_matches_jax(flat_dp, builder):
    """Four views, one step: the port's dp step against the JAX builder:
    losses, parameters, both Adam moments, exposure and its moments,
    densification stats, the sparse-Adam mask (rows with a nonzero
    opacity gradient in any view, H8) and the locked skybox rows."""
    jout, tout = flat_dp["jax"][builder], flat_dp["port"]
    _assert_close(float(tout.photo_loss), float(jout.photo_loss), "photo")
    _assert_close(float(tout.depth_loss), float(jout.depth_loss), "depth")
    assert float(jout.depth_loss) > 0
    assert int(tout.n_visible) == int(jout.n_visible)
    for f in PARAMS + STATS:
        _assert_close(getattr(tout.state, f), getattr(jout.state, f), f)
    for k in jout.opt.mu:
        _assert_close(tout.opt.mu[k], jout.opt.mu[k], "mu " + k)
        _assert_close(tout.opt.nu[k], jout.opt.nu[k], "nu " + k)
    assert int(tout.opt.step) == int(jout.opt.step) == 4
    _assert_close(tout.exposure, jout.exposure, "exposure")
    _assert_close(tout.exposure_opt.mu["exposure"],
                  jout.exposure_opt.mu["exposure"], "exposure mu")
    mu0 = flat_dp["start"]["opt"][0]["opacity"][:, 0]
    t_moved = np_(tout.opt.mu["opacity"])[:, 0] != mu0
    j_moved = np.asarray(jout.opt.mu["opacity"])[:, 0] != mu0
    assert t_moved.sum() > 10
    np.testing.assert_array_equal(t_moved, j_moved)
    before = flat_dp["start"]["state"]
    for f in PARAMS:
        np.testing.assert_array_equal(np_(getattr(tout.state, f))[:4],
                                      before[f][:4])


def test_dp_step_one_view_is_the_single_step(flat_dp):
    """One view through the dp step equals the single-view step bit for
    bit (state, moments, exposure, losses); with four views the step
    takes the views' mean, so it differs from the first view's step."""
    kw, opt_kw = flat_dp["kw"], flat_dp["opt_kw"]
    bg = t_(flat_dp["bg"])
    single = tstep.make_train_step(OptimizationConfig(**opt_kw),
                                   TRasterCfg(), **kw)
    dp = tpar.make_dp_train_step(OptimizationConfig(**opt_kw), TRasterCfg(),
                                 **kw)
    view = flat_dp["tb"][2]
    a = single(*flat_dp["port_inputs"](), view, 7, bg, 2.0, 3.0, 1)
    b = dp(*flat_dp["port_inputs"](), [view], 7, bg, 2.0, 3.0, 1)
    for f in tstate.ALL_FIELDS:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    for k in a.opt.mu:
        assert torch.equal(a.opt.mu[k], b.opt.mu[k]), k
        assert torch.equal(a.opt.nu[k], b.opt.nu[k]), k
    assert torch.equal(a.exposure, b.exposure)
    assert torch.equal(a.exposure_opt.mu["exposure"],
                       b.exposure_opt.mu["exposure"])
    assert float(a.photo_loss) == float(b.photo_loss)
    assert float(a.depth_loss) == float(b.depth_loss)
    assert int(a.n_visible) == int(b.n_visible)
    assert not torch.equal(a.state.xyz, flat_dp["port"].state.xyz)


# ------------------------------------------------------------ post step ---

N_LEAVES, N_LOCKED, N_SKY = 60, 5, 3
POST_LIMITS = (0.05, 0.16)


@pytest.fixture(scope="module")
def post_dp(tmp_path_factory):
    """A hierarchy state with anchors and skybox rows, two views with
    their own limits and exposure rows, and one dp post step in both
    packages (the JAX step on a one-device mesh with max_cut = n_nodes,
    H11)."""
    from h3dgs_tpu.hierarchy import tree as jtree

    tmp = str(tmp_path_factory.mktemp("post_dp"))
    means, scales, quats, opac, shs = random_scene(
        N_LEAVES, 0, sh_degree=1, opacity_hi=0.8)
    shs[:, 0] = np.clip(shs[:, 0], -0.6, 0.6)
    h = jtree.build_hierarchy(means, shs, opac, np.log(scales), quats,
                              locked_leaf_mask=np.arange(N_LEAVES)
                              < N_LOCKED, backend="numpy")
    sc_dir = os.path.join(tmp, "scaffold")
    _write_scaffold(sc_dir, N_SKY, 4, seed=7)
    jst, anchor_mask = jinit.state_from_hierarchy(h, sc_dir,
                                                  max_sh_degree=1)
    cams = [camera_pair((0.3, -0.2, -d), fovx=1.0, width=48, height=32)
            for d in (3.5, 4.5)]
    bg = np.full(3, 0.5, np.float32)
    rng = np.random.default_rng(1)
    tgt = shs + rng.normal(0, 0.1, shs.shape).astype(np.float32)
    gts = np.stack([np.asarray(jrasterize(
        means, scales, quats, opac, tgt, jc, 1, jnp.asarray(bg),
        config=XCFG)["render"]) for jc, _ in cams])
    alpha = np.ones((2, 1, 32, 48), np.float32)
    alpha[:, :, :3] = 0.0
    zeros = np.zeros_like(alpha)
    host = dict(gt_image=np.clip(gts, 0, 1) * alpha, alpha_mask=alpha,
                invdepth=zeros, depth_mask=zeros,
                depth_reliable=np.zeros(2, bool),
                image_idx=np.zeros(2, np.int32))
    jb, tb = view_batches(host, cams)
    exp_rows = np.tile(np.eye(3, 4, dtype=np.float32)[None], (2, 1, 1))
    exp_rows[0, 0, 0], exp_rows[1, 1, 3] = 0.95, 0.01
    lock_all = anchor_mask.copy()
    lock_all[-N_SKY:] = True
    start = _arrays(jst)
    opt_cfg = dict(iterations=60)
    mesh = jshard.make_mesh(n_data=1, n_tile=1)
    j_step = jpar.make_dp_post_step(JOptCfg(**opt_cfg), XCFG, h.n_nodes,
                                    mesh, skybox_locked=True,
                                    use_exposure=True)
    jout = j_step(jst, jadam.init(jst.trainable_dict()), jb,
                  jnp.asarray(h.nodes), jnp.asarray(h.boxes),
                  jnp.asarray(anchor_mask), jnp.asarray(exp_rows),
                  jnp.asarray(POST_LIMITS, jnp.float32), jnp.asarray(7.0),
                  jnp.asarray(bg), jnp.asarray(2.0), 1)

    def port_state():
        return tstate.state_from_jax_arrays(start, device="cpu",
                                            **_static(jst))

    nodes, boxes = t_(h.nodes), t_(h.boxes)
    t_step = tpar.make_dp_post_step(OptimizationConfig(**opt_cfg),
                                    TRasterCfg(), skybox_locked=True,
                                    use_exposure=True)
    st = port_state()
    tout = t_step(st, tadam.init(st.trainable_dict()), tb, nodes, boxes,
                  t_(anchor_mask), [t_(e) for e in exp_rows],
                  [torch.tensor(x) for x in POST_LIMITS], 7, t_(bg), 2.0, 1)
    return dict(h=h, jout=jout, tout=tout, start=start, lock_all=lock_all,
                port_state=port_state, tb=tb, exp_rows=exp_rows,
                nodes=nodes, boxes=boxes, anchor_mask=anchor_mask, bg=bg,
                opt_cfg=opt_cfg)


def test_dp_post_step_matches_jax(post_dp):
    """Two views with their own limits and exposure rows, one step: the
    photometric loss, every parameter and both Adam moments against the
    JAX dp post step; the largest cut equal; anchors and skybox rows bit
    for bit unchanged."""
    jout, tout = post_dp["jout"], post_dp["tout"]
    _assert_close(float(tout.photo_loss), float(jout.photo_loss), "photo")
    assert int(tout.cut_size) == int(jout.cut_size) <= post_dp["h"].n_nodes
    for f in PARAMS:
        _assert_close(getattr(tout.state, f), getattr(jout.state, f), f)
    for k in jout.opt.mu:
        _assert_close(tout.opt.mu[k], jout.opt.mu[k], "mu " + k)
        _assert_close(tout.opt.nu[k], jout.opt.nu[k], "nu " + k)
    lock = post_dp["lock_all"]
    for f in PARAMS:
        got = np_(getattr(tout.state, f))
        np.testing.assert_array_equal(got[lock], post_dp["start"][f][lock])
        assert np.abs(got[~lock] - post_dp["start"][f][~lock]).max() > 0, f


def test_dp_post_step_one_view_is_the_single_step(post_dp):
    """One view through the dp post step equals the single-view post step
    bit for bit; its cut is the exact cut of that view's limit."""
    opt_cfg = OptimizationConfig(**post_dp["opt_cfg"])
    kw = dict(skybox_locked=True, use_exposure=True)
    single = tpost.make_post_train_step(opt_cfg, TRasterCfg(), **kw)
    dp = tpar.make_dp_post_step(opt_cfg, TRasterCfg(), **kw)
    args = (post_dp["nodes"], post_dp["boxes"], t_(post_dp["anchor_mask"]))
    exp_row, limit = t_(post_dp["exp_rows"][1]), POST_LIMITS[1]
    sa, sb = post_dp["port_state"](), post_dp["port_state"]()
    a = single(sa, tadam.init(sa.trainable_dict()), post_dp["tb"][1], *args,
               exp_row, limit, 7, t_(post_dp["bg"]), 2.0, 1)
    b = dp(sb, tadam.init(sb.trainable_dict()), [post_dp["tb"][1]], *args,
           [exp_row], [limit], 7, t_(post_dp["bg"]), 2.0, 1)
    for f in PARAMS:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    for k in a.opt.mu:
        assert torch.equal(a.opt.mu[k], b.opt.mu[k]), k
    assert float(a.photo_loss) == float(b.photo_loss)
    assert int(a.cut_size) == int(b.cut_size)
    assert int(a.n_visible) == int(b.n_visible)


# ---------------------------------------------------------------- loops ---

@pytest.fixture(scope="module")
def toy_path(tmp_path_factory):
    """The toy scene of tests/test_dp_loop.py."""
    path = str(tmp_path_factory.mktemp("dp_toy"))
    write_colmap_scene(path, *make_gaussian_scene(n=80, seed=3),
                       ring_cameras(n_cams=8), test_every=0)
    return path


def flat_cfg(path, model_path, iters, **runtime) -> FullConfig:
    """tests/test_dp_loop.py's configuration, in the port."""
    return FullConfig(
        model=ModelConfig(source_path=path, model_path=model_path,
                          resolution=1),
        opt=OptimizationConfig(iterations=iters, densify_from_iter=10**9,
                               densify_until_iter=0,
                               opacity_reset_interval=10**9,
                               position_lr_max_steps=iters),
        runtime=RuntimeConfig(capacity_factor=2.0, **runtime))


def test_train_single_views_per_step(toy_path, tmp_path, monkeypatch):
    """``cli/train_single --views_per_step 4 --device cpu``: the loop runs
    the dp step on four views a step (16 views for 4 iterations), the
    loss stays finite, the run saves its point cloud."""
    from h3dgs_tpu_torch.cli import train_single

    seen = []
    orig = tpar.make_dp_train_step

    def spy(*a, **kw):
        step = orig(*a, **kw)

        def wrapped(state, opt, exp, exp_opt, batch, *rest):
            seen.append(len(batch))
            return step(state, opt, exp, exp_opt, batch, *rest)
        return wrapped

    monkeypatch.setattr(tpar, "make_dp_train_step", spy)
    out = str(tmp_path / "out")
    train_single.main(["-s", toy_path, "-m", out, "-r", "1",
                       "--iterations", "4", "--views_per_step", "4",
                       "--disable_viewer", "--device", "cpu"])
    assert seen == [4] * 4
    assert os.path.exists(os.path.join(out, "point_cloud", "iteration_4",
                                       "point_cloud.ply"))


def test_views_per_step_divisibility(toy_path, tmp_path):
    """The JAX loop's ValueErrors: views_per_step a multiple of
    data_devices, and data_devices the size of the process group."""
    cfg = flat_cfg(toy_path, str(tmp_path / "bad"), 1, data_devices=4,
                   views_per_step=6)
    with pytest.raises(ValueError, match="multiple of data_devices"):
        tloop.dp_setup(cfg)
    cfg = flat_cfg(toy_path, str(tmp_path / "bad"), 1, data_devices=2,
                   views_per_step=4)
    with pytest.raises(ValueError, match="size of the process group"):
        tloop.dp_setup(cfg)
    dp = tloop.dp_setup(flat_cfg(toy_path, "", 1, views_per_step=3))
    assert dp.local_views == 3 and dp.keep_fn is None
    dp = tloop.dp_setup(flat_cfg(toy_path, "", 1))
    assert dp.views_per_step == 1 and dp.local_views == 1


def test_keep_fn_partitions_windows(monkeypatch):
    """The per-process keep_fn partitions every views_per_step window:
    across processes the loaded views are the shared-seed sequence, with
    no overlap, across epoch reshuffles too (tests/test_multihost.py)."""
    n_views, v, n_proc = 7, 4, 2
    local = v // n_proc
    monkeypatch.setattr(tloader, "_decode",
                        lambda info, res, tte, idx, pin: idx)
    loaded = {}
    for p in range(n_proc):
        keep = (lambda pos, _p=p: (pos % v) // local == _p)
        vs = tloader.ViewStream([None] * n_views, "cpu", num_workers=1,
                                prefetch=1, seed=0, keep_fn=keep)
        loaded[p] = [next(vs) for _ in range(8)]     # 4 windows
        vs.close()
    vs = tloader.ViewStream([None] * n_views, "cpu", num_workers=1,
                            prefetch=1, seed=0)
    seq = [next(vs) for _ in range(4 * v)]
    vs.close()
    for w in range(4):
        window = seq[w * v:(w + 1) * v]
        assert loaded[0][w * local:(w + 1) * local] == window[:local]
        assert loaded[1][w * local:(w + 1) * local] == window[local:]


def test_train_post_views_per_step(chunk, tmp_path,  # noqa: F811
                                   monkeypatch):
    """``cli/train_post --views_per_step 2 --device cpu`` on a chunk with
    a hierarchy: two views a step, each with its own limit (drawn from
    the shared generator) and exposure row; anchors and skybox rows bit
    for bit unchanged; ``<hier>_opt`` written."""
    from h3dgs_tpu_torch.cli import hierarchy_creator, train_post
    from h3dgs_tpu_torch.hierarchy import io as thio

    out = str(tmp_path / "post")
    hier = hierarchy_creator.create_hierarchy(
        chunk["ply"], chunk["root"], out, chunk["scaffold"])
    seen = []
    orig = tpar.make_dp_post_step

    def spy(*a, **kw):
        step = orig(*a, **kw)

        def wrapped(state, opt, batch, nodes, boxes, amask, exp_rows,
                    limits, *rest):
            o = step(state, opt, batch, nodes, boxes, amask, exp_rows,
                     limits, *rest)
            seen.append((state, o.state, [float(x) for x in limits],
                         amask))
            return o
        return wrapped

    monkeypatch.setattr(tpar, "make_dp_post_step", spy)
    train_post.main(["-s", chunk["root"], "-m", out, "--hierarchy", hier,
                     "--scaffold_file", chunk["scaffold"], "--skybox_locked",
                     "--iterations", "3", "--views_per_step", "2",
                     "--device", "cpu"])
    assert len(seen) == 3
    gen = torch.Generator()
    gen.manual_seed(0)
    want = [float(tpost.sample_limit(gen)) for _ in range(6)]
    assert [x for s in seen for x in s[2]] == want
    first, last, amask = seen[0][0], seen[-1][1], seen[0][3]
    lock = np_(amask) | np_(first.locked_rows_mask())
    for f in PARAMS:
        a, b = np_(getattr(first, f)), np_(getattr(last, f))
        np.testing.assert_array_equal(a[lock], b[lock], f)
    thio.read_hier(hier + "_opt").validate()


# -------------------------------------------------- two gloo processes ---

ITERS = 4


def _free_port():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def test_two_processes_match_one(toy_path, tmp_path):
    """Two gloo processes over local TCP (``data_devices=2``,
    ``views_per_step=4``), each a port-only child with two threads, end
    ``train_flat`` with the parameters of one process with
    ``views_per_step=4``: the same views in the same windows, the
    gradients all-reduced instead of summed in one process."""
    port = _free_port()
    out = str(tmp_path / "mh_result.pt")
    env = dict(os.environ, OMP_NUM_THREADS="2")
    env.pop("PYTEST_CURRENT_TEST", None)
    worker = os.path.join(REPO, "tests", "torch_dp_worker.py")
    procs = [subprocess.Popen(
        [sys.executable, worker, "--scene", toy_path, "--out", out,
         "--pid", str(pid), "--nproc", "2", "--port", str(port),
         "--iters", str(ITERS), "--views_per_step", "4"],
        env=env, cwd=REPO, stdout=subprocess.PIPE,
        stderr=subprocess.STDOUT, text=True) for pid in range(2)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=240)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for pid, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {pid} failed:\n{o[-3000:]}"
    assert "saved" in outs[0] and "saved" not in outs[1]

    cfg = flat_cfg(toy_path, str(tmp_path / "one"), ITERS, views_per_step=4)
    from h3dgs_tpu_torch.scene.scene import Scene
    scene = Scene(cfg.model, cfg.runtime, device="cpu")
    state, exposure = tloop.train_flat(cfg, scene)
    got = torch.load(out, weights_only=True)
    for f in ("xyz", "opacity", "scaling", "features_dc"):
        np.testing.assert_allclose(np_(got[f]), np_(getattr(state, f)),
                                   rtol=RTOL, atol=ATOL, err_msg=f)
    np.testing.assert_allclose(np_(got["exposure"]), np_(exposure),
                               rtol=RTOL, atol=ATOL)
    assert np.abs(np_(got["xyz"]) - np_(scene.state.xyz)).max() > 0


def test_dp_flat_config_fields():
    """``views_per_step`` is a RuntimeConfig field (so ``--views_per_step``
    is a flag of every training CLI), with the JAX default."""
    names = {f.name: f.default for f in dataclasses.fields(RuntimeConfig)}
    assert names["views_per_step"] == 0 and names["data_devices"] == 1


# ------------------------------------------------- rows below the mark ---

PREFIX_CAP = 320


def _prefix_store(last_row_alive: bool, n: int = 48, seed: int = 11):
    """A flat store of ``PREFIX_CAP`` rows: 4 locked skybox rows and 4
    scaffold rows first, a hole of dead rows among the live ones (rows
    20-23 and 32-95), live rows up to row 111, dead rows above; the dead
    rows, Adam's moments and the statistics hold noise that a step must
    leave as it is. With ``last_row_alive`` the last row holds a copy of
    row 10, so the mark is the capacity. Returns (state, opt, exposure,
    exposure opt, four views)."""
    means, scales, quats, opac, shs = random_scene(n, seed, sh_degree=1,
                                                   spread=0.8)
    opac[40:44] = 0.003  # pruned by the densify pass (min_opacity 0.005)
    feats = np.zeros((n, 16, 3), np.float32)
    feats[:, :4] = shs
    st = tstate.from_arrays(
        means, feats[:, :1], feats[:, 1:],
        np.log(opac / (1 - opac))[:, None], np.log(scales), quats,
        capacity=PREFIX_CAP, max_sh_degree=1, n_skybox=4, n_scaffold=4,
        device="cpu")
    g = torch.Generator().manual_seed(seed)
    src, dst = torch.arange(32, 48), torch.arange(96, 112)
    fields = {}
    for k in tstate.ALL_FIELDS:
        t = getattr(st, k).clone()
        if k != "alive":
            noise = torch.randn(t.shape, generator=g)
            if k == "denom":
                noise = noise.abs().round()
            t = torch.where(st.alive.reshape((-1,) + (1,) * (t.dim() - 1)),
                            t, noise)
        t[dst] = t[src]
        t[src] = False if k == "alive" else t[src + 200]
        if last_row_alive:
            t[-1] = t[10]
        fields[k] = t
    fields["alive"][20:24] = False
    st = dataclasses.replace(st, **fields)
    opt = tadam.init(st.trainable_dict())
    opt = tadam.AdamState(
        mu={k: 0.01 * torch.randn(v.shape, generator=g)
            for k, v in opt.mu.items()},
        nu={k: 1e-4 * torch.rand(v.shape, generator=g)
            for k, v in opt.nu.items()},
        step=torch.tensor(3, dtype=torch.int32))
    n_views, h, w = 4, 32, 32
    rng = np.random.default_rng(seed)
    exposure = torch.eye(3, 4).repeat(n_views, 1, 1) + t_(
        rng.uniform(-0.02, 0.02, (n_views, 3, 4)).astype(np.float32))
    alpha = np.ones((1, h, w), np.float32)
    alpha[:, :2] = 0.0
    views = []
    for i, a in enumerate(np.linspace(0, np.pi, n_views, endpoint=False)):
        cam = camera_pair((3 * np.sin(a), -0.4, -3 * np.cos(a)), fovx=1.1,
                          width=w, height=h)[1]
        views.append(tviews.ViewBatch(
            camera=cam, gt_image=t_(rng.random((3, h, w)) * alpha),
            alpha_mask=t_(alpha), invdepth=t_(0.3 * rng.random((1, h, w))),
            depth_mask=t_(alpha), depth_reliable=torch.tensor(True),
            image_idx=torch.tensor(i)))
    return st, opt, exposure, tadam.init({"exposure": exposure}), views


def _prefix_trajectory(views_per_step: int, coarse: bool,
                       last_row_alive: bool):
    """Seven dp steps with a densify pass that clones, splits, prunes
    and fills holes, a capacity growth and an opacity reset between them.
    Returns every step's outputs and the mark each step ran on."""
    st, opt, exposure, exp_opt, views = _prefix_store(last_row_alive)
    kw = (dict(use_depth_loss=False, use_exposure=False, freeze_xyz=True,
               shrink_threshold=0.1) if coarse else {})
    step = tpar.make_dp_train_step(OptimizationConfig(iterations=100),
                                   TRasterCfg(), skybox_locked=True, **kw)
    gen = torch.Generator().manual_seed(0)
    bg = torch.full((3,), 0.5)
    outs, marks = [], []
    for it in range(1, 8):
        batch = [views[(it * views_per_step + j) % len(views)]
                 for j in range(views_per_step)]
        marks.append(st.high_water)
        out = step(st, opt, exposure, exp_opt, batch, it, bg, 2.0, 3.0, 1)
        outs.append(out)
        st, opt, exposure, exp_opt = (out.state, out.opt, out.exposure,
                                      out.exposure_opt)
        if it == 2:
            st, opt, counts = tstep.densify_step(st, opt, gen, 1e-9, 0.005,
                                                 3.0, 0.03)
            assert all(int(c) > 0 for c in counts[:3]), counts
        elif it == 4:
            st = tstate.grow_capacity(st, PREFIX_CAP + 128)
            opt = tadam.grow_rows(opt, PREFIX_CAP + 128)
        elif it == 5:
            st, opt = tstep.reset_opacity_step(st, opt)
    return outs, marks


def _assert_outputs_equal(a, b):
    for f in tstate.ALL_FIELDS:
        assert torch.equal(getattr(a.state, f), getattr(b.state, f)), f
    for o, p in ((a.opt, b.opt), (a.exposure_opt, b.exposure_opt)):
        assert o.mu.keys() == p.mu.keys()
        for k in o.mu:
            assert torch.equal(o.mu[k], p.mu[k]), k
            assert torch.equal(o.nu[k], p.nu[k]), k
        assert torch.equal(o.step, p.step)
    for f in ("exposure", "photo_loss", "depth_loss", "n_visible",
              "n_duplicates"):
        assert torch.equal(getattr(a, f), getattr(b, f)), f


@pytest.mark.parametrize("views_per_step,coarse,last_row_alive", [
    (1, False, False), (2, False, False), (1, True, False),
    (1, False, True)], ids=["one_view", "two_views", "coarse",
                            "last_row_alive"])
def test_prefix_step_matches_full_capacity(views_per_step, coarse,
                                           last_row_alive, monkeypatch):
    """The dp step on the rows below the mark equals the step on every
    capacity row (the mark forced to the capacity) bit for bit, over
    seven steps across a densify pass with holes, a capacity growth and
    an opacity reset: every leaf, ``alive``, the statistics, both
    optimizers, the exposure, the losses and the counts."""
    got, marks = _prefix_trajectory(views_per_step, coarse, last_row_alive)
    with monkeypatch.context() as m:
        m.setattr(tstate.GaussianState, "high_water",
                  property(lambda s: s.capacity))
        want, full = _prefix_trajectory(views_per_step, coarse,
                                        last_row_alive)
    caps = [PREFIX_CAP] * 4 + [PREFIX_CAP + 128] * 3
    assert full == caps
    if last_row_alive:  # the mark is the capacity until the growth
        assert marks == [PREFIX_CAP] * 7
    else:
        assert marks[0] == 128 and all(m < c for m, c in zip(marks, caps))
    for a, b in zip(got, want):
        _assert_outputs_equal(a, b)
    assert a.state.capacity == PREFIX_CAP + 128


def _assert_mark_fits(st):
    """The cached mark is the one computed afresh: every live row lies
    below it, and a live row lies in its last block of rows."""
    mark = st.high_water
    assert mark == tstate.high_water_mark(st.alive)
    assert not bool(st.alive[mark:].any())
    live = torch.nonzero(st.alive)[:, 0]
    assert mark == min(st.capacity, -(-(int(live[-1]) + 1)
                                      // tstate.ROW_GRAIN) * tstate.ROW_GRAIN)


@pytest.mark.parametrize("op", ["from_arrays", "grow_capacity",
                                "densify_and_prune", "reset_opacity",
                                "checkpoint", "in_place"])
def test_mark_follows_alive(op, tmp_path):
    """Whatever writes ``alive`` (a new store, a growth, a densify pass,
    an opacity reset, a checkpoint loaded into another store, an in-place
    write), the mark read afterwards is never stale."""
    st, opt, exposure, exp_opt, _ = _prefix_store(False)
    assert st.high_water == 128
    if op == "from_arrays":
        means, scales, quats, opac, shs = random_scene(150, 3)
        st = tstate.from_arrays(
            means, shs[:, :1], shs[:, 1:], np.log(opac / (1 - opac))[:, None],
            np.log(scales), quats, capacity=PREFIX_CAP, max_sh_degree=1,
            device="cpu")
        assert st.high_water == 192
        # The skybox lock of a skybox_last store addresses its last rows.
        sky_last = tstate.from_arrays(
            means, shs[:, :1], shs[:, 1:], np.log(opac / (1 - opac))[:, None],
            np.log(scales), quats, capacity=PREFIX_CAP, max_sh_degree=1,
            device="cpu", n_skybox=4, skybox_last=True)
        assert sky_last.high_water == PREFIX_CAP
    elif op == "grow_capacity":
        st = tstate.grow_capacity(st, PREFIX_CAP + 128)
        assert st.high_water == 128
    elif op == "densify_and_prune":
        res = tdens.densify_and_prune(st, torch.Generator().manual_seed(0),
                                      1e-9, 0.005, 3.0, 0.03)
        assert not torch.equal(res.state.alive, st.alive)
        st = res.state
    elif op == "reset_opacity":
        st = tdens.reset_opacity(st)
    elif op == "checkpoint":
        path = str(tmp_path / "chkpnt.npz")
        tckpt.save_flat(path, st, opt, exposure, exp_opt, 5)
        other = _prefix_store(True)[0]
        assert other.high_water == PREFIX_CAP
        st = tckpt.load_flat(path, other)[0]
        assert st.high_water == 128
    else:
        st.alive[300] = True
        assert st.high_water == PREFIX_CAP
        st.alive[256:].fill_(False)
        assert st.high_water == 128
    _assert_mark_fits(st)


def test_mark_read_only_after_alive_changes(monkeypatch):
    """Ordinary steps compute no mark: the first step reads it once, the
    next three none, and the step after a densify pass once more."""
    calls = []
    compute = tstate.high_water_mark

    def counted(alive):
        calls.append(alive.shape[0])
        return compute(alive)

    monkeypatch.setattr(tstate, "high_water_mark", counted)
    st, opt, exposure, exp_opt, views = _prefix_store(False)
    step = tpar.make_dp_train_step(OptimizationConfig(iterations=100),
                                   TRasterCfg())
    bg = torch.zeros(3)

    def run(it):
        out = step(st, opt, exposure, exp_opt, [views[it % 4]], it, bg, 2.0,
                   3.0, 1)
        return out.state, out.opt, out.exposure, out.exposure_opt

    st, opt, exposure, exp_opt = run(1)
    assert len(calls) == 1
    for it in range(2, 5):
        st, opt, exposure, exp_opt = run(it)
    assert len(calls) == 1
    st, opt, _ = tstep.densify_step(st, opt, torch.Generator().manual_seed(0),
                                    1e-9, 0.005, 3.0, 0.03)
    st, opt, exposure, exp_opt = run(5)
    st, opt, exposure, exp_opt = run(6)
    assert len(calls) == 2
