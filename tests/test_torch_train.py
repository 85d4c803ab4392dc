"""Parity of the port's training slice with the JAX package (XLA blend
path), on the same seeded numpy inputs: the blend backward (K2's plain
version) against ``jax.vjp`` of ``blend_tiles``, rasterize gradients,
masked sparse Adam, densification, model init, one full train step and a
5-step trajectory. Tolerances are stated per test."""
from __future__ import annotations

import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h3dgs_tpu.config import OptimizationConfig as JOptCfg
from h3dgs_tpu.io.ply import write_gaussian_ply
from h3dgs_tpu.model import densify as jdens
from h3dgs_tpu.model import init as jinit
from h3dgs_tpu.model import state as jstate
from h3dgs_tpu.ops import adam as jadam
from h3dgs_tpu.ops import binning as jbin
from h3dgs_tpu.ops import projection as jproj
from h3dgs_tpu.ops import rasterize as jras
from h3dgs_tpu.train import step as jstep
from h3dgs_tpu_torch.config import OptimizationConfig as TOptCfg
from h3dgs_tpu_torch.model import densify as tdens
from h3dgs_tpu_torch.model import init as tinit
from h3dgs_tpu_torch.model import state as tstate
from h3dgs_tpu_torch.ops import adam as tadam
from h3dgs_tpu_torch.ops import binning as tbin
from h3dgs_tpu_torch.ops import blend as tblend
from h3dgs_tpu_torch.ops import projection as tproj
from h3dgs_tpu_torch.ops import rasterize as tras
from h3dgs_tpu_torch.scene import views as tviews
from h3dgs_tpu_torch.train import step as tstep

from .synthetic_scene import make_gaussian_scene, ring_cameras
from .test_torch_common import camera_pair, np_, scene_tensors, t_
from .utils import random_scene

torch.set_num_threads(2)

# The XLA path's caps; parity scenes stay inside both (hazard H4).
XCFG = jras.RasterizeConfig(max_entries=1 << 15, max_per_tile=1024,
                            chunk=32, backend="xla")
STATE_FIELDS = tstate.ALL_FIELDS


def _grad_near(got, want, rel=1e-4, what=""):
    """|got - want| <= rel * max|want| everywhere (float32 sums in another
    order; the XLA path's transmittance is a log-space cumsum, the port's
    a cumprod)."""
    got = np_(got).astype(np.float64)
    want = np.asarray(want, np.float64)
    assert got.shape == want.shape, (what, got.shape, want.shape)
    scale = np.abs(want).max()
    err = np.abs(got - want).max()
    assert np.isfinite(got).all() and err <= rel * scale + 1e-12, (
        what, err, scale)


def _jstate_arrays(st) -> dict:
    return {f: np.array(getattr(st, f)) for f in STATE_FIELDS}


def _static(st) -> dict:
    return dict(max_sh_degree=st.max_sh_degree, opacity_abs=st.opacity_abs,
                n_skybox=st.n_skybox, n_scaffold=st.n_scaffold,
                skybox_last=st.skybox_last)


def _tstate_of(st) -> tstate.GaussianState:
    return tstate.state_from_jax_arrays(_jstate_arrays(st), device="cpu",
                                        **_static(st))


def _assert_state_close(ts, js, rtol=1e-6, atol=1e-7, fields=STATE_FIELDS):
    for f in fields:
        np.testing.assert_allclose(np_(getattr(ts, f)),
                                   np.asarray(getattr(js, f)), rtol=rtol,
                                   atol=atol, err_msg=f)


# ------------------------------------------------------- blend backward ---

def test_blend_backward_plain_matches_jax_vjp():
    """A scene whose pixels terminate and whose opaque splats hit the 0.99
    clamp; cotangents on image (with a background), inverse depth and
    final T. Gradients within 1e-4 of their max."""
    means, scales, quats, opac, shs = random_scene(
        250, 3, sh_degree=1, spread=0.5, opacity_lo=0.9, opacity_hi=1.0,
        scale_lo=0.08, scale_hi=0.3)
    h, w = 52, 72
    jc, _ = camera_pair((0.1, -0.1, -3.0), fovx=1.0, width=w, height=h)
    jp = jproj.project_gaussians(means, scales, quats, opac, shs, jc, 1)
    jb = jbin.bin_gaussians(jp, h, w, XCFG.max_entries)
    assert int(np.asarray(jb.tile_count).max()) < XCFG.max_per_tile
    bg = jnp.asarray([0.3, 0.1, 0.2], jnp.float32)
    rng = np.random.default_rng(0)
    g_img = rng.normal(size=(3, h, w)).astype(np.float32)
    g_invd = rng.normal(size=(1, h, w)).astype(np.float32)
    g_t = rng.normal(size=(h, w)).astype(np.float32)

    def f(m2, con, rgb, op, depth):
        p = jp._replace(means2d=m2, conic=con, rgb=rgb, opacity=op,
                        depth=depth)
        return jras.blend_tiles(p, jb, h, w, bg, XCFG)

    (img, _, final_t), vjp = jax.vjp(f, jp.means2d, jp.conic, jp.rgb,
                                     jp.opacity, jp.depth)
    assert (np.asarray(final_t) < 1e-3).mean() > 0.05      # terminates
    jg = vjp((jnp.asarray(g_img), jnp.asarray(g_invd), jnp.asarray(g_t)))

    tp = tproj.ProjectedGaussians(*(t_(x) for x in jp))
    tb = tbin.bin_gaussians(tp, h, w)
    inv_depth = 1.0 / torch.clamp_min(tp.depth, 1e-6)
    args = (tp.means2d, tp.conic, tp.rgb, tp.opacity, inv_depth,
            tb.gauss_idx, tb.tile_start, tb.tile_count)
    color, invd, trans, _ = tblend.blend_plain(*args, h, w)
    # The background reaches final T outside the blend.
    g_t_all = t_(g_t) + (t_(g_img) * t_(np.asarray(bg))[:, None, None]).sum(0)
    got = tblend.blend_backward_plain(*args, color, invd, trans, t_(g_img),
                                      t_(g_invd), g_t_all, h, w)
    d_depth = got[4] * (-1.0 / tp.depth ** 2)
    clamped = float(np.asarray(jp.opacity).max()) > 0.99
    assert clamped
    for name, g, want in zip(("means2d", "conic", "rgb", "opacity", "depth"),
                             got[:4] + (d_depth,), jg):
        _grad_near(g, want, 1e-4, name)
    # H8: the rows with a nonzero opacity gradient are the same, except
    # rows whose gradient is below 1e-12 in both.
    tz = np_(got[3]) != 0
    jz = np.asarray(jg[3]) != 0
    tiny = (np.abs(np_(got[3])) < 1e-12) & (np.abs(np.asarray(jg[3])) < 1e-12)
    assert ((tz == jz) | tiny).all()


def test_rasterize_gradients_all_inputs():
    """Gradients of a fixed linear functional of render / invdepth /
    final T with respect to all six rasterize inputs, against jax.grad of
    the JAX rasterizer: within 2e-4 of each gradient's max."""
    means, scales, quats, opac, shs = random_scene(200, 5, sh_degree=2,
                                                   spread=1.0)
    h, w = 60, 80
    jc, tc = camera_pair((0.3, -0.2, -3.0), fovx=1.0, width=w, height=h)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    rng = np.random.default_rng(1)
    gi = rng.normal(size=(3, h, w)).astype(np.float32)
    gd = rng.normal(size=(1, h, w)).astype(np.float32)
    gt = rng.normal(size=(h, w)).astype(np.float32)
    off = np.zeros((200, 2), np.float32)

    def jloss(m, s, q, o, sh, of):
        out = jras.rasterize(m, s, q, o, sh, jc, 2, jnp.asarray(bg),
                             means2d_offset=of, config=XCFG)
        return (jnp.sum(out["render"] * gi) + jnp.sum(out["invdepth"] * gd)
                + jnp.sum(out["final_transmittance"] * gt))

    jg = jax.grad(jloss, argnums=tuple(range(6)))(means, scales, quats,
                                                  opac, shs, off)
    ts = [x.requires_grad_(True) for x in
          scene_tensors(means, scales, quats, opac, shs) + (t_(off),)]
    out = tras.rasterize(*ts[:5], tc, 2, t_(bg), means2d_offset=ts[5])
    loss = ((out["render"] * t_(gi)).sum() + (out["invdepth"] * t_(gd)).sum()
            + (out["final_transmittance"] * t_(gt)).sum())
    loss.backward()
    for name, t, want in zip(("means3d", "scales", "quats", "opacities",
                              "shs", "means2d_offset"), ts, jg):
        assert float(t.grad.abs().max()) > 0, name
        _grad_near(t.grad, want, 2e-4, name)


# ------------------------------------------------------------------ adam ---

def test_sparse_adam_reset_and_grow():
    """Two masked steps, a row reset and a tail-preserving grow: float32
    elementwise, within 1e-6 relative."""
    rng = np.random.default_rng(2)
    c = 16
    params = {"xyz": rng.normal(size=(c, 3)).astype(np.float32),
              "opacity": rng.normal(size=(c, 1)).astype(np.float32)}
    lrs = {"xyz": 0.01, "opacity": 0.05}
    jp_ = {k: jnp.asarray(v) for k, v in params.items()}
    tp_ = {k: t_(v) for k, v in params.items()}
    jo, to = jadam.init(jp_), tadam.init(tp_)
    for i in range(2):
        g = {k: rng.normal(size=v.shape).astype(np.float32)
             for k, v in params.items()}
        mask = rng.random(c) < 0.6
        jp_, jo = jadam.sparse_adam_update(
            jp_, {k: jnp.asarray(v) for k, v in g.items()}, jo,
            {k: jnp.float32(v) for k, v in lrs.items()}, jnp.asarray(mask))
        tp_, to = tadam.sparse_adam_update(
            tp_, {k: t_(v) for k, v in g.items()}, to, lrs, t_(mask))
    assert int(to.step) == int(jo.step) == 2
    for k in params:
        for a, b in ((tp_[k], jp_[k]), (to.mu[k], jo.mu[k]),
                     (to.nu[k], jo.nu[k])):
            np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-6,
                                       atol=1e-8, err_msg=k)
    rows = rng.random(c) < 0.3
    jr = jadam.reset_rows(jo, jnp.asarray(rows), keys=["opacity"])
    tr = tadam.reset_rows(to, t_(rows), keys=["opacity"])
    jg_ = jadam.grow_rows(jr, 24, tail_rows=3)
    tg_ = tadam.grow_rows(tr, 24, tail_rows=3)
    for k in params:
        np.testing.assert_array_equal(np_(tg_.mu[k]), np.asarray(jg_.mu[k]))
        np.testing.assert_array_equal(np_(tg_.nu[k]), np.asarray(jg_.nu[k]))


# ------------------------------------------------------------- densify ---

def _stats_state(seed=4, n=40, capacity=64, **static):
    rng = np.random.default_rng(seed)
    st = jstate.from_arrays(
        rng.normal(size=(n, 3)), rng.normal(size=(n, 1, 3)),
        rng.normal(size=(n, 15, 3)), rng.normal(-1.0, 3.0, size=(n, 1)),
        rng.uniform(-5, -1, size=(n, 3)), rng.normal(size=(n, 4)),
        capacity=capacity, **static)
    return dataclasses.replace(
        st,
        xyz_gradient_accum=jnp.asarray(
            rng.uniform(0, 0.01, capacity).astype(np.float32)),
        max_radii2d=jnp.asarray(
            rng.uniform(0, 30, capacity).astype(np.float32)),
        denom=jnp.asarray(rng.integers(0, 5, capacity).astype(np.float32)))


@pytest.mark.parametrize("capacity", [120, 52])    # 52: slots run out
def test_densify_prune_reset_shrink(capacity):
    """With the JAX noise injected: slots, alive and counts exact, values
    within float32 rounding."""
    st = _stats_state(capacity=capacity, n_skybox=2, n_scaffold=5)
    key = jax.random.PRNGKey(7)
    eps = jax.random.normal(key, (2, capacity, 3), jnp.float32)
    args = (0.002, 0.005, 2.0, 0.02)
    jr = jdens.densify_and_prune(st, key, *args)
    ts = _tstate_of(st)
    tr = tdens.densify_and_prune(ts, None, *args, eps=t_(eps))
    for f in ("n_cloned", "n_split", "n_pruned", "n_dropped"):
        assert int(getattr(tr, f)) == int(getattr(jr, f)), f
    assert int(jr.n_cloned) + int(jr.n_split) > 0 and int(jr.n_pruned) > 0
    assert (int(jr.n_dropped) > 0) == (capacity == 52)
    np.testing.assert_array_equal(np_(tr.touched_rows),
                                  np.asarray(jr.touched_rows))
    _assert_state_close(tr.state, jr.state, rtol=1e-5, atol=1e-6)

    jo = jdens.reset_opacity(jr.state)
    to = tdens.reset_opacity(tr.state)
    np.testing.assert_allclose(np_(to.opacity), np.asarray(jo.opacity),
                               rtol=1e-5, atol=1e-6)
    js = jdens.shrink_big_gaussians(jo, 3.0, 0.02)
    tsh = tdens.shrink_big_gaussians(to, 3.0, 0.02)
    np.testing.assert_allclose(np_(tsh.scaling), np.asarray(js.scaling),
                               rtol=1e-6, atol=1e-6)

    # Capacity growth keeps every row (skybox-last: tail stays last).
    jl = _stats_state(capacity=capacity, n_skybox=3, skybox_last=True)
    _assert_state_close(tstate.grow_capacity(_tstate_of(jl), capacity + 16),
                        jstate.grow_capacity(jl, capacity + 16), rtol=0,
                        atol=0)


# ---------------------------------------------------------------- init ---

def test_init_from_pcd_skybox_and_scaffold(tmp_path):
    rng = np.random.default_rng(8)
    pts = rng.normal(size=(120, 3)).astype(np.float32)
    rgb = rng.random((120, 3)).astype(np.float32)
    kw = dict(capacity_factor=2.0, max_sh_degree=3, seed=3)
    js = jinit.init_from_pcd(pts, rgb, skybox_points=30, **kw)
    ts = tinit.init_from_pcd(pts, rgb, skybox_points=30, device="cpu", **kw)
    assert _static(ts) == _static(js) and ts.capacity == js.capacity
    _assert_state_close(ts, js, rtol=1e-6, atol=1e-6)
    np.testing.assert_allclose(tstate.default_opacity_init(5, 0.02),
                               jstate.default_opacity_init(5, 0.02),
                               rtol=1e-6)

    # A scaffold: its skybox rows plus the ring 0.5-1.5 extents around the
    # chunk center, prepended.
    n_sc, n_sky = 60, 6
    sc = rng.normal(0.0, 2.0, size=(n_sc, 3)).astype(np.float32)
    write_gaussian_ply(os.path.join(str(tmp_path), "point_cloud.ply"), sc,
                       rng.normal(size=(n_sc, 1, 3)),
                       rng.normal(size=(n_sc, 3, 3)),
                       rng.normal(size=(n_sc, 1)),
                       rng.normal(size=(n_sc, 3)), rng.normal(size=(n_sc, 4)))
    with open(os.path.join(str(tmp_path), "pc_info.txt"), "w") as f:
        f.write(f"{n_sky}\n")
    center = np.zeros(3, np.float32)
    extent = np.full(3, 1.5, np.float32)
    kw = dict(scaffold_dir=str(tmp_path), chunk_center=center,
              chunk_extent=extent, capacity_factor=1.5)
    js = jinit.init_from_pcd(pts, rgb, **kw)
    ts = tinit.init_from_pcd(pts, rgb, device="cpu", **kw)
    assert _static(ts) == _static(js)
    assert n_sky < js.n_scaffold < n_sc
    _assert_state_close(ts, js, rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------- train step ---

def _step_setup(seed=9, n_sky=6):
    """A skybox-first flat state over a random scene, a view with a
    reliable depth map, and both packages' step inputs."""
    means, scales, quats, opac, shs = random_scene(150, seed, sh_degree=1,
                                                   spread=0.8)
    n = means.shape[0]
    feats = np.zeros((n, 16, 3), np.float32)
    feats[:, :4] = shs
    st = jstate.from_arrays(
        means, feats[:, :1], feats[:, 1:],
        np.log(opac / (1 - opac))[:, None], np.log(scales), quats,
        capacity=n + 10, max_sh_degree=1, n_skybox=n_sky, n_scaffold=n_sky)
    h, w = 48, 64
    jc, tc = camera_pair((0.2, -0.3, -3.0), fovx=1.0, width=w, height=h)
    rng = np.random.default_rng(seed)
    gt = rng.random((3, h, w)).astype(np.float32)
    alpha = (rng.random((1, h, w)) > 0.1).astype(np.float32)
    invd = (0.3 * rng.random((1, h, w))).astype(np.float32)
    exposure = np.tile(np.eye(3, 4, dtype=np.float32)[None], (3, 1, 1))
    exposure[1, :, 3] = 0.02
    host = dict(gt_image=gt * alpha, alpha_mask=alpha, invdepth=invd,
                depth_mask=alpha, depth_reliable=np.asarray(True),
                image_idx=np.asarray(1))
    jb = jstep.ViewBatch(camera=jc, **{k: jnp.asarray(v)
                                       for k, v in host.items()})
    tb = tviews.ViewBatch(camera=tc, **{k: t_(v) for k, v in host.items()})
    return st, exposure, jb, tb


def _opt_arrays(o):
    return ({k: np.array(v) for k, v in o.mu.items()},
            {k: np.array(v) for k, v in o.nu.items()}, np.array(o.step))


def test_train_step_matches_jax():
    """One step from the same state, optimizer, exposure and view:
    parameters, moments, exposure and its moments, densification stats
    and the sparse-Adam mask (H8)."""
    st, exposure, jb, tb = _step_setup()
    opt_kw = dict(iterations=100, densify_grad_threshold=1e9)
    j_step = jstep.make_train_step(JOptCfg(**opt_kw), XCFG)
    t_step = tstep.make_train_step(TOptCfg(**opt_kw), tras.RasterizeConfig())
    # Non-zero moments and step going in, so the update is not a first
    # step from zeros.
    rng = np.random.default_rng(10)
    jo = jadam.init(st.trainable_dict())
    jo = jadam.AdamState(
        mu={k: jnp.asarray(0.01 * rng.normal(size=v.shape), jnp.float32)
            for k, v in jo.mu.items()},
        nu={k: jnp.asarray(1e-4 * rng.random(v.shape), jnp.float32)
            for k, v in jo.nu.items()}, step=jnp.int32(3))
    je = jnp.asarray(exposure)
    jeo = jadam.init({"exposure": je})
    t_st = _tstate_of(st)
    # The JAX step donates its inputs: keep host copies first.
    jo_host = _opt_arrays(jo)
    t_o = tstate.adam_from_jax_arrays(*jo_host, device="cpu")
    t_e = t_(exposure)
    t_eo = tstate.adam_from_jax_arrays(*_opt_arrays(jeo), device="cpu")
    before = _jstate_arrays(st)

    bg = np.zeros(3, np.float32)
    jout = j_step(st, jo, je, jeo, jb, jnp.asarray(7.0), jnp.asarray(bg),
                  jnp.asarray(2.0), jnp.asarray(3.0), 1)
    tout = t_step(t_st, t_o, t_e, t_eo, tb, 7, t_(bg), 2.0, 3.0, 1)

    np.testing.assert_allclose(float(tout.photo_loss),
                               float(jout.photo_loss), rtol=1e-5)
    np.testing.assert_allclose(float(tout.depth_loss),
                               float(jout.depth_loss), rtol=1e-5)
    assert float(jout.depth_loss) > 0
    assert int(tout.n_visible) == int(jout.n_visible)
    assert int(tout.n_duplicates) == int(jout.n_duplicates)
    # Adam divides by sqrt(nu): a float32 difference in a tiny gradient
    # moves a parameter by up to ~lr, so parameters are held to 1e-6
    # absolute (the learning rates are <= 0.05).
    _assert_state_close(tout.state, jout.state, rtol=1e-5, atol=2e-6,
                        fields=tstate.TENSOR_FIELDS)
    # Stats: the max screen-gradient norm within 1e-4 of its max.
    _grad_near(tout.state.xyz_gradient_accum,
               jout.state.xyz_gradient_accum, 1e-4, "xyz_gradient_accum")
    for f in ("denom", "max_radii2d"):
        np.testing.assert_array_equal(np_(getattr(tout.state, f)),
                                      np.asarray(getattr(jout.state, f)))
    for k in jout.opt.mu:
        _grad_near(tout.opt.mu[k], jout.opt.mu[k], 1e-4, "mu " + k)
        _grad_near(tout.opt.nu[k], jout.opt.nu[k], 1e-4, "nu " + k)
    assert int(tout.opt.step) == int(jout.opt.step) == 4
    np.testing.assert_allclose(np_(tout.exposure), np.asarray(jout.exposure),
                               rtol=1e-5, atol=1e-6)
    _grad_near(tout.exposure_opt.mu["exposure"],
               jout.exposure_opt.mu["exposure"], 1e-4, "exposure mu")
    # Locked skybox rows are untouched; the update mask agrees (H8).
    for f in ("xyz", "opacity", "scaling"):
        np.testing.assert_array_equal(np_(getattr(tout.state, f))[:6],
                                      before[f][:6])
    t_moved = np_(tout.opt.mu["opacity"])[:, 0] != np_(t_o.mu["opacity"])[:, 0]
    j_moved = (np.asarray(jout.opt.mu["opacity"])[:, 0]
               != jo_host[0]["opacity"][:, 0])
    assert t_moved.sum() > 20
    np.testing.assert_array_equal(t_moved, j_moved)


def test_five_step_trajectory():
    """Five steps over the synthetic ring scene from the same start: the
    photometric loss of every step within 1e-4 relative."""
    from h3dgs_tpu.ops.rasterize import rasterize as jrasterize
    from h3dgs_tpu.utils.sh import rgb_to_sh

    means, scales, quats, opac, shs, _ = make_gaussian_scene(n=50, seed=3)
    cams = ring_cameras(3, width=48, height=40)
    bg = jnp.zeros(3, jnp.float32)
    targets = [np.asarray(jrasterize(means, scales, quats, opac, shs, c, 0,
                                     bg, config=XCFG)["render"])
               for c in cams]
    rng = np.random.default_rng(0)
    n = means.shape[0]
    st = jstate.from_arrays(
        means + rng.normal(0, 0.05, means.shape).astype(np.float32),
        rgb_to_sh(np.full((n, 1, 3), 0.5, np.float32)),
        np.zeros((n, 15, 3), np.float32), np.zeros((n, 1), np.float32),
        np.full((n, 3), np.log(0.12), np.float32),
        np.tile(np.array([1, 0, 0, 0], np.float32), (n, 1)),
        capacity=64, max_sh_degree=0)
    kw = dict(iterations=50, position_lr_init=0.002,
              position_lr_final=0.0002, position_lr_max_steps=50)
    j_step = jstep.make_train_step(JOptCfg(**kw), XCFG,
                                   use_depth_loss=False, skybox_locked=False)
    t_step = tstep.make_train_step(TOptCfg(**kw), tras.RasterizeConfig(),
                                   use_depth_loss=False, skybox_locked=False)
    t_st = _tstate_of(st)
    jo = jadam.init(st.trainable_dict())
    to = tadam.init(t_st.trainable_dict())
    exposure = np.tile(np.eye(3, 4, dtype=np.float32)[None], (3, 1, 1))
    je, te = jnp.asarray(exposure), t_(exposure)
    jeo, teo = jadam.init({"exposure": je}), tadam.init({"exposure": te})
    h, w = 40, 48
    ones = np.ones((1, h, w), np.float32)
    zeros = np.zeros((1, h, w), np.float32)
    _, tcams = zip(*(camera_pair(np.asarray(c.cam_center), fovx=1.1,
                                 width=w, height=h) for c in cams))
    losses = []
    for it in range(1, 6):
        i = it % 3
        host = dict(gt_image=targets[i], alpha_mask=ones, invdepth=zeros,
                    depth_mask=zeros, depth_reliable=np.asarray(False),
                    image_idx=np.asarray(i))
        jout = j_step(st, jo, je, jeo, jstep.ViewBatch(
            camera=cams[i], **{k: jnp.asarray(v) for k, v in host.items()}),
            jnp.asarray(float(it)), bg, jnp.asarray(1.0), jnp.asarray(4.0),
            0)
        tout = t_step(t_st, to, te, teo, tviews.ViewBatch(
            camera=tcams[i], **{k: t_(v) for k, v in host.items()}),
            it, t_(np.zeros(3, np.float32)), 1.0, 4.0, 0)
        st, jo, je, jeo = (jout.state, jout.opt, jout.exposure,
                           jout.exposure_opt)
        t_st, to, te, teo = (tout.state, tout.opt, tout.exposure,
                             tout.exposure_opt)
        losses.append((float(tout.photo_loss), float(jout.photo_loss)))
    for a, b in losses:
        assert abs(a - b) <= 1e-4 * abs(b), losses
    assert losses[-1][1] < losses[0][1] * 1.5
