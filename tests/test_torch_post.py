"""Parity of the port's hierarchy post-training slice with the JAX package,
on the same seeded numpy inputs: the post step (one step and a three-step
trajectory with three granularity limits), anchor / skybox locking,
``sample_limit``, ``create_hierarchy``, ``update_hierarchy_from_state``,
and ``train_post`` through its CLI on the CPU. Tolerances are stated per
test.

Parity scenes keep off the known ties (hazards H4-H6, H9, H10): a grey
background and unsaturated colours, so no pixel sits exactly on a clamp
bound (``jnp.clip`` splits the gradient there, ``torch.clamp`` does not),
and the JAX step's ``max_cut`` is the node count, so it never truncates;
the port's step sizes its cut exactly (the JAX step's padded rows have
opacity 0 and carry no gradient, so the same tolerances hold).
"""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h3dgs_tpu.cli import hierarchy_creator as jcreator
from h3dgs_tpu.config import OptimizationConfig as JOptCfg
from h3dgs_tpu.hierarchy import io as jhio
from h3dgs_tpu.hierarchy import tree as jtree
from h3dgs_tpu.io import meta as jmeta
from h3dgs_tpu.io import ply as jply
from h3dgs_tpu.model import init as jinit
from h3dgs_tpu.ops import adam as jadam
from h3dgs_tpu.ops.rasterize import RasterizeConfig as JRasterCfg
from h3dgs_tpu.ops.rasterize import rasterize as jrasterize
from h3dgs_tpu.train import post_step as jpost
from h3dgs_tpu.train import step as jstep
from h3dgs_tpu_torch.cli import hierarchy_creator as tcreator
from h3dgs_tpu_torch.cli import train_post as tpost_cli
from h3dgs_tpu_torch.config import OptimizationConfig as TOptCfg
from h3dgs_tpu_torch.hierarchy import cut as tcut
from h3dgs_tpu_torch.hierarchy import io as thio
from h3dgs_tpu_torch.model import init as tinit
from h3dgs_tpu_torch.model import state as tstate
from h3dgs_tpu_torch.ops.rasterize import RasterizeConfig as TRasterCfg
from h3dgs_tpu_torch.parallel import step as tpar
from h3dgs_tpu_torch.scene import views as tviews
from h3dgs_tpu_torch.train import post_step as tpost

from .synthetic_scene import make_gaussian_scene, ring_cameras, \
    write_colmap_scene
from .test_torch_common import camera_pair, np_, t_
from .utils import random_scene

torch.set_num_threads(2)

# The XLA blend path with caps the scene stays inside (hazard H4).
JCFG = JRasterCfg(max_entries=1 << 14, max_per_tile=256, chunk=16)
N_LEAVES, N_LOCKED, N_SKY = 60, 5, 3
LIMITS = (0.05, 0.16, 0.3)
PARAMS = ("xyz", "features_dc", "features_rest", "opacity", "scaling",
          "rotation")


def _write_scaffold(path, n_sky, n_ring, seed):
    """A degree-1 scaffold: ``n_sky`` far skybox rows, then ring rows."""
    rng = np.random.default_rng(seed)
    n = n_sky + n_ring
    xyz = np.concatenate([
        np.stack([rng.uniform(-3, 3, n_sky), rng.uniform(-3, 3, n_sky),
                  np.full(n_sky, 30.0)], 1),
        rng.uniform(4.0, 5.0, (n_ring, 3))]).astype(np.float32)
    os.makedirs(path, exist_ok=True)
    jply.write_gaussian_ply(
        os.path.join(path, "point_cloud.ply"), xyz,
        rng.uniform(-0.5, 0.5, (n, 1, 3)).astype(np.float32),
        rng.normal(0, 0.05, (n, 3, 3)).astype(np.float32),
        rng.uniform(-1.0, 1.0, (n, 1)).astype(np.float32),
        np.log(np.concatenate([np.full((n_sky, 3), 4.0),
                               np.full((n_ring, 3), 0.05)])
               ).astype(np.float32),
        np.tile(np.array([1.0, 0, 0, 0], np.float32), (n, 1)))
    jmeta.write_pc_info(os.path.join(path, "pc_info.txt"), n_sky)
    return xyz


def _static(st) -> dict:
    return dict(max_sh_degree=st.max_sh_degree, opacity_abs=st.opacity_abs,
                n_skybox=st.n_skybox, n_scaffold=st.n_scaffold,
                skybox_last=st.skybox_last)


def _arrays(st) -> dict:
    return {f: np.array(getattr(st, f)) for f in tstate.ALL_FIELDS}


def _opt_arrays(o):
    return ({k: np.array(v) for k, v in o.mu.items()},
            {k: np.array(v) for k, v in o.nu.items()}, np.array(o.step))


@pytest.fixture(scope="module")
def trajectory(tmp_path_factory):
    """Three consecutive post steps in both packages from the same state,
    moments, views, limits and iterations. The JAX step is compiled
    once."""
    tmp = str(tmp_path_factory.mktemp("post"))
    means, scales, quats, opac, shs = random_scene(
        N_LEAVES, 0, sh_degree=1, opacity_hi=0.8)
    # Unsaturated colours (H10): DC in [-0.6, 0.6] -> base colour in
    # [0.33, 0.67].
    shs[:, 0] = np.clip(shs[:, 0], -0.6, 0.6)
    locked = np.arange(N_LEAVES) < N_LOCKED
    h = jtree.build_hierarchy(means, shs, opac, np.log(scales), quats,
                              locked_leaf_mask=locked, backend="numpy")
    sc_dir = os.path.join(tmp, "scaffold")
    _write_scaffold(sc_dir, N_SKY, 4, seed=7)
    jst, anchor_mask = jinit.state_from_hierarchy(h, sc_dir,
                                                  max_sh_degree=1)
    tst0, t_anchor = tinit.state_from_hierarchy(h, sc_dir, max_sh_degree=1,
                                                device="cpu")
    np.testing.assert_array_equal(t_anchor, anchor_mask)
    for f in tstate.ALL_FIELDS:
        np.testing.assert_array_equal(np_(getattr(tst0, f)),
                                      np.asarray(getattr(jst, f)), f)
    assert jst.n_skybox == N_SKY and jst.skybox_last and jst.opacity_abs

    cams = [camera_pair((0.3, -0.2, -d), fovx=1.0, width=48, height=32)
            for d in (3.5, 4.5, 4.0)]
    bg = np.full(3, 0.5, np.float32)
    rng = np.random.default_rng(1)
    tgt = shs + rng.normal(0, 0.1, shs.shape).astype(np.float32)
    gts = [np.asarray(jrasterize(means, scales, quats, opac, tgt, jc, 1,
                                 jnp.asarray(bg), config=JCFG)["render"])
           for jc, _ in cams]
    exp_row = np.eye(3, 4, dtype=np.float32)
    exp_row[0, 0], exp_row[1, 3] = 0.95, 0.01

    def batches(i):
        hh, ww = gts[i].shape[1:]
        alpha = np.ones((1, hh, ww), np.float32)
        alpha[:, :3] = 0.0
        host = dict(gt_image=np.clip(gts[i], 0, 1) * alpha,
                    alpha_mask=alpha,
                    invdepth=np.zeros((1, hh, ww), np.float32),
                    depth_mask=np.zeros((1, hh, ww), np.float32),
                    depth_reliable=np.asarray(False),
                    image_idx=np.asarray(0))
        jc, tc = cams[i]
        return (jstep.ViewBatch(camera=jc, **{k: jnp.asarray(v)
                                              for k, v in host.items()}),
                tviews.ViewBatch(camera=tc, **{k: t_(v)
                                               for k, v in host.items()}))

    # Non-zero moments going in, zero on the locked rows (so those must
    # come out bit-identical).
    lock_all = anchor_mask.copy()
    lock_all[-N_SKY:] = True
    jo = jadam.init(jst.trainable_dict())
    rng = np.random.default_rng(2)

    def moments(v, scale, positive):
        a = rng.random(v.shape) if positive else rng.normal(size=v.shape)
        a = (scale * a).astype(np.float32)
        a[lock_all] = 0.0
        return jnp.asarray(a)

    jo = jadam.AdamState(
        mu={k: moments(v, 0.01, False) for k, v in jo.mu.items()},
        nu={k: moments(v, 1e-4, True) for k, v in jo.nu.items()},
        step=jnp.int32(3))
    tst = tstate.state_from_jax_arrays(_arrays(jst), device="cpu",
                                       **_static(jst))
    to = tstate.adam_from_jax_arrays(*_opt_arrays(jo), device="cpu")
    start = dict(state=_arrays(jst), opt=_opt_arrays(jo))

    opt_kw = dict(iterations=60)
    j_step = jpost.make_post_train_step(JOptCfg(**opt_kw), JCFG, h.n_nodes,
                                        skybox_locked=True,
                                        use_exposure=True)
    t_step = tpost.make_post_train_step(TOptCfg(**opt_kw), TRasterCfg(),
                                        skybox_locked=True,
                                        use_exposure=True)
    nodes_j, boxes_j = jnp.asarray(h.nodes), jnp.asarray(h.boxes)
    nodes_t, boxes_t = t_(h.nodes), t_(h.boxes)
    records = []
    for k, limit in enumerate(LIMITS):
        jb, tb = batches(k)
        it = 7 + k
        jout = j_step(jst, jo, jb, nodes_j, boxes_j,
                      jnp.asarray(anchor_mask), jnp.asarray(exp_row),
                      jnp.asarray(limit, jnp.float32),
                      jnp.asarray(float(it)), jnp.asarray(bg),
                      jnp.asarray(2.0), 1)
        tout = t_step(tst, to, tb, nodes_t, boxes_t, t_(anchor_mask),
                      t_(exp_row), limit, it, t_(bg), 2.0, 1)
        jst, jo, tst, to = jout.state, jout.opt, tout.state, tout.opt
        records.append(dict(
            j=dict(state=_arrays(jout.state), opt=_opt_arrays(jout.opt),
                   photo=float(jout.photo_loss),
                   cut=int(jout.cut_size), vis=int(jout.n_visible)),
            t=tout))
    return dict(h=h, start=start, records=records, lock_all=lock_all,
                anchor_mask=anchor_mask)


@pytest.mark.parametrize("n_steps", [1, 3])
def test_post_step_matches_jax(trajectory, n_steps):
    """After one step, and after three consecutive steps with three
    limits: the photometric loss within 1e-5 (x n_steps), every
    parameter and both Adam moments within 1e-5 (x n_steps) of the
    field's largest value, cut size and visible count equal."""
    tol = 1e-5 * n_steps
    for rec in trajectory["records"][:n_steps]:
        assert int(rec["t"].cut_size) == rec["j"]["cut"]
        assert int(rec["t"].n_visible) == rec["j"]["vis"]
        assert rec["j"]["cut"] <= trajectory["h"].n_nodes
        assert abs(float(rec["t"].photo_loss) - rec["j"]["photo"]) <= tol
    rec = trajectory["records"][n_steps - 1]
    cuts = {r["j"]["cut"] for r in trajectory["records"]}
    assert len(cuts) >= 2, cuts               # the limits move the cut
    for f in PARAMS:
        want = rec["j"]["state"][f]
        scale = np.abs(want).max()
        err = np.abs(np_(getattr(rec["t"].state, f)) - want).max()
        assert err <= tol * scale, (f, err, scale)
    j_mu, j_nu, j_count = rec["j"]["opt"]
    assert int(rec["t"].opt.step) == int(j_count) == 3 + n_steps
    for k in j_mu:
        for got, want in ((rec["t"].opt.mu[k], j_mu[k]),
                          (rec["t"].opt.nu[k], j_nu[k])):
            scale = np.abs(want).max()
            assert np.abs(np_(got) - want).max() <= tol * scale, k


def test_post_step_locked_rows_bit_identical(trajectory):
    """Anchor and skybox rows (zero gradients, zero moments, dense Adam
    with eps 1e-15) come out of three steps bit-identical, in both
    packages; the other rows of the cut moved."""
    lock = trajectory["lock_all"]
    assert lock.sum() > N_SKY + N_LOCKED      # anchors above the leaves too
    start = trajectory["start"]["state"]
    last = trajectory["records"][-1]
    for f in PARAMS:
        np.testing.assert_array_equal(
            np_(getattr(last["t"].state, f))[lock], start[f][lock], f)
        np.testing.assert_array_equal(last["j"]["state"][f][lock],
                                      start[f][lock], f)
    moved = np.abs(np_(last["t"].state.features_dc)
                   - start["features_dc"]).reshape(len(lock), -1).max(1)
    assert (moved[~lock] > 0).sum() > N_LEAVES // 2
    for k, v in last["t"].opt.mu.items():
        assert not np_(v)[lock].any(), k


def test_sample_limit_in_range():
    """512 draws lie in [LIMIT_MIN, LIMIT_MAX] and are log-uniform: the
    sorted log2 values stay within 0.08 of the uniform quantiles."""
    assert (tpost.LIMIT_MIN, tpost.LIMIT_MAX) == (jpost.LIMIT_MIN,
                                                  jpost.LIMIT_MAX)
    gen = torch.Generator().manual_seed(0)
    lims = np.array([float(tpost.sample_limit(gen)) for _ in range(512)])
    assert np.all((lims >= 0.005 - 1e-9) & (lims <= 0.1 + 1e-9))
    lo, hi = np.log2(0.005), np.log2(0.1)
    q = (np.sort(np.log2(lims)) - lo) / (hi - lo)
    assert np.abs(q - (np.arange(512) + 0.5) / 512).max() < 0.08


# ------------------------------------------------- files and the CLI ---

@pytest.fixture(scope="module")
def chunk(tmp_path_factory):
    """A tiny trained chunk: COLMAP model and views, a trained
    point_cloud.ply whose first rows are skybox (pc_info.txt), a scaffold
    with the same skybox rows and two of the chunk's own positions, and
    the chunk bounds."""
    root = str(tmp_path_factory.mktemp("chunk"))
    means, scales, quats, opac, shs, rgb = make_gaussian_scene(n=70, seed=4)
    cams = ring_cameras(3, width=48, height=32)
    write_colmap_scene(root, means, scales, quats, opac, shs, rgb, cams)
    sc_dir = os.path.join(root, "scaffold")
    sc_xyz = _write_scaffold(sc_dir, N_SKY, 4, seed=3)
    rng = np.random.default_rng(5)
    n = means.shape[0]
    xyz = np.concatenate([sc_xyz[:N_SKY], means])
    xyz[N_SKY:N_SKY + 2] = sc_xyz[N_SKY:N_SKY + 2]   # scaffold positions
    total = n + N_SKY
    pc_dir = os.path.join(root, "trained", "point_cloud", "iteration_9")
    os.makedirs(pc_dir)
    jply.write_gaussian_ply(
        os.path.join(pc_dir, "point_cloud.ply"), xyz,
        np.concatenate([np.zeros((N_SKY, 1, 3), np.float32), shs]),
        rng.normal(0, 0.03, (total, 15, 3)).astype(np.float32),
        rng.uniform(-1.0, 2.0, (total, 1)).astype(np.float32),
        np.log(np.concatenate([np.full((N_SKY, 3), 4.0, np.float32),
                               scales])),
        np.concatenate([np.tile(np.array([1.0, 0, 0, 0], np.float32),
                                (N_SKY, 1)), quats]))
    jmeta.write_pc_info(os.path.join(pc_dir, "pc_info.txt"), N_SKY)
    jmeta.write_vec(os.path.join(root, "center.txt"), [0.0, 0.0, 0.0])
    jmeta.write_vec(os.path.join(root, "extent.txt"), [1.6, 1.6, 1.6])
    return dict(root=root, scaffold=sc_dir,
                ply=os.path.join(pc_dir, "point_cloud.ply"))


def test_create_hierarchy_matches_jax(chunk, tmp_path, capsys):
    """The same .ply, bounds and scaffold through both packages' creators:
    ``anchors.bin`` byte for byte, and ``hierarchy.hier`` byte for byte
    (both with the numpy tree builder, which the port copies; the C++
    builder merges in another floating-point order), and the same log
    but for the port's line naming the backend that ran."""
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    orig = jtree.build_hierarchy

    def numpy_build(*a, **kw):
        return orig(*a, backend="numpy", **kw)

    jtree.build_hierarchy = numpy_build
    try:
        jcreator.create_hierarchy(chunk["ply"], chunk["root"], jdir,
                                  chunk["scaffold"])
    finally:
        jtree.build_hierarchy = orig
    j_said = capsys.readouterr().out
    tcreator.main([chunk["ply"], chunk["root"], tdir, chunk["scaffold"],
                   "--backend", "numpy"])
    t_said = capsys.readouterr().out.splitlines(keepends=True)
    backend_line = [ln for ln in t_said if "built by the" in ln]
    assert len(backend_line) == 1 and "numpy backend" in backend_line[0]
    t_said.remove(backend_line[0])
    assert "".join(t_said) == j_said.replace(jdir, tdir)
    assert "2 scaffold-position leaves" in j_said
    for name in ("anchors.bin", "hierarchy.hier"):
        with open(os.path.join(jdir, name), "rb") as fj, \
                open(os.path.join(tdir, name), "rb") as ft:
            assert fj.read() == ft.read(), name
    h = thio.read_hier(os.path.join(tdir, "hierarchy.hier"))
    assert h.n_leaves == 70                    # skybox rows excluded
    anchors = thio.read_anchors(os.path.join(tdir, "anchors.bin"))
    np.testing.assert_array_equal(anchors, h.anchors)
    np.testing.assert_array_equal(
        anchors, jhio.read_anchors(os.path.join(tdir, "anchors.bin")))
    assert 0 < anchors.size < h.n_nodes
    with pytest.raises(SystemExit):
        tcreator.main([chunk["ply"]])


def test_update_hierarchy_from_state_equal(trajectory):
    """Rows [0, M) of a trained state written back into the hierarchy:
    every array equal in both packages, alpha = |opacity|."""
    h = trajectory["h"]
    arrays = trajectory["records"][-1]["j"]["state"]
    arrays = dict(arrays, opacity=-np.abs(arrays["opacity"]))
    static = dict(max_sh_degree=1, opacity_abs=True, n_skybox=N_SKY,
                  n_scaffold=0, skybox_last=True)
    tst = tstate.state_from_jax_arrays(arrays, device="cpu", **static)
    from h3dgs_tpu.model import state as jstate_lib
    jst = jstate_lib.GaussianState(
        **{k: jnp.asarray(v) for k, v in arrays.items()}, **static)
    jh = jinit.update_hierarchy_from_state(h, jst)
    th = tinit.update_hierarchy_from_state(h, tst)
    for f in ("xyz", "shs", "alpha", "scaling", "rotation", "nodes",
              "boxes", "anchors"):
        np.testing.assert_array_equal(getattr(th, f),
                                      np.asarray(getattr(jh, f)), f)
    assert (th.alpha >= 0).all() and th.alpha.max() > 0
    th.validate()


def test_train_post_cli_cpu(chunk, tmp_path, monkeypatch):
    """``train_post.main`` for 6 iterations on the CPU over the hierarchy
    the port's creator wrote: no step renders a truncated cut (the rows
    handed to the rasterizer are the cut mask's count, recomputed here,
    plus the skybox), anchors
    and skybox rows stay put, ``<hier>_opt`` reads back and validates in
    both packages, a checkpoint resumes; without CUDA and without
    ``--device`` it raises, and so does view data parallelism."""
    out = str(tmp_path / "post")
    tcreator.create_hierarchy(chunk["ply"], chunk["root"], out,
                              chunk["scaffold"])
    hier = os.path.join(out, "hierarchy.hier")
    jmeta.write_exposure_json(
        os.path.join(out, "exposure.json"),
        {"img_000": np.eye(3, 4, dtype=np.float32) * 0.97})
    seen, splatted = [], []
    orig = tpar.make_dp_post_step
    orig_splat = tpost.splat_cut_gaussians

    def splat_spy(xyz, *a, **kw):
        splatted.append(int(xyz.shape[0]))
        return orig_splat(xyz, *a, **kw)

    def spy(*a, **kw):
        step = orig(*a, **kw)

        def wrapped(state, opt, batch, nodes, boxes, amask, exp_rows,
                    limits, *sa):
            o = step(state, opt, batch, nodes, boxes, amask, exp_rows,
                     limits, *sa)
            (view,), (limit,) = batch, limits
            center = view.camera.cam_center
            in_cut = tcut.cut_mask(nodes, boxes, limit, center)[0]
            seen.append((int(o.cut_size), int(in_cut.sum()), state, o.state,
                         float(o.photo_loss)))
            return o
        return wrapped

    monkeypatch.setattr(tpar, "make_dp_post_step", spy)
    monkeypatch.setattr(tpost, "splat_cut_gaussians", splat_spy)
    argv = ["-s", chunk["root"], "-m", out, "--hierarchy", hier,
            "--scaffold_file", chunk["scaffold"], "--skybox_locked",
            "--iterations", "6", "--checkpoint_iterations", "4"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        tpost_cli.main(argv)
    # data_devices > 1 needs a process group of that size (one process
    # per card); views_per_step must be a multiple of it.
    with pytest.raises(ValueError, match="data_devices"):
        tpost_cli.main(argv + ["--device", "cpu", "--data_devices", "2"])
    with pytest.raises(ValueError, match="multiple of data_devices"):
        tpost_cli.main(argv + ["--device", "cpu", "--data_devices", "2",
                               "--views_per_step", "3"])
    tpost_cli.main(argv + ["--device", "cpu"])
    assert len(seen) == 6
    h0 = thio.read_hier(hier)
    assert len(splatted) == 6
    for (cut, in_mask, _, _, photo), rows in zip(seen, splatted):
        assert rows - N_SKY == in_mask == cut <= h0.n_nodes
        assert np.isfinite(photo)
    first, last = seen[0][2], seen[-1][3]
    assert first.n_skybox == N_SKY and first.capacity == h0.n_nodes + N_SKY
    lock = np.zeros(first.capacity, bool)
    lock[h0.anchors] = True
    lock[-N_SKY:] = True
    for f in PARAMS:
        a, b = np_(getattr(first, f)), np_(getattr(last, f))
        np.testing.assert_array_equal(a[lock], b[lock], f)
    assert np.abs(np_(first.features_dc) - np_(last.features_dc))[
        ~lock].max() > 0
    for read in (thio.read_hier, jhio.read_hier):
        h1 = read(hier + "_opt")
        h1.validate()
        np.testing.assert_array_equal(h1.nodes, h0.nodes)
        np.testing.assert_array_equal(h1.xyz, np_(last.xyz)[:h0.n_nodes])
        np.testing.assert_array_equal(
            h1.alpha, np.abs(np_(last.opacity)[:h0.n_nodes, 0]))
    assert os.path.exists(os.path.join(out, "chkpnt4.npz"))
    del seen[:]
    tpost_cli.main(argv[:-2] + ["--device", "cpu", "--start_checkpoint",
                                os.path.join(out, "chkpnt4.npz")])
    assert len(seen) == 2                      # iterations 5 and 6
