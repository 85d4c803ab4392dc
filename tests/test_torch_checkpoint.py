"""Checkpoints of the port against the JAX package's: one ``.npz`` written
by either package loads in the other with equal arrays and iteration; a
flat run of 4 iterations equals 2 iterations, a checkpoint and a resumed
2; and the coarse trainer's CLI runs on the CPU."""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h3dgs_tpu.model import state as jstate
from h3dgs_tpu.ops import adam as jadam
from h3dgs_tpu.train import checkpoint as jckpt
from h3dgs_tpu_torch.cli import train_coarse, train_single
from h3dgs_tpu_torch.io import meta as tmeta
from h3dgs_tpu_torch.io import ply as tply
from h3dgs_tpu_torch.model import state as tstate
from h3dgs_tpu_torch.scene.scene import Scene as TScene
from h3dgs_tpu_torch.train import checkpoint as tckpt
from h3dgs_tpu_torch.train import loop as tloop

from .synthetic_scene import make_gaussian_scene, ring_cameras, \
    write_colmap_scene
from .test_torch_common import np_
from .utils import random_scene

torch.set_num_threads(2)

STATIC = dict(max_sh_degree=1, opacity_abs=False, n_skybox=4, n_scaffold=4,
              skybox_last=False)


def _snapshot(seed=11, n=30, cap=40, n_views=3):
    """State, optimizer, exposure and exposure optimizer as numpy."""
    rng = np.random.default_rng(seed)
    means, scales, quats, opac, shs = random_scene(n, seed, sh_degree=1)
    feats = np.zeros((n, 16, 3), np.float32)
    feats[:, :4] = shs
    st = jstate.from_arrays(means, feats[:, :1], feats[:, 1:],
                            opac[:, None], np.log(scales), quats,
                            capacity=cap, **STATIC)
    arrays = {f: np.array(getattr(st, f)) for f in tstate.ALL_FIELDS}
    arrays["max_radii2d"] = rng.random(cap).astype(np.float32)
    arrays["xyz_gradient_accum"] = rng.random(cap).astype(np.float32)
    arrays["denom"] = rng.integers(0, 5, cap).astype(np.float32)
    groups = {k: np.asarray(v).shape
              for k, v in st.trainable_dict().items()}
    mu = {k: rng.normal(size=s).astype(np.float32)
          for k, s in groups.items()}
    nu = {k: rng.random(s).astype(np.float32) for k, s in groups.items()}
    exposure = rng.normal(size=(n_views, 3, 4)).astype(np.float32)
    emu = rng.normal(size=exposure.shape).astype(np.float32)
    enu = rng.random(exposure.shape).astype(np.float32)
    return arrays, (mu, nu, np.int32(17)), exposure, (emu, enu, np.int32(9))


@pytest.mark.parametrize("writer", ["jax", "torch"])
def test_checkpoint_crosses_packages(tmp_path, writer):
    """``save_flat`` of one package, ``load_flat`` of the other: every
    state field, moment, step, exposure and the iteration equal, tensors
    on the template's device with the template's static metadata."""
    arrays, (mu, nu, step), exposure, (emu, enu, estep) = _snapshot()
    path = str(tmp_path / "chkpnt7.npz")
    jst = jstate.GaussianState(**{k: jnp.asarray(v)
                                  for k, v in arrays.items()}, **STATIC)
    tst = tstate.state_from_jax_arrays(arrays, device="cpu", **STATIC)
    if writer == "jax":
        jckpt.save_flat(
            path, jst,
            jadam.AdamState({k: jnp.asarray(v) for k, v in mu.items()},
                            {k: jnp.asarray(v) for k, v in nu.items()},
                            jnp.asarray(step)), jnp.asarray(exposure),
            jadam.AdamState({"exposure": jnp.asarray(emu)},
                            {"exposure": jnp.asarray(enu)},
                            jnp.asarray(estep)), 7)
        template = tstate.empty_state(40, device="cpu", **STATIC)
        st, opt, exp, eopt, it = tckpt.load_flat(path, template)
        assert st.xyz.device.type == "cpu" and st.n_skybox == 4
        assert st.alive.dtype == torch.bool
        assert opt.step.dtype == torch.int32
    else:
        tckpt.save_flat(
            path, tst, tstate.adam_from_jax_arrays(mu, nu, step, "cpu"),
            torch.as_tensor(exposure),
            tstate.adam_from_jax_arrays({"exposure": emu},
                                        {"exposure": enu}, estep, "cpu"), 7)
        st, opt, exp, eopt, it = jckpt.load_flat(path, jst)
    assert it == 7
    with np.load(path) as z:
        assert sorted(z.files) == sorted(
            [f"state.{k}" for k in tstate.ALL_FIELDS]
            + [f"opt.{m}.{k}" for m in ("mu", "nu") for k in mu]
            + ["opt.step", "exposure", "exp_opt.mu", "exp_opt.nu",
               "exp_opt.step", "iteration"])
    for f, want in arrays.items():
        np.testing.assert_array_equal(np_(getattr(st, f)), want, f)
    for k in mu:
        np.testing.assert_array_equal(np_(opt.mu[k]), mu[k], k)
        np.testing.assert_array_equal(np_(opt.nu[k]), nu[k], k)
    assert int(opt.step) == 17 and int(eopt.step) == 9
    np.testing.assert_array_equal(np_(exp), exposure)
    np.testing.assert_array_equal(np_(eopt.mu["exposure"]), emu)
    np.testing.assert_array_equal(np_(eopt.nu["exposure"]), enu)


@pytest.fixture(scope="module")
def colmap_dir(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("chunk"))
    means, scales, quats, opac, shs, rgb = make_gaussian_scene(n=60, seed=6)
    write_colmap_scene(root, means, scales, quats, opac, shs, rgb,
                       ring_cameras(4, width=48, height=32))
    return root


class _SkippedStream:
    """A view stream whose first ``n`` views were already taken."""

    def __init__(self, inner, n):
        self.inner = inner
        for _ in range(n):
            next(inner)

    def __next__(self):
        return next(self.inner)

    def close(self):
        self.inner.close()


def test_train_flat_resumes_from_checkpoint(colmap_dir, tmp_path,
                                            monkeypatch):
    """4 iterations in one run equal 2 iterations, a checkpoint, and a
    resumed run of 2 more: the final state, exposures and saved point
    cloud are equal (the CPU path is deterministic). What a checkpoint
    reproduces: state, both optimizers, exposures, iteration (so the
    schedules). What it does not, as in the reference: the view stream's
    position -- the test hands the resumed run a stream advanced by the
    2 views already taken -- and the generator's state, which these
    iterations do not draw from (no densification, not coarse)."""
    finals = {}
    orig = tloop.train_flat

    def keep(cfg, scene, **kw):
        finals[scene.model_path] = orig(cfg, scene, **kw)
        return finals[scene.model_path]

    monkeypatch.setattr(tloop, "train_flat", keep)
    # The exposure rate decays over ``--iterations``, which the first part
    # sets to 2: hold it constant so both schedules agree.
    base = ["-s", colmap_dir, "--skybox_num", "6", "--skybox_locked",
            "--disable_viewer", "--device", "cpu", "--exposure_lr_init",
            "0.001", "--exposure_lr_final", "0.001", "--iterations", "4"]
    whole, parts = str(tmp_path / "whole"), str(tmp_path / "parts")
    train_single.main(base + ["-m", whole])
    train_single.main(base + ["-m", parts, "--iterations", "2",
                              "--checkpoint_iterations", "2"])
    ckpt = os.path.join(parts, "chkpnt2.npz")
    with np.load(ckpt) as z:
        assert int(z["iteration"]) == 2 and int(z["opt.step"]) == 2
    stream = TScene.train_stream
    monkeypatch.setattr(
        TScene, "train_stream",
        lambda self, **kw: _SkippedStream(stream(self, **kw), 2))
    train_single.main(base + ["-m", parts, "--start_checkpoint", ckpt])
    (st_a, exp_a), (st_b, exp_b) = finals[whole], finals[parts]
    for f in tstate.ALL_FIELDS:
        np.testing.assert_array_equal(np_(getattr(st_a, f)),
                                      np_(getattr(st_b, f)), f)
    np.testing.assert_array_equal(np_(exp_a), np_(exp_b))
    assert not np.array_equal(np_(exp_a), np.tile(np.eye(3, 4), (4, 1, 1)))
    plys = [tply.read_gaussian_ply(os.path.join(
        d, "point_cloud", "iteration_4", "point_cloud.ply"), 3)
        for d in (whole, parts)]
    for k in plys[0]:
        np.testing.assert_array_equal(plys[0][k], plys[1][k], k)


def test_train_coarse_cli_cpu(colmap_dir, tmp_path, monkeypatch):
    """``train_coarse.main`` for 3 iterations on the CPU: a degree-1
    point cloud with its skybox count, positions frozen, no exposure
    learnt; without CUDA and without ``--device`` it raises."""
    out = str(tmp_path / "coarse")
    argv = ["-s", colmap_dir, "-m", out, "--skybox_num", "8",
            "--iterations", "3", "--disable_viewer"]
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA is not available"):
        train_coarse.main(argv)
    train_coarse.main(argv + ["--device", "cpu",
                              "--checkpoint_iterations", "3"])
    pc = os.path.join(out, "point_cloud", "iteration_3")
    g = tply.read_gaussian_ply(os.path.join(pc, "point_cloud.ply"), 1)
    assert g["features_rest"].shape[1:] == (3, 3)
    assert tmeta.read_pc_info(os.path.join(pc, "pc_info.txt")) == 8
    assert g["xyz"].shape[0] == 60 + 8
    exp = tmeta.read_exposure_json(os.path.join(out, "exposure.json"))
    for v in exp.values():
        np.testing.assert_array_equal(v, np.eye(3, 4, dtype=np.float32))
    means = make_gaussian_scene(n=60, seed=6)[0]
    np.testing.assert_array_equal(g["xyz"][8:], means)      # frozen
    with np.load(os.path.join(out, "chkpnt3.npz")) as z:
        np.testing.assert_array_equal(z["state.xyz"][:68], g["xyz"])
        assert np.abs(z["opt.mu.f_dc"]).max() > 0
