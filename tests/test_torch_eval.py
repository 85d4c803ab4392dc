"""Parity of the port's evaluation slice with the JAX package, on the same
seeded numpy inputs: LPIPS (with synthetic weights in the ``.npz`` layout:
the repository holds no pretrained ones) and its weights loader and
converter, PSNR / SSIM, the flat renders ``render`` / ``render_coarse``
(index subset, exposure), and ``render_hierarchy`` (``render_set`` through
both CLIs) on a tiny hierarchy scene. Tolerances are stated per test.

The scenes stay inside the XLA path's caps (hazard H4), away from depth
and termination ties (H5, H9), and the evaluation is forward only (H10
concerns gradients).
"""
from __future__ import annotations

import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from h3dgs_tpu import render as jrender
from h3dgs_tpu.cli import render_hierarchy as jrh
from h3dgs_tpu.eval import metrics as JM
from h3dgs_tpu.hierarchy import io as jhio
from h3dgs_tpu.hierarchy import tree as jtree
from h3dgs_tpu.io import meta as jmeta
from h3dgs_tpu.model import state as jstate
from h3dgs_tpu.ops.rasterize import RasterizeConfig
from h3dgs_tpu_torch import render as trender
from h3dgs_tpu_torch.cli import render_hierarchy as trh
from h3dgs_tpu_torch.eval import convert_lpips as tconv
from h3dgs_tpu_torch.eval import metrics as TM
from h3dgs_tpu_torch.io.image import read_png
from h3dgs_tpu_torch.model import state as tstate
from h3dgs_tpu_torch.train import post_step as tpost
from h3dgs_tpu_torch.utils import losses as tloss

from .synthetic_scene import make_gaussian_scene, ring_cameras, \
    write_colmap_scene
from .test_torch_common import camera_pair, np_, t_
from .utils import random_scene, write_random_lpips_weights

torch.set_num_threads(2)

XCFG = RasterizeConfig(max_entries=1 << 14, max_per_tile=256, chunk=16,
                       backend="xla")
# float32 VGG features in another summation order: the distances agree to
# a few 1e-7 on these sizes; 1e-5 absolute is the stated bound.
LPIPS_ATOL = 1e-5


@pytest.fixture(scope="module")
def weights(tmp_path_factory):
    return write_random_lpips_weights(
        tmp_path_factory.mktemp("lpips") / "rand_lpips.npz")


def _image_pair(seed, h=48, w=64):
    rng = np.random.default_rng(seed)
    a = rng.uniform(0, 1, (3, h, w)).astype(np.float32)
    b = np.clip(a + rng.normal(0, 0.1, a.shape), 0, 1).astype(np.float32)
    return a, b


# ------------------------------------------------------------- LPIPS ---

@pytest.mark.parametrize("seed,h,w", [(0, 48, 64), (1, 37, 53)])
def test_lpips_matches_jax(weights, seed, h, w):
    """The port's LPIPS within LPIPS_ATOL of the JAX LPIPS on the same
    images and weights (odd sizes exercise the floor of the pools); an
    image against itself is < 1e-6."""
    a, b = _image_pair(seed, h, w)
    want = JM.lpips(a, b, weights_path=weights)
    got = TM.lpips(a, b, weights_path=weights, device="cpu")
    assert want > 1e-5 and abs(got - want) <= LPIPS_ATOL, (got, want)
    assert abs(TM.lpips(a, a, weights_path=weights, device="cpu")) < 1e-6
    # Tensors on the device are taken as they are.
    got_t = TM.lpips(t_(a), t_(b), weights_path=weights, device="cpu")
    assert got_t == got


def test_lpips_none_without_weights_and_env_discovery(weights, monkeypatch,
                                                      capsys):
    """No weights anywhere: None, and one loud warning (not two); the
    environment variable finds them; a file without the source tag warns
    that the metric is non-standard."""
    monkeypatch.delenv(TM.LPIPS_WEIGHTS_ENV, raising=False)
    monkeypatch.setattr(TM, "_WARNED", [False])
    monkeypatch.setattr(TM, "_default_weight_paths", lambda: iter(()))
    a, b = _image_pair(2, 16, 16)
    assert TM.lpips(a, b, device="cpu") is None
    assert TM.lpips(a, b) is None            # no device needed for None
    err = capsys.readouterr().err
    assert err.count("LPIPS unavailable") == 1
    assert TM.LPIPS_WEIGHTS_ENV in err
    monkeypatch.setenv(TM.LPIPS_WEIGHTS_ENV, weights)
    TM._load_weights.cache_clear()
    d = TM.lpips(a, b, device="cpu")
    assert d is not None and d > 0
    assert "source tag" in capsys.readouterr().err


def test_lpips_constants_match_jax():
    assert TM.LPIPS_WEIGHTS_ENV == JM.LPIPS_WEIGHTS_ENV
    assert TM.LPIPS_UNAVAILABLE == JM.LPIPS_UNAVAILABLE == \
        "unavailable(no-weights)"
    assert TM.LPIPS_SOURCE_TAG == JM.LPIPS_SOURCE_TAG
    assert TM._VGG_CFG == JM._VGG_CFG
    np.testing.assert_array_equal(TM._SHIFT, JM._SHIFT)
    np.testing.assert_array_equal(TM._SCALE, JM._SCALE)


@pytest.mark.parametrize("corrupt", ["conv_shape", "missing_lin",
                                     "negative_lin"])
def test_weights_layout_errors_match_jax(weights, corrupt):
    """A malformed file raises the same ValueError in both packages; the
    good file passes both."""
    z = dict(np.load(weights))
    JM.validate_weights_layout(z)
    TM.validate_weights_layout(z)
    bad = dict(z)
    if corrupt == "conv_shape":
        bad["conv3.weight"] = bad["conv3.weight"][:, :, :2, :2]
    elif corrupt == "missing_lin":
        del bad["lin4.weight"]
    else:
        bad["lin0.weight"] = -np.abs(bad["lin0.weight"])
    with pytest.raises(ValueError) as want:
        JM.validate_weights_layout(bad)
    with pytest.raises(ValueError) as got:
        TM.validate_weights_layout(bad)
    assert str(got.value) == str(want.value)


def _state_dicts(z):
    """torchvision- and lpips-style state dicts holding the arrays of a
    weights file (torchvision's conv indices in ``features``)."""
    conv_idx = [0, 2, 5, 7, 10, 12, 14, 17, 19, 21, 24, 26, 28]
    vgg = {}
    for li, n in enumerate(conv_idx):
        vgg[f"features.{n}.weight"] = torch.as_tensor(z[f"conv{li}.weight"])
        vgg[f"features.{n}.bias"] = torch.as_tensor(z[f"conv{li}.bias"])
    vgg["classifier.0.weight"] = torch.zeros(4, 4)     # ignored
    lin = {f"lin{i}.model.1.weight": torch.as_tensor(z[f"lin{i}.weight"])
           for i in range(5)}
    return vgg, lin


def test_convert_lpips_from_state_dicts(weights, tmp_path, capsys):
    """Synthetic torchvision / lpips state dicts saved with torch.save:
    the converted file validates in both packages, holds the same arrays,
    is tagged by its own sha256 prefix (not the standard checkpoint), and
    gives the same distance."""
    z = dict(np.load(weights))
    vgg, lin = _state_dicts(z)
    vgg_path, lin_path = str(tmp_path / "vgg16.pth"), str(tmp_path / "l.pth")
    torch.save(vgg, vgg_path)
    torch.save(lin, lin_path)
    out = str(tmp_path / "lpips_vgg.npz")
    tconv.main(["--vgg16", vgg_path, "--lin", lin_path, "--out", out])
    assert "WARNING" in capsys.readouterr().out
    conv = dict(np.load(out))
    JM.validate_weights_layout(conv)
    TM.validate_weights_layout(conv)
    tag = str(conv.pop("source_tag"))
    assert tag.startswith("vgg16-") and tag != TM.LPIPS_SOURCE_TAG
    assert set(conv) == set(z)
    for k in z:
        np.testing.assert_array_equal(conv[k], z[k], err_msg=k)
    arrays = tconv.convert_state_dicts(vgg, lin, TM.LPIPS_SOURCE_TAG)
    assert str(arrays["source_tag"]) == TM.LPIPS_SOURCE_TAG
    a, b = _image_pair(3, 24, 32)
    assert TM.lpips(a, b, weights_path=out, device="cpu") == \
        TM.lpips(a, b, weights_path=weights, device="cpu")
    del lin["lin2.model.1.weight"]
    with pytest.raises(KeyError):
        tconv.convert_state_dicts(vgg, lin, "x")


@pytest.mark.parametrize("name,dark", [("psnr", False), ("psnr", True),
                                       ("ssim", False)])
def test_psnr_ssim_match_jax(name, dark):
    """The re-exported losses against the JAX package's metrics: within
    1e-5 relative (float32). SSIM on dark, low-variance images is left to
    ``tests/test_torch_losses.py``: its variance terms cancel there, and
    the two blurs' summation orders then part by ~1e-5 (hazard H1)."""
    a, b = _image_pair(4)
    if dark:
        a, b = 0.02 + 0.002 * a, 0.02 + 0.002 * b
    assert getattr(TM, name) is getattr(tloss, name)
    want = float(getattr(JM, name)(jnp.asarray(a), jnp.asarray(b)))
    got = float(getattr(TM, name)(t_(a), t_(b)))
    np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-6)


# ------------------------------------------------------ flat renders ---

def _state_pair(n=90, capacity=100, seed=6):
    means, scales, quats, opac, shs = random_scene(n, seed, sh_degree=1)
    shs[:, 0] = np.clip(shs[:, 0], -0.6, 0.6)
    logit = np.log(opac / (1 - opac)).reshape(n, 1)
    js = jstate.from_arrays(means, shs[:, :1], shs[:, 1:], logit,
                            np.log(scales), quats, capacity=capacity,
                            max_sh_degree=1)
    arrays = {f: np.array(getattr(js, f)) for f in tstate.ALL_FIELDS}
    ts = tstate.state_from_jax_arrays(arrays, device="cpu", max_sh_degree=1,
                                      opacity_abs=False, n_skybox=0,
                                      n_scaffold=0, skybox_last=False)
    return js, ts


def _near(a, b, tol, frac=1e-3):
    """|a - b| <= tol except on at most ``frac`` of the elements (pixels
    whose termination test flips within float32 rounding)."""
    d = np.abs(np_(a).astype(np.float64) - np.asarray(b, np.float64))
    assert np.isfinite(d).all()
    assert (d > tol).mean() <= frac, ((d > tol).mean(), d.max())


def test_render_matches_jax_subset_and_exposure():
    """``render`` with an exact index subset (the JAX call gets the same
    rows in a -1-padded bucket) and a trained exposure: image and inverse
    depth within 1e-4 except termination flips, visibility and radii
    scattered back to all rows and equal, the means2d-offset gradient of
    a weighted image sum within 1e-4 of its max and zero off the subset.
    ``render_coarse`` against the JAX one the same way."""
    js, ts = _state_pair()
    jc, tc = camera_pair((0.3, -0.2, -3.2), fovx=1.0, width=64, height=48)
    bg = np.array([0.1, 0.2, 0.3], np.float32)
    exp = np.eye(3, 4, dtype=np.float32)
    exp[0, 0], exp[2, 1], exp[1, 3] = 0.9, 0.05, 0.02
    idx = np.arange(3, 90, 2)
    padded = np.concatenate([idx, np.full(7, -1)]).astype(np.int32)
    cot = np.random.default_rng(0).normal(size=(3, 48, 64)).astype(
        np.float32)

    def jfn(off):
        out = jrender.render(jc, js, jnp.asarray(bg), use_trained_exp=True,
                             exposure=jnp.asarray(exp), means2d_offset=off,
                             indices=jnp.asarray(padded), config=XCFG)
        return jnp.sum(out["render"] * cot), out

    # Jitted: XLA's op-by-op dispatch of the rasterizer is ten times
    # slower on the CPU than one compile.
    (_, jout), jgrad = jax.jit(jax.value_and_grad(jfn, has_aux=True))(
        jnp.zeros((100, 2), jnp.float32))
    off = torch.zeros((100, 2), requires_grad=True)
    tout = trender.render(tc, ts, bg, use_trained_exp=True,
                          exposure=t_(exp), means2d_offset=off,
                          indices=t_(idx), device="cpu")
    (tout["render"] * t_(cot)).sum().backward()
    assert set(tout) == set(jout)
    assert tout["viewspace_points"] is off
    _near(tout["render"], jout["render"], 1e-4)
    _near(tout["depth"], jout["depth"], 1e-4)
    np.testing.assert_array_equal(np_(tout["visibility_filter"]),
                                  np.asarray(jout["visibility_filter"]))
    np.testing.assert_array_equal(np_(tout["radii"]),
                                  np.asarray(jout["radii"]))
    assert np_(tout["visibility_filter"]).sum() > 20
    assert not np_(tout["visibility_filter"])[:3].any()
    g, jg = np_(off.grad), np.asarray(jgrad)
    assert np.abs(g - jg).max() <= 1e-4 * np.abs(jg).max()
    rows = np.zeros(100, bool)
    rows[idx] = True
    assert not g[~rows].any() and np.abs(g[rows]).max() > 0
    image = tout["render"].detach()
    assert float(image.min()) >= 0 and float(image.max()) <= 1
    with pytest.raises(ValueError, match="exact subset"):
        trender.render(tc, ts, bg, indices=t_(padded), device="cpu")

    jco = jax.jit(lambda st: jrender.render_coarse(
        jc, st, jnp.asarray(bg), config=XCFG))(js)
    tco = trender.render_coarse(tc, ts, bg, device="cpu")
    assert set(tco) == set(jco)
    _near(tco["render"], jco["render"], 1e-4)
    np.testing.assert_array_equal(np_(tco["radii"]), np.asarray(jco["radii"]))


# ------------------------------------------------- render_hierarchy ---

@pytest.fixture(scope="module")
def eval_scene(tmp_path_factory, weights):
    """A 4-view COLMAP scene (48x32, test views img_000 and img_002), the
    hierarchy of a perturbed copy of its Gaussians with pretrained
    exposures beside it, and synthetic LPIPS weights."""
    root = str(tmp_path_factory.mktemp("evalscene"))
    means, scales, quats, opac, shs, rgb = make_gaussian_scene(n=70, seed=3)
    write_colmap_scene(root, means, scales, quats, opac, shs, rgb,
                       ring_cameras(4, width=48, height=32), test_every=2)
    rng = np.random.default_rng(5)
    hshs = np.zeros((70, 16, 3), np.float32)
    hshs[:, 0] = shs[:, 0] + rng.normal(0, 0.1, (70, 3))
    hshs[:, 1:4] = rng.normal(0, 0.05, (70, 3, 3))
    h = jtree.build_hierarchy(
        means + rng.normal(0, 0.02, means.shape).astype(np.float32), hshs,
        opac * 0.9, np.log(scales), quats, backend="numpy")
    hdir = os.path.join(root, "merged")
    os.makedirs(hdir)
    jhio.write_hier(os.path.join(hdir, "merged.hier"), h)
    exp = np.eye(3, 4, dtype=np.float32)
    exp[0, 0], exp[1, 3] = 0.93, 0.02
    # Every view has one (the JAX evaluation compiles a frame once per
    # shape and exposure presence).
    jmeta.write_exposure_json(os.path.join(hdir, "exposure.json"),
                              {f"img_00{i}.png": exp * (1.0 - 0.01 * i)
                               for i in range(4)})
    return dict(root=root, hier=os.path.join(hdir, "merged.hier"),
                weights=weights, n_leaves=h.n_leaves)


@pytest.mark.parametrize("split", ["train_views", "test_views_exp_crop"])
def test_render_hierarchy_matches_jax(eval_scene, split, tmp_path,
                                      monkeypatch):
    """Both CLIs on the same hierarchy and views (all four train views, or
    the two test views under ``--train_test_exp``, cropped to their right
    halves): the same metrics.json keys, n_views and cut sizes; PSNR within
    0.05 dB, SSIM within 1e-4, LPIPS within LPIPS_ATOL; the cut coarsens
    with tau; every PNG within one level of the JAX package's on 99.9 % of
    values."""
    monkeypatch.setenv(TM.LPIPS_WEIGHTS_ENV, eval_scene["weights"])
    argv = ["-s", eval_scene["root"], "--hierarchy", eval_scene["hier"],
            "--taus", "0", "6"]
    if split == "test_views_exp_crop":
        argv += ["--eval", "--train_test_exp"]
    jdir, tdir = str(tmp_path / "j"), str(tmp_path / "t")
    jrh.main(argv + ["-m", jdir, "--max_entries", "16384",
                     "--max_per_tile", "256"])
    with_exposure = []
    render_cut = tpost.render_cut

    def spy(*a, exposure=None, **kw):
        with_exposure.append(exposure is not None)
        return render_cut(*a, exposure=exposure, **kw)

    monkeypatch.setattr(tpost, "render_cut", spy)
    trh.main(argv + ["-m", tdir, "--device", "cpu"])
    with open(os.path.join(jdir, "metrics.json")) as f:
        jm = json.load(f)
    with open(os.path.join(tdir, "metrics.json")) as f:
        tm = json.load(f)
    n_views = 2 if split == "test_views_exp_crop" else 4
    assert with_exposure == [True] * (2 * n_views)
    assert set(tm) == set(jm) == {"0.0", "6.0"}
    for tau in tm:
        t, j = tm[tau], jm[tau]
        assert set(t) == set(j) == {"psnr", "ssim", "lpips", "n_views",
                                    "cut_mean", "cut_min", "cut_max"}
        assert t["n_views"] == j["n_views"] == n_views
        for k in ("cut_mean", "cut_min", "cut_max"):
            assert t[k] == j[k], (tau, k, t[k], j[k])
        assert abs(t["psnr"] - j["psnr"]) <= 0.05, (t, j)
        assert abs(t["ssim"] - j["ssim"]) <= 1e-4, (t, j)
        assert abs(t["lpips"] - j["lpips"]) <= LPIPS_ATOL, (t, j)
        assert np.isfinite(t["psnr"]) and t["lpips"] > 0
    assert tm["6.0"]["cut_mean"] < tm["0.0"]["cut_mean"] \
        <= eval_scene["n_leaves"]
    for tau in tm:
        for vi in range(n_views):
            name = os.path.join("renders", f"tau_{tau}", f"{vi:05d}.png")
            got = read_png(os.path.join(tdir, name))
            want = read_png(os.path.join(jdir, name))
            assert got.shape == want.shape == (32, 48, 3)
            d = np.abs(got.astype(np.int32) - want.astype(np.int32))
            assert (d <= 1).mean() >= 0.999, (name, d.max())


def test_render_hierarchy_without_weights_and_no_images(eval_scene,
                                                        tmp_path,
                                                        monkeypatch):
    """No LPIPS weights: metrics.json carries the JAX package's sentinel;
    ``--no_images`` writes no PNG."""
    monkeypatch.delenv(TM.LPIPS_WEIGHTS_ENV, raising=False)
    monkeypatch.setattr(TM, "_default_weight_paths", lambda: iter(()))
    out = str(tmp_path / "t")
    res = trh.main(["-s", eval_scene["root"], "--hierarchy",
                    eval_scene["hier"], "--taus", "3", "-m", out,
                    "--no_images", "--device", "cpu"])
    assert res[3.0]["lpips"] == TM.LPIPS_UNAVAILABLE
    with open(os.path.join(out, "metrics.json")) as f:
        assert json.load(f)["3.0"]["lpips"] == "unavailable(no-weights)"
    assert not os.path.exists(os.path.join(out, "renders"))
