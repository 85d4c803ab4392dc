"""The port's ``.pt`` format (``io/pt.py``), its C++ hierarchy tools
(``native.py``) and its profiling helpers (``utils/profiling.py``), against
the JAX package on the same seeded inputs.

``.pt``: a directory written by either package loads in the other, with
``point_cloud.bin`` byte for byte; ``Scene.save`` past ``PLY_MAX_POINTS``
(lowered here) writes it and ``Scene`` loads it back. Native: the port
builds ``native/hierarchy_native.cpp`` itself; its builder and merger
write the same ``.hier`` bytes as the JAX package's native tools (the
same source and flags), and stay within ``tests/test_native.py``'s
tolerances of the numpy implementations (nodes and anchors equal; the C++
code merges in another floating-point order and picks eigenvector signs
of its own, so the bytes differ). Skipped only without a C++ compiler.
"""
from __future__ import annotations

import os

import numpy as np
import pytest
import torch

from h3dgs_tpu.hierarchy import io as jhio
from h3dgs_tpu.hierarchy import merge as jmerge
from h3dgs_tpu.hierarchy import tree as jtree
from h3dgs_tpu.io import pt as jpt
from h3dgs_tpu_torch import native as tnative
from h3dgs_tpu_torch.hierarchy import io as thio
from h3dgs_tpu_torch.hierarchy import merge as tmerge
from h3dgs_tpu_torch.hierarchy import tree as ttree
from h3dgs_tpu_torch.io import pt as tpt
from h3dgs_tpu_torch.utils import profiling

from .test_torch_common import np_
from .utils import random_scene

torch.set_num_threads(2)

needs_cxx = pytest.mark.skipif(not tnative.native_available(),
                               reason="no C++ compiler")


def _gaussians(n=50, seed=0):
    rng = np.random.default_rng(seed)
    return dict(
        xyz=rng.normal(size=(n, 3)).astype(np.float32),
        features_dc=rng.normal(size=(n, 1, 3)).astype(np.float32),
        features_rest=rng.normal(size=(n, 15, 3)).astype(np.float32),
        opacity=rng.normal(size=(n, 1)).astype(np.float32),
        scaling=rng.normal(size=(n, 3)).astype(np.float32),
        rotation=rng.normal(size=(n, 4)).astype(np.float32))


def test_pt_crosses_packages(tmp_path):
    """The port's ``save_pt`` (from tensors) loads in the JAX package and
    the JAX package's in the port, array for array; ``point_cloud.bin`` is
    byte for byte the same."""
    g = _gaussians()
    tdir, jdir = str(tmp_path / "t"), str(tmp_path / "j")
    tpt.save_pt(tdir, **{k: torch.as_tensor(v) for k, v in g.items()})
    jpt.save_pt(jdir, **g)
    with open(os.path.join(tdir, "point_cloud.bin"), "rb") as ft, \
            open(os.path.join(jdir, "point_cloud.bin"), "rb") as fj:
        t_bin, j_bin = ft.read(), fj.read()
    assert t_bin == j_bin and int.from_bytes(t_bin[:4], "little") == 50
    assert len(t_bin) == 4 + 50 * 4 * (3 + 48 + 1 + 3 + 4)
    for load, src in ((jpt.load_pt, tdir), (tpt.load_pt, jdir),
                      (tpt.load_pt, tdir)):
        got = load(src)
        for k, v in g.items():
            np.testing.assert_array_equal(np_(got[k]), v, k)
    # A view's storage is not written whole: a row slice saves its rows.
    tpt.save_pt(tdir, **{k: torch.as_tensor(np.concatenate([v, v]))[:50]
                         for k, v in g.items()})
    assert os.path.getsize(os.path.join(tdir, "done_xyz.pt")) < \
        os.path.getsize(os.path.join(jdir, "done_xyz.pt")) + 600


def test_scene_saves_and_loads_pt(tmp_path, monkeypatch):
    """A Scene past ``PLY_MAX_POINTS`` (lowered to 60) saves the packed
    format instead of a ``.ply``; a Scene pointed at that directory loads
    it back through the ``.pt`` branch, row for row."""
    from h3dgs_tpu_torch.config import ModelConfig, RuntimeConfig
    from h3dgs_tpu_torch.model.state import from_arrays
    from h3dgs_tpu_torch.scene import scene as tscene

    from .synthetic_scene import make_gaussian_scene, ring_cameras, \
        write_colmap_scene

    src = str(tmp_path / "src")
    write_colmap_scene(src, *make_gaussian_scene(n=30, seed=2),
                       ring_cameras(2), test_every=0)
    g = _gaussians(n=70, seed=1)
    state = from_arrays(**g, capacity=80, max_sh_degree=3, device="cpu")
    scene = tscene.Scene(ModelConfig(source_path=src,
                                     model_path=str(tmp_path / "m")),
                         RuntimeConfig(capacity_factor=1.0), device="cpu")
    monkeypatch.setattr(tscene, "PLY_MAX_POINTS", 60)
    pc_dir = scene.save(5, state)
    assert sorted(os.listdir(pc_dir)) == [
        "done_dc.pt", "done_opacity.pt", "done_rest.pt",
        "done_rotation.pt", "done_scaling.pt", "done_xyz.pt",
        "pc_info.txt", "point_cloud.bin"]
    loaded = tscene.Scene(ModelConfig(source_path=src,
                                      model_path=str(tmp_path / "m"),
                                      pretrained=pc_dir),
                          RuntimeConfig(capacity_factor=1.0), device="cpu")
    for k in ("xyz", "features_dc", "features_rest", "opacity", "scaling",
              "rotation"):
        np.testing.assert_array_equal(np_(getattr(loaded.state, k)),
                                      np_(getattr(state, k))[:70], k)
    assert loaded.state.capacity == 70


def _leaves(n, seed):
    means, scales, quats, opac, shs = random_scene(n, seed, sh_degree=1)
    return means, shs, opac, np.log(scales), quats


def _hier_bytes(path, h, writer):
    writer(path, h)
    with open(path, "rb") as f:
        return f.read()


def _assert_close_to_numpy(h_cc, h_np):
    """tests/test_native.py's tolerances."""
    h_cc.validate()
    np.testing.assert_array_equal(h_cc.nodes, h_np.nodes)
    np.testing.assert_array_equal(h_cc.anchors, h_np.anchors)
    np.testing.assert_allclose(h_cc.xyz, h_np.xyz, atol=1e-4)
    np.testing.assert_allclose(h_cc.alpha, h_np.alpha, atol=1e-4)
    np.testing.assert_allclose(h_cc.scaling, h_np.scaling, atol=1e-3)
    np.testing.assert_allclose(h_cc.boxes, h_np.boxes, atol=1e-3)
    np.testing.assert_allclose(h_cc.shs, h_np.shs, atol=1e-4)
    np.testing.assert_allclose(
        ttree.covariance_np(h_cc.scaling, h_cc.rotation),
        ttree.covariance_np(h_np.scaling, h_np.rotation), atol=1e-3)


@needs_cxx
@pytest.mark.parametrize("n", [1, 2, 17, 300])
def test_native_builder(tmp_path, n):
    """The port's C++ builder (after ``import torch``, threads capped):
    the JAX native builder's ``.hier`` bytes, and the numpy builder's tree
    within tolerance."""
    leaves = _leaves(n, n)
    locked = np.arange(n) % 7 == 0
    t_cc = ttree.build_hierarchy(*leaves, locked_leaf_mask=locked,
                                 backend="native")
    j_cc = jtree.build_hierarchy(*leaves, locked_leaf_mask=locked,
                                 backend="native")
    t_np = ttree.build_hierarchy(*leaves, locked_leaf_mask=locked,
                                 backend="numpy")
    assert _hier_bytes(str(tmp_path / "t.hier"), t_cc, thio.write_hier) == \
        _hier_bytes(str(tmp_path / "j.hier"), j_cc, jhio.write_hier)
    _assert_close_to_numpy(t_cc, t_np)
    assert ttree.resolve_backend("auto") == "native"


@needs_cxx
def test_native_merger(tmp_path):
    """The port's C++ merger: the JAX native merger's ``.hier`` bytes and
    the numpy merger's tree within tolerance (tests/test_native.py's
    three overlapping chunks)."""
    hs, centers, extents = [], [], []
    for i, cx in enumerate((-2.0, 2.0, 6.0)):
        means, scales, quats, opac, shs = random_scene(60, seed=i,
                                                       sh_degree=1)
        means = means + np.array([cx, 0.0, 0.0], np.float32)
        means[::3, 0] += 2.0
        hs.append(ttree.build_hierarchy(
            means, shs, opac, np.log(scales), quats,
            locked_leaf_mask=np.arange(60) % 5 == 0, backend="numpy"))
        centers.append(np.array([cx, 0.0, 0.0], np.float32))
        extents.append(np.array([4.0, 100.0, 100.0], np.float32))
    from h3dgs_tpu.native import merge_hierarchies_native as jmerge_native

    t_cc = tnative.merge_hierarchies_native(hs, centers, extents)
    j_cc = jmerge_native(hs, centers, extents)
    assert _hier_bytes(str(tmp_path / "t.hier"), t_cc, thio.write_hier) == \
        _hier_bytes(str(tmp_path / "j.hier"), j_cc, jhio.write_hier)
    _assert_close_to_numpy(t_cc, tmerge.merge_hierarchies(hs, centers,
                                                          extents))
    np.testing.assert_array_equal(
        jmerge.merge_hierarchies(hs, centers, extents).nodes, t_cc.nodes)


@needs_cxx
def test_native_build_is_keyed_and_failures_raise(tmp_path, monkeypatch):
    """The library is built once per (source, flags, compiler, CPU) into
    ``_build/`` and reused; a source that does not compile raises with
    the compiler's output, and ``backend="native"`` never falls back to
    numpy; an unknown backend raises."""
    path = tnative.build()
    assert os.path.dirname(path) == tnative.BUILD_DIR
    assert tnative.build() == path and os.path.exists(path)
    bad = tmp_path / "broken.cpp"
    bad.write_text("this is not C++\n")
    monkeypatch.setattr(tnative, "SOURCE", str(bad))
    monkeypatch.setattr(tnative, "BUILD_DIR", str(tmp_path / "build"))
    monkeypatch.setattr(tnative, "_LIB", None)
    with pytest.raises(RuntimeError, match="build failed"):
        tnative.build()
    with pytest.raises(RuntimeError, match="build failed"):
        ttree.build_hierarchy(*_leaves(5, 0), backend="native")
    with pytest.raises(ValueError, match="unknown hierarchy backend"):
        ttree.build_hierarchy(*_leaves(5, 0), backend="cuda")
    monkeypatch.setattr(tnative, "compiler", lambda: None)
    assert ttree.resolve_backend("auto") == "numpy"


@needs_cxx
def test_creator_cli_backends(tmp_path, capsys):
    """``hierarchy_creator --backend native`` and ``numpy`` on the same
    point cloud: the same anchors, trees within tolerance, and each says
    which backend ran."""
    from h3dgs_tpu_torch.cli import hierarchy_creator
    from h3dgs_tpu_torch.io.ply import write_gaussian_ply

    g = _gaussians(n=40, seed=3)
    g["scaling"] = (g["scaling"] * 0.3 - 3.0).astype(np.float32)
    ply = str(tmp_path / "pc" / "point_cloud.ply")
    write_gaussian_ply(ply, **g)
    out = {}
    for backend in ("native", "numpy"):
        hierarchy_creator.main([ply, str(tmp_path), str(tmp_path / backend),
                                "--backend", backend])
        said = capsys.readouterr().out
        assert f"built by the {backend} backend" in said
        out[backend] = thio.read_hier(str(tmp_path / backend /
                                          "hierarchy.hier"))
    _assert_close_to_numpy(out["native"], out["numpy"])


def test_trace(tmp_path):
    """``trace`` yields the profiler and writes a Chrome trace of the
    block."""
    with profiling.trace(str(tmp_path / "trace")) as prof:
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert any("mm" in e.key for e in prof.key_averages())
    assert os.path.getsize(tmp_path / "trace" / "trace.json") > 0
