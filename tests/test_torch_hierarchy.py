"""Parity of the port's hierarchy build, .hier I/O, cut selection, LOD
interpolation and state construction with the JAX package."""
from __future__ import annotations

import os

import jax.numpy as jnp
import numpy as np
import torch

from h3dgs_tpu.hierarchy import cut as jcut
from h3dgs_tpu.hierarchy import io as jio
from h3dgs_tpu.hierarchy import tree as jtree
from h3dgs_tpu.io.ply import write_gaussian_ply
from h3dgs_tpu.model import init as jinit
from h3dgs_tpu.model import state as jstate
from h3dgs_tpu_torch.hierarchy import cut as tcut
from h3dgs_tpu_torch.hierarchy import io as tio
from h3dgs_tpu_torch.hierarchy import tree as ttree
from h3dgs_tpu_torch.model import init as tinit
from h3dgs_tpu_torch.model import state as tstate

from .test_torch_common import np_, t_
from .utils import random_scene

torch.set_num_threads(2)

H_FIELDS = ("xyz", "shs", "alpha", "scaling", "rotation", "nodes", "boxes",
            "anchors")


def _leaves(n=200, seed=0, sh_degree=1):
    means, scales, quats, opac, shs = random_scene(n, seed,
                                                   sh_degree=sh_degree)
    return means, shs, opac, np.log(scales), quats


def _hier(n=200, seed=0):
    means, shs, opac, log_s, quats = _leaves(n, seed)
    locked = np.random.default_rng(seed).random(n) < 0.1
    return jtree.build_hierarchy(means, shs, opac, log_s, quats,
                                 locked_leaf_mask=locked, backend="numpy")


def test_build_hierarchy_bit_equal():
    means, shs, opac, log_s, quats = _leaves(257, 1)
    locked = np.random.default_rng(1).random(257) < 0.2
    hj = jtree.build_hierarchy(means, shs, opac, log_s, quats,
                               locked_leaf_mask=locked, backend="numpy")
    ht = ttree.build_hierarchy(means, shs, opac, log_s, quats,
                               locked_leaf_mask=locked, backend="numpy")
    ht.validate()
    for f in H_FIELDS:
        a, b = getattr(hj, f), getattr(ht, f)
        assert a.dtype == b.dtype, f
        np.testing.assert_array_equal(a, b, err_msg=f)


def test_hier_files_cross_read(tmp_path):
    """A .hier written by either package reads identically in the other."""
    h = _hier(120, 2)
    pj = os.path.join(str(tmp_path), "jax.hier")
    pt = os.path.join(str(tmp_path), "torch.hier")
    jio.write_hier(pj, h)
    tio.write_hier(pt, h)
    with open(pj, "rb") as a, open(pt, "rb") as b:
        assert a.read() == b.read()
    for got in (tio.read_hier(pj), jio.read_hier(pt)):
        for f in H_FIELDS:
            np.testing.assert_array_equal(getattr(got, f), getattr(h, f))


def _cam_centers():
    return [np.array(c, np.float32) for c in
            ((0.0, -0.5, -6.0), (2.0, 1.0, 3.0), (0.1, 0.2, 0.3))]


def test_cut_selection_exact():
    """Membership, order, parents, counts and ladder counts match."""
    h = _hier(300, 3)
    nodes, boxes = h.nodes, h.boxes
    tn, tb = t_(nodes), t_(boxes)
    for c in _cam_centers():
        limits = np.float32(0.02) * (1.5 ** np.arange(16)).astype(np.float32)
        np.testing.assert_array_equal(
            np_(tcut.cut_counts(tn, tb, t_(c), t_(limits))),
            np.asarray(jcut.cut_counts(nodes, boxes, c, limits)))
        for limit in (0.01, 0.05, 0.3):
            for max_cut in (h.n_nodes, 64):
                cj = jcut.expand_to_size(nodes, boxes, jnp.float32(limit), c,
                                         max_cut)
                ct = tcut.expand_to_size(tn, tb, limit, t_(c), max_cut)
                for f in ("indices", "parents", "num_siblings", "valid",
                          "count"):
                    np.testing.assert_array_equal(
                        np_(getattr(ct, f)), np.asarray(getattr(cj, f)),
                        err_msg=f"{f} limit={limit} max_cut={max_cut}")
                # w = (psize - limit) / (psize - size) amplifies a 1-ulp
                # difference of the float32 sizes by psize / (psize - size).
                np.testing.assert_allclose(np_(ct.weights),
                                           np.asarray(cj.weights),
                                           rtol=1e-4, atol=1e-5)
    # Overflow: count exceeds the capacity, padding is M.
    cj = jcut.expand_to_size(nodes, boxes, jnp.float32(0.001),
                             _cam_centers()[2], 64)
    assert int(cj.count) > 64


def test_interpolate_cut_parity():
    h = _hier(300, 4)
    st = jstate.from_arrays(h.xyz, h.shs[:, :1], h.shs[:, 1:], h.alpha,
                            h.scaling, h.rotation, opacity_abs=True)
    params = {k: np.asarray(v) for k, v in st.trainable_dict().items()}
    tparams = {k: t_(v) for k, v in params.items()}
    c = _cam_centers()[0]
    cj = jcut.expand_to_size(h.nodes, h.boxes, jnp.float32(0.05), c, 256)
    ct = tcut.expand_to_size(t_(h.nodes), t_(h.boxes), 0.05, t_(c), 256)
    table_j = jcut.interp_table(params)
    table_t = tcut.interp_table(tparams)
    np.testing.assert_allclose(np_(table_t), np.asarray(table_j),
                               rtol=1e-6, atol=1e-6)
    outs_j = jcut.interpolate_cut(params, cj, table_j)
    for table in (None, table_t):
        outs_t = tcut.interpolate_cut(tparams, ct, table)
        for a, b in zip(outs_t, outs_j):
            # float32 lerp of the same values: 1e-6.
            np.testing.assert_allclose(np_(a), np.asarray(b), rtol=1e-6,
                                       atol=1e-6)
    assert tcut.pixel_limit(3.0, 0.7, 1920) == jcut.pixel_limit(3.0, 0.7,
                                                                1920)


def test_state_from_jax_arrays():
    """Carries a padded, skybox-last JAX state across unchanged."""
    rng = np.random.default_rng(5)
    n = 40
    st = jstate.from_arrays(
        rng.normal(size=(n, 3)), rng.normal(size=(n, 1, 3)),
        rng.normal(size=(n, 15, 3)), rng.normal(size=(n, 1)),
        rng.normal(size=(n, 3)), rng.normal(size=(n, 4)), capacity=48,
        n_skybox=4, skybox_last=True, opacity_abs=True)
    d = {f: np.asarray(getattr(st, f)) for f in
         ("xyz", "features_dc", "features_rest", "scaling", "rotation",
          "opacity", "alive", "max_radii2d", "denom")}
    ts = tstate.state_from_jax_arrays(d, n_skybox=4, skybox_last=True,
                                      opacity_abs=True, device="cpu")
    assert ts.capacity == 48 and ts.n_skybox == 4 and ts.skybox_last
    for f in tstate.TENSOR_FIELDS:
        np.testing.assert_array_equal(np_(getattr(ts, f)), d[f])
    for k, v in ts.trainable_dict().items():
        np.testing.assert_array_equal(np_(v),
                                      np.asarray(st.trainable_dict()[k]))
    # The port's own from_arrays builds the same padded layout.
    rng = np.random.default_rng(5)
    own = tstate.from_arrays(
        rng.normal(size=(n, 3)), rng.normal(size=(n, 1, 3)),
        rng.normal(size=(n, 15, 3)), rng.normal(size=(n, 1)),
        rng.normal(size=(n, 3)), rng.normal(size=(n, 4)), capacity=48,
        n_skybox=4, skybox_last=True, opacity_abs=True)
    for f in tstate.TENSOR_FIELDS:
        np.testing.assert_array_equal(np_(getattr(own, f)), d[f], err_msg=f)


def test_state_from_hierarchy_with_scaffold(tmp_path):
    """Hierarchy rows first, the scaffold's skybox rows last (opacity
    sigmoid-activated), anchors as a mask."""
    h = _hier(80, 6)
    rng = np.random.default_rng(6)
    n_sc, n_sky = 12, 5
    sc_dir = str(tmp_path)
    write_gaussian_ply(
        os.path.join(sc_dir, "point_cloud.ply"),
        rng.normal(size=(n_sc, 3)), rng.normal(size=(n_sc, 1, 3)),
        rng.normal(size=(n_sc, 3, 3)), rng.normal(size=(n_sc, 1)),
        rng.normal(size=(n_sc, 3)), rng.normal(size=(n_sc, 4)))
    with open(os.path.join(sc_dir, "pc_info.txt"), "w") as f:
        f.write(f"{n_sky}\n")
    sj, mj = jinit.state_from_hierarchy(h, sc_dir)
    st, mt = tinit.state_from_hierarchy(h, sc_dir, device="cpu")
    np.testing.assert_array_equal(mt, mj)
    assert mt.sum() == h.anchors.size > 0
    assert (st.n_skybox, st.skybox_last, st.opacity_abs) == (
        sj.n_skybox, sj.skybox_last, sj.opacity_abs) == (n_sky, True, True)
    assert st.capacity == h.n_nodes + n_sky
    for f in tstate.TENSOR_FIELDS:
        np.testing.assert_allclose(np_(getattr(st, f)),
                                   np.asarray(getattr(sj, f)), rtol=1e-7,
                                   err_msg=f)
