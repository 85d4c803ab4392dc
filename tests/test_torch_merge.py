"""Parity of the port's hierarchy merger with the JAX package's numpy
merger: ``prune_to_box`` and ``merge_hierarchies`` bit-equal on the scenes
of ``tests/test_merge.py`` (two chunks with out-of-box duplicates, three
chunks under a wide root, a merged tree pruned again), the merger CLI's
``merged.hier`` byte for byte against ``h3dgs_tpu.cli.hierarchy_merger
--backend numpy``, the ``.hier`` fallback, and the backends the port does
not have."""
from __future__ import annotations

import dataclasses
import os

import numpy as np
import pytest
import torch

from h3dgs_tpu.cli import hierarchy_merger as jmerger
from h3dgs_tpu.hierarchy import io as jhio
from h3dgs_tpu.hierarchy import merge as jmerge
from h3dgs_tpu.hierarchy import tree as jtree
from h3dgs_tpu.io import meta as jmeta
from h3dgs_tpu_torch.cli import hierarchy_merger as tmerger
from h3dgs_tpu_torch.hierarchy import cut as tcut
from h3dgs_tpu_torch.hierarchy import io as thio
from h3dgs_tpu_torch.hierarchy import merge as tmerge
from h3dgs_tpu_torch.hierarchy import tree as ttree

from .test_merge import _chunk_hierarchy
from .utils import random_scene

torch.set_num_threads(2)

FIELDS = [f.name for f in dataclasses.fields(jtree.Hierarchy)]


def _port(h) -> ttree.Hierarchy:
    """The same hierarchy as the port's dataclass (copies)."""
    return ttree.Hierarchy(**{f: np.array(getattr(h, f)) for f in FIELDS})


def _assert_bit_equal(th, jh):
    for f in FIELDS:
        got, want = getattr(th, f), np.asarray(getattr(jh, f))
        assert got.dtype == want.dtype, (f, got.dtype, want.dtype)
        np.testing.assert_array_equal(got, want, err_msg=f)


def _two_chunks():
    (h0, _), (h1, _) = _chunk_hierarchy(-2.0, seed=1), \
        _chunk_hierarchy(2.0, seed=2)
    centers = [np.asarray([-2.0, 0, 0]), np.asarray([2.0, 0, 0])]
    extents = [np.asarray([4.0, 8.0, 8.0])] * 2
    return [h0, h1], centers, extents


def _three_chunks():
    hs, centers, extents = [], [], []
    for i, cx in enumerate((-2.0, 2.0, 6.0)):
        means, scales, quats, opac, shs = random_scene(40, seed=i,
                                                       sh_degree=1)
        means = means + np.array([cx, 0.0, 0.0], np.float32)
        hs.append(jtree.build_hierarchy(means, shs, opac, np.log(scales),
                                        quats, backend="numpy"))
        centers.append(np.array([cx, 0.0, 0.0], np.float32))
        extents.append(np.array([4.0, 100.0, 100.0], np.float32))
    return hs, centers, extents


@pytest.mark.parametrize("scene", ["two_chunks", "three_chunks"])
def test_merge_hierarchies_bit_equal(scene):
    """Every field of the merged tree equal to the JAX numpy merger's, in
    value and dtype; the global root has one child per chunk; the tree
    validates."""
    hs, centers, extents = (_two_chunks if scene == "two_chunks"
                            else _three_chunks)()
    want = jmerge.merge_hierarchies(hs, centers, extents)
    got = tmerge.merge_hierarchies([_port(h) for h in hs], centers, extents)
    _assert_bit_equal(got, want)
    got.validate()
    assert got.nodes[got.root, ttree.N_CHILDREN] == len(hs)
    assert got.root == 0


@pytest.mark.parametrize("box", [
    ((-2.0, -2.0, -2.0), (2.0, 2.0, 2.0)),         # a chunk with duplicates
    ((-100.0,) * 3, (100.0,) * 3),                 # merged, all kept
    ((4.5, -100.0, -100.0), (100.0, 100.0, 100.0)),  # merged, third chunk
])
def test_prune_to_box_bit_equal(box):
    """``prune_to_box`` on one chunk (with out-of-box duplicates) and on a
    merged tree whose root has three children: bit-equal to JAX, and the
    kept leaves lie inside the box on X and Y."""
    lo, hi = (np.asarray(b, np.float32) for b in box)
    if box[0][0] == -2.0:
        h, _ = _chunk_hierarchy(0.0)
    else:
        h = jmerge.merge_hierarchies(*_three_chunks())
    want = jmerge.prune_to_box(h, lo, hi)
    got = tmerge.prune_to_box(_port(h), lo, hi)
    _assert_bit_equal(got, want)
    got.validate()
    leaf = got.nodes[:, ttree.N_CHILDREN] == 0
    for a in (0, 1):
        assert np.all((got.xyz[leaf, a] >= lo[a]) & (got.xyz[leaf, a]
                                                      <= hi[a]))
    with pytest.raises(ValueError, match="owns no leaves"):
        tmerge.prune_to_box(_port(h), lo + 1e3, hi + 1e3)


def test_port_cut_partitions_merged_leaves():
    """The port's cut over the merged tree of two chunks covers every
    owned leaf exactly once, at any limit; a huge limit selects the global
    root alone."""
    hs, centers, extents = _two_chunks()
    merged = tmerge.merge_hierarchies([_port(h) for h in hs], centers,
                                      extents)
    nodes, boxes = torch.as_tensor(merged.nodes), torch.as_tensor(
        merged.boxes)
    cam = torch.tensor([0.0, 0.0, -30.0])
    for limit in (1e-8, 0.1, 1e12):
        in_cut = tcut.cut_mask(nodes, boxes, limit, cam)[0].numpy()
        # Leaves under each cut node, counted down the children ranges.
        covered = np.zeros(merged.n_nodes, np.int64)
        frontier = np.nonzero(in_cut)[0]
        while frontier.size:
            nc = merged.nodes[frontier, ttree.N_CHILDREN]
            covered[frontier[nc == 0]] += 1
            fc = merged.nodes[frontier, ttree.FIRST_CHILD]
            frontier = np.concatenate(
                [np.arange(f, f + n) for f, n in zip(fc[nc > 0],
                                                     nc[nc > 0])]
                or [np.zeros(0, np.int64)])
        leaf = merged.nodes[:, ttree.N_CHILDREN] == 0
        assert covered[leaf].min() == covered[leaf].max() == 1, limit
    assert int(tcut.cut_mask(nodes, boxes, 1e12, cam)[0].sum()) == 1


@pytest.fixture()
def chunk_dirs(tmp_path):
    """Two trained chunks in the full_train layout: ``c0`` holds a
    ``hierarchy.hier_opt``, ``c1`` only a ``hierarchy.hier`` (post-opt
    skipped); bounds split the X axis at 0."""
    trained, chunks = str(tmp_path / "trained"), str(tmp_path / "chunks")
    hs, _, _ = _two_chunks()
    for name, h, fname, cx in (("c0", hs[0], "hierarchy.hier_opt", -2.0),
                               ("c1", hs[1], "hierarchy.hier", 2.0)):
        os.makedirs(os.path.join(trained, name))
        os.makedirs(os.path.join(chunks, name))
        jhio.write_hier(os.path.join(trained, name, fname), h)
        jmeta.write_vec(os.path.join(chunks, name, "center.txt"),
                        [cx, 0.0, 0.0])
        jmeta.write_vec(os.path.join(chunks, name, "extent.txt"),
                        [4.0, 8.0, 8.0])
    return trained, chunks


def test_merger_cli_same_bytes(chunk_dirs, tmp_path, capsys):
    """Both CLIs on the same chunks: ``merged.hier`` byte for byte (the
    JAX tool with ``--backend numpy``), the same log lines, and the
    ``.hier`` fallback taken for the chunk without ``.hier_opt``."""
    trained, chunks = chunk_dirs
    j_out, t_out = str(tmp_path / "j" / "merged.hier"), str(
        tmp_path / "t" / "merged.hier")
    jmerger.main([trained, "0", chunks, j_out, "c0", "c1",
                  "--backend", "numpy"])
    j_said = capsys.readouterr().out
    tmerger.main([trained, "0", chunks, t_out, "c0", "c1"])
    t_said = capsys.readouterr().out
    assert t_said == j_said.replace(j_out, t_out)
    assert "hierarchy.hier_opt" in t_said and \
        os.path.join("c1", "hierarchy.hier") + "\n" in t_said
    with open(j_out, "rb") as fj, open(t_out, "rb") as ft:
        assert fj.read() == ft.read()
    merged = thio.read_hier(t_out)
    merged.validate()
    assert merged.nodes[0, ttree.N_CHILDREN] == 2
    tmerger.main([trained, "0", chunks, t_out, "c0", "c1", "--backend",
                  "numpy"])
    with open(j_out, "rb") as fj, open(t_out, "rb") as ft:
        assert fj.read() == ft.read()


def test_merger_backends_not_ported(chunk_dirs, tmp_path):
    """``--backend native`` raises and names the roadmap item (it never
    runs numpy under that name); an unknown backend and a short argument
    list fail too; nothing is written."""
    trained, chunks = chunk_dirs
    out = str(tmp_path / "merged.hier")
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        tmerger.main([trained, "0", chunks, out, "c0", "c1", "--backend",
                      "native"])
    with pytest.raises(ValueError, match="unknown merger backend"):
        tmerger.merge_chunks(trained, chunks, out, ["c0"], backend="cuda")
    with pytest.raises(SystemExit):
        tmerger.main([trained, "0", chunks, out])
    assert not os.path.exists(out)
