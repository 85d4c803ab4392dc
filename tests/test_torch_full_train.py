"""The port's full_train orchestrator end to end on the CPU: coarse
scaffold -> chunk (train_single -> hierarchy creator -> train_post) ->
merge, in local sequential mode over real child processes on a one-chunk
toy project (the layout of ``tests/test_full_train.py``), then the
``--skip_if_exists`` rerun. Every child is a module of the port and runs
on the CPU because ``--device cpu`` rides in ``--extra_training_args``."""
from __future__ import annotations

import os
import shutil

import numpy as np
import torch

from h3dgs_tpu.hierarchy import io as jhio
from h3dgs_tpu_torch.cli import full_train
from h3dgs_tpu_torch.hierarchy import io as thio

from .synthetic_scene import make_gaussian_scene, ring_cameras, \
    write_colmap_scene

torch.set_num_threads(2)

ITERS = 12
EXTRA = (f"--iterations {ITERS} --skybox_num 0 --capacity_factor 2.0 "
         f"--densify_until_iter 0 --opacity_reset_interval 100000 "
         f"--position_lr_max_steps {ITERS} --device cpu")


def test_full_train_sequential_cpu(tmp_path, capfd, monkeypatch):
    # The children take two CPU threads each, as the test processes do.
    monkeypatch.setenv("OMP_NUM_THREADS", "2")
    proj = str(tmp_path / "proj")
    aligned = os.path.join(proj, "camera_calibration/aligned")
    chunks = os.path.join(proj, "camera_calibration/chunks")
    os.makedirs(aligned)
    os.makedirs(chunks)
    arrays = make_gaussian_scene(n=60, seed=8)
    write_colmap_scene(aligned, *arrays, ring_cameras(n_cams=4), test_every=0)
    # One chunk covering the whole scene: the same COLMAP model + bounds.
    chunk = os.path.join(chunks, "0_0")
    shutil.copytree(os.path.join(aligned, "sparse"),
                    os.path.join(chunk, "sparse"))
    with open(os.path.join(chunk, "center.txt"), "w") as f:
        f.write("0 0 0\n")
    with open(os.path.join(chunk, "extent.txt"), "w") as f:
        f.write("100 100 100\n")

    argv = ["--project_dir", proj,
            "--images_dir", os.path.join(aligned, "images"),
            "--iterations", str(ITERS), "--extra_training_args", EXTRA]
    full_train.main(argv)
    said = capfd.readouterr().out
    children = [ln for ln in said.splitlines() if ln.startswith("+ ")]
    assert [ln.split(" -m ")[1].split()[0] for ln in children] == [
        f"h3dgs_tpu_torch.cli.{m}" for m in (
            "train_coarse", "train_single", "hierarchy_creator",
            "train_post", "hierarchy_merger")]
    # The training stages got the extra arguments, the host stages not.
    assert all(("--device cpu" in ln) == ("hierarchy_" not in ln)
               for ln in children)

    out = os.path.join(proj, "output")
    assert os.path.exists(os.path.join(
        out, f"scaffold/point_cloud/iteration_{ITERS}/point_cloud.ply"))
    trained = os.path.join(out, "trained_chunks/0_0")
    assert os.path.exists(os.path.join(
        trained, f"point_cloud/iteration_{ITERS}/point_cloud.ply"))
    h = thio.read_hier(os.path.join(trained, "hierarchy.hier"))
    h_opt = thio.read_hier(os.path.join(trained, "hierarchy.hier_opt"))
    np.testing.assert_array_equal(h_opt.nodes, h.nodes)
    assert not np.array_equal(h_opt.shs, h.shs)        # post-trained
    merged_path = os.path.join(out, "merged.hier")
    for read in (thio.read_hier, jhio.read_hier):
        merged = read(merged_path)
        merged.validate()
        assert merged.n_leaves == h_opt.n_leaves       # the box holds all
        assert merged.nodes[0, 2] == 1                 # one chunk root

    # Resume: everything exists, so --skip_if_exists re-runs no stage but
    # the merger.
    before = os.path.getmtime(os.path.join(trained, "hierarchy.hier_opt"))
    os.remove(merged_path)
    full_train.main(argv + ["--skip_if_exists"])
    said = capfd.readouterr().out
    assert "Skipping coarse" in said and "Skipping 0_0" in said
    children = [ln for ln in said.splitlines() if ln.startswith("+ ")]
    assert len(children) == 1 and \
        "h3dgs_tpu_torch.cli.hierarchy_merger" in children[0]
    assert os.path.getmtime(
        os.path.join(trained, "hierarchy.hier_opt")) == before
    thio.read_hier(merged_path).validate()
