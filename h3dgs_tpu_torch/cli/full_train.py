"""End-to-end training orchestrator (scripts/full_train.py equivalent;
counterpart of ``h3dgs_tpu/cli/full_train.py``).

Runs: coarse scaffold -> per chunk (train_single -> hierarchy creator ->
train_post) -> hierarchy merger, each stage a child process running a
module of this package (``h3dgs_tpu_torch.cli.*``). Stage flow, directory
layout, resume (--skip_if_exists) and fault tolerance (--keep_running)
are the reference's.

Execution backends:
  * local sequential (default),
  * local process pool (--n_jobs N; spawned workers, one chunk each),
  * SLURM (--use_slurm: sbatch + sacct polling, 10 s interval), one
    chunk job per node (``full_train_chunk``).

``--extra_training_args`` go to the three training stages (coarse,
single, post); the children run on the CUDA card unless those arguments
name another ``--device``.

  python -m h3dgs_tpu_torch.cli.full_train --project_dir <dir> [--use_slurm]
"""
from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

def submit_job(slurm_args):
    """sbatch submit; returns job id."""
    try:
        result = subprocess.run(slurm_args, capture_output=True, check=True,
                                text=True)
    except subprocess.CalledProcessError as e:
        raise RuntimeError(f"Error submitting job: {e.stderr}") from e
    return result.stdout.strip().split()[-1]


def is_job_finished(job_id: str) -> str:
    """Terminal sacct state, or '' while running."""
    sacct = subprocess.run(
        ["sacct", "-j", job_id, "--format=State", "--noheader",
         "--parsable2"], capture_output=True, text=True)
    states = sacct.stdout.split()
    if not states:
        return ""
    s = states[0]
    return s if s in ("COMPLETED", "FAILED", "CANCELLED", "TIMEOUT") else ""


def _run(cmd, keep_running: bool, what: str) -> bool:
    print(f"+ {' '.join(cmd)}", flush=True)
    try:
        subprocess.run(cmd, check=True)
        return True
    except subprocess.CalledProcessError as e:
        print(f"Error executing {what}: {e}", flush=True)
        if not keep_running:
            sys.exit(1)
        return False


def setup_dirs(args):
    p = args.project_dir
    images = args.images_dir or os.path.join(
        p, "camera_calibration/rectified/images")
    depths = args.depths_dir or os.path.join(
        p, "camera_calibration/rectified/depths")
    masks = args.masks_dir
    if not masks:
        cand = os.path.join(p, "camera_calibration/rectified/masks")
        masks = cand if os.path.exists(cand) else ""
    colmap = args.colmap_dir or os.path.join(p, "camera_calibration/aligned")
    chunks = args.chunks_dir or os.path.join(p, "camera_calibration/chunks")
    output = args.output_dir or os.path.join(p, "output")
    return images, depths, masks, colmap, chunks, output


def process_chunk(chunk_name: str, chunks_dir: str, output_dir: str,
                  images: str, depths: str, masks: str, extra: str,
                  iterations: int, keep_running: bool,
                  skip_if_exists: bool) -> bool:
    py = sys.executable
    source_chunk = os.path.join(chunks_dir, chunk_name)
    trained = os.path.join(output_dir, "trained_chunks", chunk_name)
    scaffold = os.path.join(output_dir,
                            f"scaffold/point_cloud/iteration_{iterations}")
    if skip_if_exists and os.path.exists(
            os.path.join(trained, "hierarchy.hier_opt")):
        print(f"Skipping {chunk_name}", flush=True)
        return True

    cmd = [py, "-m", "h3dgs_tpu_torch.cli.train_single",
           "-s", source_chunk, "--model_path", trained,
           "-i", images,
           "--scaffold_file", scaffold,
           "--bounds_file", source_chunk,
           "--skybox_locked", "--disable_viewer",
           "--iterations", str(iterations)]
    if depths and os.path.isdir(os.path.join(source_chunk, depths)
                                if not os.path.isabs(depths) else depths):
        cmd += ["--depths", depths]
    if masks:
        cmd += ["--alpha_masks", masks]
    if extra:
        cmd += extra.split()
    if not _run(cmd, keep_running, "train_single"):
        return False

    ply = os.path.join(trained,
                       f"point_cloud/iteration_{iterations}/point_cloud.ply")
    if not _run([py, "-m", "h3dgs_tpu_torch.cli.hierarchy_creator",
                 ply, source_chunk, trained, scaffold],
                keep_running, "hierarchy_creator"):
        return False

    cmd = [py, "-m", "h3dgs_tpu_torch.cli.train_post",
           "-s", source_chunk, "--model_path", trained,
           "--hierarchy", os.path.join(trained, "hierarchy.hier"),
           "-i", images, "--scaffold_file", scaffold,
           "--iterations", "15000", "--feature_lr", "0.0005",
           "--opacity_lr", "0.01", "--scaling_lr", "0.001",
           "--skybox_locked"]
    if masks:
        cmd += ["--alpha_masks", masks]
    if extra:
        cmd += extra.split()
    return _run(cmd, keep_running, "train_post")


def main(argv=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("--project_dir", required=True)
    parser.add_argument("--extra_training_args", default="")
    parser.add_argument("--colmap_dir", default="")
    parser.add_argument("--images_dir", default="")
    parser.add_argument("--masks_dir", default="")
    parser.add_argument("--depths_dir", default="")
    parser.add_argument("--chunks_dir", default="")
    parser.add_argument("--output_dir", default="")
    parser.add_argument("--use_slurm", action="store_true")
    parser.add_argument("--n_jobs", type=int, default=1,
                        help="local parallel chunk workers")
    parser.add_argument("--skip_if_exists", action="store_true")
    parser.add_argument("--keep_running", action="store_true")
    parser.add_argument("--iterations", type=int, default=30_000)
    args = parser.parse_args(argv)

    py = sys.executable
    images, depths, masks, colmap_dir, chunks_dir, output_dir = \
        setup_dirs(args)
    os.makedirs(os.path.join(output_dir, "scaffold"), exist_ok=True)
    os.makedirs(os.path.join(output_dir, "trained_chunks"), exist_ok=True)
    t0 = time.time()

    # --- coarse scaffold ---
    scaffold_ply = os.path.join(
        output_dir, f"scaffold/point_cloud/iteration_{args.iterations}/"
        "point_cloud.ply")
    if args.skip_if_exists and os.path.exists(scaffold_ply):
        print("Skipping coarse", flush=True)
    else:
        cmd = [py, "-m", "h3dgs_tpu_torch.cli.train_coarse",
               "-s", colmap_dir, "-i", images,
               "--skybox_num", "100000", "--disable_viewer",
               "--model_path", os.path.join(output_dir, "scaffold"),
               "--iterations", str(args.iterations)]
        if masks:
            cmd += ["--alpha_masks", masks]
        if args.extra_training_args:
            cmd += args.extra_training_args.split()
        _run(cmd, keep_running=False, what="train_coarse")

    # --- per-chunk pipeline ---
    chunk_names = sorted(os.listdir(chunks_dir))
    ok_chunks = []
    if args.use_slurm:
        job_ids = {}
        for name in chunk_names:
            trained = os.path.join(output_dir, "trained_chunks", name)
            os.makedirs(trained, exist_ok=True)
            job_ids[name] = submit_job(
                ["sbatch", f"--error={trained}/log.err",
                 f"--output={trained}/log.out",
                 f"--job-name=h3dgs_{name}",
                 "--wrap=" + " ".join(
                     [py, "-m", "h3dgs_tpu_torch.cli.full_train_chunk",
                      name, chunks_dir, output_dir, images, depths,
                      f"'{masks}'", str(args.iterations)]
                     + (["--skip_if_exists"] if args.skip_if_exists else [])
                     + (["--keep_running"] if args.keep_running else [])
                     + (["--extra", args.extra_training_args]
                        if args.extra_training_args else []))])
        pending = dict(job_ids)
        while pending:
            for name, jid in list(pending.items()):
                s = is_job_finished(jid)
                if s:
                    print(f"chunk {name}: {s}", flush=True)
                    if s == "COMPLETED":
                        ok_chunks.append(name)
                    del pending[name]
            if pending:
                time.sleep(10)
    elif args.n_jobs > 1:
        import concurrent.futures as cf
        import multiprocessing

        with cf.ProcessPoolExecutor(
                max_workers=args.n_jobs,
                mp_context=multiprocessing.get_context("spawn")) as pool:
            futs = {pool.submit(
                process_chunk, name, chunks_dir, output_dir, images,
                depths, masks, args.extra_training_args, args.iterations,
                True, args.skip_if_exists): name for name in chunk_names}
            failed = []
            for f in cf.as_completed(futs):
                if f.result():
                    ok_chunks.append(futs[f])
                else:
                    failed.append(futs[f])
            if failed and not args.keep_running:
                print(f"chunks failed: {failed}", flush=True)
                sys.exit(1)
    else:
        for name in chunk_names:
            if process_chunk(name, chunks_dir, output_dir, images, depths,
                             masks, args.extra_training_args,
                             args.iterations, args.keep_running,
                             args.skip_if_exists):
                ok_chunks.append(name)

    print(f"Trained in {(time.time() - t0) / 60:.1f} min; consolidating...",
          flush=True)

    # --- consolidation ---
    _run([py, "-m", "h3dgs_tpu_torch.cli.hierarchy_merger",
          os.path.join(output_dir, "trained_chunks"), "0", chunks_dir,
          os.path.join(output_dir, "merged.hier")] + sorted(ok_chunks),
         keep_running=False, what="hierarchy_merger")
    print(f"Total time {(time.time() - t0) / 60:.1f} min.", flush=True)


if __name__ == "__main__":
    main()
