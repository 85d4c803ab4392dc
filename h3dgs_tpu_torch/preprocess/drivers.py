"""Preprocessing pipeline drivers (COLMAP stays an external binary).

The port's own copy of ``h3dgs_tpu/preprocess/drivers.py``: the same
sub-commands, flags and COLMAP command lines, plus ``--device`` for the
steps that do array work (masks, chunking, depth calibration), which run
on the CUDA card unless it says otherwise.

Equivalents of the reference's top-level preprocessing scripts
(preprocess/{generate_colmap,prepare_chunk,generate_chunks,
generate_depth,concat_chunks_info,copy_file_to_chunks}.py; pipeline
documented at its README.md:111-147): global calibration (feature
extraction, custom matching, hierarchical mapper, simplify, undistort,
mask undistortion trick, auto-reorient), per-chunk refinement (distance
matching, two rounds of triangulation + bundle adjustment with fixed
intrinsics, sim3 re-anchor), and monocular depth generation hooks.

Run: python -m h3dgs_tpu_torch.preprocess.drivers colmap|chunks|depth|
prepare_chunk ... [--device cpu]
"""
from __future__ import annotations

import dataclasses
import os
import shutil
import subprocess
import sys
from typing import List

from ..utils.runtime import DeviceLike, resolve_device


def _run(cmd: List[str], what: str) -> None:
    print(f"+ {' '.join(map(str, cmd))}", flush=True)
    try:
        subprocess.run(cmd, check=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        print(f"Error executing {what}: {e}")
        sys.exit(1)


def _replace_images_by_masks(images_bin: str, out_bin: str) -> None:
    """Point image records at .png masks so the undistorter rectifies the
    masks exactly like the images (generate_colmap.py:18-34)."""
    from ..io import colmap as C
    images = C.read_images_binary(images_bin)
    out = {}
    for k, im in images.items():
        stem = os.path.splitext(im.name)[0]
        out[k] = dataclasses.replace(im, name=stem + ".png")
    C.write_images_binary(out_bin, out)


def generate_colmap(project_dir: str, images_dir: str = "",
                    masks_dir: str = "", colmap_exe: str = "colmap",
                    device: DeviceLike = None) -> None:
    """Global calibration pipeline (generate_colmap.py flow)."""
    from .masks import make_masks_uint8
    from .matchers import make_matcher_file
    from .reorient import auto_reorient
    from .simplify import simplify_images

    images_dir = images_dir or os.path.join(project_dir, "inputs/images")
    if not masks_dir:
        cand = os.path.join(project_dir, "inputs/masks")
        masks_dir = cand if os.path.exists(cand) else ""
    if masks_dir:
        device = resolve_device(device)
    cc = os.path.join(project_dir, "camera_calibration")
    unrect = os.path.join(cc, "unrectified")
    os.makedirs(os.path.join(unrect, "sparse"), exist_ok=True)
    os.makedirs(os.path.join(cc, "aligned/sparse/0"), exist_ok=True)
    os.makedirs(os.path.join(cc, "rectified"), exist_ok=True)
    db = os.path.join(unrect, "database.db")

    _run([colmap_exe, "feature_extractor",
          "--database_path", db, "--image_path", images_dir,
          "--ImageReader.single_camera", "1",
          "--ImageReader.default_focal_length_factor", "0.5",
          "--ImageReader.camera_model", "OPENCV"],
         "colmap feature_extractor")
    matching = os.path.join(unrect, "matching.txt")
    make_matcher_file(images_dir, matching)
    _run([colmap_exe, "matches_importer", "--database_path", db,
          "--match_list_path", matching], "colmap matches_importer")
    _run([colmap_exe, "hierarchical_mapper", "--database_path", db,
          "--image_path", images_dir,
          "--output_path", os.path.join(unrect, "sparse"),
          "--Mapper.ba_global_function_tolerance", "0.000001"],
         "colmap hierarchical_mapper")
    simplify_images(os.path.join(unrect, "sparse/0"))
    _run([colmap_exe, "image_undistorter", "--image_path", images_dir,
          "--input_path", os.path.join(unrect, "sparse/0"),
          "--output_path", os.path.join(cc, "rectified"),
          "--output_type", "COLMAP", "--max_image_size", "2048"],
         "colmap image_undistorter")

    if masks_dir:
        mask_model = os.path.join(unrect, "sparse/0/masks")
        os.makedirs(mask_model, exist_ok=True)
        for f in ("cameras.bin", "points3D.bin"):
            shutil.copy(os.path.join(unrect, "sparse/0", f),
                        os.path.join(mask_model, f))
        _replace_images_by_masks(
            os.path.join(unrect, "sparse/0/images.bin"),
            os.path.join(mask_model, "images.bin"))
        tmp = os.path.join(cc, "tmp")
        _run([colmap_exe, "image_undistorter", "--image_path", masks_dir,
              "--input_path", mask_model, "--output_path", tmp,
              "--output_type", "COLMAP", "--max_image_size", "2048"],
             "colmap image_undistorter (masks)")
        make_masks_uint8(os.path.join(tmp, "images"),
                         os.path.join(cc, "rectified/masks"),
                         device=device)
        shutil.rmtree(tmp)

    auto_reorient(os.path.join(cc, "rectified/sparse"),
                  os.path.join(cc, "aligned/sparse/0"))


def prepare_chunk(raw_chunk: str, out_chunk: str, images_dir: str,
                  colmap_exe: str = "colmap") -> None:
    """Per-chunk refinement: 2 rounds of triangulation + bundle adjustment
    with fixed intrinsics, then sim3 re-anchor (prepare_chunk.py flow)."""
    from .colmap_db import fill_database
    from .matchers import make_distance_matcher_file
    from .transform import transform_colmap

    bundle = os.path.join(out_chunk, "bundle_adjustment")
    os.makedirs(os.path.join(bundle, "sparse/0"), exist_ok=True)
    db = os.path.join(bundle, "database.db")
    fill_database(db, os.path.join(raw_chunk, "sparse/0"))

    matching = os.path.join(bundle, "matching.txt")
    make_distance_matcher_file(os.path.join(raw_chunk, "sparse/0"),
                               matching, n_neighbours=200)
    _run([colmap_exe, "feature_extractor", "--database_path", db,
          "--image_path", images_dir,
          "--image_list_path", _image_list(raw_chunk, bundle)],
         "colmap feature_extractor (chunk)")
    _run([colmap_exe, "matches_importer", "--database_path", db,
          "--match_list_path", matching],
         "colmap matches_importer (chunk)")

    model_in = os.path.join(raw_chunk, "sparse/0")
    for round_i in range(2):
        tri_out = os.path.join(bundle, f"sparse/t{round_i}")
        os.makedirs(tri_out, exist_ok=True)
        _run([colmap_exe, "point_triangulator", "--database_path", db,
              "--image_path", images_dir, "--input_path", model_in,
              "--output_path", tri_out,
              "--Mapper.ba_global_function_tolerance", "0.000001"],
             "colmap point_triangulator")
        ba_out = os.path.join(bundle, f"sparse/b{round_i}")
        os.makedirs(ba_out, exist_ok=True)
        _run([colmap_exe, "bundle_adjuster", "--input_path", tri_out,
              "--output_path", ba_out,
              "--BundleAdjustment.refine_focal_length", "0",
              "--BundleAdjustment.refine_extra_params", "0",
              "--BundleAdjustment.refine_principal_point", "0"],
             "colmap bundle_adjuster")
        model_in = ba_out

    refined = os.path.join(bundle, "refined")
    os.makedirs(os.path.join(refined, "sparse/0"), exist_ok=True)
    for f in os.listdir(model_in):
        shutil.copy(os.path.join(model_in, f),
                    os.path.join(refined, "sparse/0", f))
    transform_colmap(raw_chunk, refined, out_chunk)


def _image_list(raw_chunk: str, out_dir: str) -> str:
    from ..io import colmap as C
    _, images, _ = C.read_model(os.path.join(raw_chunk, "sparse/0"))
    path = os.path.join(out_dir, "image_list.txt")
    with open(path, "w") as f:
        for im in images.values():
            f.write(im.name + "\n")
    return path


def generate_chunks(project_dir: str, images_dir: str = "",
                    chunk_size: float = 100.0, n_jobs: int = 8,
                    min_n_cams: int = 100, max_n_cams: int = 1500,
                    lapla_thresh: float = 1.0, skip_bundle_adjustment=False,
                    colmap_exe: str = "colmap",
                    device: DeviceLike = None) -> None:
    """Chunk splitting + per-chunk refinement + chunks.txt
    (generate_chunks.py flow)."""
    from ..io.meta import write_chunks_txt
    from .chunk import make_chunks

    cc = os.path.join(project_dir, "camera_calibration")
    images_dir = images_dir or os.path.join(cc, "rectified/images")
    aligned = os.path.join(cc, "aligned")
    raw_dir = os.path.join(cc, "raw_chunks")
    chunks_dir = os.path.join(cc, "chunks")
    os.makedirs(chunks_dir, exist_ok=True)

    written = make_chunks(aligned, images_dir, raw_dir, chunk_size,
                          min_n_cams=min_n_cams, max_n_cams=max_n_cams,
                          lapla_thresh=lapla_thresh, device=device)

    if skip_bundle_adjustment:
        for c in written:
            src = os.path.join(raw_dir, c["name"])
            dst = os.path.join(chunks_dir, c["name"])
            if os.path.exists(dst):
                shutil.rmtree(dst)
            shutil.copytree(src, dst)
    else:
        import concurrent.futures as cf
        with cf.ThreadPoolExecutor(max_workers=n_jobs) as pool:
            futs = [pool.submit(prepare_chunk,
                                os.path.join(raw_dir, c["name"]),
                                os.path.join(chunks_dir, c["name"]),
                                images_dir, colmap_exe) for c in written]
            for f in futs:
                f.result()

    write_chunks_txt(os.path.join(chunks_dir, "chunks.txt"), written)


def generate_depth(project_dir: str, depth_tool_cmd: str = "",
                   device: DeviceLike = None) -> None:
    """Monocular depth + per-chunk calibration (generate_depth.py flow).

    The depth network stays an external pluggable tool (Depth-Anything-V2
    or DPT in the reference): ``depth_tool_cmd`` is a shell template run
    per image folder with {images} and {out} placeholders, producing
    16-bit grayscale inverse-depth PNGs. Calibration (depth_params.json)
    then runs for the aligned scene and every chunk.
    """
    from .depth_scale import make_chunks_depth_scale, make_depth_scale

    device = resolve_device(device)
    cc = os.path.join(project_dir, "camera_calibration")
    images = os.path.join(cc, "rectified/images")
    depths = os.path.join(cc, "rectified/depths")
    if depth_tool_cmd:
        os.makedirs(depths, exist_ok=True)
        cmd = depth_tool_cmd.format(images=images, out=depths)
        print(f"+ {cmd}", flush=True)
        subprocess.run(cmd, shell=True, check=True)
    elif not os.path.isdir(depths):
        print(f"no depth tool given and {depths} missing — skipping "
              "generation, only calibrating existing maps")
        return
    make_depth_scale(os.path.join(cc, "aligned"), depths, device)
    make_chunks_depth_scale(os.path.join(cc, "chunks"), depths, device)


def concat_chunks_info(chunks_dir: str, output: str = "") -> None:
    """chunks.txt from per-chunk center/extent (concat_chunks_info.py)."""
    from ..io.meta import read_vec, write_chunks_txt
    chunks = []
    for name in sorted(os.listdir(chunks_dir)):
        base = os.path.join(chunks_dir, name)
        if os.path.exists(os.path.join(base, "center.txt")):
            chunks.append({
                "name": name,
                "center": read_vec(os.path.join(base, "center.txt")),
                "extent": read_vec(os.path.join(base, "extent.txt"))})
    write_chunks_txt(output or os.path.join(chunks_dir, "chunks.txt"),
                     chunks)


def copy_file_to_chunks(file: str, chunks_dir: str,
                        dest_rel: str = "sparse/0") -> None:
    """Copy e.g. test.txt into every chunk (copy_file_to_chunks.py)."""
    for name in sorted(os.listdir(chunks_dir)):
        dst_dir = os.path.join(chunks_dir, name, dest_rel)
        if os.path.isdir(dst_dir):
            shutil.copy(file, dst_dir)


def main(argv=None):
    import argparse
    p = argparse.ArgumentParser(description=__doc__)
    sub = p.add_subparsers(dest="cmd", required=True)
    g = sub.add_parser("colmap")
    g.add_argument("--project_dir", required=True)
    g.add_argument("--images_dir", default="")
    g.add_argument("--masks_dir", default="")
    c = sub.add_parser("chunks")
    c.add_argument("--project_dir", required=True)
    c.add_argument("--images_dir", default="")
    c.add_argument("--chunk_size", type=float, default=100)
    c.add_argument("--n_jobs", type=int, default=8)
    c.add_argument("--min_n_cams", type=int, default=100)
    c.add_argument("--max_n_cams", type=int, default=1500)
    c.add_argument("--lapla_thresh", type=float, default=1.0)
    c.add_argument("--skip_bundle_adjustment", action="store_true")
    d = sub.add_parser("depth")
    d.add_argument("--project_dir", required=True)
    d.add_argument("--depth_tool_cmd", default="")
    # Single-chunk worker (what scripts/prepare_chunk.slurm dispatches).
    pc = sub.add_parser("prepare_chunk")
    pc.add_argument("--raw_chunk", required=True)
    pc.add_argument("--out_chunk", required=True)
    pc.add_argument("--images_dir", required=True)
    pc.add_argument("--colmap_exe", default="colmap")
    for q in (g, c, d):
        q.add_argument("--device", default=None,
                       help="torch device (default: the CUDA card)")
    a = p.parse_args(argv)
    if a.cmd == "colmap":
        generate_colmap(a.project_dir, a.images_dir, a.masks_dir,
                        device=a.device)
    elif a.cmd == "chunks":
        generate_chunks(a.project_dir, a.images_dir, a.chunk_size, a.n_jobs,
                        a.min_n_cams, a.max_n_cams, a.lapla_thresh,
                        a.skip_bundle_adjustment, device=a.device)
    elif a.cmd == "prepare_chunk":
        prepare_chunk(a.raw_chunk, a.out_chunk, a.images_dir, a.colmap_exe)
    else:
        generate_depth(a.project_dir, a.depth_tool_cmd, a.device)


if __name__ == "__main__":
    main()
