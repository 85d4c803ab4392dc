"""Hierarchy rendering + metric evaluation (render_hierarchy.py
equivalent; counterpart of ``h3dgs_tpu/cli/render_hierarchy.py``).

  python -m h3dgs_tpu_torch.cli.render_hierarchy -s <aligned colmap> \
      -m <out> --hierarchy <merged.hier> [--scaffold_file <coarse iter dir>] \
      --taus 0 3 6 15 --eval [--no_images] [--device cpu]

For each granularity tau (pixels), renders every test (or, without any,
train) view through the view-adaptive cut and reports PSNR / SSIM / LPIPS
(``LPIPS_UNAVAILABLE`` when no weights are found, ``eval/metrics.py``),
with the right-half crop under ``--train_test_exp``. Writes
``<out>/metrics.json`` and, unless ``--no_images``, one PNG per view and
tau under ``<out>/renders/tau_<tau>/``. Runs on the CUDA card unless
``--device`` names another device; without CUDA and without ``--device``
it raises.
"""
from __future__ import annotations

import os
import sys

import numpy as np
import torch


@torch.no_grad()
def render_set(scene, cfg, taus, out_dir: str, save_images: bool = True):
    from ..eval import metrics as M
    from ..hierarchy.cut import pixel_limit
    from ..io.image import write_png
    from ..scene.loader import load_view
    from ..train.loop import raster_config
    from ..train.post_step import render_cut

    dev = scene.device
    h = scene.hierarchy
    nodes = torch.as_tensor(h.nodes, device=dev)
    boxes = torch.as_tensor(h.boxes, device=dev)
    r_cfg = raster_config(cfg)
    bg = torch.full((3,), 1.0 if cfg.model.white_background else 0.0,
                    dtype=torch.float32, device=dev)
    cams = scene.info.test_cameras or scene.info.train_cameras
    pre_exp = scene.pretrained_exposures or {}
    results = {}
    for tau in taus:
        psnrs, ssims, lpipss, cut_sizes = [], [], [], []
        tau_dir = os.path.join(out_dir, f"tau_{tau}")
        if save_images:
            os.makedirs(tau_dir, exist_ok=True)
        for vi, info in enumerate(cams):
            view = load_view(info, cfg.model.resolution,
                             train_test_exp=cfg.model.train_test_exp,
                             is_test_dataset=True)
            cam = view.camera.to(dev)
            limit = pixel_limit(tau, float(cam.tanfovx), cam.width)
            exp = pre_exp.get(info.image_name)
            # The cut is sized exactly (max_cut=None). The reference pads
            # it to a bucket of the next power of two >= 1.25 x n_leaves,
            # which never truncates: a cut holds at most n_leaves nodes.
            # So both render the same frame.
            out = render_cut(scene.state, nodes, boxes, cam, limit,
                             cfg.model.sh_degree, bg, r_cfg, None,
                             exposure=(None if exp is None else
                                       torch.as_tensor(exp, device=dev)))
            cut_sizes.append(int(out["cut"].count))
            render = out["render"]       # clipped to [0, 1] by the splat
            img = render
            gt = torch.as_tensor(view.gt_image, device=dev)
            if cfg.model.train_test_exp:  # right half only
                img = img[..., img.shape[-1] // 2:]
                gt = gt[..., gt.shape[-1] // 2:]
            psnrs.append(float(M.psnr(img, gt)))
            ssims.append(float(M.ssim(img, gt)))
            lp = M.lpips(img, gt, device=dev)
            if lp is not None:
                lpipss.append(lp)
            if save_images:
                write_png(os.path.join(tau_dir, f"{vi:05d}.png"),
                          (render.permute(1, 2, 0) * 255).to(torch.uint8)
                          .cpu().numpy())
        res = {"psnr": float(np.mean(psnrs)),
               "ssim": float(np.mean(ssims)),
               # The reference's metric triple always includes LPIPS; when
               # no weights artifact exists the JSON says why instead of a
               # bare null.
               "lpips": (float(np.mean(lpipss)) if lpipss
                         else M.LPIPS_UNAVAILABLE),
               "n_views": len(cams),
               # The cut must coarsen as tau grows.
               "cut_mean": float(np.mean(cut_sizes)),
               "cut_min": int(np.min(cut_sizes)),
               "cut_max": int(np.max(cut_sizes))}
        results[tau] = res
        print(f"tau={tau}: PSNR {res['psnr']:.3f} SSIM {res['ssim']:.4f} "
              f"LPIPS {res['lpips']} cut_mean {res['cut_mean']:.0f}",
              flush=True)
    return results


def main(argv=None):
    import json

    from ..scene.scene import Scene
    from ..utils.runtime import resolve_device
    from .common import build_parser, parse_full_config

    parser = build_parser("Hierarchy rendering and evaluation (PyTorch/CUDA)")
    parser.add_argument("--taus", nargs="+", type=float,
                        default=[0.0, 3.0, 6.0, 15.0])
    parser.add_argument("--no_images", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; raises without "
                             "it)")
    cfg, args = parse_full_config(parser, argv)
    device = resolve_device(args.device)
    scene = Scene(cfg.model, cfg.runtime, create_from_hier=True,
                  device=device)
    out_dir = os.path.join(cfg.model.model_path, "renders")
    results = render_set(scene, cfg, args.taus, out_dir,
                         save_images=not args.no_images)
    with open(os.path.join(cfg.model.model_path, "metrics.json"), "w") as f:
        json.dump({str(k): v for k, v in results.items()}, f, indent=2)
    return results


if __name__ == "__main__":
    main(sys.argv[1:])
