"""Per-chunk training entry point (train_single.py equivalent; counterpart
of ``h3dgs_tpu/cli/train_single.py``).

Usage:
  python -m h3dgs_tpu_torch.cli.train_single -s <chunk colmap> -m <out> \
      --scaffold_file <coarse iter dir> --bounds_file <chunk dir> \
      --skybox_locked --depths depths --alpha_masks masks [--device cpu]

Runs on the CUDA card unless ``--device`` names another device; without
CUDA and without ``--device`` it raises.
"""
from __future__ import annotations

import sys


def main(argv=None):
    from ..scene.scene import Scene
    from ..train.loop import train_flat
    from ..utils.runtime import resolve_device
    from ..viewer.network_gui import maybe_viewer
    from .common import build_parser, dump_cfg_args, parse_full_config

    parser = build_parser("Per-chunk 3D Gaussian training (PyTorch/CUDA)")
    parser.add_argument("--save_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--checkpoint_iterations", nargs="+", type=int,
                        default=[])
    parser.add_argument("--start_checkpoint", type=str, default="")
    parser.add_argument("--ip", type=str, default="127.0.0.1")
    parser.add_argument("--port", type=int, default=6009)
    parser.add_argument("--disable_viewer", action="store_true")
    parser.add_argument("--device", default=None,
                        help="torch device (default: cuda; raises without "
                             "it)")
    cfg, args = parse_full_config(parser, argv)
    device = resolve_device(args.device)
    if args.checkpoint_iterations or args.start_checkpoint:
        raise NotImplementedError(
            "checkpoints (train/checkpoint.py) are not ported yet")
    dump_cfg_args(cfg)
    saves = sorted(set(args.save_iterations + [cfg.opt.iterations]))

    scene = Scene(cfg.model, cfg.runtime, device=device)
    viewer = maybe_viewer(args)
    try:
        train_flat(cfg, scene, coarse=False, save_iterations=saves,
                   viewer=viewer)
    finally:
        if viewer is not None:
            viewer.close()
    print("Training complete.")


if __name__ == "__main__":
    main(sys.argv[1:])
