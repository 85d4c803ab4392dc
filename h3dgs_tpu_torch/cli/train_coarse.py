"""Coarse scaffold training entry point (train_coarse.py equivalent;
counterpart of ``h3dgs_tpu/cli/train_coarse.py``).

Usage:
  python -m h3dgs_tpu_torch.cli.train_coarse -s <aligned colmap> -m <out> \
      --skybox_num 100000 --position_lr_init 0.00016 ... [--device cpu]

Runs on the CUDA card unless ``--device`` names another device; without
CUDA and without ``--device`` it raises.
"""
from __future__ import annotations

import sys


def main(argv=None):
    from ..parallel import multihost
    from ..scene.scene import Scene
    from ..train.loop import train_flat
    from ..utils.runtime import resolve_device
    from ..viewer.network_gui import maybe_viewer
    from .common import (add_train_args, build_parser, dump_cfg_args,
                         parse_full_config)

    parser = build_parser("Coarse scaffold training (PyTorch/CUDA)")
    add_train_args(parser, viewer=True)
    cfg, args = parse_full_config(parser, argv)
    # No-op for one process; H3DGS_* variables, torchrun or SLURM start a
    # group of one process per card.
    multihost.initialize(device=args.device)
    device = resolve_device(args.device)
    cfg.model.sh_degree = 1  # the scaffold is degree 1
    if multihost.is_primary():
        dump_cfg_args(cfg)
    saves = sorted(set(args.save_iterations + [cfg.opt.iterations]))

    scene = Scene(cfg.model, cfg.runtime, device=device)
    viewer = maybe_viewer(args) if multihost.is_primary() else None
    try:
        train_flat(cfg, scene, coarse=True, save_iterations=saves,
                   checkpoint_iterations=args.checkpoint_iterations,
                   start_checkpoint=args.start_checkpoint, viewer=viewer)
    finally:
        if viewer is not None:
            viewer.close()
    if multihost.is_primary():
        print("Training complete.")


if __name__ == "__main__":
    main(sys.argv[1:])
