"""Hierarchy fine-tuning entry point (train_post.py equivalent; counterpart
of ``h3dgs_tpu/cli/train_post.py``).

Usage:
  python -m h3dgs_tpu_torch.cli.train_post -s <chunk colmap> -m <out> \
      --hierarchy <out/hierarchy.hier> --scaffold_file <coarse iter dir> \
      --iterations 15000 --skybox_locked [--device cpu]

Writes ``<hierarchy>_opt``. Runs on the CUDA card unless ``--device`` names
another device; without CUDA and without ``--device`` it raises.
``--views_per_step`` and ``--data_devices`` as in ``train_single``.
"""
from __future__ import annotations

import sys


def main(argv=None):
    from ..parallel import multihost
    from ..scene.scene import Scene
    from ..train.loop import train_post
    from ..utils.runtime import resolve_device
    from .common import (add_train_args, build_parser, dump_cfg_args,
                         parse_full_config)

    parser = build_parser("Hierarchy post-optimization (PyTorch/CUDA)")
    add_train_args(parser, viewer=False)
    cfg, args = parse_full_config(parser, argv)
    # No-op for one process; H3DGS_* variables, torchrun or SLURM start a
    # group of one process per card.
    multihost.initialize(device=args.device)
    device = resolve_device(args.device)
    if multihost.is_primary():
        dump_cfg_args(cfg)
    saves = sorted(set(args.save_iterations + [cfg.opt.iterations]))

    scene = Scene(cfg.model, cfg.runtime, create_from_hier=True,
                  device=device)
    train_post(cfg, scene, save_iterations=saves,
               checkpoint_iterations=args.checkpoint_iterations,
               start_checkpoint=args.start_checkpoint)
    if multihost.is_primary():
        print("Training complete.")


if __name__ == "__main__":
    main(sys.argv[1:])
