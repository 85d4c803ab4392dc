"""Per-chunk training entry point (train_single.py equivalent; counterpart
of ``h3dgs_tpu/cli/train_single.py``).

Usage:
  python -m h3dgs_tpu_torch.cli.train_single -s <chunk colmap> -m <out> \
      --scaffold_file <coarse iter dir> --bounds_file <chunk dir> \
      --skybox_locked --depths depths --alpha_masks masks [--device cpu]

Runs on the CUDA card unless ``--device`` names another device; without
CUDA and without ``--device`` it raises. ``--views_per_step N`` takes N
views a step (``parallel/step.py``); ``--data_devices P`` shares them
over P processes, one card each, started with ``torchrun
--nproc_per_node P`` or with ``H3DGS_COORDINATOR`` /
``H3DGS_NUM_PROCESSES`` / ``H3DGS_PROCESS_ID`` (``parallel/multihost.py``).
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

    parser = build_parser("Per-chunk 3D Gaussian training (PyTorch/CUDA)")
    add_train_args(parser, viewer=True)
    cfg, args = parse_full_config(parser, argv)
    # No-op for one process; H3DGS_* variables, torchrun or SLURM start a
    # group of one process per card.
    multihost.initialize(device=args.device)
    device = resolve_device(args.device)
    if multihost.is_primary():
        dump_cfg_args(cfg)
    saves = sorted(set(args.save_iterations + [cfg.opt.iterations]))

    scene = Scene(cfg.model, cfg.runtime, device=device)
    viewer = maybe_viewer(args) if multihost.is_primary() else None
    try:
        train_flat(cfg, scene, coarse=False, save_iterations=saves,
                   checkpoint_iterations=args.checkpoint_iterations,
                   start_checkpoint=args.start_checkpoint, viewer=viewer)
    finally:
        if viewer is not None:
            viewer.close()
    if multihost.is_primary():
        print("Training complete.")


if __name__ == "__main__":
    main(sys.argv[1:])
