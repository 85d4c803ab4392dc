"""One process of a two-process CPU run of the port's data-parallel
``train_flat`` (torch.distributed with gloo over local TCP), for
tests/test_torch_parallel.py. Imports the port only.

  python tests/torch_dp_worker.py --scene <colmap dir> --out <file.pt> \
      --pid <rank> --nproc <n> --port <tcp port> [--iters 4] \
      [--views_per_step 4]

The primary writes the final parameters and exposures to ``--out``.
"""
import argparse
import os
import sys


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--scene", required=True)
    ap.add_argument("--out", required=True)
    ap.add_argument("--pid", type=int, required=True)
    ap.add_argument("--nproc", type=int, required=True)
    ap.add_argument("--port", type=int, required=True)
    ap.add_argument("--iters", type=int, default=4)
    ap.add_argument("--views_per_step", type=int, default=4)
    args = ap.parse_args()

    sys.path.insert(0, os.path.dirname(os.path.dirname(
        os.path.abspath(__file__))))
    import torch

    from h3dgs_tpu_torch.config import (FullConfig, ModelConfig,
                                        OptimizationConfig, RuntimeConfig)
    from h3dgs_tpu_torch.parallel import multihost
    from h3dgs_tpu_torch.scene.scene import Scene
    from h3dgs_tpu_torch.train.loop import train_flat

    torch.set_num_threads(2)
    multihost.initialize(coordinator=f"localhost:{args.port}",
                         num_processes=args.nproc, process_id=args.pid,
                         device="cpu")
    assert multihost.process_count() == args.nproc
    cfg = FullConfig(
        model=ModelConfig(source_path=args.scene,
                          model_path=args.out + f".model{args.pid}",
                          resolution=1),
        opt=OptimizationConfig(iterations=args.iters,
                               densify_from_iter=10**9,
                               densify_until_iter=0,
                               opacity_reset_interval=10**9,
                               position_lr_max_steps=args.iters),
        runtime=RuntimeConfig(capacity_factor=2.0,
                              data_devices=args.nproc,
                              views_per_step=args.views_per_step))
    scene = Scene(cfg.model, cfg.runtime, device="cpu")
    state, exposure = train_flat(cfg, scene)
    if multihost.is_primary():
        torch.save({"xyz": state.xyz, "opacity": state.opacity,
                    "scaling": state.scaling,
                    "features_dc": state.features_dc,
                    "exposure": exposure}, args.out)
    multihost.barrier()
    torch.distributed.destroy_process_group()
    print(f"worker {args.pid} done", flush=True)


if __name__ == "__main__":
    main()
