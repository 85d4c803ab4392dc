"""Single-chunk pipeline job (train_chunk.slurm equivalent; counterpart of
``h3dgs_tpu/cli/full_train_chunk.py``): runs train_single -> hierarchy
creator -> train_post for one chunk. Started by full_train's SLURM backend
through sbatch --wrap.

  python -m h3dgs_tpu_torch.cli.full_train_chunk <chunk_name> <chunks_dir>
      <output_dir> <images> <depths> <masks> <iterations>
      [--skip_if_exists] [--keep_running] [--extra <args...>]
"""
from __future__ import annotations

import sys

from .full_train import process_chunk


def main(argv=None):
    a = list(argv if argv is not None else sys.argv[1:])
    skip = keep = False
    extra = ""
    if "--skip_if_exists" in a:
        a.remove("--skip_if_exists")
        skip = True
    if "--keep_running" in a:
        a.remove("--keep_running")
        keep = True
    if "--extra" in a:
        i = a.index("--extra")
        extra = " ".join(a[i + 1:])
        a = a[:i]
    name, chunks_dir, output_dir, images, depths, masks, iters = a[:7]
    ok = process_chunk(name, chunks_dir, output_dir, images, depths,
                       masks.strip("'\""), extra, int(iters),
                       keep_running=keep, skip_if_exists=skip)
    sys.exit(0 if ok else 1)


if __name__ == "__main__":
    main()
