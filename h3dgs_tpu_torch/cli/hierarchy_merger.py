"""Hierarchy merger CLI (GaussianHierarchyMerger equivalent; counterpart of
``h3dgs_tpu/cli/hierarchy_merger.py``).

Positional contract of the native tool's invocation:

  python -m h3dgs_tpu_torch.cli.hierarchy_merger \
      <trained_chunks dir> 0 <chunks colmap dir> <output merged.hier> \
      <chunk name> [<chunk name> ...] [--backend auto|numpy|native]

Each chunk contributes <trained_chunks>/<name>/hierarchy.hier_opt (falling
back to .hier if post-opt was skipped); bounds come from
<chunks dir>/<name>/center.txt + extent.txt. Runs on the host.

``--backend``: ``native`` runs the C++ merger (``native.py``, compiled from
``native/hierarchy_native.cpp`` at first use; a failed build raises),
``numpy`` the numpy merger (``hierarchy/merge.py``), ``auto`` (the
default) the C++ one when a C++ compiler is found. Both give the same
nodes and anchors, with attributes equal to float32 rounding, not always
the same bytes; the tool logs which ran.
"""
from __future__ import annotations

import os
import sys
import time


def merge_chunks(trained_dir: str, chunks_dir: str, output: str,
                 names: list, backend: str = "auto") -> str:
    from ..hierarchy.io import read_hier, write_hier
    from ..hierarchy.merge import merge_hierarchies
    from ..hierarchy.tree import BACKENDS, resolve_backend
    from ..io.meta import read_vec

    if backend not in BACKENDS:
        raise ValueError(f"unknown merger backend {backend!r}; "
                         f"choose from {BACKENDS}")
    backend = resolve_backend(backend)
    hs, centers, extents = [], [], []
    for name in names:
        base = os.path.join(trained_dir, name)
        path = os.path.join(base, "hierarchy.hier_opt")
        if not os.path.exists(path):
            path = os.path.join(base, "hierarchy.hier")
        hs.append(read_hier(path))
        cdir = os.path.join(chunks_dir, name)
        centers.append(read_vec(os.path.join(cdir, "center.txt")))
        extents.append(read_vec(os.path.join(cdir, "extent.txt")))
        print(f"chunk {name}: {hs[-1].n_nodes} nodes from {path}")

    t0 = time.perf_counter()
    if backend == "native":
        from ..native import merge_hierarchies_native
        merged = merge_hierarchies_native(hs, centers, extents)
    else:
        merged = merge_hierarchies(hs, centers, extents)
    print(f"merged by the {backend} backend in "
          f"{time.perf_counter() - t0:.2f} s")
    os.makedirs(os.path.dirname(output) or ".", exist_ok=True)
    write_hier(output, merged)
    print(f"merged hierarchy: {merged.n_nodes} nodes "
          f"({merged.n_leaves} leaves) -> {output}")
    return output


def main(argv=None):
    argv = list(argv if argv is not None else sys.argv[1:])
    backend = "auto"
    if "--backend" in argv:
        i = argv.index("--backend")
        backend = argv[i + 1]
        del argv[i:i + 2]
    if len(argv) < 5:
        print(__doc__)
        sys.exit(2)
    trained_dir, _zero, chunks_dir, output = argv[:4]
    merge_chunks(trained_dir, chunks_dir, output, argv[4:], backend=backend)


if __name__ == "__main__":
    main()
