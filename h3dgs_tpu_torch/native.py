"""ctypes bindings for the C++ hierarchy builder and merger (counterpart
of ``h3dgs_tpu/native/__init__.py``).

The hierarchy builder and the cross-chunk merger each have two
implementations: numpy (``hierarchy/tree.py``, ``hierarchy/merge.py``) and
C++ (``native/hierarchy_native.cpp`` at the repository root, for
multi-million-Gaussian chunks). They give the same structure, leaf set
and anchors, with attributes equal to float32 rounding, but not always
the same bytes: the C++ builder quantises Morton codes in double, numpy
in float32. The port builds the
C++ library itself from that source at first use, with ``native/Makefile``'s
flags (``-O3 -march=native -std=c++17 -fPIC -shared``, and ``-fopenmp``
when the compiler can link it), into ``h3dgs_tpu_torch/_build/``. It never
loads a library built elsewhere: ``-march=native`` code from another host
can die with SIGILL. The library is keyed by a hash of the source, the
flags, the compiler and this host's CPU, as ``ops/kernels.py`` keys the
CUDA libraries. A failed build raises with the compiler's output; nothing
falls back to numpy behind the caller's back.

The library's OpenMP loops run in the process that already holds torch's
OpenMP runtime; ``torch.set_num_threads`` caps both.

``build`` compiles the PNG unfilter of ``io/image.py``
(``csrc/png_unfilter.cpp``) the same way, without OpenMP.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import platform
import shutil
import subprocess
import tempfile
import threading
from typing import Optional

import numpy as np

PKG_DIR = os.path.dirname(os.path.abspath(__file__))
BUILD_DIR = os.path.join(PKG_DIR, "_build")
SOURCE = os.path.join(os.path.dirname(PKG_DIR), "native",
                      "hierarchy_native.cpp")
CXX_FLAGS = ["-O3", "-march=native", "-std=c++17", "-fPIC", "-Wall",
             "-Wextra", "-shared"]

_LIB: Optional[ctypes.CDLL] = None


def compiler() -> Optional[str]:
    """The C++ compiler: ``$CXX``, else ``g++``, else ``c++``; None when
    none is found."""
    for name in (os.environ.get("CXX"), "g++", "c++"):
        if name and shutil.which(name):
            return shutil.which(name)
    return None


def native_available() -> bool:
    """True when the library can be built here (a C++ compiler and the
    source are present)."""
    return compiler() is not None and os.path.exists(SOURCE)


def _openmp_flag(cxx: str) -> list:
    """``["-fopenmp"]`` when the compiler builds and links a shared
    library with it (a compiler can preprocess with ``-fopenmp`` and still
    lack the OpenMP runtime to link), else ``[]``."""
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "probe.cpp")
        with open(src, "w") as f:
            f.write("#include <omp.h>\n"
                    "extern \"C\" int probe() { return omp_get_max_threads(); }\n")
        probe = subprocess.run([cxx, "-fopenmp", "-fPIC", "-shared", "-o",
                                os.path.join(tmp, "probe.so"), src],
                               capture_output=True)
    return ["-fopenmp"] if probe.returncode == 0 else []


def _host_cpu() -> bytes:
    """This host's CPU model and instruction-set flags (``-march=native``
    compiles for them)."""
    key = platform.machine()
    try:
        with open("/proc/cpuinfo") as f:
            for line in f:
                if line.startswith(("model name", "flags", "Features")):
                    key += line
                if line.strip() == "":
                    break
    except OSError:
        pass
    return key.encode()


def library_path(cxx: str, flags: list, source: Optional[str] = None,
                 stem: str = "libh3dgs_native") -> str:
    digest = hashlib.sha256(" ".join([cxx] + flags).encode())
    digest.update(_host_cpu())
    with open(source or SOURCE, "rb") as f:
        digest.update(f.read())
    return os.path.join(BUILD_DIR, f"{stem}_{digest.hexdigest()[:16]}.so")


def build(source: Optional[str] = None, stem: str = "libh3dgs_native",
          openmp: bool = True) -> str:
    """Compile ``source`` (default: the hierarchy tools' ``SOURCE``) into
    ``BUILD_DIR/<stem>_<key>.so`` unless it is built already; returns its
    path. Raises when no compiler is found or the build fails."""
    source = source or SOURCE
    cxx = compiler()
    if cxx is None:
        raise RuntimeError("no C++ compiler found (set CXX); the numpy "
                           "backend needs none")
    flags = CXX_FLAGS + (_openmp_flag(cxx) if openmp else [])
    out = library_path(cxx, flags, source, stem)
    if os.path.exists(out):
        return out
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f"{out}.{os.getpid()}.{threading.get_ident()}.tmp"
    proc = subprocess.run([cxx, *flags, "-o", tmp, source],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f"native library build failed ({source}):\n"
                           + proc.stdout + proc.stderr)
    # Atomic rename: a concurrent process never loads a partial file.
    os.replace(tmp, out)
    return out


def load_native() -> ctypes.CDLL:
    """The library, built first if needed, with its argument types."""
    global _LIB
    if _LIB is not None:
        return _LIB
    lib = ctypes.CDLL(build())
    fp = ctypes.POINTER(ctypes.c_float)
    ip = ctypes.POINTER(ctypes.c_int32)
    up = ctypes.POINTER(ctypes.c_uint8)
    lp = ctypes.POINTER(ctypes.c_int64)
    f = lib.h3dgs_build_hierarchy
    f.restype = ctypes.c_int64
    f.argtypes = [ctypes.c_int64, fp, fp, fp, fp, fp, up,
                  fp, fp, fp, fp, fp, ip, fp, up]
    g = lib.h3dgs_merge_hierarchies
    g.restype = ctypes.c_int64
    g.argtypes = [ctypes.c_int64, lp, fp, fp, fp, fp, fp, ip, fp, up, fp,
                  fp, fp, fp, fp, fp, fp, ip, fp, up]
    _LIB = lib
    return lib


def _ptr(a: np.ndarray, ctype):
    return a.ctypes.data_as(ctypes.POINTER(ctype))


def _f(a: np.ndarray):
    return _ptr(a, ctypes.c_float)


def build_hierarchy_native(xyz, shs, alpha, scaling, rotation,
                           locked_leaf_mask=None):
    """Run the C++ builder; returns a ``hierarchy.tree.Hierarchy``."""
    from .hierarchy.tree import Hierarchy

    lib = load_native()
    n = int(np.asarray(xyz).shape[0])
    if n == 0:
        raise ValueError("cannot build a hierarchy over 0 Gaussians")
    m = 2 * n - 1

    def as32(a, shape):
        return np.ascontiguousarray(np.asarray(a, np.float32).reshape(shape))

    xyz = as32(xyz, (n, 3))
    shs_in = np.asarray(shs, np.float32).reshape(n, -1, 3)
    if shs_in.shape[1] < 16:
        shs_in = np.concatenate(
            [shs_in, np.zeros((n, 16 - shs_in.shape[1], 3), np.float32)],
            axis=1)
    shs_in = np.ascontiguousarray(shs_in)
    alpha = as32(alpha, (n,))
    scaling = as32(scaling, (n, 3))
    rotation = as32(rotation, (n, 4))
    locked = None
    if locked_leaf_mask is not None:
        locked = np.ascontiguousarray(locked_leaf_mask, np.uint8).reshape(n)

    o_xyz = np.empty((m, 3), np.float32)
    o_shs = np.empty((m, 16, 3), np.float32)
    o_alpha = np.empty((m,), np.float32)
    o_scaling = np.empty((m, 3), np.float32)
    o_rotation = np.empty((m, 4), np.float32)
    o_nodes = np.empty((m, 4), np.int32)
    o_boxes = np.empty((m, 2, 3), np.float32)
    o_anchor = np.empty((m,), np.uint8)
    ret = lib.h3dgs_build_hierarchy(
        n, _f(xyz), _f(shs_in), _f(alpha), _f(scaling), _f(rotation),
        _ptr(locked, ctypes.c_uint8) if locked is not None else None,
        _f(o_xyz), _f(o_shs), _f(o_alpha), _f(o_scaling), _f(o_rotation),
        _ptr(o_nodes, ctypes.c_int32), _f(o_boxes),
        _ptr(o_anchor, ctypes.c_uint8))
    if ret != m:
        raise RuntimeError(f"native hierarchy build failed (ret={ret})")
    return Hierarchy(
        xyz=o_xyz, shs=o_shs, alpha=o_alpha, scaling=o_scaling,
        rotation=o_rotation, nodes=o_nodes, boxes=o_boxes,
        anchors=np.nonzero(o_anchor)[0].astype(np.int32))


def merge_hierarchies_native(hierarchies, centers, extents):
    """Run the C++ merger; the same result as
    ``hierarchy.merge.merge_hierarchies``."""
    from .hierarchy.tree import Hierarchy

    lib = load_native()
    k = len(hierarchies)
    sizes = np.asarray([h.n_nodes for h in hierarchies], np.int64)
    total_in = int(sizes.sum())

    def cat(field, shape):
        return np.ascontiguousarray(
            np.concatenate([np.asarray(getattr(h, field), np.float32)
                            .reshape((h.n_nodes,) + shape)
                            for h in hierarchies]))

    xyz = cat("xyz", (3,))
    shs = cat("shs", (16, 3))
    alpha = cat("alpha", ())
    scaling = cat("scaling", (3,))
    rotation = cat("rotation", (4,))
    boxes = cat("boxes", (2, 3))
    nodes = np.ascontiguousarray(
        np.concatenate([np.asarray(h.nodes, np.int32) for h in hierarchies]))
    anchor = np.zeros(total_in, np.uint8)
    off = 0
    for h in hierarchies:
        if h.anchors.size:
            anchor[off + np.asarray(h.anchors)] = 1
        off += h.n_nodes
    box_min = np.ascontiguousarray(
        np.stack([np.asarray(c, np.float32) - np.asarray(e, np.float32) / 2
                  for c, e in zip(centers, extents)]))
    box_max = np.ascontiguousarray(
        np.stack([np.asarray(c, np.float32) + np.asarray(e, np.float32) / 2
                  for c, e in zip(centers, extents)]))

    cap = total_in + 1
    o_xyz = np.empty((cap, 3), np.float32)
    o_shs = np.empty((cap, 16, 3), np.float32)
    o_alpha = np.empty((cap,), np.float32)
    o_scaling = np.empty((cap, 3), np.float32)
    o_rotation = np.empty((cap, 4), np.float32)
    o_nodes = np.empty((cap, 4), np.int32)
    o_boxes = np.empty((cap, 2, 3), np.float32)
    o_anchor = np.empty((cap,), np.uint8)
    ret = lib.h3dgs_merge_hierarchies(
        k, _ptr(sizes, ctypes.c_int64), _f(xyz), _f(shs), _f(alpha),
        _f(scaling), _f(rotation), _ptr(nodes, ctypes.c_int32), _f(boxes),
        _ptr(anchor, ctypes.c_uint8), _f(box_min), _f(box_max),
        _f(o_xyz), _f(o_shs), _f(o_alpha), _f(o_scaling), _f(o_rotation),
        _ptr(o_nodes, ctypes.c_int32), _f(o_boxes),
        _ptr(o_anchor, ctypes.c_uint8))
    if ret < 0:
        raise RuntimeError(f"native merge failed (ret={ret})")
    m = int(ret)
    return Hierarchy(
        xyz=o_xyz[:m], shs=o_shs[:m], alpha=o_alpha[:m],
        scaling=o_scaling[:m], rotation=o_rotation[:m], nodes=o_nodes[:m],
        boxes=o_boxes[:m],
        anchors=np.nonzero(o_anchor[:m])[0].astype(np.int32))
