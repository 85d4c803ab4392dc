"""Build, load and count the port's hand-written CUDA kernels.

Each kernel source under ``h3dgs_tpu_torch/csrc/`` is compiled at first
use with ``nvcc`` into a shared library with a plain C interface, which is
loaded with ``ctypes``. Libraries are keyed by a hash of the sources, so a
changed source builds anew and an unchanged one is reused; the build
directory (``h3dgs_tpu_torch/_build/``) is listed in ``.gitignore``.
Nothing is built when a module is imported: the CPU tests import every
module on a machine without ``nvcc``.

``LAUNCHES`` counts each kernel's launches; a wrapper adds one where it
launches its kernel and nowhere else. ``chip_smoke.py`` resets and reads
the counts around the main path to show that the path ran the kernels.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import time
from typing import Dict, Iterable

PKG_DIR = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CSRC_DIR = os.path.join(PKG_DIR, "csrc")
BUILD_DIR = os.path.join(PKG_DIR, "_build")

# kernel name -> its source file under csrc/
SOURCES: Dict[str, str] = {
    "blend_fwd": "blend_fwd.cu",
}

NVCC_FLAGS = ["-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v"]

LAUNCHES: Dict[str, int] = {name: 0 for name in SOURCES}

_loaded: Dict[str, ctypes.CDLL] = {}


def reset_launches() -> None:
    for name in LAUNCHES:
        LAUNCHES[name] = 0


def nvcc_path() -> str:
    home = os.environ.get("CUDA_HOME") or os.environ.get("CUDA_PATH")
    if home and os.path.exists(os.path.join(home, "bin", "nvcc")):
        return os.path.join(home, "bin", "nvcc")
    found = shutil.which("nvcc")
    if found:
        return found
    default = "/usr/local/cuda/bin/nvcc"
    if os.path.exists(default):
        return default
    raise RuntimeError("nvcc not found: set CUDA_HOME to the CUDA toolkit")


def library_path(name: str) -> str:
    src = os.path.join(CSRC_DIR, SOURCES[name])
    with open(src, "rb") as f:
        digest = hashlib.sha256(f.read() + " ".join(NVCC_FLAGS).encode())
    return os.path.join(BUILD_DIR, f"lib{name}_{digest.hexdigest()[:16]}.so")


def build(names: Iterable[str] = tuple(SOURCES)) -> Dict[str, float]:
    """Compile the named kernels that are not built yet, one ``nvcc`` per
    source, all started together. Returns the seconds each build took
    (0.0 for a library that was already there). Raises on a failed build
    with the compiler's output."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    procs = {}
    seconds = {}
    for name in names:
        out = library_path(name)
        if os.path.exists(out):
            seconds[name] = 0.0
            continue
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc_path(), *NVCC_FLAGS, "-o", tmp,
               os.path.join(CSRC_DIR, SOURCES[name])]
        procs[name] = (subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                        stderr=subprocess.STDOUT, text=True),
                       tmp, out, time.perf_counter())
    failed = []
    for name, (proc, tmp, out, t0) in procs.items():
        log, _ = proc.communicate()
        seconds[name] = time.perf_counter() - t0
        if proc.returncode != 0:
            failed.append(f"{name}:\n{log}")
            continue
        # Atomic rename: a concurrent process never loads a partial file.
        os.replace(tmp, out)
        with open(out + ".log", "w") as f:
            f.write(log)
    if failed:
        raise RuntimeError("kernel build failed:\n" + "\n".join(failed))
    return seconds


def load(name: str) -> ctypes.CDLL:
    """The kernel's library, built first if needed."""
    lib = _loaded.get(name)
    if lib is None:
        build([name])
        lib = ctypes.CDLL(library_path(name))
        _loaded[name] = lib
    return lib


def check(name: str, status: int) -> None:
    """Raise when a launch returned a CUDA error (cudaGetLastError)."""
    if status != 0:
        raise RuntimeError(f"kernel {name} failed to launch: CUDA error "
                           f"{status}")
