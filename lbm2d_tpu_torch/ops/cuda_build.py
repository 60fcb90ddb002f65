"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ctypes; a library may hold several
kernel variants, each behind its own C entry. Libraries go to ``csrc/_build/``
(gitignored), named by a hash of the source, the shared header and the
flags, so a checkout builds them at first use and reuses them afterwards.
``build_all`` starts one ``nvcc`` per missing library, all at once, and
keeps nvcc's stderr (ptxas's registers and spills) beside each library,
so ``BUILD_LOG`` holds it in every process that uses the build.

There is no fallback: a failed build raises with nvcc's stderr.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
import time
from typing import Dict

CSRC = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "csrc")
BUILD_DIR = os.path.join(CSRC, "_build")

# -fmad=false and no --use_fast_math: each operation rounds as the plain
# PyTorch step's does, so data-dependent branches agree between the two.
NVCC_FLAGS = [
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-fmad=false", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
]

# library name -> source
SOURCES = {"k1_step": "k1_step.cu", "k3_fused": "k3_fused.cu", "copy_probe": "copy_probe.cu"}

# C entry name -> (library, C entry, argtypes); each entry launches the
# variants ops/cuda_step.py counts under their own names
_P = ctypes.c_void_p
_I = ctypes.c_int
KERNELS = {
    # K1 takes host pointers to the block's geometry (8 ints,
    # cuda_step.BlockGeom: the whole grid or one shard of a spatial mesh)
    # and to the scalar row, then the four sides' BC types
    "k1_step": ("k1_step", "k1_step_launch", [_P] * 10 + [_I] * 7 + [_P]),
    "k1_step_dev": ("k1_step", "k1_step_dev_launch", [_P] * 6 + [_I] * 6 + [_P]),
    "k3_fused": ("k3_fused", "k3_fused_launch", [_P] * 5 + [_I] * 11 + [_P]),
    "copy_probe": ("copy_probe", "copy_probe_launch", [_P] * 3 + [_I] * 2 + [_P]),
}
_HEADERS = ("lbm_common.cuh", "lbm_cell.cuh")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[str, object] = {}
BUILD_LOG: Dict[str, str] = {}  # library -> nvcc's stderr (ptxas usage)
BUILD_SECONDS: Dict[str, float] = {}


def nvcc_path() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels need the CUDA toolkit")
    return path


def _lib_path(name: str) -> str:
    src = SOURCES[name]
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for fname in (src,) + _HEADERS:
        with open(os.path.join(CSRC, fname), "rb") as fh:
            h.update(fh.read())
    return os.path.join(BUILD_DIR, f"lib{name}_{h.hexdigest()[:16]}.so")


def build_all() -> Dict[str, str]:
    """Compile every kernel library that is missing, in parallel; return
    {library: path}. Raises RuntimeError with nvcc's stderr."""
    paths = {name: _lib_path(name) for name in SOURCES}
    todo = {n: p for n, p in paths.items() if not os.path.exists(p)}
    for name, out in paths.items():  # an earlier process's build: its ptxas log
        if name not in todo and name not in BUILD_LOG and os.path.exists(out + ".log"):
            with open(out + ".log") as fh:
                BUILD_LOG[name] = fh.read()
    if not todo:
        return paths
    os.makedirs(BUILD_DIR, exist_ok=True)
    nvcc = nvcc_path()
    procs = {}
    t0 = time.perf_counter()
    for name, out in todo.items():
        tmp = f"{out}.{os.getpid()}.tmp"
        cmd = [nvcc, *NVCC_FLAGS, "-o", tmp, os.path.join(CSRC, SOURCES[name])]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True),
            tmp, out,
        )
    errors = []
    for name, (proc, tmp, out) in procs.items():
        _, err = proc.communicate()
        BUILD_SECONDS[name] = time.perf_counter() - t0
        BUILD_LOG[name] = err
        if proc.returncode != 0:
            errors.append(f"nvcc failed for {SOURCES[name]}:\n{err}")
        else:
            with open(out + ".log", "w") as fh:
                fh.write(err)
            os.replace(tmp, out)
    if errors:
        raise RuntimeError("\n".join(errors))
    return paths


def load(name: str):
    """The C entry of kernel ``name`` (a ctypes function returning the CUDA
    error code), its library built on first use."""
    with _LOCK:
        fn = _ENTRIES.get(name)
        if fn is None:
            lib_name, entry, argtypes = KERNELS[name]
            lib = _LIBS.get(lib_name)
            if lib is None:
                lib = _LIBS[lib_name] = ctypes.CDLL(build_all()[lib_name])
            fn = getattr(lib, entry)
            fn.argtypes = argtypes
            fn.restype = ctypes.c_int
            _ENTRIES[name] = fn
        return fn
