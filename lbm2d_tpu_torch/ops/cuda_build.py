"""Build and load the port's hand-written CUDA kernels (``csrc/*.cu``).

Each source is compiled by ``nvcc`` into its own shared library with a
plain C interface and loaded with ctypes; a library may hold several
kernel variants, each behind its own C entry. Libraries go to ``csrc/_build/``
(gitignored), named by a hash of the source, the shared header and the
flags, so a checkout builds them at first use and reuses them afterwards.
``build_all`` starts one ``nvcc`` per missing library, all at once.

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
SOURCES = {"k1_step": "k1_step.cu", "k2_edge_bc": "k2_edge_bc.cu"}

# C entry name -> (library, C entry, argtypes); each entry launches the
# variants ops/cuda_step.py counts under their own names
_P = ctypes.c_void_p
_I = ctypes.c_int
KERNELS = {
    "k1_step": ("k1_step", "k1_step_launch", [_P] * 9 + [_I] * 5 + [_P]),
    "k1_step_dev": ("k1_step", "k1_step_dev_launch", [_P] * 5 + [_I] * 4 + [_P]),
    "k2_edge_bc": ("k2_edge_bc", "k2_edge_bc_launch", [_P] * 7 + [_I] * 8 + [_P]),
    "k2_edge_bc_dev": ("k2_edge_bc", "k2_edge_bc_dev_launch", [_P] * 5 + [_I] * 7 + [_P]),
}
_HEADERS = ("lbm_common.cuh",)

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
