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
import re
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
SOURCES = {"k1_step": "k1_step.cu", "k3_fused": "k3_fused.cu", "copy_probe": "copy_probe.cu",
           "monitors": "monitors.cu", "render": "render.cu"}

# C entry name -> (library, C entry, argtypes); each entry launches the
# variants ops/cuda_step.py counts under their own names
_P = ctypes.c_void_p
_I = ctypes.c_int
KERNELS = {
    # K1 takes host pointers to the block's geometry (8 ints,
    # cuda_step.BlockGeom: the whole grid or one shard of a spatial mesh)
    # and to the scalar row, then the four sides' BC types; each K1 entry
    # ends with the no-op sides' previous rho and u and their ``fresh`` flag
    # (csrc/k1_step.cu RingPrev)
    "k1_step": ("k1_step", "k1_step_launch", [_P] * 10 + [_I] * 7 + [_P] * 3 + [_I]),
    "k1_step_dev": ("k1_step", "k1_step_dev_launch", [_P] * 6 + [_I] * 6 + [_P] * 3 + [_I]),
    # a chunk's fast steps in one call: the host table of n scalar rows,
    # the ping-pong buffers, and a host int that names a failing step
    "k1_steps": ("k1_step", "k1_steps_launch",
                 [_P] * 7 + [_I, _P] + [_I] * 7 + [_P] * 4 + [_I]),
    # a sharded chunk on a mesh whose blocks live on the cards of one
    # process: host tables of the blocks' pointers and geometries, the mesh
    # grid, then as k1_steps, with host tables of each block's device and
    # stream; the closing full step on every block; peer access between the
    # mesh's cards
    "k1_shard_steps": ("k1_step", "k1_shard_steps_launch",
                       [_P] * 7 + [_I, _I, _P] + [_I] * 8 + [_P] * 5 + [_I]),
    "k1_shard_full": ("k1_step", "k1_shard_full_launch",
                      [_P] * 10 + [_I] * 8 + [_P] * 4 + [_I]),
    "mesh_peers": ("k1_step", "mesh_peers_launch", [_P, _I]),
    # a lockstep group's chunk: its fast steps (one launch a step over the
    # alive cases of a device slot table, the scalar rows a device table
    # [B, n, 14] with its row stride) and its closing full step; then the
    # group's monitors in one launch
    "k1_group_steps": ("k1_step", "k1_group_steps_launch",
                       [_P] * 7 + [_I] * 2 + [_P] + [_I] * 10 + [_P] * 4 + [_I]),
    "k1_group_full": ("k1_step", "k1_group_full_launch",
                      [_P] * 9 + [_I] + [_P] + [_I] * 9 + [_P] * 3 + [_I]),
    # the monitors of every chunk path, one launch (csrc/monitors.cu): a
    # host array of the base item and its strides, the device item table,
    # the CSR link lists, the case table, the scratch and slots, the
    # outputs (part, packed, alive, total), then I, the blocks an item,
    # the scheme's instance and the stream
    "monitors": ("monitors", "monitors_launch", [_P] * 11 + [_I] * 3 + [_P]),
    "k3_fused": ("k3_fused", "k3_fused_launch", [_P] * 5 + [_I] * 11 + [_P]),
    "k3_passes": ("k3_fused", "k3_passes_launch", [_P] * 6 + [_I] * 12 + [_P, _P]),
    "copy_probe": ("copy_probe", "copy_probe_launch", [_P] * 3 + [_I] * 2 + [_P]),
    # the video frames of a call's cases (csrc/render.cu): u, mask, the two
    # outputs, the device tables, host arrays of the strides and the
    # colour ranges, then B, H, W, gui_h, gui_w, the gaussian's radius,
    # smooth, yuv, the tile and its shared bytes, and the stream
    "render": ("render", "render_launch", [_P] * 8 + [_I] * 11 + [_P]),
}
_HEADERS = ("lbm_common.cuh", "lbm_cell.cuh", "halo.cuh")

_LOCK = threading.Lock()
_LIBS: Dict[str, ctypes.CDLL] = {}
_ENTRIES: Dict[str, object] = {}
BUILD_LOG: Dict[str, str] = {}  # library -> nvcc's stderr (ptxas usage)
BUILD_SECONDS: Dict[str, float] = {}
CALLS: Dict[str, int] = {}  # calls of each C entry (``load``'s name), a run's library calls


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


class _Counted:
    """A C entry that counts its calls in ``CALLS``."""

    __slots__ = ("name", "fn")

    def __init__(self, name: str, fn):
        self.name, self.fn = name, fn

    def __call__(self, *args):
        CALLS[self.name] = CALLS.get(self.name, 0) + 1
        return self.fn(*args)


def load(name: str):
    """The C entry of kernel ``name`` (a ctypes function returning the CUDA
    error code, its calls counted in ``CALLS``), its library built on first
    use."""
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
            fn = _ENTRIES[name] = _Counted(name, fn)
        return fn


def ptxas_usage(log: str):
    """{function: (registers a thread or None, spill store bytes, spill
    load bytes)} of every kernel instance (with its registers) and every
    out-of-line device function in ptxas's -v output (``BUILD_LOG``)."""
    out, entry, fn = {}, None, None
    for line in log.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            entry = m.group(1)
            continue
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        if m and fn:
            out[fn] = (out.get(fn, (None,))[0], int(m.group(1)), int(m.group(2)))
            fn = None
            continue
        m = re.search(r"Used (\d+) registers", line)
        if m and entry:
            out[entry] = (int(m.group(1)),) + out.get(entry, (None, 0, 0))[1:]
            entry = None
    return out


def ptxas_stack(log: str):
    """{function: stack frame bytes} from ptxas's -v output. A K1 instance
    whose stack frame grows holds some of its values in local memory on
    every thread (an array indexed at run time), with no spill reported."""
    out, fn = {}, None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\w+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes stack frame", line)
        if m and fn:
            out[fn] = int(m.group(1))
            fn = None
    return out


def _k1_key(entry: str):
    """(storage, scheme, shard, full) of a K1 instance's mangled name
    (k1_step_kernel<S, OBST, SHARD, FULL>), or None."""
    k = re.search(r"k1_step_kernelI\d+(F32Store|DevStore)Li(\d)ELb([01])ELb([01])E", entry)
    return k and (k.group(1), int(k.group(2)), k.group(3) == "1", k.group(4) == "1")


def k1_registers(log: str):
    """{(storage, scheme, shard, full): (registers a thread, spill stores,
    spill loads)} of the K1 instances in ptxas's -v output."""
    return {_k1_key(e): use for e, use in ptxas_usage(log).items() if _k1_key(e)}


def k1_stack_frames(log: str):
    """{(storage, scheme, shard, full): stack frame bytes} of the K1
    instances in ptxas's -v output."""
    return {_k1_key(e): n for e, n in ptxas_stack(log).items() if _k1_key(e)}


def _group_key(entry: str):
    """(storage, scheme, full) of a K1 group instance's mangled name
    (k1_group_kernel<S, OBST, FULL>), or None."""
    k = re.search(r"k1_group_kernelI\d+(F32Store|DevStore)Li(\d)ELb([01])E", entry)
    return k and (k.group(1), int(k.group(2)), k.group(3) == "1")


def k1_group_registers(log: str):
    """{(storage, scheme, full): (registers a thread, spill stores, spill
    loads)} of K1's lockstep-group instances in ptxas's -v output."""
    return {_group_key(e): use for e, use in ptxas_usage(log).items() if _group_key(e)}


def k1_group_stack_frames(log: str):
    """{(storage, scheme, full): stack frame bytes} of K1's group
    instances."""
    return {_group_key(e): n for e, n in ptxas_stack(log).items() if _group_key(e)}


def monitor_registers(log: str):
    """{bouzidi: (registers a thread, spill stores, spill loads)} of the
    monitor kernel's instances (monitors_kernel<BOUZIDI>)."""
    out = {}
    for entry, use in ptxas_usage(log).items():
        k = re.search(r"monitors_kernelILb([01])E", entry)
        if k:
            out[k.group(1) == "1"] = use
    return out


def k3_registers(log: str):
    """{(scheme, window columns): (registers a thread, spill stores, spill
    loads)} of the K3 kernel instances (k3_fused_kernel<OBST, WW>)."""
    out = {}
    for entry, use in ptxas_usage(log).items():
        k = re.search(r"k3_fused_kernelILi(\d)ELi(\d+)E", entry)
        if k:
            out[int(k.group(1)), int(k.group(2))] = use
    return out
