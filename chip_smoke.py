#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``lbm2d_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the process exits non-zero):

0. the card (nvidia-smi name and power limit), torch and nvcc versions,
   and the environment doctor (``python -m lbm2d_tpu_torch.native``, which
   builds and loads the kernels), which must name the card;
1. build the CUDA kernels from ``lbm2d_tpu_torch/csrc`` with nvcc, and
   print ptxas's registers a thread and spill bytes of every K1 instance
   (the fast and full steps are instances of their own) and of K3, and
   K3's tile, threads, shared memory and resident blocks a SM (from its
   shared memory and its launch bounds' register cap, which every K3
   instance must keep) at S = 4 and S = 8;
2. hold each kernel variant (``cuda_step.KERNEL_VARIANTS``: K1 fast and
   full for each obstacle scheme -- equilibrium, full-way, half-way and
   Bouzidi bounce-back, the Bouzidi q planes drawn from a seeded generator
   on the mask's boundary links -- and K1 in 16-bit deviation storage for
   the equilibrium and full-way schemes, each with the boundary ring its
   ring threads write, over BC combinations that take every side's types:
   left 0/2/3/4, right 0/1/2, top/bottom 0/2; full-way bounce-back keeps
   the BC values on solid ring cells, the other schemes overwrite them)
   against its plain PyTorch version at the production grid 2432x1152 on a
   developed state, with each variant's time, bound, registers per thread
   and host issue per launch; then a 20-step ``run_chunk_cuda``
   against the eager ``run_chunk`` and, with ``store_dev``, against its
   plain version: max relative error (max |a - b| / max |b|) <= 1e-5 each;
   the ``store_dev`` chunk within the JAX package's 5e-4 budget of the
   exact chunk (and > 0) under that budget test's conditions; then
   ``run_chunk_cuda`` chunks (a chunk's fast steps in one call of the
   libraries' step loops, ``k3_passes`` and ``k1_steps``) against the same
   chunks issued one wrapper call a step (``run_chunk_stepwise``), bitwise
   on f, f_post, rho, u and the monitors, with the same launches: f32 and
   ``store_dev`` on the smoke case, fused at S = 4, and Bouzidi + NEBB on
   the DFG grid, each chunk straddling its case's warmup; the host's issue
   time a launch of each loop entry beside its device time, a 100-step
   DFG chunk issued both ways, and what a chunk still builds (pack_aux,
   the scalar rows); time each kernel with CUDA events beside its bound
   (``ms``: replayed from a CUDA graph, the kernel alone;
   ``launch_path_ms``: launched from Python one by one);
3. drive the serial main path, ``LBMEngine`` + ``run_simulation_loop``, on
   the production-shaped case in ``lbm2d_tpu_torch/data`` (3000 steps in
   chunks of 100), and check status Success, finite moments, mean jx > 0,
   Fx > 0, and that each of its kernels was launched (one launch a step)
   and no plain step ran; the kernel path's host-paced us/step and the
   host's issue us/step in two turns, f32 and ``store_dev``, beside a
   step's device time and a whole chunk's (``run_chunk_cuda`` in a CUDA
   graph: kernels, monitors and copies) and the monitors' share;
   then a 20-step ``store_dev`` chunk from the flow it ends with must lie
   within 1e-4 of the exact chunk (and differ from it);
4. drive the lockstep production path, ``batch_run --lockstep
   --device_resize --max_batch 5 --f16_state --f16_transfer --yuv_video
   --f16_retry``, on a temporary project of three sibling cases of the
   smoke case (the same mask; nu 0.02, 0.03, 0.05; video on), and check
   every case Success, finite HDF5 frames with mean jx > 0, one mp4 per
   case, the launch counts of its kernels (k1_step_dev 3 x 2970,
   k1_step_full 3 x 30: one a step) and no plain call, and
   print the fetch pacer's record (stall fraction, final group size, its
   chunk-wall estimate and the chunks that calibrated it). Where
   the machine has no h5py, the HDF5 writer runs on an in-memory stand-in
   of ``h5py.File`` and the frames are read back from it;
5. drive the DFG-2D validation path, ``analysis.dfg_validation.
   run_validation(mode="dfg", obstacle="bounce_back_bouzidi", inlet="nebb",
   ny=165, steps=160000, chunk=500)`` (the JAX package's own benchmark
   test, tests/test_dfg_bc.py), and check its ranges (St 0.26-0.32, Cd
   2.7-3.5, Cl amplitude 0.5-1.4, Re 90-110, shedding), its launch counts
   (k1_step_bouzidi, k1_step_bouzidi_full: one a step) and no plain call,
   the device time of one step at 881x165 and of a whole 500-step chunk
   (CUDA graphs), and the host's issue time of a chunk's monitors and
   the cylinder's force; print the
   coefficients beside the recorded row of
   docs/benchmarks/dfg2d_results.json; then, from its developed state,
   the five other obstacle x inlet pairs for 200 steps through the kernels
   and through ``run_chunk_plain`` (and the full-way pairs in deviation
   storage), within 1e-5 relative;
6. drive the serial main path of phase 3 again with temporal blocking on
   (``cuda_step._FUSE_STEPS = 4``, opt-in, as the JAX package's
   ``_FUSE_STEPS``): check Success, finite moments, mean jx > 0, Fx > 0,
   the launch counts (k3_fused 720, k1_step 90, k1_step_full 30) and no
   plain call, and its final f against phase 3's
   (bitwise expected; gated at the relative tolerance); print its
   kernel-path and wall MLUPS beside phase 3's and the chunk's device
   time (its kernels, and the whole chunk in a CUDA graph); then every
   other scheme K3
   runs, fused through the kernels against the unfused plain chunk runner:
   the equilibrium, full-way and half-way DFG pairs with both inlets for 200
   steps from phase 5's developed flow, and full-way and half-way on the
   smoke case for one chunk, so that every K3 variant is launched;
   phase 2 also holds each K3 variant (``k3_fused[_bounce|_halfway][_vel]``
   at S = 4 and S = 8, default tiles) against its plain version, one K3
   pass against four K1 steps through the kernels, and times K3 at S = 4
   and, ``k3_fused``, at S = 8, and each sharded form of K1
   (``k1_step[_bounce|_halfway|_bouzidi]_shard[_full|_dev]``) on the four
   blocks of a 2x2 mesh of the card (local 1216x576, halos cut from the
   developed state) over the same BC combinations, bitwise against its
   plain version, timed on block (0, 0);
7. run the roofline tool's measurement (``tools/roofline.measure``) at
   4096^2 with two chunks of 50 steps, and hold the copy probe, with and
   without the aux read, against its plain version at that size, both
   forms timed beside ``torch.Tensor.copy_`` in the same run;
8. drive the sharded path (``parallel/sharded.py``) through its resident
   blocks (``sharded.BlockRunner``: the state placed once, chunks run on
   the blocks, a field gathered only where it is read): (a) on a 2x2 mesh
   of the card, phase 3's final state placed and run for 2 chunks of 100
   steps, f32 and ``store_dev``, bitwise against ``run_chunk_cuda`` (f,
   f_post, rho, u, force, max_v); (b) on a (5, 1) mesh at the DFG grid,
   whose seams cut the cylinder, the Bouzidi, half-way and full-way pairs
   with the NEBB inlet (full-way in ``store_dev`` too) from phase 5's
   flow, 200 steps, bitwise against the single-device kernels; (c) the
   production entry ``run_batch(..., spatial_mesh="1x1")`` on the smoke
   case (the engine keeps its blocks across chunks): Success, final f
   bitwise equal to phase 3's, only ``_shard`` launches and no plain call;
   (d) on a 2x2 mesh at 4096^2 (the demo case), a 6-step chunk from a
   seeded random state bitwise against the plain runner (the kernels at
   this block size), then the chunk loop in turns, the state placed and
   gathered every chunk (``run_chunk_sharded_cuda``) and resident:
   host-paced us/step beside the host's time to issue the loop and the
   garbage collector's pauses in it, the memory the state holds and the
   loop's peak
   (``torch.cuda.max_memory_allocated``); the device time of one step (a
   CUDA graph of K1 on every block and the halo copies), the halo
   exchange's share, the per-chunk cost of what is still gathered (the
   closing f_post into the global f_post) and of the chunk's monitors.
   Every ``_shard`` variant is launched in phase 8, one launch a block a
   step;
9. drive the multi-worker and multi-process paths, each worker an OS
   process (``lbm2d_tpu_torch/tools/smoke_workers.py``, hard time limit)
   on sibling cases of the smoke case (nu 0.02, 0.03, 0.04, 0.05): (a) two
   ``batch_run --coordinate`` workers on one 4-case project, video on:
   every case Success once, disjoint owners, ``.claims/`` empty, the NPZ
   complete, one mp4 each, each case's HDF5 datasets byte-equal to a
   one-worker run, one launch a step and no plain call in each worker;
   (b) ``batch_run --coordinate --lockstep --f16_state --max_batch 2``,
   one worker alone, then two at once, on fresh copies of the project:
   the same checks, and wall, aggregate wall MLUPS and cases/hour of each;
   (c) ``BatchEngine(runner="sharded")``, 3 cases on a case mesh naming
   cuda:0 twice (one inert pad), one chunk, f32 and ``store_dev``: states
   and monitors bitwise equal to ``runner="auto"``, the pad launching
   nothing; (d) two processes in a gloo group (``parallel/multihost``),
   both on cuda:0, the smoke case through ``run_one_case.main`` on a
   global 2x1 mesh: Success on both ranks, the final f bitwise equal to
   phase 3's, the monitors equal across ranks and within 5e-6 of 8(c)'s
   final state's force in float64, rank 0's HDF5 datasets byte-equal to
   8(c)'s, only ``_shard`` launches, us/step; then a resume from a
   checkpoint only rank 0's path holds: both ranks resume at its step and
   end with phase 3's final f;
10. drive the README quickstart through the port's own CLIs and functions
   in a temporary directory, at the production width: (1) ``gen_masks -c
   master_config.yaml -n 1 --mode hybrid --seed 7``, whose mask must equal
   ``data/smoke_case_mask.npz`` bit for bit at 2432x1152 with pads 256,
   640, 192, 192; (2) ``config_batch_gen``: five configs, nu 0.007, 0.01,
   0.02, 0.03, 0.05, the nu 0.02 one equal to ``data/smoke_case.json``
   outside the depth, video, project and mask keys, ``config_meta.json``
   with five Pending cases; the configs cut in depth only, as the smoke
   case is (warmup 1000, chunk 100, 3000 steps, recording and intervals
   1000, video on); (3) ``run_batch`` with the production flags over the
   five cases, one group: every case Success, finite frames with mean jx
   > 0, one mp4 each, k1_step_dev 5 x 2970 and k1_step_full 5 x 30
   launches and no plain call; (4) ``post.h5_to_zarr.run`` on the
   project's summary: ``global_stats.json`` lists the five cases, each
   case's ``turbulence`` read back with ``zarrlite.read_region`` equals
   the HDF5 frames normalised in numpy, bit for bit, and the sampling-
   weight maps lie in [0, 1]; then ``video_stats.process_video`` on each
   mp4 (where cv2 imports), one ``io_bench._timed_zarr`` crop, and one
   100-step chunk of the smoke case under ``utils.profiling.device_trace``,
   whose trace must name a ``k1_step`` kernel; each step's wall seconds;
11. run the port's headline bench (``tools/bench.run()``) at its defaults
   in this process: the 1024^2 demo cylinder, 8 warm-up chunks and three
   windows of 20 chunks of 500 steps, then the 40-step guard against the
   eager step (1e-5); print its one JSON line, and check the line's keys
   and metric, k1_step 68 x 499 + 39 and k1_step_full 68 + 1 launches (the
   timed chunks and the guard's chunk) and no plain call but the guard's
   40 eager steps; then a whole chunk's and one K1 step's device time
   (CUDA graphs) beside the bytes bound;
12. time the Bouzidi q planes of the smoke mask (its own signed distance)
   on this host, then run the DFG-2D matrix (``tools/dfg_suite.run_suite``:
   the 12 rows of ``tools_dfg_suite.sh``, full-way, half-way and Bouzidi
   with the equilibrium and NEBB inlets at 881x165 and 1761x329) cut to
   4000 steps a row: every row's keys those of
   docs/benchmarks/dfg2d_results.json's rows plus ``card`` and
   ``wall_s``, every value finite, each scheme's K1 launches (one a step)
   and no plain call; then the last row's engine (ny 329, Bouzidi + NEBB)
   200 steps on through the kernels and through ``run_chunk_plain``,
   bitwise.

The last two lines are the kernels' JSON record (``launches``: the sum over
the driven paths, split in ``launches_by_path``, phase 9's under
``coord``, ``coord_lock``, ``case_sharded`` and ``multihost``, phase 10's under
``quickstart`` and ``quickstart_trace``, phase 11's under ``bench``, phase
12's under ``suite``) and ``{"ok": true,
"device": {...}}``. Without a CUDA device, or without the package beside
this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import dataclasses
import gc
import json
import os
import re
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5  # max relative error of a kernel against its plain version
# max absolute difference of a 20-step deviation-storage chunk from the
# exact f32 chunk: the JAX package's own budget (tests/test_pallas.py)
DEV_TOL = 5e-4
# the same on the developed flow of the smoke case at step 3000, set from
# its readings on an H100 (f 2.1e-5, rho 4.8e-5, u 2.2e-5; PERF.md)
DEV_FLOW_TOL = 1e-4
SEED = 0
# the DFG-2D run of phase 5: the JAX package's benchmark test
# (tests/test_dfg_bc.py:258-266), its length, chunk and ranges
DFG_RUN = dict(mode="dfg", obstacle="bounce_back_bouzidi", inlet="nebb", re=100.0,
               u_target=0.1, ny=165, steps=160000, chunk=500, progress=False)
DFG_RANGES = {"strouhal": (0.26, 0.32), "cd_mean": (2.7, 3.5),
              "cl_amplitude": (0.5, 1.4), "re_measured": (90.0, 110.0)}
DFG_PAIR_STEPS, DFG_PAIR_CHUNK = 200, 100
# phase 12: the DFG matrix cut to 20 monitor samples a row (the FFT
# Strouhal of run_validation needs 16)
SUITE_STEPS = 4000

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s and
# f32 non-tensor-core FLOP/s. bound = max(bytes / BW, ops / FLOPS).
PEAK_BW = 3.35e12
PEAK_F32 = 67e12
# f32 operations per interior cell of K1, counted from csrc/lbm_common.cuh
# mrt_collide (sqrt and division count one each) plus the overwrite
K1_OPS_PER_CELL = 120
# per Bouzidi boundary link: 2q, 1 - 2q, two products and a sum (q < 1/2),
# or two divisions, a subtraction, a product and a sum (q >= 1/2)
K1_OPS_PER_LINK = 6
# per ring cell of K1's ring threads: one BC (~70 for the Zou-He
# branches) plus the overwrite
RING_OPS_PER_CELL = 80
# the BC combinations phase 2 holds every K1 variant to: each side's types
# (left 0/2/3/4, right 0/1/2, top/bottom 0/2) and each corner pairing of a
# side type with both row types; the first is the smoke case's and is
# the one timed
BC_COMBOS = ((0, 2, 1, 2), (2, 0, 0, 0), (3, 2, 2, 0), (4, 0, 1, 2), (4, 2, 0, 0),
             (0, 0, 2, 2))
# shared memory of an H100 SXM: 128 B per clock per SM, 132 SMs, 1.98 GHz
PEAK_SMEM = 33e12
# phase 6: temporal blocking at S = 4 (K3's default tile), and S = 8 timed
FUSE_S, FUSE_S_MAX = 4, 8
# phase 7: the roofline tool at 4096^2 with a few short chunks
ROOF_N, ROOF_CHUNKS, ROOF_SPC = 4096, 2, 50
# phase 8(d): the chunk that holds the sharded kernels against their plain
# versions on the 2x2 mesh at 4096^2 (K1 fast and full), and the chunks of
# each timed turn (scatter and gather every chunk, then resident, in turns)
CHECK_4K_STEPS = 6
SHARD_4K_CHUNKS = 8
# phase 2: the chunk through the libraries' step loops against the per-step
# wrappers (a chunk straddling its case's warmup), and the rows of each
# loop entry's timed call
LOOP_N = 20
ISSUE_N = 100


def rel_err(a: torch.Tensor, b: torch.Tensor) -> float:
    a = a.double()
    b = b.double()
    scale = b.abs().max().item()
    return (a - b).abs().max().item() / (scale if scale > 0 else 1.0)


def check(name: str, err: float) -> None:
    print(f"  {name:<34s} max rel err {err:.3e} (tol {TOL:g})", flush=True)
    if not err <= TOL:
        raise AssertionError(f"{name}: max relative error {err:.3e} > {TOL:g}")


def median_ms(fn, batches: int = 7, per_batch: int = 10):
    """(device ms, host ms) of one call: the median over batches of the
    mean time between CUDA events, and of the host's time to issue it. A
    device time no larger than the host time means the launches, not the
    kernel, set the pace."""
    fn()
    torch.cuda.synchronize()
    times, host = [], []
    for _ in range(batches):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        t0 = time.perf_counter()
        for _ in range(per_batch):
            fn()
        host.append((time.perf_counter() - t0) * 1e3 / per_batch)
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_batch)
    return statistics.median(times), statistics.median(host)


def ptxas_usage(log: str):
    """{function: (registers a thread or None, spill store bytes, spill
    load bytes)} of every kernel instance (with its registers) and every
    out-of-line device function in ptxas's -v output."""
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


def k1_registers(log: str):
    """{(storage, scheme, shard, full): (registers a thread, spill stores,
    spill loads)} of the K1 instances (k1_step_kernel<S, OBST, SHARD,
    FULL>) in ptxas's -v output."""
    out = {}
    for entry, use in ptxas_usage(log).items():
        k = re.search(r"k1_step_kernelI\d+(F32Store|DevStore)Li(\d)ELb([01])ELb([01])E", entry)
        if k:
            out[k.group(1), int(k.group(2)), k.group(3) == "1", k.group(4) == "1"] = use
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


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BW * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k3_work(cs, H: int, W: int, S: int, tile):
    """Work of one K3 pass of S sub-steps on an H x W grid.

    The function's own work sets the bound: f (36 B) and aux (4 B) read once,
    f (36 B) written once, 76 B a cell whatever S is, and 120 operations
    (K1's count; the ring's BCs are cheaper) per cell and sub-step. The
    kernel's tiles at centre ``tile`` do more, and that is a design figure
    beside the bound: each block loads its window's rows (the tile's rows
    and S more a side) over 128 columns (csrc/k3_fused.cu), the cells
    inside the grid, 36 B each, reads aux through L1 (4 B a window cell),
    and stores each grid cell once (36 B); every cell update of levels 1 ..
    S moves 72 B through shared memory (9 populations read, 9 written; the
    last level writes device memory instead) and each loaded cell 36 B.
    Returns (bytes, operations, tile bytes, shared-memory bytes, cell
    updates)."""
    th, tw = tile
    ww = cs.k3_window_w(S, tw)
    loaded = updates = smem = 0
    for yn in range(0, H, th):
        yc = min(yn, max(H - th, 0))
        rows = [max(yc - S, 0), min(yc + th + S, H)]
        for xn in range(0, W, tw):
            xc = min(xn, max(W - tw, 0))
            x0 = cs.k3_window_x0(xc, S, tw, W)
            loaded += (rows[1] - rows[0]) * (min(x0 + ww, W) - max(x0, 0))
            for s in range(1, S + 1):
                n = ((min(yc + th + S - s, H) - max(yc - S + s, 0))
                     * (min(xc + tw + S - s, W) - max(xc - S + s, 0)))
                updates += n
                smem += (72 if s < S else 36) * n
    smem += 36 * loaded
    return (76 * H * W, K1_OPS_PER_CELL * H * W * S, 40 * loaded + 36 * H * W, smem,
            updates)


class MomentSink:
    """In-memory stand-in for the HDF5 writer: keeps what the loop appends."""

    def __init__(self):
        self.frames = []

    def append(self, moments, pre_resized=False):
        self.frames.append(np.asarray(moments))


# phase 9: the sibling cases of the multi-worker runs, the per-worker
# time limit and the multi-host mesh
COORD_NUS = (0.02, 0.03, 0.04, 0.05)
WORKER_TIMEOUT_S = 300
MH_MESH = "2x1"


def spawn_workers(mode: str, arg_list, timeout: float = WORKER_TIMEOUT_S):
    """Start one ``tools/smoke_workers`` process per JSON args, all at
    once, each with a hard time limit; returns ([(record, stdout)], wall
    seconds from the first start to the last exit). A worker that fails,
    hangs or prints no record raises with its output; none outlives this
    call."""
    env = dict(os.environ, PYTHONPATH=HERE + os.pathsep + os.environ.get("PYTHONPATH", ""),
               SMOKE_WORKER_TRIPWIRE_S=str(timeout - 20))
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, "-m", "lbm2d_tpu_torch.tools.smoke_workers", mode,
                               json.dumps(a)], cwd=HERE, env=env, stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True) for a in arg_list]
    outs = []
    try:
        for proc in procs:
            left = max(1.0, timeout - (time.perf_counter() - t0))
            try:
                outs.append(proc.communicate(timeout=left))
            except subprocess.TimeoutExpired:
                raise AssertionError(f"phase 9 {mode} worker exceeded {timeout} s")
    finally:
        for proc in procs:
            if proc.poll() is None:
                proc.kill()
                proc.wait()
    wall = time.perf_counter() - t0
    recs = []
    for proc, (out, err) in zip(procs, outs):
        lines = [x for x in out.splitlines() if x.startswith("WORKER ")]
        if proc.returncode != 0 or not lines:
            raise AssertionError(f"phase 9 {mode} worker exited {proc.returncode}:\n"
                                 f"{out[-3000:]}\n{err[-6000:]}")
        recs.append((json.loads(lines[-1][len("WORKER "):]), out))
    return recs, wall


def sum_launches(records, variants):
    """{variant: launches summed over worker records}."""
    return {k: sum(r["launches"].get(k, 0) for r in records) for k in variants}


def check_coordinated(out_dir: str, names, recs, tag: str):
    """Every case Success, owned by one of the workers; the claims released;
    the NPZ complete. Returns {worker id: [case file names]}."""
    with open(os.path.join(out_dir, "plots", "sim_results.json")) as fh:
        results = {e["config_filename"]: e for e in json.load(fh)}
    ids = []
    for _, out in recs:
        ids += [x.split("worker=", 1)[1] for x in out.splitlines() if "multi-worker mode, worker=" in x]
    owners = {}
    for fname, _ in names:
        e = results[fname]
        if e["status"] != "Success" or e.get("worker") not in ids:
            raise AssertionError(f"{tag}: {fname} {e['status']} owned by {e.get('worker')} "
                                 f"(workers {ids})")
        owners.setdefault(e["worker"], []).append(fname)
    claims = os.listdir(os.path.join(out_dir, "plots", ".claims"))
    vec = np.load(os.path.join(out_dir, "plots", "all_cases_vectors.npz"), allow_pickle=True)
    if claims or len(vec["case_names"]) != len(names):
        raise AssertionError(f"{tag}: claims left {claims}, NPZ cases {list(vec['case_names'])}")
    return owners


def phase9(config, mask, f_serial, force8c, h5_8c, counted, card):
    """The multi-worker and multi-process paths (see the module docstring);
    returns their launches by path. ``f_serial``: phase 3's final f;
    ``force8c``, ``h5_8c``: the final force (float64, and the run's float32
    monitor) and the datasets of phase 8(c)'s one-process run of the smoke
    case on a 1x1 mesh."""
    import hashlib
    import socket

    from lbm2d_tpu_torch.core.engine import LBMEngine
    from lbm2d_tpu_torch.ops import cuda_step as cs
    from lbm2d_tpu_torch.parallel.batch import BatchEngine
    from lbm2d_tpu_torch.pipeline.batch_run import run_batch
    from lbm2d_tpu_torch.tools import smoke_case

    H, W = mask.shape
    max_steps = int(config["simulation"]["max_steps"])
    chunk = int(config["simulation"]["compute_step_size"])
    chunks = max_steps // chunk
    per_case = {"k1_step": chunks * (chunk - 1), "k1_step_full": chunks}
    n = len(COORD_NUS)
    by_path = {}

    # (a) serial --coordinate: two OS processes on one project, video on
    with tempfile.TemporaryDirectory(prefix="chip_smoke_9a_") as root:
        names = smoke_case.write_sibling_project(root, config, mask, COORD_NUS, name="Coord")
        argv = ["--project_name", "Coord", "--root", root, "--coordinate"]
        recs, wall = spawn_workers("batch", [{"argv": argv}] * 2)
        out_dir = os.path.join(root, "outputs", "Coord")
        owners = check_coordinated(out_dir, names, recs, "9(a)")
        ran = [r["launches"].get("k1_step_full", 0) // chunks for r, _ in recs]
        print(f"[9] (a) serial --coordinate, 2 workers x {n} cases: {wall:.2f} s wall; "
              f"cases run per worker {ran}; owners {owners} [{card}]", flush=True)
        for r, _ in recs:
            k = r["launches"].get("k1_step_full", 0) // chunks
            want = {v: c * k for v, c in per_case.items() if k}
            print(f"    worker launches {r['launches']}, plain calls {r['plain_calls']}", flush=True)
            if r["launches"] != want or any(r["plain_calls"].values()):
                raise AssertionError(f"9(a): launches {r['launches']} (want {want}), "
                                     f"plain calls {r['plain_calls']}")
        if sum(ran) != n:
            raise AssertionError(f"9(a): {sum(ran)} case runs for {n} cases")
        if len(owners) < 2:
            print("    (one worker won every claim race)", flush=True)
        for _, case in names:
            mp4 = os.path.join(out_dir, "vis", f"{case}.mp4")
            if not os.path.exists(mp4) or os.path.getsize(mp4) <= 0:
                raise AssertionError(f"9(a): no mp4 for {case}")
        # the same configs run by one in-process worker (video off: the
        # datasets do not depend on it)
        with tempfile.TemporaryDirectory(prefix="chip_smoke_9a1_") as root1:
            smoke_case.write_sibling_project(root1, config, mask, COORD_NUS, name="Coord",
                                             video=False)
            one = run_batch("Coord", root=root1, progress=False, device="cuda")
            if one.get("success") != n:
                raise AssertionError(f"9(a) one-worker run: {one}")
            for _, case in names:
                got = smoke_case.read_datasets(os.path.join(out_dir, "raw", f"{case}.h5"))
                ref = smoke_case.read_datasets(
                    os.path.join(root1, "outputs", "Coord", "raw", f"{case}.h5"))
                if sorted(got) != sorted(ref) or any(
                        got[k].tobytes() != ref[k].tobytes() for k in ref):
                    raise AssertionError(f"9(a): {case} datasets differ from the one-worker run")
        print(f"    every case Success once, owners disjoint, .claims/ empty, NPZ {n} cases, "
              f"{n} mp4; each case's HDF5 datasets byte-equal to a one-worker run", flush=True)
        by_path["coord"] = sum_launches([r for r, _ in recs], cs.KERNEL_VARIANTS)

    # (b) lockstep --coordinate --f16_state --max_batch 2: one worker alone,
    # then two at once, each on a fresh copy of the project
    lock = {"k1_step_dev": chunks * (chunk - 1), "k1_step_full": chunks}
    runs = {}
    lock_records = []
    for n_workers in (1, 2):
        with tempfile.TemporaryDirectory(prefix="chip_smoke_9b_") as root:
            names = smoke_case.write_sibling_project(root, config, mask, COORD_NUS, name="Lock")
            argv = ["--project_name", "Lock", "--root", root, "--coordinate", "--lockstep",
                    "--f16_state", "--max_batch", "2"]
            recs, wall = spawn_workers("batch", [{"argv": argv}] * n_workers)
            owners = check_coordinated(os.path.join(root, "outputs", "Lock"), names, recs,
                                       f"9(b) x{n_workers}")
        for r, _ in recs:
            k = r["launches"].get("k1_step_full", 0) // chunks
            want = {v: c * k for v, c in lock.items() if k}
            if r["launches"] != want or any(r["plain_calls"].values()):
                raise AssertionError(f"9(b): launches {r['launches']} (want {want}), "
                                     f"plain calls {r['plain_calls']}")
        lock_records += [r for r, _ in recs]
        span = max(r["t1"] for r, _ in recs) - min(r["t0"] for r, _ in recs)
        cells = n * max_steps * H * W
        runs[n_workers] = (wall, span)
        print(f"[9] (b) lockstep --coordinate --f16_state --max_batch 2, {n_workers} worker(s) x "
              f"{n} cases: {wall:.2f} s from spawn to exit = {cells / wall / 1e6:.1f} MLUPS, "
              f"{n / wall * 3600:.0f} cases/hour; run_batch span {span:.2f} s = "
              f"{cells / span / 1e6:.1f} MLUPS aggregate wall, {n / span * 3600:.0f} cases/hour; "
              f"owners {owners} [{card}]", flush=True)
    (w1, s1), (w2, s2) = runs[1], runs[2]
    print(f"    two workers against one: spawn-to-exit {w1 / w2:.3f}x, run_batch span "
          f"{s1 / s2:.3f}x the cases/hour [{card}]", flush=True)
    by_path["coord_lock"] = sum_launches(lock_records, cs.KERNEL_VARIANTS)

    # (c) BatchEngine(runner="sharded"): 3 cases on a case mesh naming
    # cuda:0 twice (one inert pad), one chunk, f32 and store_dev, bitwise
    # against runner="auto"
    dev = torch.device("cuda", 0)
    cfgs = []
    for nu in COORD_NUS[:3]:
        c = json.loads(json.dumps(config))
        c["simulation"]["nu"] = nu
        cfgs.append(c)
    launches_c = {k: 0 for k in cs.KERNEL_VARIANTS}
    for store_dev in (False, True):
        sh9 = BatchEngine(cfgs, [mask] * 3, store_dev=store_dev, device="cuda",
                          runner="sharded", case_devices=[dev, dev])
        counted.clear()
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        m_sh = sh9.run_step(chunk)
        torch.cuda.synchronize()
        got = dict(cs.LAUNCHES)
        auto = BatchEngine(cfgs, [mask] * 3, store_dev=store_dev, device="cuda")
        m_auto = auto.run_step(chunk)
        kind = "k1_step_dev" if store_dev else "k1_step"
        want = {kind: 3 * (chunk - 1), "k1_step_full": 3}
        if {k: v for k, v in got.items() if v} != want or any(counted.values()):
            raise AssertionError(f"9(c): launches {got} (want {want}), plain calls {counted}")
        if sh9._shard_pad != 1 or len(sh9.mesh) != 2 or any(
                len(m_sh[k]) != 3 for k in ("force", "max_v", "stable")):
            raise AssertionError(f"9(c): pad {sh9._shard_pad}, mesh {sh9.mesh}, "
                                 f"monitors {[len(v) for v in m_sh.values()]}")
        for k in ("force", "max_v", "stable"):
            if not np.array_equal(m_sh[k], m_auto[k]):
                raise AssertionError(f"9(c) store_dev={store_dev}: monitor {k} differs")
        a, b = sh9.state, auto.state
        for k in ("f", "f_post", "rho", "u", "step"):
            if not torch.equal(getattr(a, k), getattr(b, k)):
                raise AssertionError(f"9(c) store_dev={store_dev}: state {k} differs")
        launches_c = {k: launches_c[k] + got[k] for k in launches_c}
        print(f"[9] (c) BatchEngine(runner='sharded'), 3 cases on [cuda:0, cuda:0] + 1 pad, "
              f"store_dev={store_dev}: states and monitors bitwise equal to runner='auto'; "
              f"launches {({k: v for k, v in got.items() if v})} (the pad launches nothing), "
              f"plain calls {counted}", flush=True)
        del sh9, auto
    by_path["case_sharded"] = launches_c

    # (d) multi-host: two processes in a gloo group, both on cuda:0, the
    # smoke case through run_one_case.main on a global 2x1 mesh
    f_sha = hashlib.sha256(f_serial.cpu().numpy().tobytes()).hexdigest()
    mh_records = []
    with tempfile.TemporaryDirectory(prefix="chip_smoke_9d_") as root:
        names = smoke_case.write_sibling_project(root, config, mask, (config["simulation"]["nu"],),
                                                 name="SmokeS", video=False)
        base = os.path.join(root, "SimCases", "SmokeS")
        cfg_path = os.path.join(base, "configs", names[0][0])
        mask_png = os.path.join(base, "masks", "smoke_mask.png")
        h5 = [os.path.join(root, f"rank{r}", "case.h5") for r in (0, 1)]
        for path in h5:
            os.makedirs(os.path.dirname(path))

        def multihost(cfg, timed, start=0):
            """Both ranks on ``cfg`` (resuming at step ``start``)."""
            with socket.socket() as s_:
                s_.bind(("127.0.0.1", 0))
                port = s_.getsockname()[1]
            args = [{"coord": f"127.0.0.1:{port}", "rank": r, "cfg": cfg, "mask": mask_png,
                     "h5": h5, "mesh": MH_MESH, "chunk": chunk, "timed_chunks": timed}
                    for r in (0, 1)]
            recs, wall = spawn_workers("multihost", args)
            mh_records.extend(r for r, _ in recs)
            left = (max_steps - start) // chunk
            want = {"k1_step_shard": left * (chunk - 1), "k1_step_shard_full": left}
            for r, out in recs:
                if r["status"] != "Success" or not r.get("multihost"):
                    raise AssertionError(f"9(d): rank {r['rank']}: {r['status']} ({r['reason']})")
                if r["launches"] != want or any(r["plain_calls"].values()):
                    raise AssertionError(f"9(d) rank {r['rank']}: launches {r['launches']} "
                                         f"(want {want}), plain calls {r['plain_calls']}")
                if r["f_sha256"] != f_sha:
                    raise AssertionError(f"9(d) rank {r['rank']}: final f differs from phase 3's")
            return recs, wall

        recs, wall = multihost(cfg_path, 5)
        r0, r1 = recs[0][0], recs[1][0]
        if r0["force"] != r1["force"] or r0["max_v"] != r1["max_v"]:
            raise AssertionError(f"9(d): monitors differ across ranks: {r0['force']}, "
                                 f"{r1['force']}")
        force64, force32 = force8c
        dforce = float(np.abs(np.array(r0["force"]) - force64).max())
        if dforce > 5e-6 * max(1.0, float(np.abs(force64).max())):
            raise AssertionError(f"9(d): force {r0['force']} vs phase 8(c)'s {force64}")
        got = smoke_case.read_datasets(h5[0])
        if sorted(got) != sorted(h5_8c) or any(
                got[k].tobytes() != h5_8c[k].tobytes() for k in h5_8c):
            raise AssertionError("9(d): rank 0's datasets differ from phase 8(c)'s")
        if os.path.exists(h5[1]) or os.path.exists(h5[1] + ".npz"):
            raise AssertionError("9(d): rank 1 wrote a case file")
        print(f"[9] (d) multi-host, 2 processes x 1 block ({MH_MESH} mesh on cuda:0, backend "
              f"{r0['backend']}, halos staged through pinned host buffers): both ranks Success "
              f"in {wall:.2f} s wall; final f bitwise equal to phase 3's on both; monitors equal "
              f"across ranks, force {r0['force']} vs phase 8(c)'s state in float64 "
              f"{force64.tolist()} (max diff {dforce:.3e}; 8(c)'s float32 monitor "
              f"{force32.tolist()}, {float(np.abs(force32 - force64).max()):.3e} off); rank 0's HDF5 datasets byte-equal to phase 8(c)'s; launches a "
              f"rank {r0['launches']}, plain calls {r0['plain_calls']}; "
              f"{r0['us_per_step']:.1f} us/step = {H * W / r0['us_per_step']:.1f} MLUPS [{card}]",
              flush=True)

        # resume from a checkpoint that only rank 0's path holds
        ckpt_cfg = json.loads(json.dumps(config))
        ckpt_cfg["mask"]["path"] = mask_png
        # interval 0: resume without writing checkpoints along the way
        ckpt_cfg["outputs"]["checkpoint"] = {"enable": True, "interval_steps": 0,
                                             "resume": True}
        ckpt_path = os.path.join(root, "checkpointed.json")
        with open(ckpt_path, "w") as fh:
            json.dump(ckpt_cfg, fh)
        eng = LBMEngine(ckpt_cfg, mask_yx=mask, device="cuda")
        for _ in range(1000 // chunk):
            eng.run_step(chunk)
        eng.save_checkpoint(h5[0] + ".ckpt.npz")
        del eng
        for path in h5:
            for f in (path, path + ".npz"):
                if os.path.exists(f):
                    os.remove(f)
        t0 = time.perf_counter()
        recs, wall = multihost(ckpt_path, 0, start=1000)
        resumed = ["[Checkpoint] resumed at step 1000" in out for _, out in recs]
        if not all(resumed):
            raise AssertionError(f"9(d) resume: ranks resumed {resumed}")
        print(f"    resume from a step-1000 checkpoint only rank 0's path holds: both ranks "
              f"resumed at step 1000 and ended Success with phase 3's final f, "
              f"{time.perf_counter() - t0:.2f} s [{card}]", flush=True)
    by_path["multihost"] = sum_launches(mh_records, cs.KERNEL_VARIANTS)
    return by_path


# phase 10: the README quickstart; its master config, the mask seed, the
# viscosities config_batch_gen must emit for it, and the depth cut
QS_PROJECT = "Urban-1"
QS_SEED = 7
QS_NUS = (0.007, 0.01, 0.02, 0.03, 0.05)
QS_DEPTH = dict(warmup=1000, chunk=100, max_steps=3000, interval=1000, video=True)
QS_PADS = {"pad_left": 256, "pad_right": 640, "pad_top": 192, "pad_bot": 192}


def phase10(config, mask, counted, card):
    """The README quickstart through the port's own CLIs and functions, at
    the production width (see the module docstring); returns its launches
    by path."""
    import contextlib
    import random
    import shutil

    import yaml

    from lbm2d_tpu_torch.analysis import io_bench, video_stats
    from lbm2d_tpu_torch.core.engine import LBMEngine
    from lbm2d_tpu_torch.ops import cuda_step as cs
    from lbm2d_tpu_torch.pipeline.batch_run import run_batch
    from lbm2d_tpu_torch.post import h5_to_zarr, zarrlite
    from lbm2d_tpu_torch.tools import config_batch_gen, gen_masks, smoke_case
    from lbm2d_tpu_torch.utils.masks import load_grayscale
    from lbm2d_tpu_torch.utils.profiling import device_trace

    H, W = mask.shape
    n = len(QS_NUS)
    chunks = QS_DEPTH["max_steps"] // QS_DEPTH["chunk"]
    want = {"k1_step_dev": n * chunks * (QS_DEPTH["chunk"] - 1), "k1_step_full": n * chunks}
    walls = {}
    by_path = {}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_qs_") as root, contextlib.chdir(root):
        shutil.copy(os.path.join(HERE, "master_config.yaml"), "master_config.yaml")
        base = os.path.join(root, "SimCases", QS_PROJECT)
        out = os.path.join(root, "outputs", QS_PROJECT)

        # step 1: gen_masks
        t0 = time.perf_counter()
        gen_masks.main(["-c", "master_config.yaml", "-n", "1", "--mode", "hybrid",
                        "--seed", str(QS_SEED)])
        walls["1 gen_masks"] = time.perf_counter() - t0
        with open(os.path.join(base, "masks", "metadata.json")) as fh:
            meta = json.load(fh)
        png = load_grayscale(os.path.join(base, "masks", meta[0]["file_name"]))
        same = bool(np.array_equal(png < 127, mask > 0.5))
        grid = (meta[0]["domain_W_total"], meta[0]["domain_H_total"])
        pads = {k: meta[0][k] for k in QS_PADS}
        print(f"[10] step 1, gen_masks -n 1 --mode hybrid --seed {QS_SEED}: "
              f"{meta[0]['file_name']} {grid[0]}x{grid[1]}, pads {pads}, {int((png < 127).sum())} "
              f"solid cells, equal to data/smoke_case_mask.npz bit for bit: {same}", flush=True)
        if len(meta) != 1 or not same or grid != (W, H) or pads != QS_PADS:
            raise AssertionError(f"step 1: {meta[0]['file_name']} {grid} {pads}, mask equal {same}")

        # step 2: config_batch_gen
        t0 = time.perf_counter()
        config_batch_gen.main(["-c", "master_config.yaml"])
        walls["2 config_batch_gen"] = time.perf_counter() - t0
        cfg_dir = os.path.join(base, "configs")
        cfgs = {}
        for fname in sorted(os.listdir(cfg_dir)):
            with open(os.path.join(cfg_dir, fname)) as fh:
                cfgs[fname] = yaml.safe_load(fh)
        nus = sorted(c["simulation"]["nu"] for c in cfgs.values())
        ref = json.loads(json.dumps(config))
        mid = next(c for c in cfgs.values() if c["simulation"]["name"] == ref["simulation"]["name"])
        diff = smoke_case.config_diff(mid, ref)
        with open(os.path.join(base, "config_meta.json")) as fh:
            metas = json.load(fh)
        print(f"[10] step 2, config_batch_gen: {len(cfgs)} configs, nu {nus}, "
              f"{mid['simulation']['max_steps']} steps each; {mid['simulation']['name']} differs "
              f"from data/smoke_case.json in {sorted(diff)}; config_meta.json "
              f"{[m['status'] for m in metas]}", flush=True)
        if (tuple(nus) != QS_NUS or not diff <= smoke_case.QUICKSTART_FREE_KEYS
                or [m["status"] for m in metas] != ["Pending"] * n):
            raise AssertionError(f"step 2: nu {nus}, differing keys "
                                 f"{diff - smoke_case.QUICKSTART_FREE_KEYS}, metas {len(metas)}")

        # cut in depth only, as the smoke case is
        smoke_case.cut_depth(cfg_dir, **QS_DEPTH)
        print(f"[10] cut in depth only: {QS_DEPTH} (warmup, chunk, max steps, the start of "
              f"recording and every interval), for each of the {n} configs", flush=True)

        # step 3: batch_run --lockstep with the production flags
        if smoke_case.use_memory_h5():
            print("[10] h5py is not installed here: the HDF5 writer and readers run on the "
                  "in-memory stand-in of h5py.File", flush=True)
        counted.clear()
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        stats = run_batch(QS_PROJECT, root=root, progress=False, device="cuda",
                          **smoke_case.PRODUCTION_FLAGS)
        torch.cuda.synchronize()
        walls["3 batch_run --lockstep"] = time.perf_counter() - t0
        launches = {k: v for k, v in cs.LAUNCHES.items() if v}
        by_path["quickstart"] = dict(cs.LAUNCHES)
        with open(os.path.join(out, "plots", "sim_results.json")) as fh:
            results = {e["config_filename"]: e for e in json.load(fh)}
        statuses = {f: results[f]["status"] for f in cfgs}
        flags = " ".join(f"--{k}" if v is True else f"--{k} {v}"
                         for k, v in smoke_case.PRODUCTION_FLAGS.items() if k != "lockstep")
        print(f"[10] step 3, batch_run --lockstep {flags}: {stats} in "
              f"{walls['3 batch_run --lockstep']:.2f} s = "
              f"{n * QS_DEPTH['max_steps'] * H * W / walls['3 batch_run --lockstep'] / 1e6:.1f} "
              f"MLUPS aggregate wall [{card}]", flush=True)
        print(f"    statuses {statuses}; launches {launches} (want {want}), plain calls "
              f"{counted}", flush=True)
        if set(statuses.values()) != {"Success"} or stats.get("success") != n:
            for f, e in results.items():
                if e["status"] != "Success":
                    print(f"    {f}: {json.dumps(e.get('run_summary', e))[:600]}", flush=True)
            raise AssertionError(f"step 3: not every case succeeded: {statuses}")
        if launches != want or any(counted.values()):
            raise AssertionError(f"step 3: launches {launches} (want {want}), plain {counted}")
        frames = {}
        n_frames = (QS_DEPTH["max_steps"] - QS_DEPTH["interval"]) // QS_DEPTH["interval"] + 1
        for c in cfgs.values():
            case = c["simulation"]["name"]
            turb = smoke_case.read_turbulence(os.path.join(out, "raw", f"{case}.h5"))
            jx = float(turb[:, 3].mean())
            mp4 = os.path.join(out, "vis", f"{case}.mp4")
            size = os.path.getsize(mp4) if os.path.exists(mp4) else 0
            print(f"    {case}: turbulence {turb.shape} finite {bool(np.isfinite(turb).all())}, "
                  f"mean jx {jx:.4e}, mp4 {size} bytes", flush=True)
            if turb.shape[:2] != (n_frames, 9) or not np.isfinite(turb).all() or not jx > 0:
                raise AssertionError(f"step 3, {case}: frames {turb.shape}, mean jx {jx}")
            if size <= 0:
                raise AssertionError(f"step 3, {case}: no mp4")
            frames[case] = turb

        # step 4: h5_to_zarr, and the dataset read back
        zarr_dir = os.path.join(out, "zarr")
        t0 = time.perf_counter()
        zstats = h5_to_zarr.run(os.path.join(out, "plots", "all_cases_summary.json"),
                                os.path.join(out, "raw"), zarr_dir)
        walls["4 h5_to_zarr"] = time.perf_counter() - t0
        with open(os.path.join(zarr_dir, "global_stats.json")) as fh:
            gstats = json.load(fh)
        if sorted(gstats["cases"]) != sorted(frames):
            raise AssertionError(f"step 4: global_stats lists {gstats['cases']}")
        m = np.asarray(gstats["mean"]).reshape(1, 9, 1, 1).astype(np.float32)
        sd = np.asarray(gstats["std"]).reshape(1, 9, 1, 1).astype(np.float32)
        t0 = time.perf_counter()
        for case, turb in frames.items():
            zcase = os.path.join(zarr_dir, f"{case}.zarr")
            got = zarrlite.read_region(os.path.join(zcase, "turbulence"),
                                       tuple(slice(0, k) for k in turb.shape))
            if not np.array_equal(got, ((turb - m) / sd).astype(np.float16)):
                raise AssertionError(f"step 4, {case}: the Zarr frames differ from the HDF5's")
            for name in ("vor", "sdf", "mix"):
                wmap = zarrlite.open_array(os.path.join(zcase, "sampling_weights", name))
                if not (wmap.min() >= 0.0 and wmap.max() <= 1.0):
                    raise AssertionError(f"step 4, {case}: {name} map outside [0, 1]")
        walls["4 read back"] = time.perf_counter() - t0
        codec = zarrlite.DEFAULT_CODEC
        print(f"[10] step 4, h5_to_zarr: {len(zstats['cases'])} cases -> {zarr_dir} (codec "
              f"{codec}); each case's turbulence read back with zarrlite.read_region equals "
              f"((frames - mean) / std).astype(float16) bit for bit; vor, sdf, mix maps in "
              f"[0, 1]", flush=True)

        # the analysis tools
        t0 = time.perf_counter()
        try:
            import cv2  # noqa: F401
        except ImportError as exc:
            print(f"[10] video_stats skipped: cv2 is not installed here ({exc})", flush=True)
        else:
            for case in frames:
                pngs = video_stats.process_video(os.path.join(out, "vis", f"{case}.mp4"))
                if not pngs or not all(os.path.getsize(p) > 0 for p in pngs):
                    raise AssertionError(f"video_stats, {case}: {pngs}")
            print(f"[10] video_stats: last and mean frames of {len(frames)} mp4s written",
                  flush=True)
        walls["5 video_stats"] = time.perf_counter() - t0
        case0 = sorted(frames)[0]
        t_read = io_bench._timed_zarr(os.path.join(zarr_dir, f"{case0}.zarr"), n_frames, 64,
                                      random.Random(SEED))
        print(f"[10] io_bench: one random {n_frames} x 9 x 64 x 64 crop of {case0}.zarr read "
              f"in {t_read * 1e3:.3f} ms [{card}]", flush=True)

        # one 100-step chunk of the smoke case under the profiler
        engine = LBMEngine(config, mask_yx=mask, device="cuda")
        engine.init()
        engine.run_step(QS_DEPTH["chunk"])  # warm-up
        torch.cuda.synchronize()
        trace_dir = os.path.join(root, "trace")
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        with device_trace(trace_dir):
            engine.run_step(QS_DEPTH["chunk"])
        walls["6 traced chunk"] = time.perf_counter() - t0
        by_path["quickstart_trace"] = dict(cs.LAUNCHES)
        traces = sorted(os.listdir(trace_dir))
        with open(os.path.join(trace_dir, traces[0])) as fh:
            events = json.load(fh)["traceEvents"]
        kernels = sorted({e["name"] for e in events if str(e.get("cat", "")).lower() == "kernel"
                          and "k1_step" in e.get("name", "")})
        print(f"[10] device_trace: {traces} ({os.path.getsize(os.path.join(trace_dir, traces[0]))} "
              f"bytes), {sum(e.get('cat') == 'kernel' for e in events)} kernel events, "
              f"k1_step kernels named: {[k[:60] for k in kernels]}", flush=True)
        if len(traces) != 1 or not kernels:
            cats = sorted({str(e.get("cat")) for e in events})
            raise AssertionError(f"device_trace: {traces}, no k1_step kernel in the trace "
                                 f"(event categories {cats})")
        del engine
        print("[10] wall seconds a step: " + ", ".join(f"{k} {v:.3f}" for k, v in walls.items())
              + f" [{card}]", flush=True)
    return by_path


def phase11(counted, card):
    """The port's headline bench at its defaults (``tools/bench.run()``),
    in this process; returns its launches."""
    from contextlib import redirect_stdout
    from io import StringIO

    from lbm2d_tpu_torch.ops import cuda_step as cs
    from lbm2d_tpu_torch.tools import bench
    from lbm2d_tpu_torch.tools.cuda_timing import graph_ms

    print("[11] the bench: tools.bench.run() at its defaults (1024^2 demo cylinder, nu 0.01, "
          "8 + 3 x 20 chunks of 500 steps, the 40-step guard)", flush=True)
    out = StringIO()
    counted.clear()
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    with redirect_stdout(out):
        res = bench.run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cs.LAUNCHES)
    lines = out.getvalue().splitlines()
    print(f"[11] {lines[0] if lines else '(no line)'} [{card}]", flush=True)
    line = json.loads(lines[0]) if len(lines) == 1 else {}
    if list(line) != ["metric", "value", "unit", "vs_baseline"] or line["metric"] != bench.METRIC:
        raise AssertionError(f"bench stdout is not its one JSON line: {lines}")
    n, chunk = 1024, 500
    chunks = 8 + 3 * 20
    # the timed chunks, then the guard's chunk; the guard's eager reference
    # is the one plain call
    want = {"k1_step": chunks * (chunk - 1) + bench.GUARD_STEPS - 1, "k1_step_full": chunks + 1}
    print(f"    {chunks * chunk} steps and the guard in {wall:.2f} s; guard max |f_k - f_e| / "
          f"max |f_e| = {res.guard_rel:.3e} (tolerance {bench.GUARD_TOL:g}); launches "
          f"{({k: v for k, v in launches.items() if v})}, plain calls {counted}", flush=True)
    if {k: v for k, v in launches.items() if v} != want:
        raise AssertionError(f"bench: launches {launches} (want {want})")
    if {k: v for k, v in counted.items() if v} != {"step": bench.GUARD_STEPS}:
        raise AssertionError(f"bench: plain calls {counted} (want only the guard's "
                             f"{bench.GUARD_STEPS} eager steps)")
    if res.state.step != chunks * chunk or not res.guard_rel < bench.GUARD_TOL:
        raise AssertionError(f"bench: step {res.state.step}, guard {res.guard_rel}")
    # where the bench's time goes: a whole chunk's device time (a CUDA graph
    # of run_chunk_cuda) and one K1 step's, against its bytes bound
    p = res.params
    chunk_us = graph_ms(lambda: cs.run_chunk_cuda(res.state, p, chunk), per_graph=1,
                        replays=3) * 1e3 / chunk
    f_out = torch.empty_like(res.state.f)
    aux = cs.pack_aux(p.damping, p.mask)
    scal = cs.scalar_row(p, res.state.step + 1)
    k1_us = graph_ms(lambda: cs.k1_step(res.state.f, f_out, aux, scal, p.use_les,
                                        p.bc_type)) * 1e3
    bound, by = bound_ms(76 * n * n, K1_OPS_PER_CELL * n * n)
    print(f"    {line['value']} MLUPS = {n * n / line['value']:.2f} us/step host-paced; device "
          f"time a step: whole chunk {chunk_us:.2f} us ({n * n / chunk_us:.1f} MLUPS), k1_step "
          f"{k1_us:.2f} us; K1's bound {bound * 1e3:.2f} us ({by}: 76 B/cell at 3.35 TB/s, "
          f"{n * n / (bound * 1e3):.1f} MLUPS) [{card}]", flush=True)
    return launches


def phase12(mask, counted, card, engines, exact_state):
    """The DFG-2D matrix at full width and cut depth through
    ``tools/dfg_suite.run_suite``; the Bouzidi q planes of the smoke mask
    timed on this host. Returns the suite's launches."""
    import platform

    from lbm2d_tpu_torch.core import solver
    from lbm2d_tpu_torch.ops import cuda_step as cs
    from lbm2d_tpu_torch.tools import dfg_suite

    cpu = platform.processor() or platform.machine()
    if os.path.exists("/proc/cpuinfo"):
        with open("/proc/cpuinfo") as fh:
            cpu = next((ln.split(":", 1)[1].strip() for ln in fh if ln.startswith("model name")),
                       cpu)
    times = []
    for _ in range(2):
        t0 = time.perf_counter()
        q = solver.bouzidi_q_planes(mask)
        times.append(time.perf_counter() - t0)
    print(f"[12] Bouzidi q planes of the smoke mask ({mask.shape[0]}x{mask.shape[1]}, the "
          f"mask's own signed distance): {', '.join(format(t, '.3f') for t in times)} s, "
          f"{int((q != 0.5).sum())} fractions off 1/2, on this host: {cpu}, "
          f"{os.cpu_count()} CPUs [{card}]", flush=True)

    print(f"[12] the DFG-2D matrix: dfg_suite.run_suite(steps={SUITE_STEPS}), "
          f"{len(dfg_suite.MATRIX)} rows at full width", flush=True)
    with open(os.path.join(HERE, "docs", "benchmarks", "dfg2d_results.json")) as fh:
        keys = set(json.load(fh)[0]) | {"card", "wall_s"}
    chunk = 200  # run_validation's default, which the suite keeps
    with tempfile.TemporaryDirectory(prefix="chip_smoke_suite_") as root:
        out = os.path.join(root, "dfg2d_results_h100.json")
        counted.clear()
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        rows = dfg_suite.run_suite(out, steps=SUITE_STEPS, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = dict(cs.LAUNCHES)
        with open(out) as fh:
            written = json.load(fh)
    print(f"    {len(rows)} rows in {wall:.2f} s; launches "
          f"{({k: v for k, v in launches.items() if v})}, plain calls {counted} [{card}]",
          flush=True)
    if written != rows or len(rows) != len(dfg_suite.MATRIX):
        raise AssertionError(f"suite: {len(written)} rows written, {len(rows)} returned")
    want = {}
    scheme = {"bounce_back": "k1_step_bounce", "bounce_back_halfway": "k1_step_halfway",
              "bounce_back_bouzidi": "k1_step_bouzidi"}
    for row, m in zip(rows, dfg_suite.MATRIX):
        tag = f"{m['obstacle']}/{m['inlet']}/{m['ny']}"
        floats = {k: v for k, v in row.items() if isinstance(v, float)}
        if set(row) != keys or not all(np.isfinite(v) for v in floats.values()):
            raise AssertionError(f"suite row {tag}: keys {sorted(set(row) ^ keys)} differ from "
                                 f"the TPU file's, or a value is not finite: {row}")
        if (row["obstacle"], row["inlet"], row["ny"], row["steps"]) != (
                m["obstacle"], m["inlet"], m["ny"], SUITE_STEPS) or row["card"] != card:
            raise AssertionError(f"suite row {tag}: {row}")
        fast = scheme[m["obstacle"]]
        want[fast] = want.get(fast, 0) + SUITE_STEPS // chunk * (chunk - 1)
        want[fast + "_full"] = want.get(fast + "_full", 0) + SUITE_STEPS // chunk
    if {k: v for k, v in launches.items() if v} != want or any(counted.values()):
        raise AssertionError(f"suite: launches {launches} (want {want}), plain calls {counted}")
    walls = ", ".join(format(r["wall_s"], ".2f") for r in rows)
    print(f"    every row's keys are the TPU file's plus card and wall_s, every value finite; "
          f"wall s a row: {walls}", flush=True)
    # the last row (ny 329, Bouzidi + NEBB) on: 200 steps through the
    # kernels and through the plain chunk runner from its state
    eng = engines[-1]
    p = eng.params
    if p.shape != (329, 1761) or cs.k1_variant(cs.obstacle_scheme(p)) != "k1_step_bouzidi":
        raise AssertionError(f"suite: last engine {p.shape}, {cs.obstacle_scheme(p)}")
    sk, mk = cs.run_chunk_cuda(eng.state, p, 200)
    sp, mp = cs.run_chunk_plain(eng.state, p, 200)
    torch.cuda.synchronize()
    exact_state("ny-329 Bouzidi + NEBB, 200 steps from the suite's state, kernels vs plain",
                sk, sp, mk, mp)
    return launches


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device (torch.cuda.is_available() is False)",
              file=sys.stderr)
        return 1
    sys.path.insert(0, HERE)
    import lbm2d_tpu_torch
    pkg_dir = os.path.dirname(os.path.abspath(lbm2d_tpu_torch.__file__))
    if os.path.dirname(pkg_dir) != HERE:
        raise RuntimeError(f"lbm2d_tpu_torch resolved outside this checkout: {pkg_dir}")
    from lbm2d_tpu_torch.core import solver
    from lbm2d_tpu_torch.core.engine import LBMEngine
    from lbm2d_tpu_torch.analysis import dfg_validation
    from lbm2d_tpu_torch.core.lattice import E as E_LAT
    from lbm2d_tpu_torch.core.lattice import f_eq
    from lbm2d_tpu_torch.ops import cuda_build, cuda_step as cs
    from lbm2d_tpu_torch.parallel import sharded as sh
    from lbm2d_tpu_torch.parallel.topology import make_mesh
    from lbm2d_tpu_torch.pipeline.sim_loop import run_simulation_loop
    from lbm2d_tpu_torch.tools import smoke_case
    from lbm2d_tpu_torch.tools.cuda_timing import card_line, graph_ms

    dev = torch.device("cuda", 0)
    card = card_line()

    # -- phase 0 ------------------------------------------------------------
    print(f"[0] card: {card}", flush=True)
    print(f"[0] torch {torch.__version__} (CUDA {torch.version.cuda}), "
          f"device {torch.cuda.get_device_name(0)}", flush=True)
    nv = subprocess.run([cuda_build.nvcc_path(), "--version"], capture_output=True,
                        text=True, check=True, timeout=60)
    print(f"[0] nvcc: {nv.stdout.strip().splitlines()[-1]}", flush=True)
    # the environment doctor, as a user runs it: it must name this card
    t0 = time.perf_counter()
    doc = subprocess.run([sys.executable, "-m", "lbm2d_tpu_torch.native"], cwd=HERE,
                         capture_output=True, text=True, timeout=600)
    print(f"[0] doctor (python -m lbm2d_tpu_torch.native), exit {doc.returncode} in "
          f"{time.perf_counter() - t0:.1f} s:", flush=True)
    print("\n".join("    " + line for line in doc.stdout.strip().splitlines()), flush=True)
    smi_name = card.split(",")[0].strip()
    if doc.returncode != 0 or f"device 0: {smi_name}" not in doc.stdout:
        raise AssertionError(f"the doctor does not name the card {smi_name!r}: "
                             f"{doc.stderr[-2000:]}")

    # -- phase 1 ------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build_all()
    for name in cuda_build.KERNELS:
        cuda_build.load(name)
    print(f"[1] built kernels in {time.perf_counter() - t0:.1f} s"
          + ("" if cuda_build.BUILD_SECONDS else " (the doctor of phase 0 built them)"),
          flush=True)
    # ptxas's registers a thread and spill bytes (stores / loads) of every
    # K1 instance, the fast and full steps apart, and of K3, beside K3's
    # resident blocks a SM, its shared-memory rows and its tile
    regs = k1_registers(cuda_build.BUILD_LOG.get("k1_step", ""))
    for (store, obst, shard, full), (nreg, st, ld) in sorted(regs.items()):
        print(f"    K1 {store:<8s} {cs.k1_variant(obst, full, store == 'DevStore', shard):<28s} "
              f"{nreg} registers, spills {st} / {ld} B", flush=True)
    regs3 = k3_registers(cuda_build.BUILD_LOG.get("k3_fused", ""))
    if not regs or not regs3:
        raise AssertionError("no ptxas register lines for K1 or K3 in the build log")
    for (obst, ww), (nreg, st, ld) in sorted(regs3.items()):
        print(f"    K3 {cs.k3_variant(obst, 0):<20s} window {ww:<3d} columns {nreg} registers, "
              f"spills {st} / {ld} B", flush=True)
    # the resident blocks a SM follow from the shared memory and the
    # launch bounds' register cap, which ptxas must keep
    over = {k: v[0] for k, v in regs3.items() if v[0] > cs.K3_MAX_REGISTERS}
    if over:
        raise AssertionError(f"K3 instances above {cs.K3_MAX_REGISTERS} registers: {over}")
    occupancy3 = {S: cs.k3_blocks_per_sm(S, cs.k3_tile(S)[1]) for S in (FUSE_S, FUSE_S_MAX)}
    for S, n in occupancy3.items():
        tw = cs.k3_tile(S)[1]
        print(f"    K3 at S = {S}: tile {cs.k3_tile(S)}, window {cs.k3_window_w(S, tw)} columns, "
              f"{cs.k3_window_w(S, tw) * S} threads and {cs.k3_smem_bytes(S, tw)} B of shared "
              f"memory a block (stages: an 8-row ring of level 0 filled by cp.async 3 "
              f"iterations ahead, 4 rows of each level 1 .. {S - 1}), {n} resident blocks a SM "
              f"(its shared memory and <= {cs.K3_MAX_REGISTERS} registers a thread)", flush=True)
    for name, log in cuda_build.BUILD_LOG.items():
        for fn, (nreg, st, ld) in ptxas_usage(log).items():
            if nreg is None and (st or ld):  # an out-of-line function's own spills
                print(f"    {name}: {fn}: spills {st} / {ld} B", flush=True)

    # -- phase 2 ------------------------------------------------------------
    config, mask = smoke_case.load_smoke_case()
    p = solver.make_params(config, mask, dtype=torch.float32, device=dev)
    H, W = p.shape
    print(f"[2] kernels vs plain at {H}x{W} f32, bc {p.bc_type}, LES {p.use_les}",
          flush=True)
    rng = np.random.default_rng(SEED)
    rho0 = torch.tensor(1.0 + 1e-3 * rng.standard_normal((H, W)), dtype=torch.float32, device=dev)
    u0 = torch.tensor(0.02 * rng.standard_normal((2, H, W)), dtype=torch.float32, device=dev)
    f0 = f_eq(rho0, u0[0], u0[1])
    state = solver.LBMState(f=f0, f_post=f0.clone(), rho=rho0, u=u0, step=0)
    state, _ = solver.run_chunk(state, p, 3)  # a developed state, eager
    aux = cs.pack_aux(p.damping, p.mask)
    scal = cs.scalar_row(p, state.step + 1)

    # Bouzidi wall fractions from a seeded generator: q in (0, 1] on the
    # mask's boundary links (fluid c, solid c + e_j), 0.5 elsewhere, so both
    # interpolation branches run
    solid_np = mask > 0.5
    links = np.zeros((8, H, W), bool)
    for j in range(1, 9):
        ex, ey = int(E_LAT[j, 0]), int(E_LAT[j, 1])
        nb = np.zeros_like(solid_np)
        nb[max(0, -ey):H - max(0, ey), max(0, -ex):W - max(0, ex)] = solid_np[
            max(0, ey):H - max(0, -ey), max(0, ex):W - max(0, -ex)]
        links[j - 1] = ~solid_np & nb
    q_np = np.where(links, 1.0 - rng.random(links.shape), 0.5).astype(np.float32)
    qplanes = torch.from_numpy(q_np).to(dev)
    n_links = int(links.sum())
    print(f"  Bouzidi q planes: {n_links} boundary links, {int((q_np < 0.5).sum())} with q < 1/2",
          flush=True)

    def combo_params(bc):
        """The smoke case with BC types ``bc``; left types 3/4 get a
        parabolic inlet of u_max 0.1."""
        cfg = json.loads(json.dumps(config))
        cfg["boundary_condition"]["type"] = list(bc)
        if bc[0] in (solver.BC_VEL_INLET, solver.BC_VEL_INLET_NEBB):
            cfg["boundary_condition"]["value"][0] = [0.1, 0.0]
        return solver.make_params(cfg, mask, dtype=torch.float32, device=dev)

    def prof_of(pk):
        vel = pk.bc_type[0] in (solver.BC_VEL_INLET, solver.BC_VEL_INLET_NEBB)
        return pk.inlet_profile if vel else None

    def bc_tag(pk):
        return "".join(str(int(t)) for t in pk.bc_type)

    combos = [(pk, cs.scalar_row(pk, state.step + 1)) for pk in map(combo_params, BC_COMBOS)]

    def exact(tag, a, b):
        """Max relative error of a variant's output, which must be 0
        (bitwise: the same per-cell code in the same order)."""
        err = rel_err(a, b)
        if not torch.equal(a, b):
            raise AssertionError(f"{tag}: not bitwise equal to its plain version "
                                 f"(max rel err {err:.3e})")
        return err

    def k1_buffers(full):
        # NaN, so a cell the kernel leaves unwritten fails the check
        nan = float("nan")
        out = {"f_out": torch.full_like(state.f, nan)}
        if full:
            out.update(rho=torch.full((H, W), nan, device=dev),
                       u=torch.full((2, H, W), nan, device=dev), f_post=state.f_post.clone())
        return out

    def run_k1(fn, b, obst, pk, sc):
        fn(state.f, b["f_out"], aux, sc, p.use_les, pk.bc_type, b.get("rho"), b.get("u"),
           b.get("f_post"), obstacle=obst, q=qplanes if obst == cs.OBSTACLE_BOUZIDI else None,
           prof=prof_of(pk))

    def abs_err(bk, bp, fields):
        return max(float((bk[k].float() - bp[k].float()).abs().max()) for k in fields)

    def record(max_abs, errs, kernel_call, plain_call, nbytes, ops, usage=None):
        """A variant's readings; ``usage`` is ptxas's (registers, spill
        store bytes, spill load bytes) of its instance."""
        launch_ms, host_ms = median_ms(kernel_call)
        return dict(max_abs_err=max_abs,
                    max_rel_err=max(errs.values()), ms=graph_ms(kernel_call), launch_ms=launch_ms,
                    host_ms=host_ms,
                    plain_ms=median_ms(plain_call, batches=5, per_batch=2)[0],
                    bound=bound_ms(nbytes, ops), registers=usage and usage[0],
                    spill_bytes=usage and list(usage[1:]))

    def over_combos(name, new_buffers, run, kern, plain):
        """Kernel and plain version over every BC combination, bitwise;
        returns (max abs err, {tag: rel err})."""
        errs, abs_errs = {}, []
        for pk, sc in combos:
            bk, bp = new_buffers(), new_buffers()
            run(kern, bk, pk, sc)
            run(plain, bp, pk, sc)
            torch.cuda.synchronize()
            abs_errs.append(abs_err(bk, bp, bk))
            for k in bk:
                tag = f"{name} bc {bc_tag(pk)} {k}"
                errs[tag] = exact(tag, bk[k], bp[k])
        print(f"  {name:<30s} {len(errs)} outputs over {len(combos)} BC combinations bitwise "
              f"(max rel err {max(errs.values()):.1e})", flush=True)
        return max(abs_errs), errs

    records = {}
    n_in = (H - 2) * (W - 2)
    ring = 2 * (H - 2) + 2 * W
    for obst in range(4):
        for full in (False, True):
            name = cs.k1_variant(obst, full)
            max_abs, errs = over_combos(
                name, lambda: k1_buffers(full),
                lambda fn, b, pk, sc: run_k1(fn, b, obst, pk, sc), cs.k1_step, cs.k1_step_plain)
            # f in (36 B) and aux (4 B) read, f out (36 B) written on every
            # cell, the ring included; the full variant adds rho and u on
            # every cell and f_post on the interior. Bouzidi reads q where
            # this mask has a boundary link (the dense [8, H, W] planes
            # would add 32 B/cell: PERF.md)
            nbytes = 76 * H * W
            ops = K1_OPS_PER_CELL * n_in + RING_OPS_PER_CELL * ring
            if full:
                nbytes += 12 * H * W + 36 * n_in
            if obst == cs.OBSTACLE_BOUZIDI:
                nbytes += 4 * n_links
                ops += K1_OPS_PER_LINK * n_links
            bk, bp = k1_buffers(full), k1_buffers(full)
            records[name] = record(
                max_abs, errs, lambda: run_k1(cs.k1_step, bk, obst, p, scal),
                lambda: run_k1(cs.k1_step_plain, bp, obst, p, scal), nbytes, ops,
                regs.get(("F32Store", obst, False, full)))

    # K1 in 16-bit deviation storage, on the same developed state
    fq = cs.quantize(state.f)

    def kd_buffers():
        return {"f_out": torch.full_like(fq, float("nan"))}

    def run_k1d(fn, b, obst, pk, sc):
        fn(fq, b["f_out"], aux, sc, p.use_les, pk.bc_type, obst, prof_of(pk))

    for obst in cs.DEV_OBSTACLES:
        name = cs.k1_variant(obst, dev=True)
        max_abs, errs = over_combos(name, kd_buffers,
                                    lambda fn, b, pk, sc: run_k1d(fn, b, obst, pk, sc),
                                    cs.k1_step_dev, cs.k1_step_dev_plain)
        # f 18 B in (bf16), aux 4, f 18 B out; the dequantize and quantize
        # add 18 operations per cell, 9 per ring cell
        bk, bp = kd_buffers(), kd_buffers()
        records[name] = record(
            max_abs, errs, lambda: run_k1d(cs.k1_step_dev, bk, obst, p, scal),
            lambda: run_k1d(cs.k1_step_dev_plain, bp, obst, p, scal), 40 * H * W,
            (K1_OPS_PER_CELL + 18) * n_in + (RING_OPS_PER_CELL + 9) * ring,
            regs.get(("DevStore", obst, False, False)))

    def vel_params(left_type):
        cfg = json.loads(json.dumps(config))
        cfg["boundary_condition"]["type"][0] = left_type
        cfg["boundary_condition"]["value"][0] = [0.1, 0.0]
        return solver.make_params(cfg, mask, dtype=torch.float32, device=dev)

    # K3 at S = 4 and S = 8 on its default tiles, each variant against its
    # plain version (the windowed algorithm) on the same state, left types
    # 0 and 3/4; output buffers start as NaN so an unwritten cell fails the
    # check; timed at S = 4, and k3_fused at S = 8
    tile3, tile8 = cs.k3_tile(FUSE_S), cs.k3_tile(FUSE_S_MAX)
    rows3 = torch.stack([cs.scalar_row(p, state.step + 1 + i) for i in range(FUSE_S)])
    rows8 = torch.stack([cs.scalar_row(p, state.step + 1 + i) for i in range(FUSE_S_MAX)])
    k3_bytes, k3_ops, k3_tile_bytes, k3_smem, k3_updates = k3_work(cs, H, W, FUSE_S, tile3)
    print(f"  K3: S = {FUSE_S}, centre tile {tile3}, {cs.k3_smem_bytes(FUSE_S, tile3[1])} B of "
          f"shared memory a block, {occupancy3[FUSE_S]} blocks a SM; bound from "
          f"{k3_bytes / (H * W * FUSE_S):.2f} B and {k3_ops / (H * W * FUSE_S):.1f} operations "
          f"per cell-step; the tiles move {k3_tile_bytes / (H * W * FUSE_S):.2f} B of device "
          f"memory per cell-step (halo re-reads included) and update "
          f"{k3_updates / (H * W * FUSE_S):.3f} cells per cell-step", flush=True)

    def run_k3(fn, out, obst, pk, rows=rows3, tile=tile3):
        fn(state.f, out, aux, rows, pk.bc_type, p.use_les, obst, pk.inlet_profile, tile)

    def nan_f():
        return torch.full_like(state.f, float("nan"))

    k3_params = {solver.BC_INLET: [p], solver.BC_VEL_INLET: [vel_params(4), vel_params(3)]}
    for obst in cs.FUSE_OBSTACLES:
        for lt, plist in k3_params.items():
            name = cs.k3_variant(obst, lt)
            errs, abs_errs = {}, []
            for pk in plist:
                for S_, rows_, tile_ in ((FUSE_S, rows3, tile3), (FUSE_S_MAX, rows8, tile8)):
                    bk, bp = nan_f(), nan_f()
                    run_k3(cs.k3_fused, bk, obst, pk, rows_, tile_)
                    run_k3(cs.k3_fused_plain, bp, obst, pk, rows_, tile_)
                    torch.cuda.synchronize()
                    tag = f"{name} S {S_} left {pk.bc_type[0]} f"
                    errs[tag] = rel_err(bk, bp)
                    abs_errs.append(float((bk - bp).abs().max()))
                    check(tag + (" (bitwise)" if torch.equal(bk, bp) else ""), errs[tag])
            pk = plist[0]
            prof_bytes = 4 * H if pk.inlet_profile is not None else 0
            records[name] = record(max(abs_errs), errs, lambda: run_k3(cs.k3_fused, bk, obst, pk),
                                   lambda: run_k3(cs.k3_fused_plain, bp, obst, pk),
                                   k3_bytes + prof_bytes, k3_ops,
                                   regs3.get((obst, cs.k3_window_w(FUSE_S, tile3[1]))))
    # one K3 pass against S single K1 steps, all through the kernels
    f_k = state.f
    for i in range(FUSE_S):
        nxt = torch.empty_like(f_k)
        cs.k1_step(f_k, nxt, aux, rows3[i], p.use_les, p.bc_type)
        f_k = nxt
    bk = nan_f()
    run_k3(cs.k3_fused, bk, cs.OBSTACLE_EQ, p)
    torch.cuda.synchronize()
    check(f"k3_fused pass vs {FUSE_S} x K1" + (" (bitwise)" if torch.equal(bk, f_k) else ""),
          rel_err(bk, f_k))
    # the deepest fusion, timed beside S = 4
    b8 = nan_f()
    k3_s8 = dict(zip(("bytes", "ops", "tile_bytes", "smem", "updates"),
                     k3_work(cs, H, W, FUSE_S_MAX, tile8)))
    k3_s8.update(tile=tile8, ms=graph_ms(lambda: run_k3(cs.k3_fused, b8, cs.OBSTACLE_EQ, p,
                                                        rows8, tile8)))
    # the sharded forms, on the four blocks of a 2x2 mesh of this card with
    # real halos cut from the developed state (NaN beyond the global edge,
    # so a read of one would show): each variant on every block against
    # its plain version, bitwise; timed on block (0, 0), which holds the
    # global left column and bottom row
    mesh22 = make_mesh((2, 2), [dev] * 4)
    hl2, wl2 = H // 2, W // 2
    blocks2 = [(iy, ix) for iy in range(2) for ix in range(2)]
    geoms2 = {b: cs.BlockGeom.shard(hl2, wl2, b[0] * hl2, b[1] * wl2, H, W) for b in blocks2}
    pitch2 = geoms2[0, 0].pitch
    T2 = (0, 0)

    def cut(x, fill=sh.NAN):
        bl = sh.halo_blocks(x, mesh22, fill, pitch2)
        return {b: bl[b[0]][b[1]] for b in blocks2}

    # f_post is an output buffer (compared whole): a finite halo
    fS, auxS, qS, fpS = cut(state.f), cut(aux), cut(qplanes), cut(state.f_post, 0.0)
    fqS = {b: cs.quantize(v) for b, v in fS.items()}
    print(f"  sharded forms: 2x2 mesh of {dev}, blocks {hl2}x{wl2} in [{hl2 + 2}, {pitch2}] "
          f"planes; each variant on all four blocks, bitwise", flush=True)

    def interior_box(g):
        i0, i1, j0, j1 = g.interior()
        return (slice(g.y_off + i0, g.y_off + i1 + 1), slice(g.x_off + j0, g.x_off + j1 + 1))

    def ring_cells(g):
        inner = min(g.hl - 1, g.Hg - 2 - g.y_off) - max(0, 1 - g.y_off) + 1
        return (inner * ((g.x_off == 0) + (g.x_off + g.wl == g.Wg))
                + g.wl * ((g.y_off == 0) + (g.y_off + g.hl == g.Hg)))

    def ks_buffers(b, full, dtype=torch.float32):
        # zeros: the halo, which no variant writes, compares equal
        g = geoms2[b]
        out = {"f_out": torch.zeros((9,) + g.plane, dtype=dtype, device=dev)}
        if full:
            out.update(rho=torch.zeros(g.plane, device=dev),
                       u=torch.zeros((2,) + g.plane, device=dev), f_post=fpS[b].clone())
        return out

    def prof_rows(pk, b):
        prof = prof_of(pk)
        return None if prof is None else prof[b[0] * hl2:(b[0] + 1) * hl2].contiguous()

    def run_ks(fn, b, bufs, obst, pk, sc):
        fn(fS[b], bufs["f_out"], auxS[b], sc, p.use_les, pk.bc_type, bufs.get("rho"),
           bufs.get("u"), bufs.get("f_post"), obstacle=obst,
           q=qS[b] if obst == cs.OBSTACLE_BOUZIDI else None, prof=prof_rows(pk, b),
           geom=geoms2[b])

    def run_kds(fn, b, bufs, obst, pk, sc):
        fn(fqS[b], bufs["f_out"], auxS[b], sc, p.use_les, pk.bc_type, obst, prof_rows(pk, b),
           geom=geoms2[b])

    def shard_checked(name, new_buffers, run, kern, plain):
        """Every block and BC combination through the kernel and its plain
        version, bitwise; returns (max abs err, {tag: rel err})."""
        errs, abs_errs = {}, []
        for pk, sc in combos:
            for b in blocks2:
                bk, bp = new_buffers(b), new_buffers(b)
                run(kern, b, bk, pk, sc)
                run(plain, b, bp, pk, sc)
                torch.cuda.synchronize()
                abs_errs.append(abs_err(bk, bp, bk))
                for k in bk:
                    tag = f"{name} bc {bc_tag(pk)} block {b} {k}"
                    errs[tag] = exact(tag, bk[k], bp[k])
        print(f"  {name:<30s} {len(errs)} outputs on 4 blocks x {len(combos)} BC combinations "
              f"bitwise (max rel err {max(errs.values()):.1e})", flush=True)
        return max(abs_errs), errs

    g2 = geoms2[T2]
    cells2 = (g2.hl + 2) * (g2.wl + 2)  # the block read with its halo
    n_in2 = (g2.interior()[1] - g2.interior()[0] + 1) * (g2.interior()[3] - g2.interior()[2] + 1)
    links2 = int(links[(slice(None),) + interior_box(g2)].sum())
    ring2 = ring_cells(g2)
    for obst in range(4):
        for full in (False, True):
            name = cs.k1_variant(obst, full, shard=True)
            max_abs, errs = shard_checked(
                name, lambda b: ks_buffers(b, full),
                lambda fn, b, bufs, pk, sc: run_ks(fn, b, bufs, obst, pk, sc),
                cs.k1_step, cs.k1_step_plain)
            # as K1 above, on block (0, 0) read with its halo ring and
            # written on its own cells (its interior and its global ring)
            nbytes = 40 * cells2 + 36 * g2.hl * g2.wl
            ops = K1_OPS_PER_CELL * n_in2 + RING_OPS_PER_CELL * ring2
            if full:
                nbytes += 12 * g2.hl * g2.wl + 36 * n_in2
            if obst == cs.OBSTACLE_BOUZIDI:
                nbytes += 4 * links2
                ops += K1_OPS_PER_LINK * links2
            bk, bp = ks_buffers(T2, full), ks_buffers(T2, full)
            records[name] = record(max_abs, errs,
                                   lambda: run_ks(cs.k1_step, T2, bk, obst, p, scal),
                                   lambda: run_ks(cs.k1_step_plain, T2, bp, obst, p, scal),
                                   nbytes, ops, regs.get(("F32Store", obst, True, full)))
    for obst in cs.DEV_OBSTACLES:
        name = cs.k1_variant(obst, dev=True, shard=True)
        max_abs, errs = shard_checked(
            name, lambda b: ks_buffers(b, False, cs.DEV_DTYPE),
            lambda fn, b, bufs, pk, sc: run_kds(fn, b, bufs, obst, pk, sc), cs.k1_step_dev,
            cs.k1_step_dev_plain)
        bk, bp = ks_buffers(T2, False, cs.DEV_DTYPE), ks_buffers(T2, False, cs.DEV_DTYPE)
        records[name] = record(
            max_abs, errs, lambda: run_kds(cs.k1_step_dev, T2, bk, obst, p, scal),
            lambda: run_kds(cs.k1_step_dev_plain, T2, bp, obst, p, scal),
            22 * cells2 + 18 * g2.hl * g2.wl,
            (K1_OPS_PER_CELL + 18) * n_in2 + (RING_OPS_PER_CELL + 9) * ring2,
            regs.get(("DevStore", obst, True, False)))

    missing = set(cs.KERNEL_VARIANTS) - set(records)
    if missing:
        raise AssertionError(f"phase 2 did not check {sorted(missing)}")

    # a 20-step chunk through the kernels against the eager reference step
    sk, mk = cs.run_chunk_cuda(state, p, 20)
    se, me = solver.run_chunk(state, p, 20)
    torch.cuda.synchronize()
    for k in ("f", "f_post", "rho", "u"):
        check(f"run_chunk_cuda(20) {k}", rel_err(getattr(sk, k), getattr(se, k)))
    check("run_chunk_cuda(20) force", rel_err(mk["force"], me["force"]))
    check("run_chunk_cuda(20) max_v", rel_err(mk["max_v"], me["max_v"]))
    # the same chunk in deviation storage against its plain version, on the
    # developed state
    sd, _ = cs.run_chunk_cuda(state, p, 20, store_dev=True)
    sp, _ = cs.run_chunk_plain(state, p, 20, store_dev=True)
    torch.cuda.synchronize()
    for k in ("f", "f_post", "rho", "u"):
        check(f"run_chunk_cuda(20, store_dev) {k}", rel_err(getattr(sd, k), getattr(sp, k)))
    # and within the quantization budget of the exact f32 chunk (> 0: the
    # path engaged), under the JAX package's own budget test's conditions
    # (tests/test_pallas.py: from rest, rho_in 1.02, warmup 30) on the
    # production grid and mask
    budget_cfg = json.loads(json.dumps(config))
    budget_cfg["simulation"].update(rho_in=1.02, warmup_steps=30)
    pb = solver.make_params(budget_cfg, mask, dtype=torch.float32, device=dev)
    rest = solver.init_state(H, W, torch.float32, dev)
    sd, _ = cs.run_chunk_cuda(rest, pb, 20, store_dev=True)
    sx, _ = cs.run_chunk_cuda(rest, pb, 20)
    torch.cuda.synchronize()
    dev_abs = max(float((getattr(sd, k) - getattr(sx, k)).abs().max()) for k in ("f", "rho", "u"))
    print(f"  store_dev chunk vs exact f32 chunk (budget conditions): max abs diff {dev_abs:.3e} "
          f"(must be > 0 and <= {DEV_TOL:g})", flush=True)
    if not 0 < dev_abs <= DEV_TOL:
        raise AssertionError(f"store_dev chunk differs from the f32 chunk by {dev_abs:.3e}")
    # a chunk is one program: run_chunk_cuda's library step loops (k3_passes,
    # k1_steps, then the closing k1_step) against the same chunk issued one
    # wrapper call a step (run_chunk_stepwise), bitwise, each chunk
    # straddling its case's warmup
    cfg_d, mask_d, _ = dfg_validation.dfg_case(ny=DFG_RUN["ny"], u_max=DFG_RUN["u_target"],
                                               re=DFG_RUN["re"], obstacle=DFG_RUN["obstacle"],
                                               inlet=DFG_RUN["inlet"])
    p_d = solver.make_params(cfg_d, mask_d, dtype=torch.float32, device=dev)
    Hd, Wd = p_d.shape
    rho_d = torch.tensor(1.0 + 1e-3 * rng.standard_normal((Hd, Wd)), dtype=torch.float32,
                         device=dev)
    u_d = torch.tensor(0.02 * rng.standard_normal((2, Hd, Wd)), dtype=torch.float32, device=dev)
    f_d = f_eq(rho_d, u_d[0], u_d[1])
    w3, w5 = int(config["simulation"]["warmup_steps"]), int(cfg_d["simulation"]["warmup_steps"])
    s_w3 = dataclasses.replace(state, step=w3 - LOOP_N // 2)
    s_w5 = solver.LBMState(f=f_d, f_post=f_d.clone(), rho=rho_d, u=u_d, step=w5 - LOOP_N // 2)
    for tag, pk, s0, store_dev, fuse in (
            ("f32 [0,2,1,2]", p, s_w3, False, None), ("store_dev", p, s_w3, True, None),
            (f"fused S = {FUSE_S}", p, s_w3, False, FUSE_S),
            (f"Bouzidi + NEBB {Hd}x{Wd}", p_d, s_w5, False, None)):
        cs._FUSE_STEPS = fuse
        try:
            cs.reset_launch_counts()
            a_, ma_ = cs.run_chunk_cuda(s0, pk, LOOP_N, store_dev=store_dev)
            la = {k: v for k, v in cs.LAUNCHES.items() if v}
            cs.reset_launch_counts()
            b_, mb_ = cs.run_chunk_stepwise(s0, pk, LOOP_N, store_dev=store_dev)
            lb = {k: v for k, v in cs.LAUNCHES.items() if v}
        finally:
            cs._FUSE_STEPS = None
        torch.cuda.synchronize()
        for k in ("f", "f_post", "rho", "u"):
            exact(f"chunk loop {tag} {k}", getattr(a_, k), getattr(b_, k))
        for k in ("force", "max_v"):
            exact(f"chunk loop {tag} {k}", ma_[k], mb_[k])
        if la != lb:
            raise AssertionError(f"chunk loop {tag}: launches {la}, per-step {lb}")
        print(f"  chunk loop vs per-step wrappers, {tag}, steps {s0.step + 1}-{s0.step + LOOP_N} "
              f"(warmup {pk.warmup_steps.item():g}): f, f_post, rho, u, force, max_v bitwise; "
              f"launches {la}", flush=True)

    def issue_us(call, n, repeats=5):
        """(host us, device us) a launch of one call of ``n`` launches made
        on an idle stream: the medians over ``repeats`` calls."""
        call()
        host, devt = [], []
        for _ in range(repeats):
            torch.cuda.synchronize()
            e0, e1 = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            e0.record()
            t0 = time.perf_counter()
            call()
            host.append((time.perf_counter() - t0) * 1e6 / n)
            e1.record()
            e1.synchronize()
            devt.append(e0.elapsed_time(e1) * 1e3 / n)
        return statistics.median(host), statistics.median(devt)

    # the host's issue time a launch of each loop entry, beside the device
    # time of its launches and the per-step wrapper's issue (phase 2's
    # records); a CUDA graph of a chunk would pay only where the loop's
    # issue exceeds a step's device time
    rows_i = cs.scalar_rows(p, state.step, ISSUE_N)
    fa_i, fb_i = torch.empty_like(state.f), torch.empty_like(state.f)
    fqa_i, fqb_i = torch.empty_like(fq), torch.empty_like(fq)
    aux_d = cs.pack_aux(p_d.damping, p_d.mask)
    fa_d, fb_d = torch.empty_like(f_d), torch.empty_like(f_d)
    rows_d = cs.scalar_rows(p_d, s_w5.step + LOOP_N, ISSUE_N)
    loop_issue = {
        "k1_step": (lambda: cs.k1_steps(state.f, fa_i, fb_i, aux, rows_i, p.use_les, p.bc_type),
                    ISSUE_N, f"k1_steps, f32, {H}x{W}"),
        "k1_step_dev": (lambda: cs.k1_steps(fq, fqa_i, fqb_i, aux, rows_i, p.use_les, p.bc_type,
                                            dev=True), ISSUE_N, f"k1_steps, store_dev, {H}x{W}"),
        "k3_fused": (lambda: cs.k3_passes(state.f, fa_i, fb_i, aux, rows_i, FUSE_S, p.bc_type,
                                          p.use_les), ISSUE_N // FUSE_S,
                     f"k3_passes, S = {FUSE_S}, {H}x{W}"),
        "k1_step_bouzidi": (lambda: cs.k1_steps(f_d, fa_d, fb_d, aux_d, rows_d, p_d.use_les,
                                                p_d.bc_type, cs.OBSTACLE_BOUZIDI, p_d.bouzidi_q,
                                                p_d.inlet_profile),
                            ISSUE_N, f"k1_steps, Bouzidi + NEBB, {Hd}x{Wd}"),
    }
    for name, (call, n, tag) in loop_issue.items():
        host_us, dev_us = issue_us(call, n)
        records[name]["loop_host_us"] = host_us
        print(f"  {tag}: {n} launches in one call, host issue {host_us:.2f} us a launch "
              f"(the per-step wrapper from Python: {records[name]['host_ms'] * 1e3:.1f} us), "
              f"device {dev_us:.1f} us a launch [{card}]", flush=True)
    # a whole chunk of the DFG grid issued both ways, from an idle stream,
    # and what each chunk still builds on the host or the device
    s_i = dataclasses.replace(s_w5, step=s_w5.step + LOOP_N)
    for tag, fn in (("run_chunk_cuda", cs.run_chunk_cuda),
                    ("run_chunk_stepwise", cs.run_chunk_stepwise)):
        host_us, dev_us = issue_us(lambda: fn(s_i, p_d, ISSUE_N), ISSUE_N, repeats=3)
        print(f"  {tag}({ISSUE_N}) at {Hd}x{Wd}: issued in {host_us:.2f} us/step, device "
              f"{dev_us:.2f} us/step [{card}]", flush=True)
    aux_ms = median_ms(lambda: cs.pack_aux(p.damping, p.mask), batches=5, per_batch=4)
    t0 = time.perf_counter()
    cs.scalar_rows(p, w3 + 1000, ISSUE_N)
    rows_post_us = (time.perf_counter() - t0) * 1e6
    t0 = time.perf_counter()
    cs.scalar_rows(p, 0, ISSUE_N)
    rows_warm_us = (time.perf_counter() - t0) * 1e6
    print(f"  per chunk at {H}x{W}: pack_aux {aux_ms[0] * 1e3:.1f} us of device time, "
          f"{aux_ms[1] * 1e3:.1f} us of host issue; scalar_rows({ISSUE_N}) {rows_post_us:.1f} us "
          f"past the warmup, {rows_warm_us:.1f} us inside it (host) [{card}]", flush=True)

    for name, r in records.items():
        print(f"  {name:<24s} {r['ms'] * 1e3:7.1f} us in a CUDA graph, {r['launch_ms'] * 1e3:.1f} us "
              f"launched from Python (host issue {r['host_ms'] * 1e3:.1f} us)  "
              f"plain {r['plain_ms'] * 1e3:9.1f} us  "
              f"bound {r['bound'][0] * 1e3:7.1f} us ({r['bound'][1]})  "
              f"registers/thread {r['registers']}, spills {r['spill_bytes']} B  [{card}]",
              flush=True)
        if name.startswith("k3_"):
            print(f"  {'':<24s} = {r['ms'] * 1e3 / FUSE_S:.1f} us/step; the tiles' device-memory "
                  f"traffic {k3_tile_bytes / PEAK_BW * 1e6:.1f} us, their shared-memory traffic "
                  f"{k3_smem / PEAK_SMEM * 1e6:.1f} us at {PEAK_SMEM / 1e12:.0f} TB/s (estimates)",
                  flush=True)
    b8_bound = bound_ms(k3_s8["bytes"], k3_s8["ops"])
    print(f"  k3_fused at S = {FUSE_S_MAX}, tile {k3_s8['tile']}: {k3_s8['ms'] * 1e3:.1f} us/pass = "
          f"{k3_s8['ms'] * 1e3 / FUSE_S_MAX:.1f} us/step; bound {b8_bound[0] * 1e3:.1f} us "
          f"({b8_bound[1]}), {occupancy3[FUSE_S_MAX]} blocks a SM, "
          f"{k3_s8['updates'] / (H * W * FUSE_S_MAX):.3f} cell updates per cell-step; the "
          f"tiles' device-memory traffic "
          f"{k3_s8['tile_bytes'] / PEAK_BW * 1e6:.1f} us, shared-memory traffic "
          f"{k3_s8['smem'] / PEAK_SMEM * 1e6:.1f} us (estimates) [{card}]", flush=True)

    # -- phase 3: the main path --------------------------------------------
    counted = {}

    def counting(mod, attr):
        fn = getattr(mod, attr)

        def wrapper(*a, **kw):
            counted[attr] = counted.get(attr, 0) + 1
            return fn(*a, **kw)

        setattr(mod, attr, wrapper)

    for mod, attr in ((solver, "step"), (cs, "k1_step_plain"), (cs, "k1_step_dev_plain"),
                      (cs, "k3_fused_plain"), (sh, "local_step")):
        counting(mod, attr)
    serial_kernels = ("k1_step", "k1_step_full")

    def per_step(counts, steps):
        """Kernel launches per lattice step, and the names launched."""
        n = sum(counts.values())
        return f"{n / steps:g} kernel launches a step ({n} over {steps} steps)"

    engine = LBMEngine(config, mask_yx=mask, device="cuda")
    engine.init()
    sink = MomentSink()
    max_steps = int(config["simulation"]["max_steps"])
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    md = run_simulation_loop(config, engine, None, None, sink, max_steps, progress=False)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launches = dict(cs.LAUNCHES)
    f_serial = engine.state.f.clone()  # phase 6 runs the same case fused
    wall3 = max_steps * H * W / wall / 1e6
    print(f"[3] main path: {md['status']} ({md['reason']}) after {md['final_steps']} steps "
          f"in {wall:.2f} s = {wall3:.1f} MLUPS wall "
          f"(monitors and {len(sink.frames)} moment fetches included) [{card}]", flush=True)
    print(f"    launches {({k: v for k, v in launches.items() if v})}, plain calls {counted}; "
          f"{per_step(launches, max_steps)}", flush=True)
    if md["status"] != "Success":
        raise AssertionError(f"main path ended {md['status']}: {md['reason']}")
    if ({k for k, v in launches.items() if v} != set(serial_kernels)
            or sum(launches.values()) != max_steps or any(counted.values())):
        raise AssertionError(f"main path did not run on the kernels: {launches}, {counted}")
    if not sink.frames:
        raise AssertionError("no moment frames were written")
    mom = sink.frames[-1]
    if mom.shape != (9, H, W) or not np.isfinite(mom).all():
        raise AssertionError(f"moments: shape {mom.shape}, finite {np.isfinite(mom).all()}")
    fx, fy = engine.get_force()
    jx = float(mom[3].mean())
    print(f"    mean jx {jx:.4e}, force ({fx:.4e}, {fy:.4e}), max |u| "
          f"{engine.get_max_velocity():.4f}", flush=True)
    if not (jx > 0 and fx > 0):
        raise AssertionError(f"unphysical flow: mean jx {jx}, Fx {fx}")

    # the deviation-storage loss on the developed flow the main path ends
    # with: the state the lockstep path runs in
    sd, _ = cs.run_chunk_cuda(engine.state, p, 20, store_dev=True)
    sx, _ = cs.run_chunk_cuda(engine.state, p, 20)
    torch.cuda.synchronize()
    loss = {k: float((getattr(sd, k) - getattr(sx, k)).abs().max()) for k in ("f", "rho", "u")}
    print(f"    20-step store_dev chunk vs exact from step {engine.step_count}: max abs diff "
          + ", ".join(f"{k} {v:.3e}" for k, v in loss.items())
          + f" (must be > 0 and <= {DEV_FLOW_TOL:g})", flush=True)
    if not 0 < max(loss.values()) <= DEV_FLOW_TOL:
        raise AssertionError(f"store_dev loss on the developed flow: {loss}")

    # steady chunk rate of the kernel path alone: host-paced us/step (CUDA
    # events around 5 chunks) and the host's time to issue them
    chunk = int(config["simulation"]["compute_step_size"])
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)

    def paced(run_chunk, n_chunks=5):
        """(us/step between events around ``n_chunks`` chunks, the host's
        issue us/step) of ``run_chunk()``, from an idle stream."""
        torch.cuda.synchronize()
        a.record()
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            run_chunk()
        issue = (time.perf_counter() - t0) * 1e6 / (n_chunks * chunk)
        b.record()
        b.synchronize()
        return a.elapsed_time(b) * 1e3 / (n_chunks * chunk), issue

    def two_turns(run_chunk):
        """(mean us/step, text) of two ``paced`` turns."""
        ts = [paced(run_chunk) for _ in range(2)]
        us = statistics.mean(t[0] for t in ts)
        return us, (f"{', '.join(f'{t[0]:.1f}' for t in ts)} us/step (the host issued it in "
                    f"{', '.join(f'{t[1]:.1f}' for t in ts)} us/step)")

    us_step3, text3 = two_turns(lambda: engine.run_step(chunk))
    mlups3 = H * W / us_step3
    s3 = engine.state  # phase 8 runs the sharded path from here
    print(f"    kernel path, two turns: {text3} = {mlups3:.1f} MLUPS; one step's device time "
          f"{records['k1_step']['ms'] * 1e3:.1f} us (k1_step in a CUDA graph, phase 2) [{card}]",
          flush=True)
    # the same in 16-bit deviation storage (the lockstep path's chunk runner)
    box3 = {"s": engine.state}

    def dev_chunk():
        box3["s"], _ = cs.run_chunk_cuda(box3["s"], p, chunk, store_dev=True)

    us_dev3, text_dev3 = two_turns(dev_chunk)
    print(f"    kernel path, store_dev, two turns: {text_dev3} = {H * W / us_dev3:.1f} MLUPS; one "
          f"step's device time {records['k1_step_dev']['ms'] * 1e3:.1f} us (k1_step_dev in a "
          f"CUDA graph) [{card}]", flush=True)
    # a whole chunk's device time, kernels, monitors and the chunk's own
    # copies included (run_chunk_cuda replayed from a CUDA graph), and what
    # the monitors (force, max |u|) take of it and of the host
    def monitors3():
        return solver.obstacle_force(s3.f_post, p), solver.max_velocity(s3.u)

    chunk3_us = {sd: graph_ms(lambda sd=sd: cs.run_chunk_cuda(s3, p, chunk, store_dev=sd),
                              per_graph=2, replays=3) * 1e3 / chunk for sd in (False, True)}
    mon3_us = graph_ms(monitors3, per_graph=4) * 1e3
    mon3_host = median_ms(monitors3, batches=5, per_batch=4)[1] * 1e3
    print(f"    a whole chunk's device time (run_chunk_cuda in a CUDA graph): f32 "
          f"{chunk3_us[False]:.1f} us/step, store_dev {chunk3_us[True]:.1f} us/step; of it the "
          f"monitors {mon3_us:.1f} us a chunk = {mon3_us / chunk:.1f} us/step (their host issue "
          f"{mon3_host:.1f} us a chunk) [{card}]", flush=True)

    # -- phase 4: the lockstep production path ------------------------------
    from lbm2d_tpu_torch.pipeline.batch_run import run_batch

    if smoke_case.use_memory_h5():
        print("[4] h5py is not installed here: the HDF5 writer runs on an in-memory "
              "stand-in of h5py.File", flush=True)
    from lbm2d_tpu_torch.pipeline import batch_datagen

    pacers = []

    class RecordingPacer(batch_datagen.FetchPacer):
        """FetchPacer that keeps a handle on itself for the record below."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            pacers.append(self)

    batch_datagen.FetchPacer = RecordingPacer
    nus = smoke_case.SIBLING_NUS
    n_cases = len(nus)
    chunks = max_steps // chunk
    want = {"k1_step_dev": n_cases * chunks * (chunk - 1), "k1_step_full": n_cases * chunks}
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        names = smoke_case.write_sibling_project(root, config, mask, nus)
        counted.clear()
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        stats = run_batch("Smoke4", root=root, progress=False, device="cuda",
                          **smoke_case.PRODUCTION_FLAGS)
        torch.cuda.synchronize()
        wall4 = time.perf_counter() - t0
        launches4 = dict(cs.LAUNCHES)
        out = os.path.join(root, "outputs", "Smoke4")
        with open(os.path.join(out, "plots", "sim_results.json")) as fh:
            results = {e["config_filename"]: e for e in json.load(fh)}
        print(f"[4] lockstep path, {n_cases} cases x {max_steps} steps: {stats} in {wall4:.2f} s "
              f"= {n_cases * max_steps * H * W / wall4 / 1e6:.1f} MLUPS aggregate wall "
              f"(monitors, device resize and render, fetches, HDF5 and mp4 included) [{card}]",
              flush=True)
        print(f"    launches {({k: v for k, v in launches4.items() if v})}, plain calls {counted}; "
              f"{per_step(launches4, n_cases * max_steps)}", flush=True)
        transfer = results[names[0][0]].get("run_summary", {}).get("transfer", {})
        print(f"    transfer record: {transfer}", flush=True)
        pacer = pacers[-1]
        print(f"    fetch pacer: fetch_stall_fraction {transfer.get('fetch_stall_fraction')}, "
              f"fetch_group_size_final {transfer.get('fetch_group_size_final')}, chunk-wall "
              f"estimate c_est {pacer.chunk_wall_est} s from {pacer.calibrating_chunks} "
              f"calibrating chunks", flush=True)
        loop_s = transfer.get("group_wall_s")
        if loop_s:
            print(f"    group loop {loop_s:.2f} s = {n_cases * max_steps * H * W / loop_s / 1e6:.1f} "
                  f"MLUPS = {loop_s * 1e6 / (n_cases * max_steps):.1f} us a case-step (device "
                  f"time of a k1_step_dev step {records['k1_step_dev']['ms'] * 1e3:.1f} us); "
                  f"set-up and wind-down {wall4 - loop_s:.2f} s [{card}]", flush=True)
        bad = {n: results[n]["status"] for n, _ in names if results[n]["status"] != "Success"}
        if bad or stats.get("success") != n_cases:
            raise AssertionError(f"lockstep cases did not all succeed: {stats}, {bad}")
        if {k: v for k, v in launches4.items() if v} != want or any(counted.values()):
            raise AssertionError(f"lockstep path: launches {launches4} (want {want}), "
                                 f"plain calls {counted}")
        for _, case in names:
            turb = smoke_case.read_turbulence(os.path.join(out, "raw", f"{case}.h5"))
            n_frames = (max_steps - int(config["outputs"]["start_record_step"])) // int(
                config["outputs"]["dataset"]["interval_steps"]) + 1
            jx4 = float(turb[:, 3].mean())
            mp4 = os.path.join(out, "vis", f"{case}.mp4")
            size = os.path.getsize(mp4) if os.path.exists(mp4) else 0
            print(f"    {case}: turbulence {turb.shape} finite {bool(np.isfinite(turb).all())}, "
                  f"mean jx {jx4:.4e}, mp4 {size} bytes", flush=True)
            if turb.shape[:2] != (n_frames, 9) or not np.isfinite(turb).all() or not jx4 > 0:
                raise AssertionError(f"{case}: bad dataset frames {turb.shape}, mean jx {jx4}")
            if size <= 0:
                raise AssertionError(f"{case}: no mp4 at {mp4}")

    # -- phase 5: the DFG-2D validation path -------------------------------
    engines = []

    class RecordingEngine(LBMEngine):
        """LBMEngine that keeps a handle on itself for the checks below."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    dfg_validation.LBMEngine = RecordingEngine
    print(f"[5] DFG-2D validation path: run_validation({DFG_RUN}, device='cuda')", flush=True)
    counted.clear()
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    t0 = time.perf_counter()
    res = dfg_validation.run_validation(device="cuda", **DFG_RUN)
    torch.cuda.synchronize()
    wall5 = time.perf_counter() - t0
    launches5 = dict(cs.LAUNCHES)
    eng = engines[-1]
    H5, W5 = eng.params.shape
    print(f"    {H5}x{W5}, {res['steps']} steps in {wall5:.2f} s = {wall5 / res['steps'] * 1e6:.1f} "
          f"us/step = {res['steps'] * H5 * W5 / wall5 / 1e6:.1f} MLUPS wall (force, monitors and "
          f"breaker per chunk included) [{card}]", flush=True)
    print(f"    launches {({k: v for k, v in launches5.items() if v})}, plain calls {counted}; "
          f"{per_step(launches5, res['steps'])}", flush=True)
    # one fast step's device time on the developed flow (a CUDA graph)
    p5 = eng.params
    f5 = torch.empty_like(eng.state.f)
    aux5 = cs.pack_aux(p5.damping, p5.mask)
    scal5 = cs.scalar_row(p5, eng.state.step + 1)
    obst5 = cs.obstacle_scheme(p5)
    dfg_step_ms = graph_ms(lambda: cs.k1_step(
        eng.state.f, f5, aux5, scal5, p5.use_les, p5.bc_type, obstacle=obst5, q=p5.bouzidi_q,
        prof=p5.inlet_profile))
    print(f"    one step's device time {dfg_step_ms * 1e3:.1f} us ({cs.k1_variant(obst5)} in a CUDA "
          f"graph) against {wall5 / res['steps'] * 1e6:.1f} us/step on the path [{card}]",
          flush=True)
    # the monitors of a DFG chunk: the chunk's own (Bouzidi force, max |u|)
    # and run_validation's force on the cylinder alone, then its reads
    cyl5 = torch.as_tensor(eng.params.mask.cpu().numpy().copy(), device=dev)
    cyl5[0, :] = 0.0
    cyl5[-1, :] = 0.0
    def monitors5():
        return (solver.obstacle_force(eng.state.f_post, p5), solver.max_velocity(eng.state.u),
                solver.obstacle_force(eng.state.f_post, p5, mask=cyl5))

    chunk5_us = graph_ms(lambda: cs.run_chunk_cuda(eng.state, p5, DFG_RUN["chunk"]),
                         per_graph=1, replays=3) * 1e3 / DFG_RUN["chunk"]
    mon5_host = median_ms(monitors5, batches=5, per_batch=4)[1] * 1e3
    print(f"    a whole chunk's device time {chunk5_us:.1f} us/step (run_chunk_cuda in a CUDA "
          f"graph); the host issues a chunk's monitors and the cylinder's force in "
          f"{mon5_host:.1f} us = {mon5_host / DFG_RUN['chunk']:.1f} us/step at chunks of "
          f"{DFG_RUN['chunk']} [{card}]", flush=True)
    with open(os.path.join(HERE, "docs", "benchmarks", "dfg2d_results.json")) as fh:
        recorded = next(r for r in json.load(fh) if r.get("ny") == DFG_RUN["ny"]
                        and r.get("obstacle") == DFG_RUN["obstacle"]
                        and r.get("inlet") == DFG_RUN["inlet"])
    for k in ("cd_mean", "strouhal", "strouhal_sine_fit", "cl_amplitude", "re_measured",
              "u_inlet_measured"):
        got = res.get(k, float("nan"))
        print(f"    {k:<18s} {got:.6f}  recorded (TPU, {recorded['steps']} steps) "
              f"{recorded[k]:.6f}  difference {got - recorded[k]:+.6f}", flush=True)
    chunks5 = DFG_RUN["steps"] // DFG_RUN["chunk"]
    want5 = {"k1_step_bouzidi": chunks5 * (DFG_RUN["chunk"] - 1),
             "k1_step_bouzidi_full": chunks5}
    if res["steps"] != DFG_RUN["steps"] or not res["shedding_detected"]:
        raise AssertionError(f"DFG run: {res['steps']} steps, shedding {res['shedding_detected']}")
    for k, (lo, hi) in DFG_RANGES.items():
        if not lo <= res[k] <= hi:
            raise AssertionError(f"DFG run: {k} {res[k]} outside [{lo}, {hi}]: {res}")
    if {k: v for k, v in launches5.items() if v} != want5 or any(counted.values()):
        raise AssertionError(f"DFG path: launches {launches5} (want {want5}), plain calls {counted}")

    # the other five pairs from the developed flow, kernels against the
    # plain chunk runner (the full-way pairs in deviation storage too)
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    developed = eng.state
    for obstacle in ("bounce_back", "bounce_back_halfway", "bounce_back_bouzidi"):
        for inlet in ("equilibrium", "nebb"):
            if (obstacle, inlet) == (DFG_RUN["obstacle"], DFG_RUN["inlet"]):
                continue
            cfg5, mask5, _ = dfg_validation.dfg_case(ny=DFG_RUN["ny"], u_max=DFG_RUN["u_target"],
                                                     re=DFG_RUN["re"], obstacle=obstacle,
                                                     inlet=inlet)
            p5 = solver.make_params(cfg5, mask5, dtype=torch.float32, device=dev)
            for store_dev in ((False, True) if obstacle == "bounce_back" else (False,)):
                sk = sp = developed
                for _ in range(DFG_PAIR_STEPS // DFG_PAIR_CHUNK):
                    sk, mk = cs.run_chunk_cuda(sk, p5, DFG_PAIR_CHUNK, store_dev=store_dev)
                    sp, mp = cs.run_chunk_plain(sp, p5, DFG_PAIR_CHUNK, store_dev=store_dev)
                torch.cuda.synchronize()
                for k in ("f", "rho", "u"):
                    check(f"{obstacle}/{inlet}{' store_dev' if store_dev else ''} {k}",
                          rel_err(getattr(sk, k), getattr(sp, k)))
                check(f"{obstacle}/{inlet}{' store_dev' if store_dev else ''} force",
                      rel_err(mk["force"], mp["force"]))
    launches5b = dict(cs.LAUNCHES)
    print(f"    other pairs: launches {({k: v for k, v in launches5b.items() if v})}", flush=True)

    # -- phase 6: the fused serial path -------------------------------------
    print(f"[6] fused serial path: cuda_step._FUSE_STEPS = {FUSE_S}, the phase 3 case", flush=True)
    chunks = max_steps // chunk
    passes6, split6 = divmod(chunk - 1, FUSE_S)
    want6 = {"k3_fused": chunks * passes6, "k1_step": chunks * split6, "k1_step_full": chunks}
    cs._FUSE_STEPS = FUSE_S
    try:
        engine6 = LBMEngine(config, mask_yx=mask, device="cuda")
        engine6.init()
        sink6 = MomentSink()
        counted.clear()
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        md6 = run_simulation_loop(config, engine6, None, None, sink6, max_steps, progress=False)
        torch.cuda.synchronize()
        wall6 = time.perf_counter() - t0
        launches6 = dict(cs.LAUNCHES)
        wall6_mlups = max_steps * H * W / wall6 / 1e6
        print(f"    {md6['status']} ({md6['reason']}) after {md6['final_steps']} steps in "
              f"{wall6:.2f} s = {wall6_mlups:.1f} MLUPS wall (phase 3: {wall3:.1f}) [{card}]",
              flush=True)
        print(f"    launches {({k: v for k, v in launches6.items() if v})}, plain calls {counted}; "
              f"{per_step(launches6, max_steps)} (K3 passes of {FUSE_S} steps, single K1 "
              f"steps)", flush=True)
        if md6["status"] != "Success":
            raise AssertionError(f"fused path ended {md6['status']}: {md6['reason']}")
        if {k: v for k, v in launches6.items() if v} != want6 or any(counted.values()):
            raise AssertionError(f"fused path: launches {launches6} (want {want6}), "
                                 f"plain calls {counted}")
        mom6 = sink6.frames[-1]
        fx6, _ = engine6.get_force()
        jx6 = float(mom6[3].mean())
        if mom6.shape != (9, H, W) or not np.isfinite(mom6).all() or not (jx6 > 0 and fx6 > 0):
            raise AssertionError(f"fused path: moments {mom6.shape}, mean jx {jx6}, Fx {fx6}")
        diff6 = float((engine6.state.f - f_serial).abs().max())
        print(f"    mean jx {jx6:.4e}, Fx {fx6:.4e}; final f vs phase 3: max abs diff {diff6:.3e}"
              + (" (bitwise equal)" if diff6 == 0 else ""), flush=True)
        check("fused path final f vs phase 3", rel_err(engine6.state.f, f_serial))
        us_step6, text6 = two_turns(lambda: engine6.run_step(chunk))
        dev6 = (passes6 * records["k3_fused"]["ms"] + split6 * records["k1_step"]["ms"]
                + records["k1_step_full"]["ms"]) * 1e3 / chunk
        chunk6_us = graph_ms(lambda: cs.run_chunk_cuda(engine6.state, engine6.params, chunk),
                             per_graph=2, replays=3) * 1e3 / chunk
        print(f"    kernel path, two turns: {text6} = {H * W / us_step6:.1f} MLUPS (phase 3: "
              f"{mlups3:.1f}); the chunk's kernels {dev6:.1f} us/step ({passes6} K3 passes, "
              f"{split6} K1 steps and the full step, each in a CUDA graph, phase 2), the whole "
              f"chunk {chunk6_us:.1f} us/step (run_chunk_cuda in a CUDA graph) [{card}]",
              flush=True)

        # the other schemes K3 runs, fused through the kernels against the
        # unfused plain chunk runner: each with both DFG inlets (left types
        # 3/4) from phase 5's developed flow, and full-way and half-way on
        # the smoke case (left type 0) from this phase's final state
        pairs6 = []
        for obstacle in ("equilibrium", "bounce_back", "bounce_back_halfway"):
            for inlet in ("equilibrium", "nebb"):
                cfg6, mask6, _ = dfg_validation.dfg_case(
                    ny=DFG_RUN["ny"], u_max=DFG_RUN["u_target"], re=DFG_RUN["re"],
                    obstacle=obstacle, inlet=inlet)
                pairs6.append((f"DFG {obstacle}/{inlet}", developed,
                               solver.make_params(cfg6, mask6, dtype=torch.float32, device=dev),
                               DFG_PAIR_CHUNK, DFG_PAIR_STEPS // DFG_PAIR_CHUNK))
        for obstacle in ("bounce_back", "bounce_back_halfway"):
            cfg6 = json.loads(json.dumps(config))
            cfg6["boundary_condition"]["obstacle"] = obstacle
            pairs6.append((f"smoke {obstacle}", engine6.state,
                           solver.make_params(cfg6, mask, dtype=torch.float32, device=dev),
                           chunk, 1))
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        for tag, s0, p6, n6, reps in pairs6:
            cs._FUSE_STEPS = None
            sp = s0
            for _ in range(reps):
                sp, mp = cs.run_chunk_plain(sp, p6, n6)
            cs._FUSE_STEPS = FUSE_S
            sk = s0
            for _ in range(reps):
                sk, mk = cs.run_chunk_cuda(sk, p6, n6)
            torch.cuda.synchronize()
            for k in ("f", "rho", "u"):
                check(f"fused {tag} {k}", rel_err(getattr(sk, k), getattr(sp, k)))
            check(f"fused {tag} force", rel_err(mk["force"], mp["force"]))
        launches6b = dict(cs.LAUNCHES)
        print(f"    other schemes: launches {({k: v for k, v in launches6b.items() if v})}",
              flush=True)
        idle6 = [v for v in cs.KERNEL_VARIANTS
                 if v.startswith("k3") and launches6[v] + launches6b[v] == 0]
        if idle6:
            raise AssertionError(f"phase 6 did not launch {idle6}: {launches6b}")
    finally:
        cs._FUSE_STEPS = None

    # -- phase 7: the roofline tool --------------------------------------------
    from lbm2d_tpu_torch.ops import copy_probe as cp
    from lbm2d_tpu_torch.tools import roofline

    print(f"[7] roofline tool at {ROOF_N}^2: measure({ROOF_N}, {ROOF_CHUNKS}, {ROOF_SPC})",
          flush=True)
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    cp.reset_launch_counts()
    roof = roofline.measure(ROOF_N, ROOF_CHUNKS, ROOF_SPC)
    torch.cuda.synchronize()
    launches7, copies7 = dict(cs.LAUNCHES), dict(cp.LAUNCHES)
    print("    " + json.dumps(roof), flush=True)
    print(f"    launches {({k: v for k, v in launches7.items() if v})}, {copies7}", flush=True)
    if not all(v > 0 for v in copies7.values()) or not np.isfinite(roof["mlups"]):
        raise AssertionError(f"roofline tool: {roof}, copy launches {copies7}")
    # the copy probe against its plain version, bitwise, and timed beside
    # copy_ at that size in the same run, in turns (copy_, probe, probe,
    # copy_); copy_ computes the probe's function only without the aux read
    gen7 = torch.Generator(device=dev).manual_seed(SEED)
    f7 = torch.randn((9, ROOF_N, ROOF_N), generator=gen7, device=dev)
    aux7 = torch.randn((ROOF_N, ROOF_N), generator=gen7, device=dev)
    ok7, op7 = torch.empty_like(f7), torch.empty_like(f7)
    lib7 = [graph_ms(lambda: op7.copy_(f7))]
    forms7 = (("copy_probe", None), ("copy_probe_aux", aux7))
    for variant, a7 in forms7:
        cp.copy_probe(f7, ok7, a7)
        cp.copy_probe_plain(f7, op7, a7)
        torch.cuda.synchronize()
        err = exact(f"{variant} {ROOF_N}^2", ok7, op7)
        records[variant] = record(
            float((ok7 - op7).abs().max()), {variant: err}, lambda a7=a7: cp.copy_probe(f7, ok7, a7),
            lambda a7=a7: cp.copy_probe_plain(f7, op7, a7),
            roofline.copy_traffic(ROOF_N, ROOF_N, a7 is not None), 0)
    lib7.append(graph_ms(lambda: op7.copy_(f7)))
    copy_ms = statistics.mean(lib7)
    records["copy_probe"]["library_ms"] = copy_ms
    records["copy_probe_aux"]["library_ms"] = None
    for name in cp.VARIANTS:
        r = records[name]
        r["copy_ms"] = copy_ms
        print(f"  {name:<24s} {r['ms'] * 1e3:7.1f} us in a CUDA graph, bound {r['bound'][0] * 1e3:.1f} "
              f"us, plain {r['plain_ms'] * 1e3:.1f} us, copy_ {copy_ms * 1e3:.1f} us (before "
              f"{lib7[0] * 1e3:.1f}, after {lib7[1] * 1e3:.1f}): {r['ms'] / copy_ms:.3f} x copy_  "
              f"[{card}]", flush=True)

    # -- phase 8: the sharded path -------------------------------------------
    from lbm2d_tpu_torch.pipeline import run_one_case
    from lbm2d_tpu_torch.tools.demo_case import cylinder_mask, demo_config

    def exact_state(tag, a, b, ma, mb):
        for k in ("f", "f_post", "rho", "u"):
            exact(f"{tag} {k}", getattr(a, k), getattr(b, k))
        for k in ("force", "max_v"):
            exact(f"{tag} {k}", ma[k], mb[k])
        print(f"    {tag}: f, f_post, rho, u, force and max_v bitwise equal", flush=True)

    def resident(mesh, p_, state, n_chunks, n, store_dev=False, case=None, kind="cuda"):
        """``state`` placed once on ``mesh``'s blocks, ``n_chunks`` chunks of
        ``n`` steps on the resident blocks: (blocks, last monitors)."""
        runner = sh.BlockRunner(mesh, kind, store_dev, case)
        bs = runner.place(state, p_)
        for _ in range(n_chunks):
            mon = runner.advance(bs, p_, n)
        return bs, mon

    def shard_launches(counts):
        return {k: v for k, v in counts.items() if "_shard" in k and v}

    # (a) a 2x2 mesh of the card against the single-device kernels, from
    # phase 3's final state, f32 and deviation storage
    print(f"[8] sharded path: (a) 2x2 mesh of {dev} on the smoke case, 2 x {chunk} steps",
          flush=True)
    case22 = sh.ShardedCase(p, mesh22)
    counted.clear()
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    for store_dev in (False, True):
        bs, ma = resident(mesh22, p, s3, 2, chunk, store_dev, case22)
        sb = s3
        for _ in range(2):
            sb, mb = cs.run_chunk_cuda(sb, p, chunk, store_dev=store_dev)
        torch.cuda.synchronize()
        exact_state(f"2x2 resident vs run_chunk_cuda{' store_dev' if store_dev else ''}",
                    bs.snapshot(), sb, ma, mb)
        del bs
    launches8a = dict(cs.LAUNCHES)
    fast8 = 4 * 2 * (chunk - 1)
    want8a = {"k1_step_shard": fast8, "k1_step_shard_full": 16, "k1_step_shard_dev": fast8}
    print(f"    launches {({k: v for k, v in launches8a.items() if v})}, plain calls {counted}; "
          f"{per_step(shard_launches(launches8a), 4 * chunk)} on 4 blocks = one a block a "
          f"step", flush=True)
    if shard_launches(launches8a) != want8a or any(counted.values()):
        raise AssertionError(f"phase 8(a): launches {launches8a} (want {want8a}), {counted}")

    # (b) a (5, 1) mesh at the DFG grid: the seams at rows 66 and 99 cut the
    # cylinder; from phase 5's developed flow
    mesh51 = make_mesh((5, 1), [dev] * 5)
    print(f"    (b) (5, 1) mesh at {H5}x{W5}, 2 x {DFG_PAIR_CHUNK} steps a pair", flush=True)
    counted.clear()
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    for obstacle, modes in (("bounce_back_bouzidi", (False,)), ("bounce_back_halfway", (False,)),
                            ("bounce_back", (False, True))):
        cfg8, mask8, _ = dfg_validation.dfg_case(ny=DFG_RUN["ny"], u_max=DFG_RUN["u_target"],
                                                 re=DFG_RUN["re"], obstacle=obstacle,
                                                 inlet="nebb")
        p8 = solver.make_params(cfg8, mask8, dtype=torch.float32, device=dev)
        case8 = sh.ShardedCase(p8, mesh51)
        for store_dev in modes:
            n8 = DFG_PAIR_STEPS // DFG_PAIR_CHUNK
            bs, ma = resident(mesh51, p8, developed, n8, DFG_PAIR_CHUNK, store_dev, case8)
            sb = developed
            for _ in range(n8):
                sb, mb = cs.run_chunk_cuda(sb, p8, DFG_PAIR_CHUNK, store_dev=store_dev)
            torch.cuda.synchronize()
            exact_state(f"(5, 1) {obstacle}/nebb{' store_dev' if store_dev else ''}",
                        bs.snapshot(), sb, ma, mb)
            del bs
    launches8b = dict(cs.LAUNCHES)
    print(f"    launches {shard_launches(launches8b)}, plain calls {counted}", flush=True)
    if any(counted.values()):
        raise AssertionError(f"phase 8(b): plain calls {counted}")

    # (c) the production entry on a 1x1 mesh: the smoke case through
    # run_batch -> execute_case -> run_one_case -> LBMEngine(spatial_mesh)
    engines8 = []

    class RecordingEngine8(LBMEngine):
        """LBMEngine that keeps a handle on itself for the checks below."""

        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines8.append(self)

    run_one_case.LBMEngine = RecordingEngine8
    smoke_case.use_memory_h5()
    with tempfile.TemporaryDirectory(prefix="chip_smoke_") as root:
        # no video: the serial path's frame composer needs matplotlib, which
        # the card's machine lacks (the lockstep path renders from LUTs)
        names8c = smoke_case.write_sibling_project(root, config, mask,
                                                   (config["simulation"]["nu"],),
                                                   name="SmokeS", video=False)
        counted.clear()
        torch.cuda.synchronize()
        cs.reset_launch_counts()
        t0 = time.perf_counter()
        stats8 = run_batch("SmokeS", root=root, progress=False, device="cuda",
                           spatial_mesh="1x1")
        torch.cuda.synchronize()
        wall8 = time.perf_counter() - t0
        launches8c = dict(cs.LAUNCHES)
        with open(os.path.join(root, "outputs", "SmokeS", "plots", "sim_results.json")) as fh:
            status8 = {e["config_filename"]: e["status"] for e in json.load(fh)}
        # phase 9(d) holds the multi-host entry's datasets and monitors to
        # these (the sharded runners keep f_post's global ring, so their
        # force is not the unsharded run's)
        h5_8c = smoke_case.read_datasets(
            os.path.join(root, "outputs", "SmokeS", "raw", f"{names8c[0][1]}.h5"))
    # the force of 8(c)'s final state evaluated in float64: the multi-host
    # force sums each process's part in float64, so it is held to this; the
    # float32 one-process sum carries its own order's rounding
    p8 = engines8[-1].params
    p64 = dataclasses.replace(p8, **{k: v.double() for k, v in vars(p8).items()
                                     if torch.is_tensor(v) and v.is_floating_point()})
    force8c = (solver.obstacle_force(engines8[-1].state.f_post.double(), p64).cpu().numpy(),
               np.array(engines8[-1].get_force()))
    e8 = engines8[-1]
    want8c = {"k1_step_shard": chunks * (chunk - 1), "k1_step_shard_full": chunks}
    print(f"    (c) run_batch(spatial_mesh='1x1'): {stats8}, {status8} in {wall8:.2f} s "
          f"(HDF5 and monitors included) [{card}]", flush=True)
    print(f"    launches {({k: v for k, v in launches8c.items() if v})}, plain calls {counted}; "
          f"{per_step(launches8c, max_steps)}", flush=True)
    if stats8.get("success") != 1 or set(status8.values()) != {"Success"}:
        raise AssertionError(f"phase 8(c): {stats8}, {status8}")
    if {k: v for k, v in launches8c.items() if v} != want8c or any(counted.values()):
        raise AssertionError(f"phase 8(c): launches {launches8c} (want {want8c}), {counted}")
    if e8.mesh is None or e8.mesh.grid != (1, 1) or e8.step_count != max_steps:
        raise AssertionError(f"phase 8(c): engine mesh {e8.mesh}, step {e8.step_count}")
    exact("phase 8(c) final f vs phase 3", e8.state.f, f_serial)
    print("    final f bitwise equal to phase 3's", flush=True)
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        e8.run_step(chunk)
    b.record()
    b.synchronize()
    us8 = a.elapsed_time(b) * 1e3 / (5 * chunk)
    print(f"    kernel path on the 1x1 mesh: {us8:.1f} us/step = {H * W / us8:.1f} MLUPS "
          f"(phase 3: {us_step3:.1f} us/step) [{card}]", flush=True)

    # (d) a 2x2 mesh of the card at 4096^2, the demo case (README 3c's grid
    # class): us/step of the chunk runner, and one step's device time from
    # a CUDA graph of K1 on every block and the halo copies
    N8 = ROOF_N
    p4k = solver.make_params(demo_config(N8, N8, nu=0.01, warmup=2000), cylinder_mask(N8, N8),
                             device=dev)
    case4k = sh.ShardedCase(p4k, mesh22)
    # first, the sharded kernels at this block size (2048 x 2048 cells in
    # [2050, pitch] planes) against their plain versions: a short chunk
    # from a seeded random state, whose cells all differ, so a misplaced
    # read would show; bitwise, as in phase 2
    gen = torch.Generator(device=dev).manual_seed(SEED)
    rho_r = 1.0 + 1e-3 * torch.randn((N8, N8), generator=gen, device=dev)
    u_r = 0.02 * torch.randn((2, N8, N8), generator=gen, device=dev)
    f_r = f_eq(rho_r, u_r[0], u_r[1])
    s_r = solver.LBMState(f=f_r, f_post=f_r.clone(), rho=rho_r, u=u_r, step=0)
    bs_a, ma = resident(mesh22, p4k, s_r, 1, CHECK_4K_STEPS, case=case4k)
    bs_b, mb = resident(mesh22, p4k, s_r, 1, CHECK_4K_STEPS, case=case4k, kind="plain")
    torch.cuda.synchronize()
    exact_state(f"(d) 2x2 at {N8}^2 from a random state, {CHECK_4K_STEPS} steps, kernels vs "
                "their plain versions", bs_a.snapshot(), bs_b.snapshot(), ma, mb)
    del s_r, bs_a, bs_b, f_r, rho_r, u_r
    # then the chunk loop in turns: the state placed and gathered every
    # chunk (run_chunk_sharded_cuda: scatter, chunk, gather, as the runner
    # ran before the blocks stayed resident), and the resident blocks;
    # host-paced us/step (CUDA events around the loop) and the memory the
    # state holds and the loop peaks at, above what 8(d) found allocated
    torch.cuda.synchronize()
    base4k = torch.cuda.memory_allocated(dev)
    runner4k = sh.BlockRunner(mesh22, "cuda", False, case4k)
    s4k = solver.init_state(N8, N8, torch.float32, dev)
    counted.clear()
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    s4k, _ = sh.run_chunk_sharded_cuda(s4k, p4k, ROOF_SPC, mesh22, case=case4k)  # warm-up

    gc_ms, gc_start = [], [0.0]

    def on_gc(phase, info):
        if phase == "start":
            gc_start[0] = time.perf_counter()
        else:
            gc_ms.append((time.perf_counter() - gc_start[0]) * 1e3)

    def turn(chunk_fn):
        """(us/step, the host's issue us/step, GB held at the start, GB
        peak, ms the garbage collector paused the host) of SHARD_4K_CHUNKS
        chunks."""
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats(dev)
        held = torch.cuda.memory_allocated(dev) - base4k
        steps = SHARD_4K_CHUNKS * ROOF_SPC
        gc_ms.clear()
        gc.callbacks.append(on_gc)
        a.record()
        t0 = time.perf_counter()
        for _ in range(SHARD_4K_CHUNKS):
            chunk_fn()
        issue = (time.perf_counter() - t0) * 1e6 / steps
        b.record()
        gc.callbacks.remove(on_gc)
        b.synchronize()
        return (a.elapsed_time(b) * 1e3 / steps, issue, held / 1e9,
                (torch.cuda.max_memory_allocated(dev) - base4k) / 1e9, sum(gc_ms))

    box = {"s": s4k}
    del s4k

    def gathered_chunk():
        box["s"], box["m"] = sh.run_chunk_sharded_cuda(box["s"], p4k, ROOF_SPC, mesh22,
                                                       case=case4k)

    def resident_chunk():
        box["m"] = runner4k.advance(box["bs"], p4k, ROOF_SPC)

    turns = {"gathered": [], "resident": []}
    for kind in ("gathered", "resident", "resident", "gathered"):
        if kind == "resident" and "bs" not in box:
            box["bs"] = runner4k.place(box.pop("s"), p4k)
        elif kind == "gathered" and "s" not in box:
            box["s"] = box.pop("bs").snapshot()
        turns[kind].append(turn(gathered_chunk if kind == "gathered" else resident_chunk))
    launches8d = dict(cs.LAUNCHES)
    steps8d = (1 + 4 * SHARD_4K_CHUNKS) * ROOF_SPC
    s4k, m4k = box["s"], box["m"]
    if not (torch.isfinite(s4k.f).all() and torch.isfinite(m4k["force"]).all()):
        raise AssertionError("phase 8(d): non-finite state at 4096^2")
    bs4k = runner4k.place(s4k, p4k)
    del s4k, box
    scal4 = cs.scalar_row(p4k, bs4k.step + 1)
    step4k_ms = graph_ms(lambda: sh.fast_step(bs4k.f, bs4k.f_alt, case4k, scal4, False),
                         per_graph=10)
    exch4k_ms = graph_ms(lambda: sh.exchange_halos(bs4k.f_alt, mesh22, case4k.hl, case4k.wl),
                         per_graph=10)
    fp4k_ms = median_ms(bs4k.collect_f_post, batches=5, per_batch=4)[0]
    mon4k_ms = median_ms(lambda: sh.block_monitors(bs4k, p4k, None), batches=5,
                         per_batch=4)[0]
    del bs4k

    def summary(kind):
        ts = turns[kind]
        us = statistics.mean(t[0] for t in ts)
        runs = ", ".join(f"{t[0]:.1f}" for t in ts)
        issue = ", ".join(f"{t[1]:.1f}" for t in ts)
        paused = ", ".join(f"{t[4]:.1f}" for t in ts)
        return us, (f"{us:.1f} us/step ({runs}; the host's issue {issue}; garbage "
                    f"collection {paused} ms a turn), state {ts[0][2]:.2f} GB, loop peak "
                    f"{max(t[3] for t in ts):.2f} GB")

    us4k, res4k = summary("resident")
    us4k_g, gat4k = summary("gathered")
    print(f"    (d) 2x2 mesh at {N8}^2, chunks of {ROOF_SPC}, host-paced, in turns (gathered, "
          f"resident, resident, gathered): resident {res4k} = {N8 * N8 / us4k:.1f} MLUPS; "
          f"placed and gathered every chunk {gat4k}; one step's device time "
          f"{step4k_ms * 1e3:.1f} us (CUDA graph: K1 on 4 blocks and "
          f"{2 * 2 * 2} halo copies), halo exchange {exch4k_ms * 1e3:.1f} us = "
          f"{100 * exch4k_ms / step4k_ms:.1f}% of it; still gathered a chunk: f_post into "
          f"the global f_post, {fp4k_ms:.3f} ms = {fp4k_ms * 1e3 / ROOF_SPC:.1f} us/step at "
          f"{ROOF_SPC} steps; the chunk's monitors (force on the global f_post, max_v from "
          f"the blocks) {mon4k_ms:.3f} ms = {mon4k_ms * 1e3 / ROOF_SPC:.1f} us/step; "
          f"unsharded (phase 7) K1 {roof['k1_us']:.1f} us, "
          f"{roof['us_per_step']:.1f} us/step [{card}]", flush=True)
    print(f"    launches {({k: v for k, v in launches8d.items() if v})}, plain calls {counted}; "
          f"{per_step(launches8d, steps8d)} on 4 blocks", flush=True)
    if any(counted.values()):
        raise AssertionError(f"phase 8(d): plain calls {counted}")
    launches8 = {k: launches8a[k] + launches8b[k] + launches8c[k] + launches8d[k]
                 for k in cs.KERNEL_VARIANTS}
    idle8 = [k for k in cs.KERNEL_VARIANTS if "_shard" in k and not launches8[k]]
    if idle8:
        raise AssertionError(f"phase 8 did not launch {idle8}")

    launches9 = phase9(config, mask, f_serial, force8c, h5_8c, counted, card)

    # -- phase 10: the README quickstart --------------------------------------
    launches10 = phase10(config, mask, counted, card)

    # -- phase 11: the headline bench -------------------------------------------
    launches11 = phase11(counted, card)

    # -- phase 12: the DFG-2D matrix at cut depth ------------------------------
    launches12 = phase12(mask, counted, card, engines, exact_state)

    kernels = []
    by_path = {"serial": launches, "lockstep": launches4, "dfg": launches5,
               "dfg_pairs": launches5b, "fused": launches6, "fused_pairs": launches6b,
               "roofline": launches7, "sharded": launches8c, "sharded_pairs": launches8a,
               "sharded_dfg": launches8b, "sharded_4096": launches8d, **launches9,
               **launches10, "bench": launches11, "suite": launches12}
    sources = {"k1": ("k1_step.cu", "lbm2d_tpu/ops/pallas_step.py:824"),
               "k3": ("k3_fused.cu", "lbm2d_tpu/ops/pallas_step.py:610"),
               "co": ("copy_probe.cu", "tools_roofline_4096.py:95")}
    for name in list(cs.KERNEL_VARIANTS) + list(cp.VARIANTS):
        r = records[name]
        if name in cp.VARIANTS:
            paths = {"roofline": copies7[name]}
        else:
            paths = {path: counts[name] for path, counts in by_path.items()}
        src, replaces = sources[name[:2]]
        entry = {
            "name": name, "route": "cuda", "source": "lbm2d_tpu_torch/csrc/" + src,
            "replaces": replaces,
            "launches": sum(paths.values()), "launches_by_path": paths,
            "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
            "ms": r["ms"], "launch_path_ms": r["launch_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": r.get("library_ms"),
            "registers": r["registers"],
        }
        if r.get("spill_bytes") is not None:
            entry["spill_bytes"] = r["spill_bytes"]
        if "loop_host_us" in r:
            entry["loop_host_us"] = r["loop_host_us"]
        if "copy_ms" in r:
            entry["copy_ms"] = r["copy_ms"]
        if name.startswith("k3"):
            entry["tile"] = list(tile3)
        if name == "k3_fused":
            entry.update({f"ms_s{FUSE_S_MAX}": k3_s8["ms"], f"tile_s{FUSE_S_MAX}": list(tile8)})
        kernels.append(entry)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
