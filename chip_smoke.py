#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``lbm2d_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the process exits non-zero):

0. the card (nvidia-smi name and power limit), torch and nvcc versions;
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
   exact chunk (and > 0) under that budget test's conditions; time each
   kernel with CUDA events beside its bound (``ms``: replayed from a CUDA
   graph, the kernel alone; ``launch_path_ms``: launched from Python one
   by one);
3. drive the serial main path, ``LBMEngine`` + ``run_simulation_loop``, on
   the production-shaped case in ``lbm2d_tpu_torch/data`` (3000 steps in
   chunks of 100), and check status Success, finite moments, mean jx > 0,
   Fx > 0, and that each of its kernels was launched (one launch a step)
   and no plain step ran;
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
   and the device time of one step at 881x165 (a CUDA graph); print the
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
   kernel-path and wall MLUPS beside phase 3's; then every other scheme K3
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
8. drive the sharded path (``parallel/sharded.py``): (a) on a 2x2 mesh of
   the card, ``run_chunk_sharded_cuda`` from phase 3's final state for 200
   steps, f32 and ``store_dev``, bitwise against ``run_chunk_cuda``; (b) on
   a (5, 1) mesh at the DFG grid, whose seams cut the cylinder, the
   Bouzidi, half-way and full-way pairs with the NEBB inlet (full-way in
   ``store_dev`` too) from phase 5's flow, 200 steps, bitwise against the
   single-device kernels; (c) the production entry ``run_batch(...,
   spatial_mesh="1x1")`` on the smoke case: Success, final f bitwise equal
   to phase 3's, only ``_shard`` launches and no plain call; (d) on a 2x2
   mesh at 4096^2 (the demo case), a 6-step chunk from a seeded random
   state bitwise against ``run_chunk_sharded_plain`` (the kernels at this
   block size), then us/step, the device time of one step
   (a CUDA graph of K1 on every block and the halo copies), the halo
   exchange's share and the scatter and gather cost of a chunk. Every
   ``_shard`` variant is launched in phase 8, one launch a block a step.

The last two lines are the kernels' JSON record (``launches``: the sum over
the driven paths, split in ``launches_by_path``) and ``{"ok": true,
"device": {...}}``. Without a CUDA device, or without the package beside
this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

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
# versions on the 2x2 mesh at 4096^2 (K1 fast and full)
CHECK_4K_STEPS = 6


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

    # -- phase 1 ------------------------------------------------------------
    t0 = time.perf_counter()
    cuda_build.build_all()
    for name in cuda_build.KERNELS:
        cuda_build.load(name)
    print(f"[1] built kernels in {time.perf_counter() - t0:.1f} s", flush=True)
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

    # steady chunk rate of the kernel path alone
    chunk = int(config["simulation"]["compute_step_size"])
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(5):
        engine.run_step(chunk)
    b.record()
    b.synchronize()
    step_ms = a.elapsed_time(b) / (5 * chunk)
    us_step3 = step_ms * 1e3
    mlups3 = H * W / step_ms / 1e3
    s3 = engine.state  # phase 8 runs the sharded path from here
    print(f"    kernel path: {step_ms * 1e3:.1f} us/step = {mlups3:.1f} MLUPS; one step's "
          f"device time {records['k1_step']['ms'] * 1e3:.1f} us (k1_step in a CUDA graph, phase "
          f"2) [{card}]", flush=True)
    # the same in 16-bit deviation storage (the lockstep path's chunk runner)
    st = engine.state
    a.record()
    for _ in range(5):
        st, _ = cs.run_chunk_cuda(st, p, chunk, store_dev=True)
    b.record()
    b.synchronize()
    step_ms = a.elapsed_time(b) / (5 * chunk)
    print(f"    kernel path, store_dev: {step_ms * 1e3:.1f} us/step = "
          f"{H * W / step_ms / 1e3:.1f} MLUPS [{card}]", flush=True)

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
                  f"MLUPS; set-up and wind-down {wall4 - loop_s:.2f} s [{card}]", flush=True)
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
        e0 = torch.cuda.Event(enable_timing=True)
        e1 = torch.cuda.Event(enable_timing=True)
        e0.record()
        for _ in range(5):
            engine6.run_step(chunk)
        e1.record()
        e1.synchronize()
        step_ms6 = e0.elapsed_time(e1) / (5 * chunk)
        print(f"    kernel path: {step_ms6 * 1e3:.1f} us/step = {H * W / step_ms6 / 1e3:.1f} MLUPS "
              f"(phase 3: {mlups3:.1f}) [{card}]", flush=True)

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
        exact(f"{tag} force", ma["force"], mb["force"])
        print(f"    {tag}: f, f_post, rho, u and force bitwise equal", flush=True)

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
        sa = sb = s3
        for _ in range(2):
            sa, ma = sh.run_chunk_sharded_cuda(sa, p, chunk, mesh22, store_dev, case22)
            sb, mb = cs.run_chunk_cuda(sb, p, chunk, store_dev=store_dev)
        torch.cuda.synchronize()
        exact_state(f"2x2 vs run_chunk_cuda{' store_dev' if store_dev else ''}", sa, sb, ma, mb)
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
            sa = sb = developed
            for _ in range(DFG_PAIR_STEPS // DFG_PAIR_CHUNK):
                sa, ma = sh.run_chunk_sharded_cuda(sa, p8, DFG_PAIR_CHUNK, mesh51, store_dev,
                                                   case8)
                sb, mb = cs.run_chunk_cuda(sb, p8, DFG_PAIR_CHUNK, store_dev=store_dev)
            torch.cuda.synchronize()
            exact_state(f"(5, 1) {obstacle}/nebb{' store_dev' if store_dev else ''}", sa, sb,
                        ma, mb)
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
        smoke_case.write_sibling_project(root, config, mask, (config["simulation"]["nu"],),
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
    sa, ma = sh.run_chunk_sharded_cuda(s_r, p4k, CHECK_4K_STEPS, mesh22, case=case4k)
    sb, mb = sh.run_chunk_sharded_plain(s_r, p4k, CHECK_4K_STEPS, mesh22, case=case4k)
    torch.cuda.synchronize()
    exact_state(f"(d) 2x2 at {N8}^2 from a random state, {CHECK_4K_STEPS} steps, kernels vs "
                "their plain versions", sa, sb, ma, mb)
    del s_r, sa, sb, f_r
    s4k = solver.init_state(N8, N8, torch.float32, dev)
    counted.clear()
    torch.cuda.synchronize()
    cs.reset_launch_counts()
    s4k, _ = sh.run_chunk_sharded_cuda(s4k, p4k, ROOF_SPC, mesh22, case=case4k)
    a.record()
    for _ in range(ROOF_CHUNKS):
        s4k, m4k = sh.run_chunk_sharded_cuda(s4k, p4k, ROOF_SPC, mesh22, case=case4k)
    b.record()
    b.synchronize()
    launches8d = dict(cs.LAUNCHES)
    us4k = a.elapsed_time(b) * 1e3 / (ROOF_CHUNKS * ROOF_SPC)
    if not (torch.isfinite(s4k.f).all() and torch.isfinite(m4k["force"]).all()):
        raise AssertionError("phase 8(d): non-finite state at 4096^2")
    src4 = sh.halo_blocks(s4k.f, mesh22, sh.NAN, case4k.pitch)
    dst4 = [[t.clone() for t in r] for r in src4]
    scal4 = cs.scalar_row(p4k, s4k.step + 1)
    step4k_ms = graph_ms(lambda: sh.fast_step(src4, dst4, case4k, scal4, False),
                         per_graph=10)
    exch4k_ms = graph_ms(lambda: sh.exchange_halos(dst4, mesh22, case4k.hl, case4k.wl),
                         per_graph=10)

    def scatter_gather():
        blk = sh.halo_blocks(s4k.f, mesh22, sh.NAN, case4k.pitch)
        _ = [[t.clone() for t in r] for r in blk]
        for _ in range(4):  # f, f_post, rho and u come back
            sh.gather_halo_blocks(blk, case4k.hl, case4k.wl, dev)

    sg4k_ms = median_ms(scatter_gather, batches=3, per_batch=2)[0]
    print(f"    (d) 2x2 mesh at {N8}^2: {us4k:.1f} us/step = {N8 * N8 / us4k:.1f} MLUPS "
          f"(chunks of {ROOF_SPC}, scatter and gather included); one step's device time "
          f"{step4k_ms * 1e3:.1f} us (CUDA graph: K1 on 4 blocks and "
          f"{2 * 2 * 2} halo copies), halo exchange {exch4k_ms * 1e3:.1f} us = "
          f"{100 * exch4k_ms / step4k_ms:.1f}% of it; scatter + gather {sg4k_ms:.2f} ms a "
          f"chunk = {sg4k_ms * 1e3 / ROOF_SPC:.1f} us/step at {ROOF_SPC} steps; unsharded "
          f"(phase 7) K1 {roof['k1_us']:.1f} us, "
          f"{roof['us_per_step']:.1f} us/step [{card}]", flush=True)
    print(f"    launches {({k: v for k, v in launches8d.items() if v})}, plain calls {counted}; "
          f"{per_step(launches8d, (ROOF_CHUNKS + 1) * ROOF_SPC)} on 4 blocks", flush=True)
    if any(counted.values()):
        raise AssertionError(f"phase 8(d): plain calls {counted}")
    launches8 = {k: launches8a[k] + launches8b[k] + launches8c[k] + launches8d[k]
                 for k in cs.KERNEL_VARIANTS}
    idle8 = [k for k in cs.KERNEL_VARIANTS if "_shard" in k and not launches8[k]]
    if idle8:
        raise AssertionError(f"phase 8 did not launch {idle8}")

    kernels = []
    by_path = {"serial": launches, "lockstep": launches4, "dfg": launches5,
               "dfg_pairs": launches5b, "fused": launches6, "fused_pairs": launches6b,
               "roofline": launches7, "sharded": launches8c, "sharded_pairs": launches8a,
               "sharded_dfg": launches8b, "sharded_4096": launches8d}
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
