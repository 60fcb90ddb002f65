#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``lbm2d_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the process exits non-zero):

0. the card (nvidia-smi name and power limit), torch and nvcc versions;
1. build the CUDA kernels from ``lbm2d_tpu_torch/csrc`` with nvcc;
2. hold each kernel variant (``cuda_step.KERNEL_VARIANTS``: K1 fast and
   full for each obstacle scheme -- equilibrium, full-way, half-way and
   Bouzidi bounce-back, the Bouzidi q planes drawn from a seeded generator
   on the mask's boundary links -- K1 in 16-bit deviation storage for the
   equilibrium and full-way schemes, and K2 for left types 0 and 3/4, f32
   and deviation storage, bounce on and off) against its plain PyTorch
   version at the production grid 2432x1152 on a developed state, then a
   20-step ``run_chunk_cuda``
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
   Fx > 0, and that each of its kernels was launched and no plain step ran;
   then a 20-step ``store_dev`` chunk from the flow it ends with must lie
   within 1e-4 of the exact chunk (and differ from it);
4. drive the lockstep production path, ``batch_run --lockstep
   --device_resize --max_batch 5 --f16_state --f16_transfer --yuv_video
   --f16_retry``, on a temporary project of three sibling cases of the
   smoke case (the same mask; nu 0.02, 0.03, 0.05; video on), and check
   every case Success, finite HDF5 frames with mean jx > 0, one mp4 per
   case, the launch counts of its kernels (k1_step_dev and k2_edge_bc_dev
   3 x 2970, k1_step_full and k2_edge_bc 3 x 30) and no plain call. Where
   the machine has no h5py, the HDF5 writer runs on an in-memory stand-in
   of ``h5py.File`` and the frames are read back from it;
5. drive the DFG-2D validation path, ``analysis.dfg_validation.
   run_validation(mode="dfg", obstacle="bounce_back_bouzidi", inlet="nebb",
   ny=165, steps=160000, chunk=500)`` (the JAX package's own benchmark
   test, tests/test_dfg_bc.py), and check its ranges (St 0.26-0.32, Cd
   2.7-3.5, Cl amplitude 0.5-1.4, Re 90-110, shedding), its launch counts
   (k1_step_bouzidi, k1_step_bouzidi_full, k2_edge_bc_vel) and no plain
   call; print the coefficients beside the recorded row of
   docs/benchmarks/dfg2d_results.json; then, from its developed state,
   the five other obstacle x inlet pairs for 200 steps through the kernels
   and through ``run_chunk_plain`` (and the full-way pairs in deviation
   storage), within 1e-5 relative;
6. drive the serial main path of phase 3 again with temporal blocking on
   (``cuda_step._FUSE_STEPS = 4``, opt-in, as the JAX package's
   ``_FUSE_STEPS``): check Success, finite moments, mean jx > 0, Fx > 0,
   the launch counts (k3_fused 720, k1_step 90, k1_step_full 30,
   k2_edge_bc 120) and no plain call, and its final f against phase 3's
   (bitwise expected; gated at the relative tolerance); print its
   kernel-path and wall MLUPS beside phase 3's; then every other scheme K3
   runs, fused through the kernels against the unfused plain chunk runner:
   the equilibrium, full-way and half-way DFG pairs with both inlets for 200
   steps from phase 5's developed flow, and full-way and half-way on the
   smoke case for one chunk, so that every K3 variant is launched;
   phase 2 also holds each K3 variant (``k3_fused[_bounce|_halfway][_vel]``
   at S = 4) against its plain version, one K3 pass against four K1 + K2
   steps through the kernels, and times K3 at S = 8;
7. run the roofline tool's measurement (``tools/roofline.measure``) at
   4096^2 with two chunks of 50 steps, and hold the copy probe, with and
   without the aux read, against its plain version at that size, timed
   beside ``torch.Tensor.copy_``.

The last two lines are the kernels' JSON record (``launches``: the sum over
the driven paths, split in ``launches_by_path``) and ``{"ok": true,
"device": {...}}``. Without a CUDA device, or without the package beside
this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
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
# per ring cell of K2: one BC (~70 for the Zou-He branches) plus overwrite
K2_OPS_PER_CELL = 80
# shared memory of an H100 SXM: 128 B per clock per SM, 132 SMs, 1.98 GHz
PEAK_SMEM = 33e12
# phase 6: temporal blocking at S = 4 (K3's default tile), and S = 8 timed
FUSE_S, FUSE_S_MAX = 4, 8
# phase 7: the roofline tool at 4096^2 with a few short chunks
ROOF_N, ROOF_CHUNKS, ROOF_SPC = 4096, 2, 50


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


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


def graph_ms(fn, per_graph: int = 20, replays: int = 7) -> float:
    """Median device time of one call without the host launch path: the
    calls are captured once in a CUDA graph, and the graph is replayed
    between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    g = torch.cuda.CUDAGraph()
    with torch.cuda.graph(g):
        for _ in range(per_graph):
            fn()
    g.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(replays):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        g.replay()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b) / per_graph)
    return statistics.median(times)


def bound_ms(nbytes: float, ops: float):
    t_bytes = nbytes / PEAK_BW * 1e3
    t_ops = ops / PEAK_F32 * 1e3
    return max(t_bytes, t_ops), ("bytes" if t_bytes >= t_ops else "operations")


def k3_work(cs, H: int, W: int, S: int, tile):
    """Work of one K3 pass of S sub-steps on an H x W grid.

    The function's own work sets the bound: f (36 B) and aux (4 B) read once,
    f (36 B) written once, 76 B a cell whatever S is, and 120 operations
    (K1's count; the ring's BCs are cheaper) per cell and sub-step. The tile
    at centre ``tile`` does more, and that is a design figure beside the
    bound: each window's cells inside the grid read once (halo re-reads
    included), each grid cell written once, and 72 B of shared-memory
    traffic (9 populations read, 9 written) per cell of each sub-step's
    region. Returns (bytes, operations, tile bytes, shared-memory bytes)."""
    gy, gx, _ = cs._k3_windows(H, W, S, *tile, "cpu")
    ingrid = (gy >= 0) & (gy < H) & (gx >= 0) & (gx < W)
    wh, ww = gy.shape[1:]
    i = torch.arange(wh)[:, None]
    j = torch.arange(ww)[None, :]
    cells = sum(int((ingrid & (i > s) & (i < wh - s - 1) & (j > s) & (j < ww - s - 1)).sum())
                for s in range(S))
    return 76 * H * W, K1_OPS_PER_CELL * H * W * S, 40 * int(ingrid.sum()) + 36 * H * W, 72 * cells


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
    from lbm2d_tpu_torch.pipeline.sim_loop import run_simulation_loop
    from lbm2d_tpu_torch.tools import smoke_case

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
    for name, log in cuda_build.BUILD_LOG.items():
        for line in log.splitlines():
            if "registers" in line or "spill" in line:
                print(f"    {name}: {line.strip()}", flush=True)

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

    def k1_buffers(full):
        out = {"f_out": torch.zeros_like(state.f), "edge": cs.new_edge_buffer(H, W, device=dev)}
        if full:
            out.update(rho=torch.zeros((H, W), device=dev), u=torch.zeros((2, H, W), device=dev),
                       f_post=state.f_post.clone())
        return out

    def run_k1(fn, b, obst):
        fn(state.f, b["f_out"], aux, b["edge"], scal, p.use_les, b.get("rho"), b.get("u"),
           b.get("f_post"), obstacle=obst, q=qplanes if obst == cs.OBSTACLE_BOUZIDI else None)

    def abs_err(bk, bp, fields):
        return max(float((bk[k].float() - bp[k].float()).abs().max()) for k in fields)

    def record(max_abs, errs, kernel_call, plain_call, nbytes, ops):
        launch_ms, host_ms = median_ms(kernel_call)
        return dict(max_abs_err=max_abs,
                    max_rel_err=max(errs.values()), ms=graph_ms(kernel_call), launch_ms=launch_ms,
                    host_ms=host_ms,
                    plain_ms=median_ms(plain_call, batches=5, per_batch=2)[0],
                    bound=bound_ms(nbytes, ops))

    records = {}
    n_in = (H - 2) * (W - 2)
    for obst in range(4):
        for full in (False, True):
            name = cs.k1_variant(obst, full)
            bk, bp = k1_buffers(full), k1_buffers(full)
            run_k1(cs.k1_step, bk, obst)
            run_k1(cs.k1_step_plain, bp, obst)
            torch.cuda.synchronize()
            errs = {k: rel_err(bk[k], bp[k]) for k in bk}
            for k, err in errs.items():
                check(f"{name} {k}", err)
            # f in (36 B) and aux (4 B) per cell, f out (36 B) per interior
            # cell, the edge export; the full variant adds rho, u, f_post.
            # Bouzidi reads q where this mask has a boundary link (the dense
            # [8, H, W] planes would add 32 B/cell: PERF.md)
            nbytes = 36 * H * W + 4 * H * W + 36 * n_in + 4 * bk["edge"].numel()
            ops = K1_OPS_PER_CELL * n_in
            if full:
                nbytes += 4 * H * W + 8 * H * W + 36 * n_in
            if obst == cs.OBSTACLE_BOUZIDI:
                nbytes += 4 * n_links
                ops += K1_OPS_PER_LINK * n_links
            records[name] = record(abs_err(bk, bp, bk), errs, lambda: run_k1(cs.k1_step, bk, obst),
                                   lambda: run_k1(cs.k1_step_plain, bp, obst), nbytes, ops)
            if obst == cs.OBSTACLE_EQ and full:
                k1_out = bp

    # K1 in 16-bit deviation storage, on the same developed state
    fq = cs.quantize(state.f)

    def kd_buffers():
        return {"f_out": torch.zeros_like(fq), "edge": cs.new_edge_buffer(H, W, device=dev)}

    def run_k1d(fn, b, obst):
        fn(fq, b["f_out"], aux, b["edge"], scal, p.use_les, obst)

    for obst in cs.DEV_OBSTACLES:
        name = cs.k1_variant(obst, dev=True)
        bk, bp = kd_buffers(), kd_buffers()
        run_k1d(cs.k1_step_dev, bk, obst)
        run_k1d(cs.k1_step_dev_plain, bp, obst)
        torch.cuda.synchronize()
        errs = {k: rel_err(bk[k], bp[k]) for k in bk}
        for k, err in errs.items():
            check(f"{name} {k}", err)
        # f 18 B in (bf16), aux 4, f 18 B out, the f32 edge export; the
        # dequantize and quantize add 18 operations per cell
        records[name] = record(
            abs_err(bk, bp, bk), errs, lambda: run_k1d(cs.k1_step_dev, bk, obst),
            lambda: run_k1d(cs.k1_step_dev_plain, bp, obst),
            18 * H * W + 4 * H * W + 18 * n_in + 4 * bk["edge"].numel(),
            (K1_OPS_PER_CELL + 18) * n_in)
        if obst == cs.OBSTACLE_EQ:
            kd_out = bp

    # K2 on K1's outputs (f32: the full variant's f ring plus rho/u ring;
    # deviation storage: the bf16 f ring), left types 0 (the smoke case) and
    # 3/4 (a parabolic inlet of u_max 0.1), bounce off (timed) and on
    ring = 2 * (H - 2) + 2 * W

    def vel_params(left_type):
        cfg = json.loads(json.dumps(config))
        cfg["boundary_condition"]["type"][0] = left_type
        cfg["boundary_condition"]["value"][0] = [0.1, 0.0]
        return solver.make_params(cfg, mask, dtype=torch.float32, device=dev)

    k2_params = {"k2_edge_bc": [p], "k2_edge_bc_vel": [vel_params(4), vel_params(3)]}

    def run_k2(fn, b, pk, bounce):
        fn(b["f_out"], aux, b["edge"], scal, pk.bc_type, b["rho"], b["u"],
           prof=pk.inlet_profile, bounce=bounce)

    def run_k2d(fn, b, pk, bounce):
        fn(b["f_out"], aux, b["edge"], scal, pk.bc_type, prof=pk.inlet_profile, bounce=bounce)

    # storage suffix -> (input, runner, kernel, plain version, checked
    # buffers, f bytes written per ring cell, operations per ring cell)
    k2_storages = {
        "": (k1_out, run_k2, cs.k2_edge_bc, cs.k2_edge_bc_plain, ("f_out", "rho", "u"),
             36 + 12, K2_OPS_PER_CELL),
        "_dev": (kd_out, run_k2d, cs.k2_edge_bc_dev, cs.k2_edge_bc_dev_plain, ("f_out",), 18,
                 K2_OPS_PER_CELL + 9),
    }
    for suffix, (src, run, kern, plain, fields, ring_bytes, ring_ops) in k2_storages.items():
        for base, plist in k2_params.items():
            name = base + suffix
            errs, abs_errs = {}, []
            for pk in plist:
                for bounce in (False, True):
                    bk = {k: v.clone() for k, v in src.items()}
                    bp = {k: v.clone() for k, v in src.items()}
                    run(kern, bk, pk, bounce)
                    run(plain, bp, pk, bounce)
                    torch.cuda.synchronize()
                    abs_errs.append(abs_err(bk, bp, fields))
                    for k in fields:
                        tag = f"{name} left {pk.bc_type[0]} bounce {int(bounce)} {k}"
                        errs[tag] = rel_err(bk[k], bp[k])
                        check(tag, errs[tag])
            pk = plist[0]
            nbytes = 4 * bk["edge"].numel() + 4 * ring + ring_bytes * ring
            if pk.inlet_profile is not None:
                nbytes += 4 * H
            records[name] = record(
                max(abs_errs), errs, lambda: run(kern, bk, pk, False),
                lambda: run(plain, bp, pk, False), nbytes, ring_ops * ring)

    # K3 at S = 4 on its default tile, each variant against its plain
    # version (the windowed algorithm) on the same state, left types 0 and
    # 3/4; output buffers start as NaN so an unwritten cell fails the check
    tile3 = cs.k3_tile(FUSE_S)
    rows3 = torch.stack([cs.scalar_row(p, state.step + 1 + i) for i in range(FUSE_S)])
    k3_bytes, k3_ops, k3_tile_bytes, k3_smem = k3_work(cs, H, W, FUSE_S, tile3)
    print(f"  K3: S = {FUSE_S}, centre tile {tile3}, {cs.k3_smem_bytes(FUSE_S, *tile3)} B of "
          f"shared memory a block; bound from {k3_bytes / (H * W * FUSE_S):.2f} B and "
          f"{k3_ops / (H * W * FUSE_S):.1f} operations per cell-step; the tile moves "
          f"{k3_tile_bytes / (H * W * FUSE_S):.2f} B of device memory per cell-step (halo "
          f"re-reads included)", flush=True)

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
                bk, bp = nan_f(), nan_f()
                run_k3(cs.k3_fused, bk, obst, pk)
                run_k3(cs.k3_fused_plain, bp, obst, pk)
                torch.cuda.synchronize()
                tag = f"{name} left {pk.bc_type[0]} f"
                errs[tag] = rel_err(bk, bp)
                abs_errs.append(float((bk - bp).abs().max()))
                check(tag, errs[tag])
            pk = plist[0]
            prof_bytes = 4 * H if pk.inlet_profile is not None else 0
            records[name] = record(max(abs_errs), errs, lambda: run_k3(cs.k3_fused, bk, obst, pk),
                                   lambda: run_k3(cs.k3_fused_plain, bp, obst, pk),
                                   k3_bytes + prof_bytes, k3_ops)
    # one K3 pass against S single steps of K1 + K2, all through the kernels
    f_k, edge3 = state.f, cs.new_edge_buffer(H, W, device=dev)
    for i in range(FUSE_S):
        nxt = torch.empty_like(f_k)
        cs.k1_step(f_k, nxt, aux, edge3, rows3[i], p.use_les)
        cs.k2_edge_bc(nxt, aux, edge3, rows3[i], p.bc_type)
        f_k = nxt
    bk = nan_f()
    run_k3(cs.k3_fused, bk, cs.OBSTACLE_EQ, p)
    torch.cuda.synchronize()
    check(f"k3_fused pass vs {FUSE_S} x (K1 + K2)", rel_err(bk, f_k))
    # the deepest fusion, held against its plain version and timed beside S = 4
    tile8 = cs.k3_tile(FUSE_S_MAX)
    rows8 = torch.stack([cs.scalar_row(p, state.step + 1 + i) for i in range(FUSE_S_MAX)])
    b8, b8p = nan_f(), nan_f()
    run_k3(cs.k3_fused, b8, cs.OBSTACLE_EQ, p, rows8, tile8)
    run_k3(cs.k3_fused_plain, b8p, cs.OBSTACLE_EQ, p, rows8, tile8)
    torch.cuda.synchronize()
    check(f"k3_fused S = {FUSE_S_MAX} tile {tile8} f", rel_err(b8, b8p))
    k3_s8 = dict(zip(("bytes", "ops", "tile_bytes", "smem"),
                     k3_work(cs, H, W, FUSE_S_MAX, tile8)))
    k3_s8.update(tile=tile8, ms=graph_ms(lambda: run_k3(cs.k3_fused, b8, cs.OBSTACLE_EQ, p,
                                                        rows8, tile8)))
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
              f"bound {r['bound'][0] * 1e3:7.1f} us ({r['bound'][1]})  [{card}]", flush=True)
        if name.startswith("k3_"):
            print(f"  {'':<24s} = {r['ms'] * 1e3 / FUSE_S:.1f} us/step; the tile's device-memory "
                  f"traffic {k3_tile_bytes / PEAK_BW * 1e6:.1f} us, its shared-memory traffic "
                  f"{k3_smem / PEAK_SMEM * 1e6:.1f} us at {PEAK_SMEM / 1e12:.0f} TB/s (estimates)",
                  flush=True)
    b8_bound = bound_ms(k3_s8["bytes"], k3_s8["ops"])
    print(f"  k3_fused at S = {FUSE_S_MAX}, tile {k3_s8['tile']}: {k3_s8['ms'] * 1e3:.1f} us/pass = "
          f"{k3_s8['ms'] * 1e3 / FUSE_S_MAX:.1f} us/step; bound {b8_bound[0] * 1e3:.1f} us "
          f"({b8_bound[1]}); the tile's device-memory traffic "
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

    for mod, attr in ((solver, "step"), (cs, "k1_step_plain"), (cs, "k2_edge_bc_plain"),
                      (cs, "k1_step_dev_plain"), (cs, "k2_edge_bc_dev_plain"),
                      (cs, "k3_fused_plain")):
        counting(mod, attr)
    serial_kernels = ("k1_step", "k1_step_full", "k2_edge_bc")

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
    print(f"    launches {launches}, plain calls {counted}", flush=True)
    if md["status"] != "Success":
        raise AssertionError(f"main path ended {md['status']}: {md['reason']}")
    if min(launches[k] for k in serial_kernels) <= 0 or any(counted.values()):
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
    mlups3 = H * W / step_ms / 1e3
    print(f"    kernel path: {step_ms * 1e3:.1f} us/step = {mlups3:.1f} MLUPS "
          f"[{card}]", flush=True)
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
    nus = smoke_case.SIBLING_NUS
    n_cases = len(nus)
    chunks = max_steps // chunk
    want = {"k1_step_dev": n_cases * chunks * (chunk - 1),
            "k2_edge_bc_dev": n_cases * chunks * (chunk - 1),
            "k1_step_full": n_cases * chunks, "k2_edge_bc": n_cases * chunks, "k1_step": 0}
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
        print(f"    launches {launches4}, plain calls {counted}", flush=True)
        transfer = results[names[0][0]].get("run_summary", {}).get("transfer", {})
        print(f"    transfer record: {transfer}", flush=True)
        loop_s = transfer.get("group_wall_s")
        if loop_s:
            print(f"    group loop {loop_s:.2f} s = {n_cases * max_steps * H * W / loop_s / 1e6:.1f} "
                  f"MLUPS; set-up and wind-down {wall4 - loop_s:.2f} s [{card}]", flush=True)
        bad = {n: results[n]["status"] for n, _ in names if results[n]["status"] != "Success"}
        if bad or stats.get("success") != n_cases:
            raise AssertionError(f"lockstep cases did not all succeed: {stats}, {bad}")
        if any(launches4[k] != v for k, v in want.items()) or any(counted.values()):
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
    print(f"    launches {({k: v for k, v in launches5.items() if v})}, plain calls {counted}",
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
             "k1_step_bouzidi_full": chunks5, "k2_edge_bc_vel": DFG_RUN["steps"]}
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
    want6 = {"k3_fused": chunks * passes6, "k1_step": chunks * split6, "k1_step_full": chunks,
             "k2_edge_bc": chunks * (split6 + 1)}
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
        print(f"    launches {({k: v for k, v in launches6.items() if v})}, plain calls {counted}",
              flush=True)
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
    # the copy probe against its plain version and against copy_ at that size
    gen7 = torch.Generator(device=dev).manual_seed(SEED)
    f7 = torch.randn((9, ROOF_N, ROOF_N), generator=gen7, device=dev)
    aux7 = torch.randn((ROOF_N, ROOF_N), generator=gen7, device=dev)
    ok7, op7 = torch.empty_like(f7), torch.empty_like(f7)
    for variant, a7 in (("copy_probe", None), ("copy_probe_aux", aux7)):
        cp.copy_probe(f7, ok7, a7)
        cp.copy_probe_plain(f7, op7, a7)
        torch.cuda.synchronize()
        err = rel_err(ok7, op7)
        check(f"{variant} {ROOF_N}^2", err)
        records[variant] = record(
            float((ok7 - op7).abs().max()), {variant: err}, lambda a7=a7: cp.copy_probe(f7, ok7, a7),
            lambda a7=a7: cp.copy_probe_plain(f7, op7, a7),
            roofline.copy_traffic(ROOF_N, ROOF_N, a7 is not None), 0)
    records["copy_probe"]["library_ms"] = graph_ms(lambda: op7.copy_(f7))
    records["copy_probe_aux"]["library_ms"] = None
    for name in cp.VARIANTS:
        r = records[name]
        lib = r["library_ms"]
        print(f"  {name:<24s} {r['ms'] * 1e3:7.1f} us in a CUDA graph, bound {r['bound'][0] * 1e3:.1f} "
              f"us, plain {r['plain_ms'] * 1e3:.1f} us"
              + (f", copy_ {lib * 1e3:.1f} us" if lib else "") + f"  [{card}]", flush=True)

    kernels = []
    by_path = {"serial": launches, "lockstep": launches4, "dfg": launches5,
               "dfg_pairs": launches5b, "fused": launches6, "fused_pairs": launches6b,
               "roofline": launches7}
    sources = {"k1": ("k1_step.cu", "lbm2d_tpu/ops/pallas_step.py:824"),
               "k2": ("k2_edge_bc.cu", "lbm2d_tpu/ops/pallas_step.py:1379"),
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
        }
        if name == "k3_fused":
            entry[f"ms_s{FUSE_S_MAX}"] = k3_s8["ms"]
        kernels.append(entry)
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
