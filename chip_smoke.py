#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``lbm2d_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the process exits non-zero):

0. the card (nvidia-smi name and power limit), torch and nvcc versions;
1. build the CUDA kernels from ``lbm2d_tpu_torch/csrc`` with nvcc;
2. hold each kernel (K1 fast, K1 full, K2, and K1 and K2 in 16-bit
   deviation storage) against its plain PyTorch version at the production
   grid 2432x1152 on a developed state, then a 20-step ``run_chunk_cuda``
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
   of ``h5py.File`` and the frames are read back from it.

The last two lines are the kernels' JSON record (``launches``: the sum over
the two paths, split in ``launches_by_path``) and ``{"ok": true, "device":
{...}}``. Without a CUDA device, or without the package beside this
script, it exits non-zero and prints no result.
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

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM3 bytes/s and
# f32 non-tensor-core FLOP/s. bound = max(bytes / BW, ops / FLOPS).
PEAK_BW = 3.35e12
PEAK_F32 = 67e12
# f32 operations per interior cell of K1, counted from csrc/lbm_common.cuh
# mrt_collide (sqrt and division count one each) plus the overwrite
K1_OPS_PER_CELL = 120
# per ring cell of K2: one BC (~70 for the Zou-He branches) plus overwrite
K2_OPS_PER_CELL = 80


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

    def k1_buffers(full):
        out = {"f_out": torch.zeros_like(state.f), "edge": cs.new_edge_buffer(H, W, device=dev)}
        if full:
            out.update(rho=torch.zeros((H, W), device=dev), u=torch.zeros((2, H, W), device=dev),
                       f_post=state.f_post.clone())
        return out

    def run_k1(fn, b):
        fn(state.f, b["f_out"], aux, b["edge"], scal, p.use_les,
           b.get("rho"), b.get("u"), b.get("f_post"))

    records = {}
    for full in (False, True):
        name = "k1_step_full" if full else "k1_step"
        bk, bp = k1_buffers(full), k1_buffers(full)
        run_k1(cs.k1_step, bk)
        run_k1(cs.k1_step_plain, bp)
        torch.cuda.synchronize()
        errs = {k: rel_err(bk[k], bp[k]) for k in bk}
        for k, err in errs.items():
            check(f"{name} {k}", err)
        launch_ms, host_ms = median_ms(lambda: run_k1(cs.k1_step, bk))
        ms = graph_ms(lambda: run_k1(cs.k1_step, bk))
        plain_ms, _ = median_ms(lambda: run_k1(cs.k1_step_plain, bp), batches=5, per_batch=2)
        n_in = (H - 2) * (W - 2)
        nbytes = 36 * H * W + 4 * H * W + 36 * n_in + 4 * bk["edge"].numel()
        if full:
            nbytes += 4 * H * W + 8 * H * W + 36 * n_in  # rho, u, f_post
        records[name] = dict(max_abs_err=max(float((bk[k] - bp[k]).abs().max()) for k in bk),
                             max_rel_err=max(errs.values()), ms=ms, launch_ms=launch_ms,
                             host_ms=host_ms, plain_ms=plain_ms,
                             bound=bound_ms(nbytes, K1_OPS_PER_CELL * n_in))
        k1_out = bp

    # K2 on K1's output (full variant: f ring plus rho/u ring)
    ring = 2 * (H - 2) + 2 * W
    bk = {k: v.clone() for k, v in k1_out.items()}
    bp = {k: v.clone() for k, v in k1_out.items()}

    def run_k2(fn, b):
        fn(b["f_out"], aux, b["edge"], scal, p.bc_type, b["rho"], b["u"])

    run_k2(cs.k2_edge_bc, bk)
    run_k2(cs.k2_edge_bc_plain, bp)
    torch.cuda.synchronize()
    for k in ("f_out", "rho", "u"):
        check(f"k2_edge_bc {k}", rel_err(bk[k], bp[k]))
    nbytes = 4 * bk["edge"].numel() + 4 * ring + (36 + 12) * ring
    launch_ms, host_ms = median_ms(lambda: run_k2(cs.k2_edge_bc, bk))
    records["k2_edge_bc"] = dict(
        max_abs_err=max(float((bk[k] - bp[k]).abs().max()) for k in ("f_out", "rho", "u")),
        max_rel_err=max(rel_err(bk[k], bp[k]) for k in ("f_out", "rho", "u")),
        ms=graph_ms(lambda: run_k2(cs.k2_edge_bc, bk)), launch_ms=launch_ms, host_ms=host_ms,
        plain_ms=median_ms(lambda: run_k2(cs.k2_edge_bc_plain, bp), batches=5, per_batch=2)[0],
        bound=bound_ms(nbytes, K2_OPS_PER_CELL * ring),
    )

    # K1 and K2 in 16-bit deviation storage, on the same developed state
    fq = cs.quantize(state.f)

    def kd_buffers():
        return {"f_out": torch.zeros_like(fq), "edge": cs.new_edge_buffer(H, W, device=dev)}

    def run_k1d(fn, b):
        fn(fq, b["f_out"], aux, b["edge"], scal, p.use_les)

    bk, bp = kd_buffers(), kd_buffers()
    run_k1d(cs.k1_step_dev, bk)
    run_k1d(cs.k1_step_dev_plain, bp)
    torch.cuda.synchronize()
    errs = {k: rel_err(bk[k], bp[k]) for k in bk}
    for k, err in errs.items():
        check(f"k1_step_dev {k}", err)
    launch_ms, host_ms = median_ms(lambda: run_k1d(cs.k1_step_dev, bk))
    n_in = (H - 2) * (W - 2)
    records["k1_step_dev"] = dict(
        max_abs_err=max(float((bk[k].float() - bp[k].float()).abs().max()) for k in bk),
        max_rel_err=max(errs.values()), ms=graph_ms(lambda: run_k1d(cs.k1_step_dev, bk)),
        launch_ms=launch_ms, host_ms=host_ms,
        plain_ms=median_ms(lambda: run_k1d(cs.k1_step_dev_plain, bp), batches=5, per_batch=2)[0],
        # f 18 B in (bf16), aux 4, f 18 B out, the f32 edge export; the
        # dequantize and quantize add 18 operations per cell
        bound=bound_ms(18 * H * W + 4 * H * W + 18 * n_in + 4 * bk["edge"].numel(),
                       (K1_OPS_PER_CELL + 18) * n_in),
    )
    bk = {k: v.clone() for k, v in bp.items()}

    def run_k2d(fn, b):
        fn(b["f_out"], aux, b["edge"], scal, p.bc_type)

    run_k2d(cs.k2_edge_bc_dev, bk)
    run_k2d(cs.k2_edge_bc_dev_plain, bp)
    torch.cuda.synchronize()
    err = rel_err(bk["f_out"], bp["f_out"])
    check("k2_edge_bc_dev f_out", err)
    launch_ms, host_ms = median_ms(lambda: run_k2d(cs.k2_edge_bc_dev, bk))
    records["k2_edge_bc_dev"] = dict(
        max_abs_err=float((bk["f_out"].float() - bp["f_out"].float()).abs().max()),
        max_rel_err=err, ms=graph_ms(lambda: run_k2d(cs.k2_edge_bc_dev, bk)),
        launch_ms=launch_ms, host_ms=host_ms,
        plain_ms=median_ms(lambda: run_k2d(cs.k2_edge_bc_dev_plain, bp), batches=5, per_batch=2)[0],
        bound=bound_ms(4 * bk["edge"].numel() + 4 * ring + 18 * ring,
                       (K2_OPS_PER_CELL + 9) * ring),
    )

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
        print(f"  {name:<13s} {r['ms'] * 1e3:7.1f} us in a CUDA graph, {r['launch_ms'] * 1e3:.1f} us "
              f"launched from Python (host issue {r['host_ms'] * 1e3:.1f} us)  "
              f"plain {r['plain_ms'] * 1e3:9.1f} us  "
              f"bound {r['bound'][0] * 1e3:7.1f} us ({r['bound'][1]})  [{card}]", flush=True)

    # -- phase 3: the main path --------------------------------------------
    counted = {}

    def counting(mod, attr):
        fn = getattr(mod, attr)

        def wrapper(*a, **kw):
            counted[attr] = counted.get(attr, 0) + 1
            return fn(*a, **kw)

        setattr(mod, attr, wrapper)

    for mod, attr in ((solver, "step"), (cs, "k1_step_plain"), (cs, "k2_edge_bc_plain"),
                      (cs, "k1_step_dev_plain"), (cs, "k2_edge_bc_dev_plain")):
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
    print(f"[3] main path: {md['status']} ({md['reason']}) after {md['final_steps']} steps "
          f"in {wall:.2f} s = {max_steps * H * W / wall / 1e6:.1f} MLUPS wall "
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
    print(f"    kernel path: {step_ms * 1e3:.1f} us/step = {H * W / step_ms / 1e3:.1f} MLUPS "
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

    kernels = []
    replaces = {
        "k1_step": "lbm2d_tpu/ops/pallas_step.py:824",
        "k1_step_full": "lbm2d_tpu/ops/pallas_step.py:824",
        "k2_edge_bc": "lbm2d_tpu/ops/pallas_step.py:1379",
        "k1_step_dev": "lbm2d_tpu/ops/pallas_step.py:824",
        "k2_edge_bc_dev": "lbm2d_tpu/ops/pallas_step.py:1379",
    }
    sources = {
        "k1_step": "lbm2d_tpu_torch/csrc/k1_step.cu",
        "k1_step_full": "lbm2d_tpu_torch/csrc/k1_step.cu",
        "k2_edge_bc": "lbm2d_tpu_torch/csrc/k2_edge_bc.cu",
        "k1_step_dev": "lbm2d_tpu_torch/csrc/k1_step.cu",
        "k2_edge_bc_dev": "lbm2d_tpu_torch/csrc/k2_edge_bc.cu",
    }
    for name, r in records.items():
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name] + launches4[name],
            "launches_by_path": {"serial": launches[name], "lockstep": launches4[name]},
            "max_abs_err": r["max_abs_err"], "max_rel_err": r["max_rel_err"],
            "ms": r["ms"], "launch_path_ms": r["launch_ms"], "plain_ms": r["plain_ms"],
            "bound_ms": r["bound"][0],
            "bound_by": r["bound"][1], "library_ms": None,
        })
    print(card)
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
