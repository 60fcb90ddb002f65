#!/usr/bin/env python3
"""Smoke test of the PyTorch + CUDA port (``lbm2d_tpu_torch``) on one GPU.

Run from the repository root on a machine with an NVIDIA H100:

    python3 chip_smoke.py

Phases (any failure raises and the process exits non-zero):

0. the card (nvidia-smi name and power limit), torch and nvcc versions;
1. build the CUDA kernels from ``lbm2d_tpu_torch/csrc`` with nvcc;
2. hold each kernel (K1 fast, K1 full, K2) against its plain PyTorch
   version at the production grid 2432x1152 f32 on a developed state, then a
   20-step ``run_chunk_cuda`` against the eager ``run_chunk``: max relative
   error (max |a - b| / max |b|) <= 1e-5 each; time each kernel with CUDA
   events beside its bound (``ms``: replayed from a CUDA graph, the
   kernel alone; ``launch_path_ms``: launched from Python one by one);
3. drive the main path, ``LBMEngine`` + ``run_simulation_loop``, on the
   production-shaped case in ``lbm2d_tpu_torch/data`` (3000 steps in chunks
   of 100), and check status Success, finite moments, mean jx > 0, Fx > 0,
   and that every kernel was launched and no plain step ran.

The last two lines are the kernels' JSON record and
``{"ok": true, "device": {...}}``. Without a CUDA device, or without the
package beside this script, it exits non-zero and prints no result.
"""

from __future__ import annotations

import json
import os
import statistics
import subprocess
import sys
import time

import numpy as np
import torch

HERE = os.path.dirname(os.path.abspath(__file__))
TOL = 1e-5  # max relative error of a kernel against its plain version
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


def load_smoke_case(pkg_dir: str):
    """(config dict, mask [H, W] float32) of the production-shaped case."""
    data = os.path.join(pkg_dir, "data")
    with open(os.path.join(data, "smoke_case.json")) as fh:
        config = json.load(fh)
    with np.load(os.path.join(data, "smoke_case_mask.npz")) as z:
        h, w = (int(v) for v in z["shape"])
        mask = np.unpackbits(z["mask_yx"], axis=1, count=w)[:h].astype(np.float32)
    return config, mask


class MomentSink:
    """In-memory stand-in for the HDF5 writer: keeps what the loop appends."""

    def __init__(self):
        self.frames = []

    def append(self, moments):
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
    config, mask = load_smoke_case(pkg_dir)
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

    # a 20-step chunk through the kernels against the eager reference step
    sk, mk = cs.run_chunk_cuda(state, p, 20)
    se, me = solver.run_chunk(state, p, 20)
    torch.cuda.synchronize()
    for k in ("f", "f_post", "rho", "u"):
        check(f"run_chunk_cuda(20) {k}", rel_err(getattr(sk, k), getattr(se, k)))
    check("run_chunk_cuda(20) force", rel_err(mk["force"], me["force"]))
    check("run_chunk_cuda(20) max_v", rel_err(mk["max_v"], me["max_v"]))
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

    for mod, attr in ((solver, "step"), (cs, "k1_step_plain"), (cs, "k2_edge_bc_plain")):
        counting(mod, attr)

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
    if min(launches.values()) <= 0 or any(counted.values()):
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

    kernels = []
    replaces = {
        "k1_step": "lbm2d_tpu/ops/pallas_step.py:824",
        "k1_step_full": "lbm2d_tpu/ops/pallas_step.py:824",
        "k2_edge_bc": "lbm2d_tpu/ops/pallas_step.py:1379",
    }
    sources = {
        "k1_step": "lbm2d_tpu_torch/csrc/k1_step.cu",
        "k1_step_full": "lbm2d_tpu_torch/csrc/k1_step.cu",
        "k2_edge_bc": "lbm2d_tpu_torch/csrc/k2_edge_bc.cu",
    }
    for name, r in records.items():
        kernels.append({
            "name": name, "route": "cuda", "source": sources[name],
            "replaces": replaces[name], "launches": launches[name],
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
