"""Headline benchmark of the port: MLUPS on the 1024^2 D2Q9 MRT-LES
cylinder (counterpart of the repository's root ``bench.py``).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 -m lbm2d_tpu_torch.tools.bench [--device cpu]

It runs the demo case (``tools/demo_case.py``: nu 0.01, warmup 2000)
through the chunk runner ``ops/cuda_step.run_chunk_cuda`` in 500-step
chunks (each chunk: 499 K1 fast steps in one library loop, the full step,
the force and max |u| monitors): 8 warm-up chunks, then three windows of
20 chunks, each ended by a host read of max |u|; the best window's rate is
the result. A guard then holds 40 steps of the chunk runner against 40 of
the eager step (``solver.run_chunk``) from rest: max |f_k - f_e| / max
|f_e| must stay below 1e-5, else it raises and the process exits
non-zero.

It prints exactly one line on stdout:
  {"metric": "...", "value": N, "unit": "MLUPS", "vs_baseline": N}
``vs_baseline`` is the MLUPS over 10,000, as in ``bench.py``. On the CPU
(``--device cpu``) the chunk runner runs the kernels' plain versions: the
line's shape, not a device rate.
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import math
import time

from ..core import solver
from ..core.engine import resolve_device
from ..ops.cuda_step import run_chunk_cuda
from .demo_case import cylinder_mask, demo_config

METRIC = "MLUPS/chip 1024^2 D2Q9 MRT-LES (cylinder, f32, 500-step monitor cadence)"
BASELINE_MLUPS = 10000.0
GUARD_STEPS = 40
GUARD_TOL = 1e-5


@dataclasses.dataclass
class BenchResult:
    line: dict  # the printed JSON object
    state: solver.LBMState  # the timed run's final state
    params: solver.CaseParams
    guard_rel: float  # max |f_k - f_e| / max |f_e| after GUARD_STEPS steps


def bench_case(n: int, device):
    """(params, initial state) of the bench case at n x n on ``device``."""
    p = solver.make_params(demo_config(n, n, nu=0.01, warmup=2000), cylinder_mask(n, n),
                           device=device)
    return p, solver.init_state(n, n, device=device)


def guard(p: solver.CaseParams, steps: int = GUARD_STEPS) -> float:
    """Relative max difference of ``steps`` steps of the chunk runner from
    the eager step's, both from rest; raises past ``GUARD_TOL``."""
    H, W = p.shape
    s0 = solver.init_state(H, W, device=p.mask.device)
    sk, _ = run_chunk_cuda(s0, p, steps)
    se, _ = solver.run_chunk(s0, p, steps)
    rel = float((sk.f - se.f).abs().max() / se.f.abs().max().clamp_min(1e-30))
    if not rel < GUARD_TOL:
        raise RuntimeError(f"chunk runner / eager step mismatch: rel={rel:.3e} "
                           f"(tolerance {GUARD_TOL:g})")
    return rel


def run(n: int = 1024, chunk: int = 500, warm_chunks: int = 8, windows: int = 3,
        n_chunks: int = 20, device="cuda") -> BenchResult:
    """Time the bench case, run the guard, print the one JSON line."""
    p, state = bench_case(n, resolve_device(device))
    # sustained load before the windows: builds the kernels and brings the
    # card to its steady clocks
    for _ in range(warm_chunks):
        state, mon = run_chunk_cuda(state, p, chunk)
    mon["max_v"].item()
    mlups = 0.0
    for _ in range(windows):
        t0 = time.perf_counter()
        for _ in range(n_chunks):
            state, mon = run_chunk_cuda(state, p, chunk)
        max_v = mon["max_v"].item()  # the scalar device-to-host read ends the window
        dt = time.perf_counter() - t0
        mlups = max(mlups, n * n * n_chunks * chunk / dt / 1e6)
    if not math.isfinite(max_v):
        raise RuntimeError("simulation diverged during bench")
    rel = guard(p)
    line = {"metric": METRIC, "value": round(mlups, 1), "unit": "MLUPS",
            "vs_baseline": round(mlups / BASELINE_MLUPS, 4)}
    print(json.dumps(line), flush=True)
    return BenchResult(line, state, p, rel)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the kernels' plain versions)")
    run(device=ap.parse_args(argv).device)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
