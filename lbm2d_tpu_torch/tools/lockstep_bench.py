"""Lockstep group throughput on one GPU: a group's chunks through
``BatchEngine.run_step``, as the lockstep loop issues them (the monitors
fetched after every chunk), with nothing else around them.

    python3 -m lbm2d_tpu_torch.tools.lockstep_bench [--chunks 20]

or by path from the root of another checkout of the port, whose package it
then imports (``python3 /path/to/lockstep_bench.py``): two trees in turns
in one call compare on one card. Two groups:

``production``: the smoke case (``tools/smoke_case.py``, 2432x1152) at
five viscosities, 16-bit deviation storage (``f16_state``), 100-step
chunks: the README lockstep command's group.

``small``: eight cases of the verify recipe's grid, 256x128 (a disc a case,
``small_config`` / ``small_mask``), exact f32, 100-step chunks.

Each prints the group's wall us a group-step and a case-step (host clock
around the chunks, ended by a synchronize) and MLUPS, beside the card's
name and power limit. Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import argparse
import os
import subprocess
import sys
import time

import numpy as np

SMALL_GRID = (128, 256)
SMALL_B = 8
PRODUCTION_NUS = (0.02, 0.025, 0.03, 0.04, 0.05)


def small_config(nu: float, rho_in: float = 1.02, warmup: int = 200, f16_state: bool = True,
                 obstacle: str = "equilibrium"):
    """A case of the small group: 256x128, sponges cut to the grid,
    pressure inlet, free-slip walls, outlet, the equilibrium obstacle rule
    unless ``obstacle`` names another."""
    ny, nx = SMALL_GRID
    return {
        "simulation": {
            "nx": nx, "ny": ny, "nu": nu, "ghost_moments_s": 1.2, "rho_in": rho_in,
            "rho_out": 1.0, "warmup_steps": warmup, "smagorinsky_constant": 0.1,
            "characteristic_length": 16, "name": "small", "f16_state": f16_state,
        },
        "domain_zones": {"sponge_in": 16, "sponge_out": 24, "sponge_top": 8, "sponge_bot": 8,
                         "sponge_strength": 3.0},
        "boundary_condition": {"type": [0, 2, 1, 2],
                               "value": [[0.05, 0.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0]],
                               "obstacle": obstacle},
    }


def small_mask(c: int) -> np.ndarray:
    """Case c's obstacle in the small group: a disc at its own place and
    size."""
    ny, nx = SMALL_GRID
    yy, xx = np.mgrid[0:ny, 0:nx]
    cy, cx, r = ny / 2 + 3 * (c % 3) - 3.4, nx / 3 + 5 * c + 0.3, 8 + c % 4
    return ((yy - cy) ** 2 + (xx - cx) ** 2 < r * r).astype(np.float32)


def time_group(engine, chunk: int, chunks: int) -> float:
    """Wall us a group-step over ``chunks`` chunks after two warm ones."""
    import torch

    for _ in range(2):
        engine.run_step(chunk)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(chunks):
        engine.run_step(chunk)
    torch.cuda.synchronize()
    return (time.perf_counter() - t0) * 1e6 / (chunks * chunk)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, default=20, help="timed chunks a group")
    args = ap.parse_args()
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("lockstep_bench: no CUDA device", file=sys.stderr)
        return 1
    import lbm2d_tpu_torch
    from lbm2d_tpu_torch.parallel.batch import BatchEngine
    from lbm2d_tpu_torch.tools import smoke_case

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"lockstep_bench: package {os.path.dirname(lbm2d_tpu_torch.__file__)} [{card}]",
          flush=True)
    config, mask = smoke_case.load_smoke_case()
    cfgs = []
    for nu in PRODUCTION_NUS:
        c = {k: dict(v) if isinstance(v, dict) else v for k, v in config.items()}
        c["simulation"] = dict(config["simulation"], nu=nu)
        cfgs.append(c)
    chunk = int(config["simulation"]["compute_step_size"])
    H, W = mask.shape
    groups = {
        "production": (BatchEngine(cfgs, [mask] * len(cfgs), store_dev=True, device="cuda"),
                       H * W),
    }
    ny, nx = SMALL_GRID
    groups["small"] = (BatchEngine([small_config(0.02 + 0.004 * c, 1.02 + 0.002 * c)
                                    for c in range(SMALL_B)],
                                   [small_mask(c) for c in range(SMALL_B)], device="cuda"),
                       ny * nx)
    for name, (engine, cells) in groups.items():
        us = time_group(engine, chunk, args.chunks)
        b = engine.batch
        print(f"lockstep_bench {name}: {b} cases, store_dev {engine._store_dev}, "
              f"{args.chunks} chunks of {chunk}: {us:.2f} us a group-step = {us / b:.2f} us a "
              f"case-step = {b * cells / us:.1f} MLUPS [{card}]", flush=True)
        del engine
        torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
