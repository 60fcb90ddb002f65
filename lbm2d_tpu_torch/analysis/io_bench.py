"""Random-crop read-latency benchmark: HDF5 vs Zarr (copy of
``lbm2d_tpu/analysis/io_bench.py``, the crop origins drawn from an explicit
generator; reference src/analysis/zarr_check.py parity).

Sweeps a (T, HW) grid of random crops from one Success case and reports the
H5/Zarr speedup per cell; optionally renders the heatmap.

Usage:
  python -m lbm2d_tpu_torch.analysis.io_bench --project_name Urban-1 [--plot out.png]
"""

from __future__ import annotations

import argparse
import json
import os
import random
import time
from typing import Dict, List, Optional

import numpy as np

T_LIST = [1, 50, 100, 150, 200, 250]
HW_LIST = [16, 32, 48, 64, 80, 96]
N_TRIALS = 10


def _h5py():
    """h5py, imported at first use (an ImportError names it where it is
    missing)."""
    import h5py

    return h5py


def _timed_h5(path: str, t_size: int, hw: int,
              rng: Optional[random.Random] = None) -> float:
    rng = rng or random.Random()
    with _h5py().File(path, "r") as f:
        data = f["turbulence"]
        t_total, _, h, w = data.shape
        t0 = rng.randint(0, max(0, t_total - t_size))
        h0 = rng.randint(0, max(0, h - hw))
        w0 = rng.randint(0, max(0, w - hw))
        start = time.perf_counter()
        _ = data[t0 : t0 + t_size, :, h0 : h0 + hw, w0 : w0 + hw]
        return time.perf_counter() - start


def _timed_zarr(path: str, t_size: int, hw: int,
                rng: Optional[random.Random] = None) -> float:
    rng = rng or random.Random()
    from ..post.zarrlite import read_region

    apath = os.path.join(path, "turbulence")
    with open(os.path.join(apath, ".zarray")) as fh:
        t_total, c, h, w = json.load(fh)["shape"]
    t0 = rng.randint(0, max(0, t_total - t_size))
    h0 = rng.randint(0, max(0, h - hw))
    w0 = rng.randint(0, max(0, w - hw))
    start = time.perf_counter()
    _ = read_region(
        apath,
        (
            slice(t0, t0 + t_size),
            slice(0, c),
            slice(h0, h0 + hw),
            slice(w0, w0 + hw),
        ),
    )
    return time.perf_counter() - start


def run_multi_benchmark(
    h5_path: str, zarr_path: str, t_list=T_LIST, hw_list=HW_LIST, trials=N_TRIALS,
    rng: Optional[random.Random] = None,
) -> List[Dict]:
    """Mean read time of ``trials`` random crops a (T, HW) cell, each crop's
    origin drawn from ``rng`` (a fresh generator when None)."""
    rng = rng or random.Random()
    results = []
    for hw in hw_list:
        for t in t_list:
            h5_t = float(np.mean([_timed_h5(h5_path, t, hw, rng) for _ in range(trials)]))
            z_t = float(np.mean([_timed_zarr(zarr_path, t, hw, rng) for _ in range(trials)]))
            results.append(
                {
                    "T": t,
                    "HW": hw,
                    "h5_s": h5_t,
                    "zarr_s": z_t,
                    "speedup": h5_t / z_t if z_t > 0 else float("inf"),
                }
            )
    return results


def plot_heatmap(results: List[Dict], out_png: str) -> None:
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    ts = sorted({r["T"] for r in results})
    hws = sorted({r["HW"] for r in results})
    grid = np.zeros((len(hws), len(ts)))
    for r in results:
        grid[hws.index(r["HW"]), ts.index(r["T"])] = r["speedup"]
    fig, ax = plt.subplots(figsize=(8, 5))
    im = ax.imshow(grid, cmap="RdYlGn", aspect="auto")
    ax.set_xticks(range(len(ts)), [str(t) for t in ts])
    ax.set_yticks(range(len(hws)), [str(h) for h in hws])
    ax.set_xlabel("T (frames)")
    ax.set_ylabel("HW (crop size)")
    ax.set_title("H5/Zarr random-crop read speedup")
    for i in range(len(hws)):
        for j in range(len(ts)):
            ax.text(j, i, f"{grid[i, j]:.2f}", ha="center", va="center", fontsize=8)
    fig.colorbar(im)
    fig.savefig(out_png, dpi=120, bbox_inches="tight")
    plt.close(fig)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument("--project_name", required=True)
    ap.add_argument("--plot", default=None)
    args = ap.parse_args(argv)
    base = os.path.join("outputs", args.project_name)
    with open(os.path.join(base, "plots", "all_cases_summary.json")) as fh:
        cases = json.load(fh)
    case = next(c for c in cases if c["status"] == "Success")
    h5_path = os.path.join(base, "raw", case["run_summary"]["h5_file"])
    zarr_path = os.path.join(base, "zarr", f"{case['case_name']}.zarr")
    results = run_multi_benchmark(h5_path, zarr_path)
    print(json.dumps(results, indent=2))
    if args.plot:
        plot_heatmap(results, args.plot)


if __name__ == "__main__":
    main()
