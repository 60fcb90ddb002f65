"""DFG-2D (Schaefer-Turek 2D-2, Re = 100) matrix on the port: the
counterpart of the repository's ``tools_dfg_suite.sh``.

On a machine with an NVIDIA GPU:

    python3 -m lbm2d_tpu_torch.tools.dfg_suite [--out FILE] [--device cpu]

The same 12 rows in the same order: for each obstacle scheme (full-way,
half-way, Bouzidi bounce-back) the equilibrium inlet then NEBB, at ny 165
(u 0.1, 200,000 steps), then the same six at ny 329 (u 0.05, 600,000
steps), each through ``analysis.dfg_validation.run_validation`` in this
process with its default chunk of 200 steps. The output file
(default ``docs/benchmarks/dfg2d_results_h100.json``; never the TPU
file) is started fresh and rewritten after each row, so a cut run keeps
the rows it finished. Each row is ``run_validation``'s dict plus ``card``
(``nvidia-smi``'s name and power limit, or ``cpu``) and ``wall_s`` (the
row's wall seconds, set-up included).

At the end it prints each row beside the recorded row of the same
configuration in ``docs/benchmarks/dfg2d_results.json``, and exits
non-zero if a row lies outside the JAX test's ranges (St 0.26-0.32, Cd
2.7-3.5, Cl amplitude 0.5-1.4, Re 90-110) or detected no shedding.
"""

from __future__ import annotations

import argparse
import json
import os
import time

from ..analysis.dfg_validation import run_validation
from ..core.engine import resolve_device

OBSTACLES = ("bounce_back", "bounce_back_halfway", "bounce_back_bouzidi")
INLETS = ("equilibrium", "nebb")
# (ny, u_max, steps) of each resolution
RESOLUTIONS = ((165, 0.1, 200_000), (329, 0.05, 600_000))
MATRIX = tuple(
    {"obstacle": obstacle, "inlet": inlet, "ny": ny, "u_target": u, "steps": steps}
    for ny, u, steps in RESOLUTIONS for obstacle in OBSTACLES for inlet in INLETS
)
# the checkout's results directory, wherever the tool is run from
_RESULTS_DIR = os.path.join(os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__)))), "docs", "benchmarks")
DEFAULT_OUT = os.path.join(_RESULTS_DIR, "dfg2d_results_h100.json")
TPU_RESULTS = os.path.join(_RESULTS_DIR, "dfg2d_results.json")
RANGES = {"strouhal": (0.26, 0.32), "cd_mean": (2.7, 3.5), "cl_amplitude": (0.5, 1.4),
          "re_measured": (90.0, 110.0)}
COMPARED = ("cd_mean", "strouhal", "cl_amplitude", "re_measured")


def run_suite(out: str = DEFAULT_OUT, steps: int | None = None, device="cuda",
              rows=MATRIX) -> list:
    """Run ``rows`` (``run_validation`` keyword sets; the matrix by
    default), each ``steps`` long if given, into ``out``; returns the
    rows' results."""
    device = resolve_device(device)
    card = "cpu"
    if device.type == "cuda":
        from .cuda_timing import card_line

        card = card_line()
    if os.path.exists(out):
        os.remove(out)
    os.makedirs(os.path.dirname(out) or ".", exist_ok=True)
    results = []
    for row in rows:
        kw = dict(row, **({} if steps is None else {"steps": steps}))
        t0 = time.perf_counter()
        res = run_validation(mode="dfg", re=100.0, device=device, progress=False, **kw)
        res["card"] = card
        res["wall_s"] = time.perf_counter() - t0
        results.append(res)
        with open(out, "w") as fh:
            json.dump(results, fh, indent=2)
        print(f"[{len(results)}/{len(rows)}] {res['obstacle']} {res['inlet']} ny {res['ny']}: "
              + ", ".join(f"{k} {res.get(k, float('nan')):.6f}" for k in COMPARED)
              + f", {res['steps']} steps in {res['wall_s']:.1f} s [{card}]", flush=True)
    return results


def gate(res: dict) -> list:
    """What of ``res`` lies outside the JAX test's ranges."""
    bad = [f"{k} {res.get(k)} outside [{lo}, {hi}]" for k, (lo, hi) in RANGES.items()
           if not lo <= res.get(k, float("nan")) <= hi]
    if not res.get("shedding_detected"):
        bad.append("no shedding detected")
    return bad


def recorded_row(res: dict, recorded: list):
    """The recorded row of ``res``'s configuration, or None."""
    key = ("obstacle", "inlet", "ny")
    return next((r for r in recorded if all(r.get(k) == res.get(k) for k in key)), None)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--out", default=DEFAULT_OUT, help="results file (started fresh)")
    ap.add_argument("--device", default="cuda",
                    help="torch device (default cuda; 'cpu' runs the eager step)")
    args = ap.parse_args(argv)
    results = run_suite(args.out, device=args.device)
    recorded = []
    if os.path.exists(TPU_RESULTS):
        with open(TPU_RESULTS) as fh:
            recorded = json.load(fh)
    failed = 0
    for res in results:
        ref = recorded_row(res, recorded)
        diffs = ", ".join(f"d{k} {res[k] - ref[k]:+.3e}" for k in COMPARED
                          if ref is not None and k in res and k in ref)
        bad = gate(res)
        failed += bool(bad)
        print(f"{res['obstacle']} {res['inlet']} ny {res['ny']}: vs the recorded TPU row "
              f"{diffs or 'none recorded'}; {'; '.join(bad) or 'inside the ranges'}", flush=True)
    return 1 if failed else 0


if __name__ == "__main__":
    raise SystemExit(main())
