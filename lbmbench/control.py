"""Readings of a cell's comparisons, the program's and its control's, on
several seeds in one process: the readings each limit is set from.

The control is the reference put in the program's place at the precision
below the one the configuration states (the drivers' ``judge(...,
control=True)``); it has to come out not correct. Each seed runs the cell's
driver with a short window (``--seconds``, at least one whole group or
validation, at the cell's own sizes), then prints one JSON line:
``{"seed", "program": {name: value}, "control": {name: value}, "limits"}``
(``control`` only on the seeds that read it).

    python3 lbmbench/control.py --workload urban5.prod --seeds 1 2 3 --seconds 1 \
        --control-seeds 1 2
"""

import argparse
import json
import os
import sys
import time

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

from lbmbench import harness  # noqa: E402


def readings(workload: str, seeds, seconds: float, device: str = "cuda", overrides=None,
             control_seeds=None):
    """Yield one dict a seed: the program's numbers, and the control's on
    ``control_seeds`` (every seed where None)."""
    found = harness.find_cell(workload, harness.manifest())
    config, wl = found["config"], found["workload"]
    if overrides:
        config, wl = overrides(config, wl)
    driver = harness.load_module(os.path.join(harness.HERE, "drivers", f"{config['driver']}.py"),
                                 f"lbmbench_driver_{config['driver']}")
    for seed in seeds:
        run = harness.Run(cell=workload, seed=seed, seconds=seconds, trace=False, chips=1,
                          config=config, device=device,
                          workload=dict(wl, control=control_seeds is None or seed in control_seeds),
                          started=time.perf_counter())
        out = driver.run(run)
        line = {"seed": seed, "program": {c.name: c.value for c in out.checks},
                "program_correct": all(c.ok for c in out.checks),
                "limits": {c.name: c.limit for c in out.checks}}
        if "control" in out.notes:
            line["control"] = {c.name: c.value for c in out.notes["control"]}
            line["control_correct"] = all(c.ok for c in out.notes["control"])
        yield line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--seconds", type=float, default=1.0)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=None,
                    help="the seeds that also read the control (default: every seed)")
    args = ap.parse_args(argv)
    harness.cache_env()
    for line in readings(args.workload, args.seeds, args.seconds,
                         control_seeds=args.control_seeds):
        print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
