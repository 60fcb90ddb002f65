"""The benchmark's harness: finds a cell by name, runs its driver, reads its
per-layer metrics, judges its comparisons, and prints one result line.

Everything a cell needs is found by name: the cell in ``BENCHMARK.json``,
its traffic in ``workloads/<cell>.json``, its configuration in the file
``BENCHMARK.json`` names, the driver that configuration names in
``drivers/<driver>.py`` and each per-layer metric in ``metrics/<metric>.py``.
"""

from __future__ import annotations

import argparse
import importlib.util
import json
import math
import os
import sys
import time
from dataclasses import dataclass, field
from typing import Any, Callable, Dict, List, Optional

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(HERE)
# top-level module names that may not be loaded in a run, compared whole
BANNED = ("jax", "jaxlib", "flax", "lbm2d_tpu")


class Refused(Exception):
    """The run cannot give a result; the message says why."""


def process_age_s() -> Optional[float]:
    """Seconds since this process started, from the kernel's record."""
    try:
        with open("/proc/self/stat") as fh:
            start_ticks = int(fh.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/uptime") as fh:
            uptime = float(fh.read().split()[0])
        return uptime - start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError):
        return None


def load_json(path: str) -> Any:
    with open(path) as fh:
        return json.load(fh)


def load_module(path: str, name: str):
    """A module from its file, by path (names may hold dots)."""
    if not os.path.exists(path):
        raise Refused(f"missing {os.path.relpath(path, ROOT)}")
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def manifest(root: str = ROOT) -> dict:
    path = os.path.join(root, "BENCHMARK.json")
    if not os.path.exists(path):
        raise Refused("no BENCHMARK.json at the root of the checkout")
    return load_json(path)


def find_cell(name: str, man: dict, root: str = ROOT) -> dict:
    """{"cell", "config", "workload", "config_entry"} of cell ``name``."""
    cells = {w["name"]: w for w in man["workloads"]}
    if name not in cells:
        raise Refused(f"no cell {name!r} in BENCHMARK.json")
    cell = cells[name]
    configs = {c["name"]: c for c in man["configs"]}
    entry = configs[cell["config"]]
    config = load_json(os.path.join(root, entry["file"]))
    workload = load_json(os.path.join(root, "lbmbench", "workloads", f"{name}.json"))
    if workload.get("traffic") != cell["traffic"]:
        raise Refused(f"workloads/{name}.json is traffic {workload.get('traffic')!r}, "
                      f"BENCHMARK.json says {cell['traffic']!r}")
    return {"cell": cell, "config": config, "workload": workload, "config_entry": entry}


def metrics_of(man: dict, cell: str, kind: str) -> List[dict]:
    """The cell's ``end_to_end`` or ``per_layer`` metrics."""
    return [m for m in man[kind] if "workloads" not in m or cell in m["workloads"]]


def banned_loaded(modules=None) -> List[str]:
    """Loaded modules whose top-level name is banned."""
    modules = sys.modules if modules is None else modules
    return sorted({m.split(".")[0] for m in modules} & set(BANNED))


@dataclass
class Check:
    """One number compared with its limit: ``value <= limit``, or within
    ``[lo, hi]`` where the limit is a pair."""

    name: str
    value: float
    limit: Any

    @property
    def ok(self) -> bool:
        if self.value is None or (isinstance(self.value, float) and math.isnan(self.value)):
            return False
        if isinstance(self.limit, (list, tuple)):
            return self.limit[0] <= self.value <= self.limit[1]
        return self.value <= self.limit


@dataclass
class Outcome:
    """What a driver hands back."""

    setup_s: float
    e2e: Dict[str, float]              # end-to-end values by metric name
    attempted: int
    failed: int
    record: dict                       # what the per-layer readers read
    checks: List[Check] = field(default_factory=list)
    memory_peak_bytes: int = 0
    trace: Optional[dict] = None       # busy_s, window_s, device_ops, idle_gaps
    notes: Dict[str, Any] = field(default_factory=dict)


@dataclass
class Run:
    """What a driver is given."""

    cell: str
    seed: int
    seconds: float
    trace: bool
    chips: int
    config: dict
    workload: dict
    device: str = "cuda"
    started: Optional[float] = None    # perf_counter() at process start
    log: Callable[[str], None] = lambda s: print(s, file=sys.stderr, flush=True)

    def since_start(self) -> float:
        return time.perf_counter() - self.started


def cache_env(root: str = ROOT) -> None:
    """Keep every build and kernel cache the program might use inside the
    checkout, at fixed paths, and keep libraries from loading JAX."""
    base = os.path.join(root, ".lbmbench_cache")
    os.environ["TRITON_CACHE_DIR"] = os.path.join(base, "triton")
    os.environ["TORCH_EXTENSIONS_DIR"] = os.path.join(base, "torch_extensions")
    os.environ["CUDA_CACHE_PATH"] = os.path.join(base, "cuda")
    os.environ["USE_FLAX"] = "0"
    os.environ["USE_JAX"] = "0"


def device_info(chips: int) -> dict:
    import torch

    return {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": chips}


def run_cell(args, started: float) -> dict:
    man = manifest()
    found = find_cell(args.workload, man)
    cell, config = found["cell"], found["config"]
    chips = int(cell["chips"])
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        raise Refused(f"cell {args.workload} needs {chips} CUDA device(s); "
                      f"{torch.cuda.device_count() if torch.cuda.is_available() else 0} found")
    driver = load_module(os.path.join(HERE, "drivers", f"{config['driver']}.py"),
                         f"lbmbench_driver_{config['driver']}")
    run = Run(cell=args.workload, seed=args.seed, seconds=args.seconds, trace=bool(args.trace),
              chips=chips, config=config, workload=found["workload"], started=started)
    out: Outcome = driver.run(run)
    loaded = banned_loaded()
    if loaded:
        raise Refused(f"modules loaded in the run: {', '.join(loaded)}")
    if args.trace:
        metrics = {}
        for m in metrics_of(man, args.workload, "per_layer"):
            reader = load_module(os.path.join(HERE, "metrics", f"{m['name']}.py"),
                                 "lbmbench_metric_" + m["name"].replace(".", "_"))
            value = reader.read(out.record, out.trace)
            if value is not None:
                metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    else:
        metrics = {}
        for m in metrics_of(man, args.workload, "end_to_end"):
            value = out.setup_s if m["name"] == "setup_s" else out.e2e.get(m["name"])
            if value is None:
                raise Refused(f"the driver gave no {m['name']}")
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    device = device_info(chips)
    device["memory_peak_bytes"] = int(out.memory_peak_bytes)
    result = {"correct": all(c.ok for c in out.checks) and bool(out.checks),
              "attempted": int(out.attempted), "failed": int(out.failed),
              "metrics": metrics, "device": device}
    if args.trace and out.trace is not None:
        device["busy_s"] = out.trace["busy_s"]
        device["window_s"] = out.trace["window_s"]
        result["breakdown"] = {"device_ops": out.trace["device_ops"],
                               "idle_gaps": out.trace["idle_gaps"]}
    result["checks"] = {c.name: {"value": c.value, "limit": c.limit} for c in out.checks}
    return result


def parse(argv):
    ap = argparse.ArgumentParser(description="Run one cell of the lbm2d_tpu_torch benchmark.")
    ap.add_argument("--workload", required=True, help="cell name in BENCHMARK.json")
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def main(argv, started: float) -> int:
    args = parse(argv)
    try:
        result = run_cell(args, started)
    except Refused as exc:
        print(f"[lbmbench] no result: {exc}", file=sys.stderr, flush=True)
        return 2
    for name, c in result["checks"].items():
        print(f"[lbmbench] check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    sys.stdout.flush()
    print(json.dumps(result), flush=True)
    return 0
