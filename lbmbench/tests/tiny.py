"""Tiny versions of the benchmark's configurations, for CPU tests: the same
files, their grids and depths cut so a run takes seconds on the CPU."""

import copy
import json
import os
import time

from lbmbench import harness

HERE = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def urban(record=True):
    cfg = harness.load_json(os.path.join(HERE, "configs", "urban_2432x1152_lockstep5.json"))
    cfg = copy.deepcopy(cfg)
    c = cfg["case"]
    c["simulation"].update(nx=256, ny=128, compute_step_size=10, max_steps=100, warmup_steps=40)
    c["outputs"]["start_record_step"] = 40
    for s in ("gui", "video", "dataset"):
        c["outputs"][s]["interval_steps"] = 10
    c["outputs"]["dataset"]["save_resolution_height"] = 32
    c["domain_zones"].update(sponge_in=16, sponge_out=64, sponge_top=8, sponge_bot=8, buffer=16)
    cfg["mask"] = {"generator": "hybrid", "domain": {"width": 160, "height": 64},
                   "padding": {"left": 32, "right": 64, "top": 32, "bot": 32}}
    wl = harness.load_json(os.path.join(HERE, "workloads",
                                        "urban5.prod.json" if record else "urban5.norecord.json"))
    wl.update(sample_groups=1, trace_chunks=[3, 6])
    return cfg, wl


def dfg():
    cfg = copy.deepcopy(harness.load_json(os.path.join(
        HERE, "configs", "dfg2d_re100_ny165_bouzidi_nebb.json")))
    cfg["validation"].update(ny=25, steps=1000, chunk=25)
    # a tiny channel sheds nothing like the published case: no range applies;
    # and in its first chunks the outlet's backflow guard, a branch on the
    # sign of u, can take another side in float32 than in float64: its gaps
    # are larger than the published case's, whose limits came from readings
    # at that case's size
    cfg["published_ranges"] = {}
    cfg["limits"] = dict(cfg["limits"], chunk_f=1e-3, chunk_f_post=1e-3, chunk_rho=1e-3,
                         chunk_u=1e-3)
    wl = harness.load_json(os.path.join(HERE, "workloads", "dfg.re100.json"))
    wl.update(sample_runs=1, warm_steps=100, trace_chunks=[3, 6])
    return cfg, wl


def run(kind, cfg, wl, seed=2**31 + 17, seconds=0.1):
    driver = harness.load_module(os.path.join(HERE, "drivers", f"{kind}.py"), f"tiny_{kind}")
    r = harness.Run(cell="tiny", seed=seed, seconds=seconds, trace=False, chips=1,
                    config=cfg, workload=wl, device="cpu", started=time.perf_counter())
    return driver.run(r)


def as_json(obj):
    return json.loads(json.dumps(obj))
