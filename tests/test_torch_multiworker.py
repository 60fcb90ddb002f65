"""Multi-worker runs of the port on the CPU (counterpart of
``tests/test_multiworker.py``): two OS processes share one project
through ``--coordinate`` claims.

- serial ``run_batch(coordinate=True)`` on a 4-case project, video on;
- lockstep ``run_batched(coordinate=True)`` on a 4-case project;
- lockstep with ``runner="sharded", n_devices=2`` on an 8-case project
  (the JAX ``:273`` shape, two devices a worker instead of four).

Each checks: every case Success and run once, disjoint owners, the claims
released, the NPZ complete, each case's HDF5 datasets byte-equal to a
one-worker run of the same mode, and ``turbulence`` within 1e-6 of the
JAX package's serial run of the same case (the port's f32 bar).

Each worker has a hard timeout and a faulthandler tripwire.
"""

import json
import os
import subprocess
import sys

import h5py
import numpy as np
import pytest

from lbm2d_tpu.pipeline.batch_run import run_batch as jax_run_batch
from lbm2d_tpu_torch.pipeline.batch_datagen import run_batched
from lbm2d_tpu_torch.pipeline.batch_run import run_batch
from test_multiworker import make_cases_project
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TIMEOUT_S = 300
NUS8 = (0.05, 0.045, 0.04, 0.035, 0.03, 0.025, 0.02, 0.015)

_WORKER = """
import faulthandler, json, sys
faulthandler.dump_traceback_later(%d, exit=True, file=sys.stderr)
sys.modules["jax"] = None  # the port needs no JAX
root, name, wid, mode = sys.argv[1:5]
kw = json.loads(sys.argv[5])
if mode == "serial":
    from lbm2d_tpu_torch.pipeline.batch_run import run_batch
    stats = run_batch(name, root=root, progress=False, device="cpu", coordinate=True, **kw)
else:
    from lbm2d_tpu_torch.pipeline.batch_datagen import run_batched
    stats = run_batched(name, root=root, progress=False, video=False, device="cpu",
                        coordinate=True, worker_id=wid, **kw)
print("STATS " + json.dumps(stats), flush=True)
""" % (TIMEOUT_S - 60)


def _project(root, name, nus, video):
    names = make_cases_project(root, name=name, nus=nus)
    if video:
        import yaml

        for n in names:
            path = os.path.join(root, "SimCases", name, "configs", n)
            with open(path) as fh:
                cfg = yaml.safe_load(fh)
            cfg["outputs"]["video"]["enable"] = True
            with open(path, "w") as fh:
                yaml.safe_dump(cfg, fh, sort_keys=False)
    return names


def _two_workers(root, name, mode, kw):
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", _WORKER, root, name, wid, mode,
                               json.dumps(kw)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
             for wid in ("workerA", "workerB")]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for p, out in zip(procs, outs):
        assert p.returncode == 0, out[-3000:]
    return outs


def _worker_ids(outs, mode):
    if mode != "serial":
        return ["workerA", "workerB"]
    tag = "[Batch] multi-worker mode, worker="
    return [[x for x in o.splitlines() if x.startswith(tag)][0][len(tag):] for o in outs]


def _case(fname):
    return fname.replace("_cfg", "").replace(".yaml", "")


def _datasets(path):
    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f}


def _check(root, name, names, mode, outs, ref_root, jax_root, video):
    stats = [json.loads([x for x in o.splitlines() if x.startswith("STATS ")][-1][6:])
             for o in outs]
    assert sum(s["success"] for s in stats) == len(names), stats  # each case ran once
    assert sum(s["failed"] for s in stats) == 0, stats
    plots = os.path.join(root, "outputs", name, "plots")
    with open(os.path.join(plots, "sim_results.json")) as fh:
        entries = {e["config_filename"]: e for e in json.load(fh)}
    owners = {}
    for n in names:
        assert entries[n]["status"] == "Success", entries[n]
        owners.setdefault(entries[n]["worker"], []).append(n)
    ids = _worker_ids(outs, mode)
    assert set(owners) <= set(ids), (owners, ids)
    assert sorted(sum(owners.values(), [])) == sorted(names)  # disjoint, complete
    assert os.listdir(os.path.join(plots, ".claims")) == []
    vec = np.load(os.path.join(plots, "all_cases_vectors.npz"), allow_pickle=True)
    assert sorted(vec["case_names"]) == sorted(_case(n) for n in names)
    for n in names:
        case = _case(n)
        got = _datasets(os.path.join(root, "outputs", name, "raw", f"{case}.h5"))
        one = _datasets(os.path.join(ref_root, "outputs", name, "raw", f"{case}.h5"))
        assert sorted(got) == sorted(one)
        for k in got:
            assert got[k].tobytes() == one[k].tobytes(), (case, k)
        ref = _datasets(os.path.join(jax_root, "outputs", name, "raw", f"{case}.h5"))
        assert got["turbulence"].shape == ref["turbulence"].shape
        np.testing.assert_allclose(got["turbulence"], ref["turbulence"], rtol=0, atol=1e-6)
        mp4 = os.path.join(root, "outputs", name, "vis", f"{case}.mp4")
        assert os.path.exists(mp4) == video, mp4


@pytest.fixture(scope="module")
def jax_runs(tmp_path_factory):
    """The JAX package's serial run of each project (video off)."""
    roots = {}
    for name, nus in (("MW", (0.05, 0.04, 0.03, 0.02)), ("MWC", NUS8)):
        root = str(tmp_path_factory.mktemp(f"jax_{name}"))
        make_cases_project(root, name=name, nus=nus)
        assert jax_run_batch(name, root=root, progress=False)["success"] == len(nus)
        roots[name] = root
    return roots


MODES = [
    ("serial", "MW", (0.05, 0.04, 0.03, 0.02), {}, True),
    ("lockstep", "MW", (0.05, 0.04, 0.03, 0.02), {"max_batch": 1}, False),
    ("sharded", "MWC", NUS8, {"max_batch": 4, "runner": "sharded", "n_devices": 2}, False),
]


@pytest.mark.parametrize("mode,name,nus,kw,video", MODES, ids=[m[0] for m in MODES])
def test_two_workers_split_one_project(tmp_path, jax_runs, mode, name, nus, kw, video):
    root, ref_root = str(tmp_path / "two"), str(tmp_path / "one")
    names = _project(root, name, nus, video)
    _project(ref_root, name, nus, video)
    outs = _two_workers(root, name, "serial" if mode == "serial" else "lockstep", kw)
    # the same project run by one worker of the same mode
    if mode == "serial":
        one = run_batch(name, root=ref_root, progress=False, device="cpu")
    else:
        one = run_batched(name, root=ref_root, progress=False, video=False, device="cpu", **kw)
    assert one["success"] == len(names)
    _check(root, name, names, mode, outs, ref_root, jax_runs[name], video)


def test_stale_claim_of_a_dead_worker_is_taken_over(tmp_path):
    """A worker that died holding a claim (same host, dead pid) leaves its
    case Running; the next --coordinate run takes the claim over and runs
    it."""
    import socket
    import time

    root = str(tmp_path)
    names = _project(root, "MW", (0.05, 0.04), False)
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    claims = os.path.join(root, "outputs", "MW", "plots", ".claims")
    os.makedirs(claims)
    with open(os.path.join(claims, names[0] + ".claim"), "w") as fh:
        json.dump({"worker": "dead", "host": socket.gethostname(), "pid": p.pid,
                   "claimed_at": time.time()}, fh)
    stats = run_batched("MW", root=root, progress=False, video=False, device="cpu",
                        coordinate=True, worker_id="next", max_batch=2)
    assert stats["success"] == 2, stats
    assert os.listdir(claims) == []
