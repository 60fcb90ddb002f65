"""The port's claim store (``pipeline/coordination.py``) against the JAX
package's: the claim cases of ``tests/test_multiworker.py`` as one
parametrised test, run on both stores with the same outcomes, and the
steal's check-then-rename race, which the JAX copy loses (two owners)
and the port's refuses."""

import json
import os
import socket
import subprocess
import sys
import time

import pytest

from lbm2d_tpu.pipeline.coordination import ClaimStore as JaxClaimStore
from lbm2d_tpu_torch.pipeline import coordination
from lbm2d_tpu_torch.pipeline.coordination import ClaimStore as PortClaimStore

STORES = {"jax": JaxClaimStore, "port": PortClaimStore}


def _claim_path(plots, name):
    return os.path.join(plots, ".claims", name + ".claim")


def _write_claim(plots, name, host, pid, age_s=0.0):
    os.makedirs(os.path.join(plots, ".claims"), exist_ok=True)
    path = _claim_path(plots, name)
    with open(path, "w") as fh:
        json.dump({"worker": "other", "host": host, "pid": pid,
                   "claimed_at": time.time()}, fh)
    if age_s:
        old = time.time() - age_s
        os.utime(path, (old, old))
    return path


def _reaped_pid():
    """A pid that existed and is now free."""
    p = subprocess.Popen([sys.executable, "-c", "pass"])
    p.wait()
    return p.pid


def excludes_other_workers(Store, plots):
    a, b = Store(plots, worker_id="A"), Store(plots, worker_id="B")
    out = [a.claim("case1.yaml"), a.claim("case1.yaml"), b.claim("case1.yaml"),
           b.claim("case2.yaml"), a.owned(), b.owned()]
    a.release("case1.yaml")
    out.append(b.claim("case1.yaml"))
    return out


def release_all_empties_dir(Store, plots):
    s = Store(plots, worker_id="W")
    out = [s.claim(f"c{i}.yaml") for i in range(3)]
    s.release_all()
    return out + [s.owned(), os.listdir(os.path.join(plots, ".claims"))]


def dead_same_host_claim_is_stolen(Store, plots):
    _write_claim(plots, "x.yaml", socket.gethostname(), _reaped_pid())
    alive = Store(plots, worker_id="alive")
    return [alive.claim("x.yaml"), alive.owned()]


def live_claim_is_not_stolen_without_timeout(Store, plots):
    mine, other = Store(plots, worker_id="mine"), Store(plots, worker_id="other")
    return [mine.claim("x.yaml"), other.claim("x.yaml"), other.owned()]


def stale_heartbeat_claim_is_stolen_with_timeout(Store, plots):
    owner = Store(plots, worker_id="owner")
    out = [owner.claim("x.yaml")]
    _write_claim(plots, "x.yaml", "elsewhere", 1, age_s=100.0)  # a foreign host
    out.append(Store(plots, worker_id="t1", stale_s=3600.0).claim("x.yaml"))
    out.append(Store(plots, worker_id="t2", stale_s=50.0).claim("x.yaml"))
    # a heartbeat protects an owned claim from the timeout
    owner2 = Store(plots, worker_id="o2")
    out.append(owner2.claim("y.yaml"))
    old = time.time() - 100.0
    os.utime(_claim_path(plots, "y.yaml"), (old, old))
    owner2.heartbeat()
    out.append(Store(plots, worker_id="t3", stale_s=50.0).claim("y.yaml"))
    return out


SCENARIOS = {
    excludes_other_workers: [True, True, False, True, ["case1.yaml"], ["case2.yaml"], True],
    release_all_empties_dir: [True, True, True, [], []],
    dead_same_host_claim_is_stolen: [True, ["x.yaml"]],
    live_claim_is_not_stolen_without_timeout: [True, False, []],
    stale_heartbeat_claim_is_stolen_with_timeout: [True, False, True, True, False],
}


@pytest.mark.parametrize("store", sorted(STORES))
@pytest.mark.parametrize("scenario", list(SCENARIOS), ids=lambda f: f.__name__)
def test_claim_store_outcomes(tmp_path, scenario, store):
    assert scenario(STORES[store], str(tmp_path)) == SCENARIOS[scenario]


def _race(Store, plots):
    """A stale claim; stealer B checks it (stale), then rival A steals it
    and re-creates a fresh claim, then B renames. Returns (A owns, B owns,
    the claim file's worker)."""
    _write_claim(plots, "x.yaml", "elsewhere", 1, age_s=100.0)
    a = Store(plots, worker_id="A", stale_s=50.0)
    b = Store(plots, worker_id="B", stale_s=50.0)
    real = b._is_stale
    calls = []

    def checked_then_raced(path):
        stale = real(path)
        if not calls:  # the rival acts between B's check and B's rename
            calls.append(path)
            assert a.claim("x.yaml")
        return stale

    b._is_stale = checked_then_raced
    b_owns = b.claim("x.yaml")
    with open(_claim_path(plots, "x.yaml")) as fh:
        holder = json.load(fh)["worker"]
    leftovers = [f for f in os.listdir(os.path.join(plots, ".claims")) if ".stale." in f]
    return "x.yaml" in a.owned(), b_owns, holder, leftovers


def test_steal_race_double_owns_in_the_jax_copy(tmp_path):
    a_owns, b_owns, holder, _ = _race(JaxClaimStore, str(tmp_path))
    assert a_owns and b_owns and holder == "B"  # two owners of one case


def test_steal_race_is_refused_in_the_port(tmp_path):
    a_owns, b_owns, holder, leftovers = _race(PortClaimStore, str(tmp_path))
    assert a_owns and not b_owns
    assert holder == "A"  # the fresh owner's file is in place
    assert leftovers == []


_STEALER = """
import sys, time
sys.path.insert(0, sys.argv[3])
from lbm2d_tpu_torch.pipeline.coordination import ClaimStore
s = ClaimStore(sys.argv[1], worker_id=sys.argv[2], stale_s=50.0)
while time.time() < float(sys.argv[4]):
    pass
print("WON" if s.claim("x.yaml") else "LOST", flush=True)
time.sleep(1.0)  # stay alive: a winner's claim must not look dead
"""


def test_concurrent_stealers_leave_one_owner(tmp_path):
    plots = str(tmp_path)
    _write_claim(plots, "x.yaml", "elsewhere", 1, age_s=100.0)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(coordination.__file__)))
    repo = os.path.dirname(repo)
    start = time.time() + 2.0
    procs = [subprocess.Popen([sys.executable, "-c", _STEALER, plots, f"w{i}", repo,
                               str(start)], stdout=subprocess.PIPE, text=True)
             for i in range(6)]
    outs = [p.communicate(timeout=60)[0].strip() for p in procs]
    assert sorted(outs).count("WON") == 1, outs
    assert [f for f in os.listdir(os.path.join(plots, ".claims"))] == ["x.yaml.claim"]
