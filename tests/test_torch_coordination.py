"""The port's claim store (``pipeline/coordination.py``) against the JAX
package's: the claim cases of ``tests/test_multiworker.py`` as one
parametrised test, run on both stores with the same outcomes; the
steal's check-then-rename race, which the JAX copy loses (two owners)
and the port's refuses; the give-back window that the JAX copy's repair
of that race opens (a third worker claims while the renamed claim is
away), which the port's steal lock closes; and six concurrent stealer
processes, of which exactly one wins."""

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
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

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


def _give_back_race(Store, plots):
    """As ``_race``, and then a third worker C claims between B's rename
    and B's second check, while the claim path is empty. A store that
    gives the renamed claim back by renaming it over the path replaces C's
    claim, and both A and C own the case. Returns (the workers that own
    the case, the claim file's worker, the files in ``.claims/``)."""
    _write_claim(plots, "x.yaml", "elsewhere", 1, age_s=100.0)
    stores = {w: Store(plots, worker_id=w, stale_s=50.0) for w in "ABC"}
    real = stores["B"]._is_stale
    calls = []

    def raced(path):
        calls.append(path)
        if len(calls) == 2:  # after B's rename in a store that renames first
            stores["C"].claim("x.yaml")
        stale = real(path)
        if len(calls) == 1:  # the rival acts between B's check and B's rename
            assert stores["A"].claim("x.yaml")
        return stale

    stores["B"]._is_stale = raced
    stores["B"].claim("x.yaml")
    with open(_claim_path(plots, "x.yaml")) as fh:
        holder = json.load(fh)["worker"]
    owners = sorted(w for w, s in stores.items() if "x.yaml" in s.owned())
    return owners, holder, sorted(os.listdir(os.path.join(plots, ".claims")))


def test_give_back_window_leaves_one_owner_in_the_port(tmp_path):
    owners, holder, files = _give_back_race(PortClaimStore, str(tmp_path))
    assert owners == [holder]  # one owner, and the claim file names it
    assert files == ["x.yaml.claim"]


def test_stalled_owner_is_told_when_the_give_back_fails_in_the_port(tmp_path):
    # A owns a claim whose heartbeat stalled past stale_s. Stealer B checks
    # it (stale); A's heartbeat lands; B renames it, and while the path is
    # empty a third worker C's first-time claim lands; B finds the renamed
    # claim fresh, cannot link it back over C's and removes the tombstone.
    # Under the stale_s policy C now owns the case: A's next heartbeat
    # drops it, and A's release leaves C's claim file alone.
    plots = str(tmp_path)
    stores = {w: PortClaimStore(plots, worker_id=w, stale_s=50.0) for w in "ABC"}
    assert stores["A"].claim("x.yaml")
    path = _claim_path(plots, "x.yaml")
    old = time.time() - 100.0
    os.utime(path, (old, old))
    real = stores["B"]._is_stale
    calls = []

    def raced(p):
        calls.append(p)
        if len(calls) == 3:  # B renamed: the path is empty
            assert stores["C"].claim("x.yaml")
        stale = real(p)
        if len(calls) == 2:  # B's check under the lock said stale
            assert stores["A"].heartbeat() == []
        return stale

    stores["B"]._is_stale = raced
    assert not stores["B"].claim("x.yaml")
    assert len(calls) == 3
    with open(path) as fh:
        assert json.load(fh)["worker"] == "C"
    assert stores["A"].heartbeat() == ["x.yaml"]
    owners = sorted(w for w, s in stores.items() if "x.yaml" in s.owned())
    assert owners == ["C"]
    stores["A"].release("x.yaml")
    with open(path) as fh:
        assert json.load(fh)["worker"] == "C"
    assert sorted(os.listdir(os.path.join(plots, ".claims"))) == ["x.yaml.claim"]


_STEALER = """
import os, sys, time
sys.path.insert(0, sys.argv[3])
from lbm2d_tpu_torch.pipeline.coordination import ClaimStore
plots, me, answered = sys.argv[1], sys.argv[2], sys.argv[5]
s = ClaimStore(plots, worker_id=me, stale_s=50.0)
while time.time() < float(sys.argv[4]):
    pass
print("WON" if s.claim("x.yaml") else "LOST", flush=True)
open(os.path.join(answered, me), "w").close()
# stay alive until all six have answered (30 s at most): a winner's claim
# must not look dead to a stealer that has not looked yet
end = time.time() + 30.0
while len(os.listdir(answered)) < 6 and time.time() < end:
    time.sleep(0.01)
"""


def test_concurrent_stealers_leave_one_owner(tmp_path):
    plots = str(tmp_path)
    answered = tmp_path / "answered"
    answered.mkdir()
    _write_claim(plots, "x.yaml", "elsewhere", 1, age_s=100.0)
    repo = os.path.dirname(os.path.dirname(os.path.abspath(coordination.__file__)))
    repo = os.path.dirname(repo)
    start = time.time() + 2.0
    procs = [subprocess.Popen([sys.executable, "-c", _STEALER, plots, f"w{i}", repo,
                               str(start), str(answered)], stdout=subprocess.PIPE, text=True)
             for i in range(6)]
    outs = [p.communicate(timeout=60)[0].strip() for p in procs]
    assert sorted(outs).count("WON") == 1, outs
    assert [f for f in os.listdir(os.path.join(plots, ".claims"))] == ["x.yaml.claim"]


def test_workers_building_the_npz_at_once_leave_a_whole_file(tmp_path):
    # --coordinate workers that finish together each build the project's
    # NPZ; the port writes a temporary file and renames it, so the path
    # always holds a whole archive (writing the path itself, one worker
    # truncated it while another wrote it)
    import threading

    import numpy as np

    from lbm2d_tpu_torch.io.vectors import build_npz

    summary = tmp_path / "all_cases_summary.json"
    summary.write_text(json.dumps([{"case_name": f"c{i}", "status": "Failed"}
                                   for i in range(200)]))
    out = str(tmp_path / "all_cases_vectors.npz")
    errors = []

    def build():
        try:
            for _ in range(10):
                build_npz(str(summary), out)
        except Exception as exc:  # noqa: BLE001 -- reported below
            errors.append(exc)

    threads = [threading.Thread(target=build) for _ in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors
    with np.load(out, allow_pickle=True) as z:
        assert len(z["case_names"]) == 200
    assert sorted(os.listdir(tmp_path)) == ["all_cases_summary.json", "all_cases_vectors.npz"]
