"""The port's FetchPacer and D2H probe (pipeline/fetch_pacer.py) against
the JAX package's, and grouped fetches in the port's lockstep loop.

The controller is plain Python in both packages: fed the same stall
sequence, the two must choose the same fetch group sizes chunk by chunk.
"""

import collections
import os
import threading
import time

import h5py
import numpy as np
import pytest

from lbm2d_tpu.pipeline.fetch_pacer import FetchPacer as JaxFetchPacer
from lbm2d_tpu_torch.pipeline.fetch_pacer import FetchPacer, probe_d2h_mbps
from test_fetch_pacer import FakeLink
from tests.test_multiworker import make_four_case_project
import torch_threads  # noqa: F401  (the test processes' torch thread budget)


def _stall_sequences():
    rng = np.random.default_rng(0)
    return {
        "slow-link": [(0.10, 0.25)] * 40 + [(0.10, 0.0)] * 60,
        "healthy": [(0.10, 0.002)] * 50,
        "borderline": [(0.10, float(s)) for s in rng.uniform(0.0, 0.05, 80)],
        "bursty": [(float(c), float(s)) for c, s in
                   zip(rng.uniform(0.05, 0.2, 120), rng.exponential(0.05, 120))],
    }


@pytest.mark.parametrize("name", sorted(_stall_sequences()))
@pytest.mark.parametrize("window, max_group", [(8, 8), (4, 2)], ids=["default", "small"])
def test_same_stalls_give_the_jax_group_sizes(name, window, max_group):
    ref = JaxFetchPacer(max_group=max_group, window=window)
    pacer = FetchPacer(max_group=max_group, window=window)
    for compute_s, stall_s in _stall_sequences()[name]:
        ref.record_chunk(compute_s, stall_s)
        pacer.record_chunk(compute_s, stall_s)
        assert pacer.group_size == ref.group_size
        assert pacer.should_fetch(3) == ref.should_fetch(3)
    assert pacer.stats() == ref.stats()


def test_fake_link_run_matches_jax():
    def link():
        return FakeLink(fixed_s=0.15, per_frame_s=0.02, chunk_s=0.10)

    util_ref, n_ref = link().run(JaxFetchPacer())
    pacer = FetchPacer()
    util, n = link().run(pacer)
    assert (util, n) == (util_ref, n_ref)
    assert pacer.group_size > 1 and util >= 0.75


def test_bad_thresholds_raise():
    with pytest.raises(ValueError):
        FetchPacer(stall_hi=0.1, stall_lo=0.2)


def test_cpu_probe_measures_a_host_copy():
    assert probe_d2h_mbps(nbytes=1 << 20, device="cpu") > 0


def _run_group(root, pacer):
    from lbm2d_tpu_torch.pipeline import paths
    from lbm2d_tpu_torch.pipeline.batch_datagen import run_lockstep_group
    from lbm2d_tpu_torch.utils.config import load_config

    names = make_four_case_project(root, name="FP")
    project_paths = paths.get_project_paths("FP", root=root)
    output_dirs = paths.setup_output_directories(project_paths["outputs"])
    members = [
        (n, load_config(os.path.join(project_paths["configs"], n))) for n in names[:2]
    ]
    entries = run_lockstep_group(
        members, project_paths, output_dirs, progress=False, video=False,
        pacer=pacer, device="cpu",
    )
    return entries, output_dirs


def test_grouped_fetch_byte_parity(tmp_path):
    frozen = FetchPacer(stall_hi=0.99, stall_lo=0.0)  # never adapts...
    frozen.group_size = 4  # ...but batches every 4 save events
    runs = {}
    for tag, pacer in (("plain", None), ("grouped", frozen)):
        root = str(tmp_path / tag)
        os.makedirs(root)
        entries, output_dirs = _run_group(root, pacer)
        assert all(e["status"] == "Success" for e in entries), entries
        runs[tag] = (entries, output_dirs)
    for entry in runs["plain"][0]:
        data = {}
        for tag, (_e, dirs) in runs.items():
            with h5py.File(os.path.join(dirs["raw"], entry["case_name"] + ".h5")) as f:
                data[tag] = {k: f[k][...].tobytes() for k in f.keys()}
        assert data["plain"] == data["grouped"], entry["case_name"]
    for tag, (entries, _d) in runs.items():
        tr = entries[0]["run_summary"]["transfer"]
        assert tr["link_d2h_mbps_pre"] > 0 and tr["link_d2h_mbps_post"] > 0
        assert tr["bytes_fetched"] > 0
    assert runs["grouped"][0][0]["run_summary"]["transfer"]["fetch_group_size_final"] == 4


def test_stall_calibration_from_chunks_without_a_fetch(tmp_path):
    # a host-paced loop (the H100's: its monitor waits ~0) whose save stage
    # keeps up charges no stall: the pacer sees only the loop's waits on the
    # stage, never the copies and writes the stage hides, and a pacer quick
    # to grow (a window of 2 chunks) keeps every save its own hand-off
    from lbm2d_tpu_torch.utils import profiling

    charged = []

    class HostPaced(FetchPacer):
        def record_chunk(self, compute_s, stall_s):
            time.sleep(0.02)  # the loop's own host work, longer than a write
            charged.append(stall_s)
            super().record_chunk(compute_s, stall_s)

    profiling.REGISTRY.reset()
    with profiling.REGISTRY.recording():
        entries, _ = _run_group(str(tmp_path), HostPaced(window=2))
    spans = profiling.REGISTRY.snapshot(reset=True)
    assert all(e["status"] == "Success" for e in entries), entries
    assert charged == [0.0] * 6
    assert not any(s.name == "loop.fetch_join" for s in spans)
    handed = sorted(s.chunk[1] for s in spans
                    if s.name == "loop.fetch_start" and "behind" in s.attrs)
    assert handed == [2, 3, 4, 5, 6]
    tr = entries[0]["run_summary"]["transfer"]
    assert tr["fetch_group_size_final"] == 1 and tr["fetch_stall_fraction"] == 0.0


def test_loop_charges_its_waits_on_the_save_stage_as_stall(tmp_path, monkeypatch):
    # the save worker takes the first save and writes nothing until a
    # release finds the stage's queue full, then 50 ms a frame: the loop's
    # waits are the pacer's stall, and nothing else
    from lbm2d_tpu_torch.io.h5_writer import AsyncLBMCaseWriter
    from lbm2d_tpu_torch.pipeline.save_stage import HELD, SaveStage
    from lbm2d_tpu_torch.utils import profiling

    charged = []

    class Spy(FetchPacer):
        def record_chunk(self, compute_s, stall_s):
            charged.append(stall_s)
            super().record_chunk(compute_s, stall_s)

    gate, entered = threading.Event(), threading.Event()
    release, append = SaveStage.release, AsyncLBMCaseWriter.append

    def gated_release(self):
        if self.held and not gate.is_set():
            assert entered.wait(30)  # the worker has taken the first save
        if self.held > HELD:
            gate.set()
        return release(self)

    def held_append(self, moments, pre_resized=False):
        entered.set()
        assert gate.wait(30)
        time.sleep(0.05)
        return append(self, moments, pre_resized)

    monkeypatch.setattr(SaveStage, "release", gated_release)
    monkeypatch.setattr(AsyncLBMCaseWriter, "append", held_append)
    root = str(tmp_path)
    profiling.REGISTRY.reset()
    with profiling.REGISTRY.recording():
        entries, _ = _run_group(root, Spy(stall_hi=0.99, stall_lo=0.0))
    spans = profiling.REGISTRY.snapshot(reset=True)
    assert all(e["status"] == "Success" for e in entries), entries
    joins = collections.Counter()  # a chunk's waits: its release, and the last's own
    for s in spans:
        if s.name == "loop.fetch_join":
            joins[s.chunk[1]] += s.seconds
    assert joins and len(charged) == 6
    stalled = {k + 1: s for k, s in enumerate(charged) if s > 0}
    assert sorted(stalled) == sorted(joins)
    for k, s in stalled.items():
        assert joins[k] <= s < joins[k] + 5e-3, (k, s, joins[k])
