"""The port's spans (``lbm2d_tpu_torch/utils/profiling.py``)
and where the program records them: the lockstep loop, the group program,
the fetch worker and the HDF5 writers, the serial engine and the DFG
validation. All on the CPU."""

import collections
import json
import os
import re
import threading

import pytest
import torch
import torch.autograd.profiler as autograd_profiler
import yaml

from lbm2d_tpu_torch.pipeline.batch_datagen import PROFILE_KEYS, profile_line
from lbm2d_tpu_torch.pipeline.batch_run import run_batch
from lbm2d_tpu_torch.pipeline.save_stage import HELD
from lbm2d_tpu_torch.utils import profiling
from lbm2d_tpu_torch.utils.profiling import Registry
from test_batch_datagen import make_two_case_project
from test_pipeline_e2e import make_project
import torch_threads  # noqa: F401  (the test processes' torch thread budget)


@pytest.fixture
def registry():
    """The program's registry, emptied before and after the test."""
    profiling.REGISTRY.reset()
    yield profiling.REGISTRY
    profiling.REGISTRY.reset()


def _by_name(spans):
    out = collections.defaultdict(list)
    for s in spans:
        out[s.name].append(s)
    return out


def test_span_off_records_nothing_and_enters_no_record_function(registry, monkeypatch):
    entered = []
    monkeypatch.setattr(autograd_profiler, "record_function",
                        lambda name: entered.append(name))
    assert not autograd_profiler._is_profiler_enabled and not registry.on()
    site = profiling.span("loop.chunk", chunk=("g", 1))
    assert site is profiling.span("loop.write")  # one shared object: no record made
    with site as sp:
        assert sp is site
        sp.set(bytes=8)
        assert profiling.current_chunk() is None
    assert entered == [] and registry.snapshot() == [] and registry.mark() == 0


def _profiled_spans(registry):
    """(registry spans by name, annotations by name) of six chunks of two
    nested spans under a CPU profiler."""
    registry.reset()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        for i in range(6):
            with profiling.span("loop.chunk", chunk=("g", i)):
                with profiling.span("loop.write"):
                    torch.ones(64, 64).sum()
    assert not registry.on()
    annotations = collections.defaultdict(list)
    for e in prof.profiler.kineto_results.events():
        if e.is_user_annotation():
            annotations[e.name()].append((e.start_ns(), e.start_ns() + e.duration_ns()))
    return _by_name(registry.snapshot()), annotations


def test_spans_are_user_annotations_of_their_names(registry):
    offsets = []
    for _ in range(3):  # a busy host may preempt the thread between two stamps
        spans, annotations = _profiled_spans(registry)
        assert sorted(spans) == sorted(annotations) == ["loop.chunk", "loop.write"]
        worst = 0
        for name, recs in spans.items():
            assert len(recs) == len(annotations[name]) == 6
            assert all(r.whole for r in recs)
            # matched in order; the first range of each name under a
            # profiler pays the profiler's set-up inside record_function
            pairs = list(zip(sorted(recs, key=lambda s: s.t0), sorted(annotations[name])))[1:]
            for rec, (a0, a1) in pairs:
                worst = max(worst, abs((rec.t1 - rec.t0) - (a1 - a0)))
        offsets.append(worst)
        if worst < 50_000:
            break
    assert min(offsets) < 50_000, offsets
    # the nesting holds on the profiler's clock too: each write inside its chunk
    for (c0, c1), (w0, w1) in zip(sorted(annotations["loop.chunk"]),
                                  sorted(annotations["loop.write"])):
        assert c0 <= w0 <= w1 <= c1


def test_profiler_stopped_inside_a_span_leaves_it_not_whole(registry):
    prof = torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU])
    with profiling.span("loop.chunk", chunk=("g", 1)):  # before the profiler: not recorded
        prof.start()
    with profiling.span("loop.chunk", chunk=("g", 2)):
        pass
    with profiling.span("loop.chunk", chunk=("g", 3)):
        prof.stop()
    with profiling.span("loop.chunk", chunk=("g", 4)):  # after it: not recorded
        pass
    spans = registry.snapshot()
    assert [(s.chunk, s.whole) for s in spans] == [(("g", 2), True), (("g", 3), False)]


def test_parents_chunks_and_threads(registry):
    seen = {}

    def worker(chunk):
        with profiling.span("fetch.d2h", chunk=chunk) as sp:
            sp.set(bytes=123)
            sp.took(0.25)  # timed elsewhere (a device copy)
        seen["thread"] = threading.get_ident()

    with registry.recording():
        with profiling.span("loop.chunk", chunk=("g", 7)):
            with profiling.span("loop.write"):
                with profiling.span("loop.write.h5"):
                    assert profiling.current_chunk() == ("g", 7)
            t = threading.Thread(target=worker, args=(profiling.current_chunk(),))
            t.start()
            t.join(timeout=30)
        assert not t.is_alive()
        with profiling.span("loop.queue"):
            pass
    spans = {s.name: s for s in registry.snapshot()}
    chunk, write, h5 = spans["loop.chunk"], spans["loop.write"], spans["loop.write.h5"]
    assert chunk.parent is None and write.parent == chunk.id and h5.parent == write.id
    assert chunk.chunk == write.chunk == h5.chunk == ("g", 7)
    d2h = spans["fetch.d2h"]
    assert d2h.chunk == ("g", 7) and d2h.parent is None and d2h.attrs == {"bytes": 123}
    assert d2h.thread == seen["thread"] != chunk.thread
    assert d2h.t1 - d2h.t0 == 250_000_000  # the length ``took`` gave it
    assert spans["loop.queue"].chunk is None and spans["loop.queue"].parent is None
    assert chunk.t0 <= write.t0 <= h5.t0 <= h5.t1 <= write.t1 <= chunk.t1


def test_registry_keeps_the_newest_and_counts_the_dropped():
    reg = Registry(capacity=4, always=True)
    for i in range(3):
        with reg.span("a", chunk=i):
            pass
    mark = reg.mark()
    for i in range(3, 10):
        with reg.span("b" if i % 2 else "a", chunk=i):
            pass
    held = reg.snapshot()
    assert [s.chunk for s in held] == [6, 7, 8, 9] and reg.dropped == 6
    assert [s.chunk for s in reg.since(mark)] == [6, 7, 8, 9]  # 3-5 no longer held
    assert [s.chunk for s in reg.since(reg.mark() - 2)] == [8, 9]
    assert reg.last["a"].chunk == 8 and reg.last["b"].chunk == 9
    assert reg.snapshot(reset=True) == held and reg.snapshot() == [] and reg.dropped == 0


def test_phase_timer_is_the_registrys_per_name_totals():
    t = profiling.PhaseTimer()
    with t.phase("step"):
        sum(range(10000))
    with t.phase("io"):
        pass
    spans = t.registry.snapshot()
    assert t.totals == {"step": spans[0].seconds, "io": spans[1].seconds}
    assert not profiling.REGISTRY.snapshot()  # its own registry, not the program's


def _two_case_root(root, **sim):
    make_two_case_project(root)
    cfg_dir = os.path.join(root, "SimCases", "LockProj", "configs")
    for fname in os.listdir(cfg_dir):
        path = os.path.join(cfg_dir, fname)
        with open(path) as fh:
            cfg = yaml.safe_load(fh)
        cfg["simulation"].update(sim)
        cfg["outputs"]["enable_profiling"] = True
        with open(path, "w") as fh:
            yaml.safe_dump(cfg, fh, sort_keys=False)


def test_lockstep_group_records_a_span_tree_a_chunk(tmp_path, registry):
    root = str(tmp_path)
    make_two_case_project(root)  # 6 chunks of 10 steps, a save every chunk from step 20
    with registry.recording():
        stats = run_batch("LockProj", root=root, progress=False, lockstep=True, device="cpu")
    assert stats["success"] == 2
    with open(os.path.join(root, "outputs", "LockProj", "plots", "sim_results.json")) as fh:
        transfer = json.load(fh)[0]["run_summary"]["transfer"]
    uid = transfer["group_uid"]
    spans = registry.snapshot()
    chunks = {s.chunk: s for s in spans if s.name == "loop.chunk"}
    assert sorted(chunks) == [(uid, k) for k in range(1, 7)]
    assert all(s.whole for s in spans)
    per = collections.defaultdict(collections.Counter)
    first = collections.defaultdict(dict)
    for s in spans:
        per[s.chunk][s.name] += 1
        first[s.chunk].setdefault(s.name, s)
    for cid in chunks:
        assert per[cid]["program.issue"] == per[cid]["loop.monitor_wait"] == 1, cid
        assert per[cid]["loop.queue"] == per[cid]["loop.fetch_start"] == 1, cid
        # the save producers are queued before the wait on the chunk's monitors
        assert first[cid]["loop.queue"].t1 <= first[cid]["loop.monitor_wait"].t0, cid
    # each save is handed off in the chunk that queued it (saves start at
    # step 20); its copy and its write carry that chunk's id, the copy
    # taken after the chunk began and before the write
    saving = {(uid, k) for k in range(2, 7)}
    d2h = {s.chunk: s for s in spans if s.name == "fetch.d2h"}
    assert set(d2h) == saving
    handed = {s.chunk: s.attrs["behind"] for s in spans
              if s.name == "loop.fetch_start" and "behind" in s.attrs}
    assert set(handed) == saving and all(0 <= b <= HELD + 1 for b in handed.values())
    writes = [s for s in spans if s.name == "loop.write"]
    assert {s.chunk for s in writes} == saving and len(writes) == len(saving)
    for w in writes:
        assert chunks[w.chunk].t0 <= d2h[w.chunk].t0 <= d2h[w.chunk].t1 <= w.t0, w
    assert {s.chunk for s in spans if s.name == "loop.write.h5"} == saving
    main = chunks[(uid, 1)].thread
    worker = {s.thread for s in writes}
    assert len(worker) == 1 and main not in worker  # one save worker a group
    for s in spans:
        if s.name in ("fetch.d2h", "loop.write") and s.chunk in chunks:
            assert s.thread in worker and s.parent is None, s
        elif s.name == "loop.write.h5":
            assert s.thread in worker and s.parent is not None, s
        elif s.name == "h5.append":
            assert s.thread != main and s.thread not in worker and s.parent is None, s
        elif s.name != "loop.chunk" and s.chunk in chunks:
            assert s.thread == main and s.parent is not None, s
    # each save: one HDF5 append a case, on the writers' threads
    assert sum(s.name == "h5.append" for s in spans) == 2 * len(saving)
    # the bytes loop.fetch_mbps reads are those the transfer record counts
    assert sum(s.attrs["bytes"] for s in spans if s.name == "fetch.d2h") == \
        transfer["bytes_fetched"] > 0


def test_enable_profiling_progress_line_keeps_its_keys(tmp_path, capsys):
    root = str(tmp_path)
    _two_case_root(root, compute_step_size=1, max_steps=50)
    assert run_batch("LockProj", root=root, progress=True, lockstep=True,
                     device="cpu")["success"] == 2
    out = capsys.readouterr().out
    lines = [l for l in out.splitlines() if "[lockstep x2]" in l]
    assert len(lines) == 1, out
    m = re.search(r"50/50 \(100%\) \| per-chunk ms: dispatch=(\d+) write=(\d+) "
                  r"monitor=(\d+) queue=(\d+) fetch=(\d+)$", lines[0])
    assert m, lines[0]
    assert [k for k, _ in PROFILE_KEYS] == ["dispatch", "write", "monitor", "queue", "fetch"]
    assert not profiling.REGISTRY.on()  # recording ends with the group


def test_profile_line_sums_the_spans_of_each_key():
    reg = Registry(always=True)
    for name in ("program.issue", "loop.fetch_join", "loop.write", "loop.write", "loop.queue",
                 "loop.render", "loop.monitor_wait", "loop.fetch_start", "fetch.d2h"):
        with reg.span(name):
            pass
    spans = reg.snapshot()
    for s in spans:
        s.t1 = s.t0 + 10_000_000  # 10 ms each
    # loop.render lies inside loop.queue: "queue" does not add it again
    assert profile_line(spans, 2) == "dispatch=5 write=15 monitor=5 queue=5 fetch=5"


def test_serial_profile_line_reads_the_newest_spans(tmp_path, capsys):
    root = str(tmp_path)
    make_project(root, name="SP")
    path = os.path.join(root, "SimCases", "SP", "configs", "mask_00_cfg_Nu0-0500.yaml")
    with open(path) as fh:
        cfg = yaml.safe_load(fh)
    cfg["simulation"]["max_steps"] = 100
    cfg["outputs"]["enable_profiling"] = True
    cfg["outputs"]["video"]["enable"] = False
    with open(path, "w") as fh:
        yaml.safe_dump(cfg, fh, sort_keys=False)
    assert run_batch("SP", root=root, progress=False, device="cpu")["success"] == 1
    line = [l for l in capsys.readouterr().out.splitlines() if l.startswith("[Profile]")]
    assert len(line) == 1
    m = re.fullmatch(r"\[Profile\] step 100 compute=([\d.]+)ms \((\d+) MLUPS\) "
                     r"viz=([\d.]+)ms h5=([\d.]+)ms", line[0])
    assert m and float(m[1]) > 0 and float(m[4]) > 0, line


def test_dfg_validation_reads_back_twice_a_chunk(registry):
    from lbm2d_tpu_torch.analysis.dfg_validation import run_validation

    with registry.recording():
        run_validation(mode="dfg", obstacle="bounce_back_bouzidi", inlet="nebb", re=100,
                       u_target=0.1, ny=45, nx_cap=120, steps=200, chunk=50,
                       progress=False, device="cpu")
    spans = registry.snapshot()
    chunks = [s.chunk for s in spans if s.name == "serial.chunk"]
    assert chunks == [1, 2, 3, 4]
    for c in chunks:
        mine = [s for s in spans if s.chunk == c]
        assert [s.name for s in sorted(mine, key=lambda s: s.t0)] == [
            "serial.chunk", "serial.issue", "serial.readback", "serial.readback"]
    assert sum(s.name == "serial.readback" for s in spans) == 8
