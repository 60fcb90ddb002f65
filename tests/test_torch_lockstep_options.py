"""The port's lockstep options against the port's own runs, on the CPU:
the lockstep artifacts equal the serial path's, and each transport option
(--device_resize, --f16_transfer, --fetch_at_idle, --yuv_video) keeps the
artifacts within the JAX package's own tolerances for it
(tests/test_batch_datagen.py), or within f16's own rounding for
--f16_transfer; the group checkpoint resumes.

Every run here is compared with one default lockstep run of the same
two-case project (``reference``), made once for the module.
"""

import collections
import hashlib
import json
import os
import threading

import h5py
import numpy as np
import pytest
import yaml

from lbm2d_tpu_torch.io.h5_writer import AsyncLBMCaseWriter
from lbm2d_tpu_torch.io.video import VideoRecorder
from lbm2d_tpu_torch.parallel.batch import BatchEngine
from lbm2d_tpu_torch.pipeline import batch_datagen, paths
from lbm2d_tpu_torch.pipeline.batch_datagen import run_batched
from lbm2d_tpu_torch.pipeline.batch_run import run_batch
from lbm2d_tpu_torch.pipeline.save_stage import HELD, SaveStage
from lbm2d_tpu_torch.utils import profiling
from lbm2d_tpu_torch.utils.masks import create_mask
from test_batch_datagen import make_two_case_project
from test_pipeline_e2e import make_project
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

PROJECT = "LockProj"
CASES = ("mask_00_Nu0-0500", "mask_00_Nu0-0300")


def _h5(root, case, name=PROJECT):
    with h5py.File(os.path.join(root, "outputs", name, "raw", f"{case}.h5"), "r") as f:
        return {k: f[k][()] for k in f}


def _run(tmp_path_factory, tag, lockstep=True, **flags):
    root = str(tmp_path_factory.mktemp(tag))
    make_two_case_project(root)
    stats = run_batch(PROJECT, root=root, progress=False, lockstep=lockstep, device="cpu",
                      **flags)
    assert stats["success"] == 2, stats
    return root


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return _run(tmp_path_factory, "reference")


def test_lockstep_equals_the_ports_serial_path(reference, tmp_path_factory):
    serial = _run(tmp_path_factory, "serial", lockstep=False)
    for case in CASES:
        ds, dl = _h5(serial, case), _h5(reference, case)
        assert sorted(ds) == sorted(dl)
        for k in ds:
            np.testing.assert_array_equal(dl[k], ds[k], err_msg=k)


def test_device_resize_matches_host_path(reference, tmp_path_factory):
    dev = _run(tmp_path_factory, "resize", device_resize=True)
    for case in CASES:
        ta, tb = _h5(reference, case)["turbulence"], _h5(dev, case)["turbulence"]
        assert ta.shape == tb.shape
        np.testing.assert_allclose(tb, ta, atol=5e-5)


def test_f16_transfer_quantizes_but_matches(reference, tmp_path_factory):
    f16 = _run(tmp_path_factory, "f16", f16_transfer=True)
    for case in CASES:
        ta, tb = _h5(reference, case)["turbulence"], _h5(f16, case)["turbulence"]
        assert tb.dtype == np.float32
        # f16 rounds to within half an ulp, 2**-11 relative (4.9e-4), down to
        # its smallest subnormal step 2**-24 in absolute terms; read on the
        # CPU: at most 4.6e-4 relative, and 2e-8 beyond 2**-11 |ref| (PERF.md)
        np.testing.assert_allclose(tb, ta, rtol=1e-3, atol=2.0**-24)
        assert not np.array_equal(ta, tb)


def test_fetch_at_idle_matches_overlapped(reference, tmp_path_factory):
    idle = _run(tmp_path_factory, "idle", fetch_overlap=False)
    for case in CASES:
        da, db = _h5(reference, case), _h5(idle, case)
        for ds in ("turbulence", "mean_vel_field", "sum_vor"):
            np.testing.assert_array_equal(db[ds], da[ds])


def _video_project(root):
    """The two-case project with its video on (a frame every 20 steps)."""
    make_two_case_project(root)
    cfg_dir = os.path.join(root, "SimCases", PROJECT, "configs")
    for fname in os.listdir(cfg_dir):
        path = os.path.join(cfg_dir, fname)
        with open(path) as fh:
            cfg = yaml.safe_load(fh)
        cfg["outputs"]["video"]["enable"] = True
        with open(path, "w") as fh:
            yaml.safe_dump(cfg, fh, sort_keys=False)


def _fed_run(root, monkeypatch, hold=False, **flags):
    """run_batch on ``root``; with ``hold`` the save worker takes the first
    save and writes nothing until a release finds the stage's queue full.
    Returns the run's stats and the frames each recorder was fed, in
    order."""
    fed = collections.defaultdict(list)
    gate, entered = threading.Event(), threading.Event()
    if not hold:
        gate.set()
    release, write_u8, append = (SaveStage.release, VideoRecorder.write_frame_u8,
                                 AsyncLBMCaseWriter.append)

    def gated_release(self):
        if self.held and not gate.is_set():
            assert entered.wait(30)  # the worker has taken the first save
        if self.held > HELD:
            gate.set()  # this release waits for the worker: let it write
        return release(self)

    def held_write_u8(self, img8):
        entered.set()
        assert gate.wait(30)
        fed[os.path.basename(self.filename)].append(np.asarray(img8).tobytes())
        return write_u8(self, img8)

    def held_append(self, moments, pre_resized=False):
        entered.set()
        assert gate.wait(30)
        return append(self, moments, pre_resized)

    with monkeypatch.context() as m:
        m.setattr(SaveStage, "release", gated_release)
        m.setattr(VideoRecorder, "write_frame_u8", held_write_u8)
        m.setattr(AsyncLBMCaseWriter, "append", held_append)
        stats = run_batch(PROJECT, root=root, progress=False, lockstep=True, device="cpu",
                          **flags)
    return stats, dict(fed)


def test_slow_save_stage_keeps_every_frame_once_in_order(reference, tmp_path, monkeypatch):
    # saves at chunks 2-6, video at 2, 4, 6; the save worker holds the first
    # save until a release finds the stage's queue full (HELD saves waiting)
    runs = {}
    for tag, hold, overlap in (("slow", True, True), ("idle", False, False)):
        root = str(tmp_path / tag)
        _video_project(root)
        profiling.REGISTRY.reset()
        with profiling.REGISTRY.recording():
            stats, fed = _fed_run(root, monkeypatch, hold, fetch_overlap=overlap)
        assert stats["success"] == 2, stats
        runs[tag] = (root, fed, profiling.REGISTRY.snapshot(reset=True))
    (slow, fed, spans), (_, fed_idle, _) = runs["slow"], runs["idle"]
    assert sorted(fed) == sorted(f"{c}.mp4" for c in CASES)
    assert fed == fed_idle and all(len(v) == 3 for v in fed.values())
    for case in CASES:
        da, db = _h5(reference, case), _h5(slow, case)
        assert sorted(da) == sorted(db)
        for k in da:
            np.testing.assert_array_equal(db[k], da[k], err_msg=k)
    # behind counts the hand-offs not yet written; the loop waits only at a
    # release that finds more than HELD of them: the last chunk's, which
    # releases its own hand-off at once
    handed = {s.chunk[1]: s.attrs["behind"] for s in spans
              if s.name == "loop.fetch_start" and "behind" in s.attrs}
    assert handed == {k: k - 2 for k in range(2, 7)}
    joins = [s.chunk[1] for s in spans if s.name == "loop.fetch_join"]
    assert joins and joins == [k for k in sorted(handed) if handed[k] > HELD], (joins, handed)


def test_case_failing_mid_group_writes_nothing_from_its_failing_chunk(tmp_path, monkeypatch):
    root = str(tmp_path)
    _video_project(root)
    calls = collections.Counter()
    sync = BatchEngine.sync_monitors

    def sync_monitors(self, packed):
        # the group's second case breaks at its fourth chunk (step 40)
        out = sync(self, packed)
        calls[id(self)] += 1
        if calls[id(self)] >= 4:
            out["stable"][1] = False
            self._alive_np[1] = False
        return out

    appended = collections.defaultdict(list)
    append = AsyncLBMCaseWriter.append

    def spy_append(self, moments, pre_resized=False):
        appended[os.path.basename(self.writer.file_path)].append(profiling.current_chunk()[1])
        return append(self, moments, pre_resized)

    monkeypatch.setattr(BatchEngine, "sync_monitors", sync_monitors)
    monkeypatch.setattr(AsyncLBMCaseWriter, "append", spy_append)
    profiling.REGISTRY.reset()
    with profiling.REGISTRY.recording():
        stats = run_batch(PROJECT, root=root, progress=False, lockstep=True, device="cpu")
    profiling.REGISTRY.reset()
    assert stats["success"] == 1 and stats["failed"] == 1, stats
    with open(os.path.join(root, "outputs", PROJECT, "plots", "sim_results.json")) as fh:
        status = {e["config_filename"]: e["status"] for e in json.load(fh)}
    names = sorted(status)
    assert status[names[0]] == "Success" and status[names[1]] == "Failed"
    ok, bad = (n.replace("_cfg", "").replace(".yaml", "") for n in names)
    # saves from chunk 2: the failed case's frames stop before chunk 4
    assert appended[ok + ".h5"] == [2, 3, 4, 5, 6]
    assert appended[bad + ".h5"] == [2, 3]
    out = os.path.join(root, "outputs", PROJECT)
    for case, kept in ((ok, True), (bad, False)):
        for path in (os.path.join(out, "raw", case + ".h5"), os.path.join(out, "vis", case + ".mp4")):
            assert os.path.exists(path) == kept, path


def test_serial_device_resize_matches_host_path(tmp_path):
    runs = {}
    for tag, resize in (("host", False), ("dev", True)):
        root = str(tmp_path / tag)
        os.makedirs(root)
        make_project(root, name="SR")
        assert run_batch("SR", root=root, progress=False, device_resize=resize,
                         device="cpu")["success"] == 1
        runs[tag] = root
    ta = _h5(runs["host"], "mask_00_Nu0-0500", "SR")["turbulence"]
    tb = _h5(runs["dev"], "mask_00_Nu0-0500", "SR")["turbulence"]
    np.testing.assert_allclose(tb, ta, atol=5e-5)
    vis = os.path.join(runs["dev"], "outputs", "SR", "vis", "mask_00_Nu0-0500.mp4")
    assert os.path.getsize(vis) > 0


def test_yuv_video_matches_rgb_video(tmp_path):
    import cv2

    runs = {}
    for tag, yuv in (("rgb", False), ("yuv", True)):
        root = str(tmp_path / tag)
        os.makedirs(root)
        make_project(root, name="V")
        run_batched("V", max_batch=4, root=root, progress=False, yuv_video=yuv, device="cpu")
        runs[tag] = os.path.join(root, "outputs", "V", "vis", "mask_00_Nu0-0500.mp4")

    def decode(path):
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame.astype(np.int32))
        cap.release()
        return frames

    fa, fb = decode(runs["rgb"]), decode(runs["yuv"])
    assert len(fa) == len(fb) == 3  # steps 20, 40, 60
    for a, b in zip(fa, fb):
        assert a.shape == b.shape and np.mean(np.abs(a - b)) < 3.0


def test_group_checkpoint_resume(tmp_path, capsys):
    root = str(tmp_path)
    make_two_case_project(root, name="CK")
    project_paths = paths.get_project_paths("CK", root=root)
    output_dirs = paths.setup_output_directories(project_paths["outputs"])
    members = []
    for fname in sorted(os.listdir(project_paths["configs"])):
        with open(os.path.join(project_paths["configs"], fname)) as fh:
            cfg = yaml.safe_load(fh)
        cfg["outputs"]["dataset"]["enable"] = False
        cfg["outputs"]["checkpoint"] = {"enable": True, "interval_steps": 40, "resume": True}
        members.append((fname, cfg))
    run = batch_datagen.run_lockstep_group
    ref = run(members, project_paths, output_dirs, progress=False, device="cpu")

    # the snapshot a crash after step 40 leaves, written as the loop writes it
    masks = [
        create_mask(c, os.path.join(project_paths["masks"], os.path.basename(c["mask"]["path"])))
        .astype(np.float32) for _, c in members
    ]
    eng = BatchEngine([c for _, c in members], masks, device="cpu")
    for _ in range(4):
        eng.run_step(10)
    gid = hashlib.sha1("|".join(f for f, _ in members).encode()).hexdigest()[:12]
    ckpt = os.path.join(output_dirs["raw"], f".lockstep_ckpt_{gid}.npz")
    st = eng.state
    np.savez(ckpt, f=st.f.numpy(), f_post=st.f_post.numpy(), rho=st.rho.numpy(),
             u=st.u.numpy(), step=st.step.numpy(), alive=eng.alive_mask, steps=40,
             n_cases=len(members))

    capsys.readouterr()
    resumed = run(members, project_paths, output_dirs, progress=False, device="cpu")
    assert "group resumed at step 40" in capsys.readouterr().out
    for a, b in zip(resumed, ref):
        assert a["parameters"]["lattice_inputs"] == b["parameters"]["lattice_inputs"]
        assert (a["parameters"]["simulation_outputs"]["total_steps_executed"]
                == b["parameters"]["simulation_outputs"]["total_steps_executed"] == 60)
    assert not os.path.exists(ckpt), "a completed group removes its checkpoint"
