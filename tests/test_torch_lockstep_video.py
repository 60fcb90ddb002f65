"""The lockstep loop's video path on a tiny group, on the CPU: each saving
chunk's frames are rendered inside ``loop.queue``, right behind the chunk
and before its monitor wait; a renderer wrapped as the benchmark's probe
wraps it keeps, after a chunk's ``run_step``, that chunk's frame; each
cv2 recorder (the card's backend) converts the I420 planes and draws the
zones on its own thread,
and the HDF5 and mp4 files are those of the synchronous conversion on the
save worker (the loop's earlier path), byte for byte.

The two-case project of tests/test_batch_datagen.py with its video on
(a frame at steps 20, 40, 60: chunks 2, 4 and 6 of 10 steps), the zone
overlay on, in YUV 4:2:0.
"""

import hashlib
import os

import h5py
import numpy as np
import pytest
import torch
import yaml

from lbm2d_tpu_torch.io.video import VideoRecorder, i420_to_rgb
from lbm2d_tpu_torch.ops import render as render_mod
from lbm2d_tpu_torch.parallel.batch import BatchEngine
from lbm2d_tpu_torch.pipeline.batch_run import run_batch
from lbm2d_tpu_torch.utils import profiling
from lbm2d_tpu_torch.viz.frames import calc_gui_size, draw_zone_overlay
from test_batch_datagen import make_two_case_project
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

PROJECT = "LockProj"
SAMPLE = 4  # a saving chunk; chunk 3 saves no frame
FLAGS = dict(lockstep=True, device="cpu", device_resize=True, yuv_video=True, progress=False)


def _project(root):
    make_two_case_project(root)
    cfg_dir = os.path.join(root, "SimCases", PROJECT, "configs")
    for fname in os.listdir(cfg_dir):
        path = os.path.join(cfg_dir, fname)
        with open(path) as fh:
            cfg = yaml.safe_load(fh)
        cfg["outputs"]["video"]["enable"] = True
        assert cfg["outputs"]["gui"]["show_zone_overlay"]
        with open(path, "w") as fh:
            yaml.safe_dump(cfg, fh, sort_keys=False)


def _outputs(root):
    """{h5 file: {dataset: array}}, {mp4 file: sha256}."""
    out = os.path.join(root, "outputs", PROJECT)
    h5 = {}
    for f in sorted(os.listdir(os.path.join(out, "raw"))):
        with h5py.File(os.path.join(out, "raw", f), "r") as fh:
            h5[f] = {k: fh[k][()] for k in fh}
    vid = {}
    for f in sorted(os.listdir(os.path.join(out, "vis"))):
        with open(os.path.join(out, "vis", f), "rb") as fh:
            vid[f] = hashlib.sha256(fh.read()).hexdigest()
    return h5, vid


def _sync_i420(self, y8, uv8):
    """The earlier path: the save worker converts the planes and draws the
    recorder's zones itself, then hands the recorder the flipped RGB frame
    to encode."""
    frame = draw_zone_overlay(i420_to_rgb(np.asarray(y8), np.asarray(uv8)), self.zones)
    self._emit(frame[: self.rec_height, : self.rec_width][::-1])


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The group run as it is (spans recorded, the probe wrapping the engine
    and the renderer) and with the earlier synchronous conversion."""
    mp = pytest.MonkeyPatch()
    probe = {"chunk": 0, "next": False, "renders": 0}
    run_step, make = BatchEngine.run_step, render_mod.make_device_frame_renderer

    def probed_run_step(engine, n=1, sync=True):
        out = run_step(engine, n, sync)
        probe["chunk"] += 1
        if probe["chunk"] in (SAMPLE - 1, SAMPLE):
            part = engine.parts[0]
            probe[probe["chunk"]] = (part.velocity().clone(), part.mask.clone())
            probe["next"] = probe["chunk"] == SAMPLE
        return out

    def make_renderer(*a, **kw):
        render = make(*a, **kw)

        def wrapped(u, mask):
            out = render(u, mask)
            probe["renders"] += 1
            if probe["next"]:
                probe["next"] = False
                probe["kept"] = tuple(t.clone() for t in out)
            return out

        return wrapped

    out = {}
    try:
        mp.setenv("LBM2D_NO_NATIVE", "1")  # the cv2 backend, the card's
        root = str(tmp_path_factory.mktemp("queued"))
        _project(root)
        mp.setattr(BatchEngine, "run_step", probed_run_step)
        mp.setattr(render_mod, "make_device_frame_renderer", make_renderer)
        profiling.REGISTRY.reset()
        with profiling.REGISTRY.recording():
            assert run_batch(PROJECT, root=root, **FLAGS)["success"] == 2
        out["queued"] = (root, profiling.REGISTRY.snapshot(reset=True), dict(probe))
        mp.undo()
        mp.setenv("LBM2D_NO_NATIVE", "1")
        root = str(tmp_path_factory.mktemp("sync"))
        _project(root)
        mp.setattr(VideoRecorder, "write_frame_i420", _sync_i420)
        assert run_batch(PROJECT, root=root, **FLAGS)["success"] == 2
        out["sync"] = root
    finally:
        mp.undo()
    return out


def test_video_producers_run_inside_the_queue_before_the_monitor_wait(runs):
    _, spans, _ = runs["queued"]
    loop = [s for s in spans if s.chunk is not None]
    video = [s for s in loop if s.name == "loop.produce" and s.attrs.get("what") == "video"]
    assert sorted(s.chunk[1] for s in video) == [2, 4, 6]  # one part: one a saving chunk
    by = {(s.name, s.chunk): s for s in loop}
    for s in video:
        queue, wait = by[("loop.queue", s.chunk)], by[("loop.monitor_wait", s.chunk)]
        render = by[("loop.render", s.chunk)]
        assert s.parent == render.id and render.parent == queue.id
        assert queue.t0 <= s.t0 <= s.t1 <= queue.t1 <= wait.t0
        assert s.attrs["bytes"] == 2 * (128 * 96 + 64 * 48 * 2)  # Y and UV of 2 cases
    # the planes are converted on the recorders' threads, a frame a case
    converts = [s for s in spans if s.name == "video.convert"]
    assert len(converts) == 2 * 3 and all(s.attrs["bytes"] == 128 * 96 * 3 for s in converts)
    assert {s.thread for s in converts}.isdisjoint({s.thread for s in loop})


def test_a_probed_renderer_keeps_its_chunks_frame(runs):
    _, _, probe = runs["queued"]
    assert probe["renders"] == 3 and "kept" in probe
    gui_w, gui_h = calc_gui_size(96, 64, 256)
    plain = render_mod.make_device_frame_renderer(gui_w, gui_h, batched=True, yuv420=True,
                                                  plain=True)
    mine, before = plain(*probe[SAMPLE]), plain(*probe[SAMPLE - 1])
    for kept, want in zip(probe["kept"], mine):
        assert torch.equal(kept, want)
    assert not all(torch.equal(a, b) for a, b in zip(mine, before))


def test_outputs_equal_the_synchronous_conversions(runs):
    h5_q, vid_q = _outputs(runs["queued"][0])
    h5_s, vid_s = _outputs(runs["sync"])
    assert sorted(vid_q) == sorted(vid_s) and len(vid_q) == 2
    assert vid_q == vid_s
    assert sorted(h5_q) == sorted(h5_s) and len(h5_q) == 2
    for f, ds in h5_s.items():
        assert sorted(h5_q[f]) == sorted(ds)
        for k, v in ds.items():
            np.testing.assert_array_equal(h5_q[f][k], v, err_msg=f"{f} {k}")


def test_saves_are_written_after_the_next_chunks_issue(runs):
    """The save worker gets a save (the HDF5 enqueues, the frames handed
    to the recorders) once the loop has issued the chunk after it
    (``SaveStage.hold`` and ``release``), so the writer and encoder threads
    do not contend with that issue; the last save, with no chunk after it,
    is written all the same."""
    _, spans, _ = runs["queued"]
    issue = {s.chunk: s for s in spans if s.name == "program.issue" and s.chunk is not None}
    writes = [s for s in spans if s.name in ("loop.write.h5", "loop.write.video")]
    chunks = {s.chunk for s in writes}
    assert {c[1] for c in chunks} == {2, 3, 4, 5, 6}  # saves from step 20 on, to the last
    for s in writes:
        after = (s.chunk[0], s.chunk[1] + 1)
        if after in issue:
            assert issue[after].t1 <= s.t0, s
        else:
            assert s.chunk[1] == 6  # the last chunk
