"""The port's video recorder on its cv2 backend (``io/video.py``): frames
are encoded on the recorder's own thread, in write order, into the bytes a
synchronous ``cv2.VideoWriter`` writes from the same frames."""

import numpy as np
import pytest

from lbm2d_tpu_torch.io.video import VideoRecorder
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

cv2 = pytest.importorskip("cv2")


def test_cv2_recorder_encodes_on_its_thread_what_a_synchronous_writer_does(tmp_path,
                                                                           monkeypatch):
    monkeypatch.setenv("LBM2D_NO_NATIVE", "1")
    h, w = 48, 64
    yy, xx = np.mgrid[:h, :w]
    frames = [((np.stack([xx * 4 + k, yy * 5, (xx + yy + 7 * k) % 256], -1)) % 256)
              .astype(np.uint8) for k in range(12)]
    rec = VideoRecorder(str(tmp_path / "thread.mp4"), width=w + 1, height=h + 1, fps=10)
    rec.start()
    assert rec.backend == "cv2-mp4v"
    buf = np.empty_like(frames[0])
    for f in frames:
        buf[...] = f
        rec.write_frame_u8(buf)  # one array, reused: the recorder copies it
        buf[...] = 0
    rec.stop()
    sync = cv2.VideoWriter(str(tmp_path / "sync.mp4"), cv2.VideoWriter_fourcc(*"mp4v"), 10,
                           (w, h))
    for f in frames:
        sync.write(f[::-1, :, ::-1])
    sync.release()
    assert (tmp_path / "thread.mp4").read_bytes() == (tmp_path / "sync.mp4").read_bytes()


class _Writer:
    """A stand-in for cv2.VideoWriter that keeps a copy of each frame."""

    def __init__(self, *args):
        self.frames = []

    def isOpened(self):
        return True

    def write(self, frame):
        self.frames.append(np.array(frame))

    def release(self):
        pass


@pytest.mark.parametrize("fmt,with_zones", [("i420", False), ("i420", True), ("rgb", True)],
                         ids=["planes", "zones", "rgb_zones"])
def test_cv2_recorder_converts_i420_planes_on_its_thread(tmp_path, monkeypatch, fmt, with_zones):
    """The save worker hands the recorder I420 planes, or an RGB frame,
    the recorder holding the zones from its construction: the write
    returns before the frame is converted, and the writer gets, in order,
    the arrays a recorder without zones gets from ``write_frame_u8`` of the
    RGB frame with ``draw_zone_overlay`` drawn (the overlay on the whole
    frame, the crop, the flip and the BGR copy)."""
    import threading

    from lbm2d_tpu_torch.io import video
    from lbm2d_tpu_torch.utils.profiling import REGISTRY
    from lbm2d_tpu_torch.viz.frames import draw_zone_overlay

    monkeypatch.setenv("LBM2D_NO_NATIVE", "1")
    monkeypatch.setattr(video.cv2, "VideoWriter", _Writer)
    gate, converted = threading.Event(), []
    flipped_bgr = video.VideoRecorder._flipped_bgr

    def gated(self, *planes):
        assert gate.wait(30)
        converted.append(threading.get_ident())
        return flipped_bgr(self, *planes)

    monkeypatch.setattr(video.VideoRecorder, "_flipped_bgr", gated)
    h, w = 40, 56
    rng = np.random.default_rng(5)
    if fmt == "i420":
        frames = [(rng.integers(16, 236, (h, w), dtype=np.uint8),
                   rng.integers(16, 241, (h // 2, w // 2, 2), dtype=np.uint8))
                  for _ in range(10)]
        rgbs = [video.i420_to_rgb(y8, uv8) for y8, uv8 in frames]
    else:  # the renderer's RGB frame is uncropped: the overlay is drawn before the crop
        rgbs = [rng.integers(0, 256, (h + 1, w + 1, 3), dtype=np.uint8) for _ in range(10)]
        frames = [(f,) for f in rgbs]
    zones = ({"nx": 112, "ny": 40, "sponge_in": 8, "sponge_out": 16, "sponge_bot": 4,
              "sponge_top": 4, "roi_x_start": 12, "roi_x_end": 92, "roi_y_start": 8,
              "roi_y_end": 32} if with_zones else None)
    rec = video.VideoRecorder(str(tmp_path / "v.mp4"), width=w + 1, height=h + 1, fps=10,
                              zones=zones)
    rec.start()
    assert rec.backend == "cv2-mp4v"
    buf = np.empty_like(frames[0][0])

    def write(frame):
        if fmt == "i420":
            rec.write_frame_i420(*frame)
        else:
            buf[...] = frame[0]
            rec.write_frame_u8(buf)  # one array, reused: the recorder copies it
            buf[...] = 0

    REGISTRY.reset()
    with REGISTRY.recording():
        write(frames[0])
        assert converted == [] and rec._writer.frames == []  # returned first
        gate.set()
        for frame in frames[1:]:
            write(frame)
        writer = rec._writer
        rec.stop()
    spans = [s for s in REGISTRY.snapshot(reset=True) if s.name == "video.convert"]
    assert len(spans) == len(frames) and all(s.attrs["bytes"] == h * w * 3 for s in spans)
    assert threading.get_ident() not in {s.thread for s in spans} | set(converted)
    plain = video.VideoRecorder(str(tmp_path / "plain.mp4"), width=w + 1, height=h + 1, fps=10)
    plain.start()
    for rgb in rgbs:
        plain.write_frame_u8(draw_zone_overlay(rgb.copy(), zones) if zones is not None else rgb)
    want = plain._writer.frames
    plain.stop()
    assert len(writer.frames) == len(want) == len(frames)
    for got, exp in zip(writer.frames, want):
        assert got.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(got, exp)
