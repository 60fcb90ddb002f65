"""The port's video recorder on its cv2 backend (``io/video.py``): frames
are encoded on the recorder's own thread, in write order, into the bytes a
synchronous ``cv2.VideoWriter`` writes from the same frames."""

import numpy as np
import pytest

from lbm2d_tpu_torch.io.video import VideoRecorder

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


@pytest.mark.parametrize("with_zones", [False, True], ids=["planes", "zones"])
def test_cv2_recorder_converts_i420_planes_on_its_thread(tmp_path, monkeypatch, with_zones):
    """The save worker hands the recorder I420 planes (and the zones): the
    write returns before they are converted, and the writer gets, in order,
    the arrays the synchronous conversion makes (RGB, the overlay, the
    crop, the flip and the BGR copy)."""
    import threading

    from lbm2d_tpu_torch.io import video
    from lbm2d_tpu_torch.utils.profiling import REGISTRY
    from lbm2d_tpu_torch.viz.frames import draw_zone_overlay

    monkeypatch.setenv("LBM2D_NO_NATIVE", "1")
    monkeypatch.setattr(video.cv2, "VideoWriter", _Writer)
    gate, converted = threading.Event(), []
    pack = video._i420_buffer

    def gated_pack(y8, uv8):
        assert gate.wait(30)
        converted.append(threading.get_ident())
        return pack(y8, uv8)

    monkeypatch.setattr(video, "_i420_buffer", gated_pack)
    h, w = 40, 56
    rng = np.random.default_rng(5)
    planes = [(rng.integers(16, 236, (h, w), dtype=np.uint8),
               rng.integers(16, 241, (h // 2, w // 2, 2), dtype=np.uint8)) for _ in range(10)]
    zones = ({"nx": 112, "ny": 40, "sponge_in": 8, "sponge_out": 16, "sponge_bot": 4,
              "sponge_top": 4, "roi_x_start": 12, "roi_x_end": 92, "roi_y_start": 8,
              "roi_y_end": 32} if with_zones else None)
    rec = video.VideoRecorder(str(tmp_path / "v.mp4"), width=w + 1, height=h, fps=10)
    rec.start()
    assert rec.backend == "cv2-mp4v"
    REGISTRY.reset()
    with REGISTRY.recording():
        rec.write_frame_i420(*planes[0], zones)
        assert converted == [] and rec._writer.frames == []  # returned first
        gate.set()
        for y8, uv8 in planes[1:]:
            rec.write_frame_i420(y8, uv8, zones)
        writer = rec._writer
        rec.stop()
    spans = [s for s in REGISTRY.snapshot(reset=True) if s.name == "video.convert"]
    assert len(spans) == len(planes) and all(s.attrs["bytes"] == h * w * 3 for s in spans)
    assert threading.get_ident() not in {s.thread for s in spans} | set(converted)
    want = []
    for y8, uv8 in planes:
        rgb = video.i420_to_rgb(y8, uv8)
        if zones is not None:
            rgb = draw_zone_overlay(rgb, zones)
        want.append(np.ascontiguousarray(rgb[:h, :w][::-1, :, ::-1]))
    assert len(writer.frames) == len(want)
    for got, exp in zip(writer.frames, want):
        assert got.flags["C_CONTIGUOUS"]
        np.testing.assert_array_equal(got, exp)
