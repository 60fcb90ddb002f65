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
