"""MP4 video recorder.

Functional parity with the reference recorder (io/video_recorder.py: even-dim
clamp, vertical flip, float->uint8). Backend ladder, best first:

1. **Native worker** (lbm2d_tpu_torch/native/videoenc.cc): libavcodec H.264 with
   the reference's exact codec contract (libx264 / yuv420p / crf 20 --
   reference io/video_recorder.py:32-41), encoding on a dedicated C++
   thread. I420 frames from the device renderer are consumed natively (no
   YUV->RGB->YUV host round trip). Disable with LBM2D_NO_NATIVE=1.
2. **cv2.VideoWriter** (mp4v) -- no ffmpeg binary is assumed in this
   environment, so this is the best pure-Python fallback.
3. **PNG frame directory** when no video backend exists at all.
"""

from __future__ import annotations

import os
from typing import Optional

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def i420_to_rgb(y8: np.ndarray, uv8: np.ndarray) -> np.ndarray:
    """(Y u8 [H, W], UV u8 [H/2, W/2, 2]) -> RGB u8 [H, W, 3].

    Prefers cv2.COLOR_YUV2RGB_I420 (the exact inverse convention of the
    device forward transform in ops/render.py); falls back to the same
    BT.601 limited-range math in numpy when cv2 is absent.
    """
    h, w = y8.shape
    if _HAS_CV2:
        # pack planes FLAT: the I420 buffer is Y (h*w bytes) then U then V
        # (h*w/4 each), contiguous. Row-sliced packing would need h % 4 == 0
        # (each chroma plane spanning h/4 buffer rows), but stacked-panel
        # frames are only guaranteed even -- e.g. h=970 broke the reshape.
        buf = np.empty(h * w * 3 // 2, np.uint8)
        n = h * w
        buf[:n] = np.ascontiguousarray(y8).ravel()
        buf[n : n + n // 4] = np.ascontiguousarray(uv8[..., 0]).ravel()
        buf[n + n // 4 :] = np.ascontiguousarray(uv8[..., 1]).ravel()
        return cv2.cvtColor(
            buf.reshape(h * 3 // 2, w), cv2.COLOR_YUV2RGB_I420
        )
    yf = y8.astype(np.float32) - 16.0
    up = np.repeat(np.repeat(uv8.astype(np.float32) - 128.0, 2, 0), 2, 1)
    u, v = up[:h, :w, 0], up[:h, :w, 1]
    r = 1.164 * yf + 1.596 * v
    g = 1.164 * yf - 0.813 * v - 0.391 * u
    b = 1.164 * yf + 2.018 * u
    return np.clip(np.stack([r, g, b], -1), 0, 255).astype(np.uint8)


class VideoRecorder:
    def __init__(
        self,
        filename: str,
        width: int,
        height: int,
        fps: int = 30,
        crf: int = 20,
    ):
        self.filename = filename
        self.rec_width = width - 1 if width % 2 else width
        self.rec_height = height - 1 if height % 2 else height
        self.fps = fps
        self.crf = crf
        self.is_recording = False
        self.backend: Optional[str] = None
        self._native = None
        self._writer = None
        self._frame_dir: Optional[str] = None
        self._frame_idx = 0

    def start(self) -> None:
        os.makedirs(os.path.dirname(self.filename) or ".", exist_ok=True)
        try:
            from ..native import NativeVideoEncoder

            self._native = NativeVideoEncoder(
                self.filename, self.rec_width, self.rec_height,
                fps=self.fps, crf=self.crf,
            )
            self.backend = f"native-{self._native.codec}"
            self.is_recording = True
            return
        except Exception:
            self._native = None
        if _HAS_CV2:
            self._writer = cv2.VideoWriter(
                self.filename,
                cv2.VideoWriter_fourcc(*"mp4v"),
                self.fps,
                (self.rec_width, self.rec_height),
            )
            if not self._writer.isOpened():
                self._writer = None
        if self._writer is not None:
            self.backend = "cv2-mp4v"
        else:
            # PNG-frame fallback directory next to the target file
            self._frame_dir = self.filename + ".frames"
            os.makedirs(self._frame_dir, exist_ok=True)
            self.backend = "png"
        self.is_recording = True

    def write_frame(self, img: np.ndarray) -> None:
        """img: [H, W, 3] float RGB in [0, 1]."""
        if not self.is_recording:
            return
        frame = img[: self.rec_height, : self.rec_width, :]
        frame8 = (np.clip(frame, 0, 1) * 255).astype(np.uint8)
        if self._native is not None:
            self._native.send_rgb(frame8, flip=True)
            return
        self._emit(frame8[::-1])  # vertical flip, reference orientation

    def write_frame_u8(self, img8: np.ndarray) -> None:
        """img8: [H, W, 3] uint8 RGB, already byte-quantized on device
        (ops/render.py); same even-dim crop + flip as the float path."""
        if not self.is_recording:
            return
        frame8 = np.asarray(img8)[: self.rec_height, : self.rec_width, :]
        if self._native is not None:
            self._native.send_rgb(frame8, flip=True)
            return
        self._emit(frame8[::-1])

    def write_frame_i420(self, y8: np.ndarray, uv8: np.ndarray) -> None:
        """YUV 4:2:0 frame from the device renderer's yuv420 mode: Y u8
        [rec_h, rec_w], UV u8 [rec_h/2, rec_w/2, 2] (even-dim crop already
        applied on device). Reconstructs RGB via cv2's own I420 inverse --
        the device forward transform pixel-matches cv2.COLOR_RGB2YUV_I420 --
        then flips/encodes like write_frame_u8.

        On the native backend the planes go straight to the yuv420p encoder
        (flip applied plane-wise in C++) -- no RGB reconstruction at all.
        The chroma rows of a plane-flipped I420 image sit one luma row off
        from re-subsampling the flipped RGB (top-left siting); both paths
        are within the encoder's own 4:2:0 siting tolerance."""
        if not self.is_recording:
            return
        if self._native is not None:
            rh, rw = self.rec_height, self.rec_width
            y = np.asarray(y8)[:rh, :rw]
            uv = np.asarray(uv8)[: rh // 2, : rw // 2, :]
            self._native.send_i420(y, uv, flip=True)
            return
        self.write_frame_u8(i420_to_rgb(np.asarray(y8), np.asarray(uv8)))

    def _emit(self, frame8: np.ndarray) -> None:
        if self._writer is not None:
            self._writer.write(frame8[:, :, ::-1])  # RGB -> BGR
        elif self._frame_dir is not None:
            from PIL import Image

            Image.fromarray(frame8).save(
                os.path.join(self._frame_dir, f"frame_{self._frame_idx:06d}.png")
            )
            self._frame_idx += 1

    def stop(self) -> None:
        if self.is_recording and self._native is not None:
            self._native.close()
        if self.is_recording and self._writer is not None:
            self._writer.release()
        self._native = None
        self._writer = None
        self.is_recording = False
