"""Interactive GUI window: live view of the composed frame during a run.

Parity target: the reference's ti.GUI usage (C8) — the window is opened when
``outputs.gui.enable`` is set (reference pipeline/run_one_case.py:45,
``ti.GUI("Taichi LBM", res=(gui_w, gui_h))``), receives the composed frame
every gui interval (core/simulation_ops.py:155-159, ``gui.set_image`` +
``gui.show``), and closing it stops the run with status Aborted
(core/simulation_ops.py:91-95).

Taichi is not part of this stack, and TPU hosts are usually headless, so the
window is a matplotlib figure: an interactive backend (TkAgg/QtAgg/macosx)
when a display is reachable, the offscreen Agg canvas otherwise. Under Agg
the frame is still rendered each ``show()`` (so the full code path is
exercised in tests and remote smoke checks) and ``running`` simply never
flips to False. Frame composition itself — colormaps, stacked |u|/vorticity
panels, zone overlay — lives in viz/frames.py and is shared with the video
path, exactly as in the reference.
"""

from __future__ import annotations

import os
import sys
from typing import Optional, Tuple

import numpy as np

_DPI = 100


def _display_available() -> bool:
    if sys.platform.startswith(("win", "darwin")):
        return True
    return bool(os.environ.get("DISPLAY") or os.environ.get("WAYLAND_DISPLAY"))


class GuiWindow:
    """Minimal ti.GUI-shaped window: .running, .set_image(), .show(), .close().

    ``set_image`` accepts an RGB frame [H, W, 3], float in [0, 1] or uint8 —
    the same array ``FrameComposer.process_frame`` / the device renderer
    produce (row 0 = top, matching the mp4 frames).
    """

    def __init__(self, title: str, res: Tuple[int, int]):
        self.title = title
        self.width, self.height = int(res[0]), int(res[1])
        self.running = True
        self.interactive = False
        self._fig = None
        self._im = None

        try:
            import matplotlib
        except Exception:  # pragma: no cover - matplotlib is in the image
            self._mpl = None
            return
        self._mpl = matplotlib

        if _display_available():
            for backend in ("TkAgg", "QtAgg", "macosx"):
                try:
                    matplotlib.use(backend, force=True)
                    self.interactive = True
                    break
                except Exception:
                    continue
        if not self.interactive:
            matplotlib.use("Agg", force=True)

        import matplotlib.pyplot as plt

        self._plt = plt
        if self.interactive:
            plt.ion()
        self._fig = plt.figure(
            num=title, figsize=(self.width / _DPI, self.height / _DPI), dpi=_DPI
        )
        ax = self._fig.add_axes((0.0, 0.0, 1.0, 1.0))
        ax.set_axis_off()
        self._im = ax.imshow(
            np.zeros((self.height, self.width, 3), dtype=np.uint8),
            interpolation="nearest",
        )
        # user closes the window -> the sim loop sees running=False and
        # aborts the case (reference simulation_ops.py:91-95)
        self._fig.canvas.mpl_connect("close_event", self._on_close)

    def _on_close(self, _event) -> None:
        self.running = False

    def set_image(self, img: np.ndarray) -> None:
        if self._im is None:
            return
        img = np.asarray(img)
        if img.dtype != np.uint8:
            img = (np.clip(img, 0.0, 1.0) * 255.0 + 0.5).astype(np.uint8)
        self._im.set_data(img)

    def show(self) -> None:
        """Render the current frame (and pump UI events when interactive)."""
        if self._fig is None:
            return
        if self.interactive:
            try:
                self._fig.canvas.draw_idle()
                self._fig.canvas.flush_events()
                self._plt.pause(0.001)
            except Exception:
                # window torn down mid-draw (user close race)
                self.running = False
        else:
            self._fig.canvas.draw()

    def frame_rgb(self) -> Optional[np.ndarray]:
        """Return the currently displayed canvas as [H, W, 3] uint8 (tests)."""
        if self._fig is None:
            return None
        self._fig.canvas.draw()
        buf = np.asarray(self._fig.canvas.buffer_rgba())
        return buf[..., :3].copy()

    def close(self) -> None:
        if self._fig is not None:
            try:
                self._plt.close(self._fig)
            finally:
                self._fig = None
                self._im = None
        self.running = False
