"""Headless frame composer: velocity + vorticity panels stacked vertically.

Replaces the reference's GUI-coupled visualizer
(visualization/Taichi_Gui_Viz.py + viz_utils.py) with a pure-array pipeline:
gaussian-smooth the velocity field, colorize |u| (plasma) and vorticity
(custom diverging map), stack panels, resize to display size.

Note: the reference viz computes vorticity as du/dy - dv/dx (the negative of
the physical curl used by the HDF5 writer); that sign convention is kept so
videos look identical. Its apply_resize argument-swap bug
(Taichi_Gui_Viz.py:51) is intentionally NOT replicated.
"""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
from scipy.ndimage import gaussian_filter

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

from .colorize import colorize_velocity, colorize_vorticity


def calc_gui_size(raw_w: int, raw_h: int, max_display_size: Optional[int] = None):
    """(w, 2h) clamped so the longest raw side fits max_display_size."""
    tw, th = raw_w, raw_h
    if max_display_size and max_display_size > 0:
        longest = max(raw_w, raw_h)
        if longest > max_display_size:
            ratio = max_display_size / longest
            tw, th = int(raw_w * ratio), int(raw_h * ratio)
    return max(1, tw), max(1, th) * 2


def apply_resize(img: np.ndarray, target_w: int, target_h: int) -> np.ndarray:
    h, w = img.shape[:2]
    if (w, h) == (target_w, target_h):
        return img
    if _HAS_CV2:
        return cv2.resize(img, (target_w, target_h), interpolation=cv2.INTER_LINEAR)
    ys = np.clip(np.round(np.arange(target_h) * h / target_h).astype(int), 0, h - 1)
    xs = np.clip(np.round(np.arange(target_w) * w / target_w).astype(int), 0, w - 1)
    return img[np.ix_(ys, xs)]


class FrameComposer:
    """Compose an RGB frame [2h, w, 3] float in [0,1] from (u, mask)."""

    def __init__(
        self,
        width: int,
        height: int,
        viz_sigma: float = 1.0,
        u_norm_max: float = 0.15,
        vorticity_range: float = 0.03,
    ):
        self.width = width
        self.height = height  # already doubled (two stacked panels)
        self.viz_sigma = viz_sigma
        self.u_norm_max = u_norm_max
        self.vorticity_range = vorticity_range

    def process_frame(self, u_yx2: np.ndarray, mask_yx: np.ndarray) -> np.ndarray:
        """u_yx2: [2, H, W] (ux, uy); mask_yx: [H, W] 1 = solid."""
        ux, uy = np.asarray(u_yx2[0]), np.asarray(u_yx2[1])
        if self.viz_sigma > 0:
            ux = gaussian_filter(ux, sigma=self.viz_sigma)
            uy = gaussian_filter(uy, sigma=self.viz_sigma)
        vel_mag = np.sqrt(ux * ux + uy * uy)
        # reference viz sign convention: du/dy - dv/dx
        vor = np.gradient(ux, axis=0) - np.gradient(uy, axis=1)

        mask = np.asarray(mask_yx)
        vel_img = colorize_velocity(vel_mag, self.u_norm_max, mask)
        vor_img = colorize_vorticity(vor, self.vorticity_range, mask)
        combined = np.concatenate([vel_img, vor_img], axis=0)  # stack panels
        return apply_resize(combined, self.width, self.height)


def draw_zone_overlay(img: np.ndarray, zones: Dict[str, int]) -> np.ndarray:
    """Draw sponge (green) and ROI (red) rectangles on an RGB frame in place.

    Array-space equivalent of the reference's ti.GUI line overlay
    (viz_utils.py:52-95); operates on the top panel of a composed frame.
    Accepts float [0,1] frames or uint8 frames (device-rendered path).
    """
    scale = 255 if img.dtype == np.uint8 else 1.0
    h, w = img.shape[:2]
    panel_h = h // 2
    nx, ny = zones["nx"], zones["ny"]
    sx = w / nx
    sy = panel_h / ny

    def vline(x, color):
        c = int(np.clip(x * sx, 0, w - 1))
        img[:panel_h, c] = color

    def hline(y, color):
        r = int(np.clip(y * sy, 0, panel_h - 1))
        img[r, :] = color

    green = (0.0, 1.0 * scale, 0.0)
    red = (1.0 * scale, 0.0, 0.0)
    vline(zones["sponge_in"], green)
    vline(nx - zones["sponge_out"], green)
    hline(zones["sponge_bot"], green)
    hline(ny - zones["sponge_top"], green)
    for x in (zones["roi_x_start"], zones["roi_x_end"]):
        vline(x, red)
    for y in (zones["roi_y_start"], zones["roi_y_end"]):
        hline(y, red)
    return img
