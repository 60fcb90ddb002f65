"""Mask geometry analysis: characteristic length + worst-section blockage.

Parity target: reference tools/config_utils/geometry.py (v4 algorithm):
  l_char = max over (erosion-separated, area-filtered) connected components
           of min(x-span, y-span), measured on the un-eroded mask inside the
           component's dilated bounding box;
  max_blockage = max of the 5px rolling-mean per-column solid fraction over
           the analysis window [5% nx, nx - pad_right - buffer).

This implementation works on [ny, nx] (y, x) arrays -- the framework's
native layout -- which is the transpose of the reference's; all outputs are
layout-invariant.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
from scipy import ndimage
from scipy.ndimage import binary_erosion

from ..sampling import get_sampled_value  # noqa: F401  (re-export convenience)
from ...utils.masks import load_grayscale, resize_nearest

_EROSION_ITER = 3
_AREA_FRAC_MAX = 0.05


def load_solid_mask_yx(png_path: str, invert: bool, nx: int, ny: int) -> np.ndarray:
    """PNG -> bool solid mask [ny, nx] with the runtime loader's semantics."""
    img = resize_nearest(load_grayscale(png_path), nx, ny)
    return (img > 127) if invert else (img < 127)


def calc_l_char(png_path: str, invert: bool, nx: int, ny: int) -> int:
    """Largest single building's equivalent feature size in pixels."""
    solid = load_solid_mask_yx(png_path, invert, nx, ny)
    eroded = binary_erosion(solid, iterations=_EROSION_ITER)
    labeled, n = ndimage.label(eroded)
    if n == 0:
        labeled, n = ndimage.label(solid)
        if n == 0:
            return max(1, ny // 8)

    area_max = int(nx * ny * _AREA_FRAC_MAX)
    best = 0
    for lab in range(1, n + 1):
        region = labeled == lab
        if int(region.sum()) > area_max:
            continue
        ys = np.where(region.any(axis=1))[0]
        xs = np.where(region.any(axis=0))[0]
        if len(xs) == 0 or len(ys) == 0:
            continue
        # dilate the bbox back by the erosion amount, then measure the real
        # (un-eroded) extent inside it
        y0 = max(0, ys[0] - _EROSION_ITER)
        y1 = min(ny - 1, ys[-1] + _EROSION_ITER)
        x0 = max(0, xs[0] - _EROSION_ITER)
        x1 = min(nx - 1, xs[-1] + _EROSION_ITER)
        roi = solid[y0 : y1 + 1, x0 : x1 + 1]
        ys_r = np.where(roi.any(axis=1))[0]
        xs_r = np.where(roi.any(axis=0))[0]
        if len(xs_r) == 0 or len(ys_r) == 0:
            continue
        span = min(int(xs_r[-1] - xs_r[0] + 1), int(ys_r[-1] - ys_r[0] + 1))
        best = max(best, span)

    if best == 0:
        # all components were area-filtered: fall back to the smallest one
        min_area, best = nx * ny, 1
        for lab in range(1, n + 1):
            region = labeled == lab
            area = int(region.sum())
            if area < min_area:
                ys = np.where(region.any(axis=1))[0]
                xs = np.where(region.any(axis=0))[0]
                if len(xs) and len(ys):
                    min_area = area
                    best = min(int(xs[-1] - xs[0] + 1), int(ys[-1] - ys[0] + 1))
    return max(1, best)


def calc_max_blockage(
    png_path: str,
    invert: bool,
    nx: int,
    ny: int,
    pad_right: int = 512,
    buffer: int = 128,
) -> float:
    """Worst 5px-rolling-average cross-section blockage fraction."""
    solid = load_solid_mask_yx(png_path, invert, nx, ny)
    x_start = max(1, int(nx * 0.05))
    x_end = min(nx - 1, nx - pad_right - buffer)
    roi = solid[:, x_start:x_end]
    if roi.shape[1] == 0:
        return 0.0
    per_x = roi.astype(np.float32).mean(axis=0)
    window = 5
    if len(per_x) >= window:
        per_x = np.convolve(per_x, np.ones(window, np.float32) / window, mode="valid")
    return float(per_x.max())


def fill_geometry(mask_ctx: Dict[str, Any], sim_ctx: Dict[str, Any]) -> None:
    mask_ctx["l_char"] = calc_l_char(
        mask_ctx["mask_path"], sim_ctx["mask_invert"], mask_ctx["nx"], mask_ctx["ny"]
    )
    mask_ctx["max_blockage"] = calc_max_blockage(
        mask_ctx["mask_path"],
        sim_ctx["mask_invert"],
        mask_ctx["nx"],
        mask_ctx["ny"],
        pad_right=mask_ctx["pad_right"],
        buffer=sim_ctx["blockage_buffer"],
    )
