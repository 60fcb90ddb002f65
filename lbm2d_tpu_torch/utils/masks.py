"""Obstacle-mask loading.

Parity target: reference utils/mask_utils.py (create_mask:43,
_create_from_png:5): PNG -> grayscale -> NEAREST resize to (nx, ny) ->
threshold at 127 (invert flag flips which side is solid).

Layout difference (intentional): this framework keeps masks in image-native
``[ny, nx]`` (y, x) order -- the solver is channel-major [9, H, W] -- so the
reference's final transpose to [nx, ny] is *not* performed. Helpers are
provided for converting to/from the reference's [x, y] order in tests.
"""

from __future__ import annotations

import os
from typing import Any, Dict, Optional

import numpy as np

try:  # pragma: no cover - import guard
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False
    from PIL import Image


def load_grayscale(png_path: str) -> np.ndarray:
    if not png_path or not os.path.exists(png_path):
        raise FileNotFoundError(f"Mask file not found: {png_path}")
    if _HAS_CV2:
        img = cv2.imread(png_path, cv2.IMREAD_GRAYSCALE)
        if img is None:
            raise ValueError(f"Failed to load image: {png_path}")
        return img
    img = Image.open(png_path).convert("L")
    return np.asarray(img)


def resize_nearest(img: np.ndarray, nx: int, ny: int) -> np.ndarray:
    if img.shape == (ny, nx):
        return img
    if _HAS_CV2:
        return cv2.resize(img, (nx, ny), interpolation=cv2.INTER_NEAREST)
    # Nearest-neighbour fallback identical to cv2 pixel mapping
    ys = np.minimum((np.arange(ny) + 0.5) * img.shape[0] / ny, img.shape[0] - 1).astype(int)
    xs = np.minimum((np.arange(nx) + 0.5) * img.shape[1] / nx, img.shape[1] - 1).astype(int)
    return img[np.ix_(ys, xs)]


def create_mask(config: Dict[str, Any], png_path: Optional[str]) -> np.ndarray:
    """Return bool mask [ny, nx], True = solid."""
    nx = config["simulation"]["nx"]
    ny = config["simulation"]["ny"]
    mask_cfg = config.get("mask", {})
    if mask_cfg.get("enable") and mask_cfg.get("type") == "png" and png_path:
        img = resize_nearest(load_grayscale(png_path), nx, ny)
        threshold = 127
        if mask_cfg.get("invert", False):
            return (img > threshold).astype(bool)
        return (img < threshold).astype(bool)
    return np.zeros((ny, nx), dtype=bool)


def to_reference_layout(mask_yx: np.ndarray) -> np.ndarray:
    """[ny, nx] -> reference [nx, ny]."""
    return mask_yx.T


def from_reference_layout(mask_xy: np.ndarray) -> np.ndarray:
    return mask_xy.T
