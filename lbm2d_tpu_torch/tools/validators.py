"""Placement validators for procedural mask generation.

Copy of ``lbm2d_tpu/tools/validators.py`` (reference
tools/map_gen/validators.py): SDF min-distance check between a candidate
shape and existing obstacles, and a max vertical blockage-ratio gate.
"""

from __future__ import annotations

import numpy as np

from .shapes import fill_polygon
from ..io.sdf import edt


def _distance_to_solid(grid: np.ndarray) -> np.ndarray:
    """Distance of each fluid cell to the nearest solid cell (cv2's 5x5
    mask where cv2 imports, else the exact transform, as the JAX package)."""
    try:
        import cv2
    except ImportError:
        return edt(1 - grid)
    return cv2.distanceTransform((1 - grid).astype(np.uint8), cv2.DIST_L2, 5)


def check_sdf_validity(grid: np.ndarray, new_box_points, min_dist: float) -> bool:
    """True if the candidate shape keeps >= min_dist from existing solids."""
    if np.sum(grid) == 0:
        return True
    sdf = _distance_to_solid(grid)
    new_mask = np.zeros_like(grid)
    fill_polygon(new_mask, new_box_points)
    covered = sdf[new_mask == 1]
    return len(covered) == 0 or float(np.min(covered)) >= min_dist


def check_blockage_ratio(grid: np.ndarray, new_box_points, max_ratio: float) -> bool:
    """True if adding the shape keeps the y-projection blockage <= max_ratio."""
    temp = grid.copy()
    fill_polygon(temp, new_box_points)
    blocked_rows = float(np.sum(np.max(temp, axis=1)))
    return (blocked_rows / grid.shape[0]) <= max_ratio
