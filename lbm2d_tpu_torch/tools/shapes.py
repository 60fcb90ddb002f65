"""Analytic obstacle outlines for the Bouzidi q planes.

Counterpart of the float-vertex helpers of ``lbm2d_tpu/tools/shapes.py``
(``rect_points_f``, ``triangle_points_f``): the un-rounded vertices that
``core/solver.bouzidi_q_planes`` intersects the lattice links with. The
rasterizers stay in the JAX package; mask generation is not ported.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def rect_points_f(cx, cy, rect_w, rect_h, angle_deg) -> np.ndarray:
    """Float corner points of a rotated rectangle (cv2.boxPoints convention)."""
    if _HAS_CV2:
        return np.asarray(
            cv2.boxPoints(((cx, cy), (rect_w, rect_h), angle_deg)), np.float64
        )
    a = np.deg2rad(angle_deg)
    c, s = np.cos(a), np.sin(a)
    hw, hh = rect_w / 2.0, rect_h / 2.0
    corners = np.array([[-hw, -hh], [hw, -hh], [hw, hh], [-hw, hh]])
    rot = corners @ np.array([[c, s], [-s, c]])
    return rot + np.array([cx, cy])


def triangle_points_f(
    cx, cy, size, angle_deg, orientation="vertex_left"
) -> np.ndarray:
    """Float vertices of the equilateral triangle of circumradius ``size``;
    ``orientation`` puts a vertex or an edge toward the inlet (-x)."""
    base = np.deg2rad(-90.0 if orientation == "vertex_left" else 90.0)
    a = base + np.deg2rad(angle_deg)
    p = np.array(
        [
            [0.0, -size],
            [-size * np.sqrt(3) / 2, size / 2],
            [size * np.sqrt(3) / 2, size / 2],
        ]
    )
    c, s = np.cos(a), np.sin(a)
    rot = np.array([[c, -s], [s, c]])
    return p @ rot.T + np.array([cx, cy])
