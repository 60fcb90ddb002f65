"""Shape rasterizers for procedural mask generation, and the analytic
obstacle outlines for the Bouzidi q planes.

Copy of ``lbm2d_tpu/tools/shapes.py`` (reference tools/map_gen/shapes.py:
circle, rotated rect via cv2.boxPoints + drawContours, equilateral triangle
with vertex_left / edge_left orientation). Grids are [H, W] uint8, 1 =
solid. The float-vertex helpers (``rect_points_f``, ``triangle_points_f``)
give the un-rounded vertices that ``core/solver.bouzidi_q_planes``
intersects the lattice links with; the integer helpers round them for
rasterization. Without cv2, polygons fill by the JAX package's scanline
rule, so both packages draw the same mask on the same machine.
"""

from __future__ import annotations

import numpy as np

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False


def add_circle(grid: np.ndarray, cx: float, cy: float, r: float) -> None:
    h, w = grid.shape
    y, x = np.ogrid[:h, :w]
    grid[(x - cx) ** 2 + (y - cy) ** 2 <= r * r] = 1


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


def rect_points(cx, cy, rect_w, rect_h, angle_deg) -> np.ndarray:
    """Corner points of a rotated rectangle, cv2.boxPoints-compatible."""
    return np.int64(rect_points_f(cx, cy, rect_w, rect_h, angle_deg))


def fill_polygon(grid: np.ndarray, points: np.ndarray, value: int = 1) -> None:
    if _HAS_CV2:
        cv2.drawContours(grid, [np.asarray(points, np.int64)], 0, value, -1)
        return
    # scanline fallback
    pts = np.asarray(points, np.float64)
    h, w = grid.shape
    ymin = max(0, int(np.floor(pts[:, 1].min())))
    ymax = min(h - 1, int(np.ceil(pts[:, 1].max())))
    n = len(pts)
    for y in range(ymin, ymax + 1):
        xs = []
        for i in range(n):
            x0, y0 = pts[i]
            x1, y1 = pts[(i + 1) % n]
            if (y0 <= y < y1) or (y1 <= y < y0):
                xs.append(x0 + (y - y0) * (x1 - x0) / (y1 - y0))
        xs.sort()
        for j in range(0, len(xs) - 1, 2):
            a = max(0, int(np.ceil(xs[j])))
            b = min(w - 1, int(np.floor(xs[j + 1])))
            if b >= a:
                grid[y, a : b + 1] = value


def add_rotated_rect(grid, cx, cy, rect_w, rect_h, angle_deg) -> None:
    fill_polygon(grid, rect_points(cx, cy, rect_w, rect_h, angle_deg))


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


def triangle_points(cx, cy, size, angle_deg, orientation="vertex_left") -> np.ndarray:
    """Equilateral triangle, size = circumradius; orientation rotates the
    base so either a vertex or an edge faces the inlet (-x)."""
    return np.int64(triangle_points_f(cx, cy, size, angle_deg, orientation))


def add_triangle(grid, cx, cy, size, angle_deg, orientation="vertex_left") -> None:
    fill_polygon(grid, triangle_points(cx, cy, size, angle_deg, orientation))
