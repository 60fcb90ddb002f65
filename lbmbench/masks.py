"""Seeded obstacle masks of the production urban case.

A plain generator of the same parts, ranges and padding as the upstream
``map_generator`` settings of ``master_config.yaml`` (hybrid mode): a
pinball triad of circles, squares or triangles near the inlet, a bank of
tubes (aligned or staggered), a step on the bottom wall, and a field of
rotated rectangles downstream, on the core domain, its first and last
``boundary_buffer`` columns cleared, then padded. Sizes given in pixels are
the upstream's at a core height of 768 and scale with the core height, so a
small test grid keeps the layout. The same seed gives the same mask.
"""

from __future__ import annotations

import numpy as np

HYBRID = {
    "pinball": {"shape": ["circle", "square", "triangle"], "center_x_ratio": [0.10, 0.18],
                "center_y_ratio": [0.40, 0.60], "size_ratio": [0.03, 0.06],
                "spacing_factor": [1.6, 2.4], "rotation_angle": [0, 60],
                "triangle_orientation": ["vertex_left", "edge_left"]},
    "tube_bank": {"shape": ["circle", "square"], "layout": ["aligned", "staggered"],
                  "start_x_ratio": [0.25, 0.32], "end_x_ratio": [0.45, 0.55],
                  "size_ratio": [0.02, 0.04], "num_cols": [2, 4], "num_rows": [3, 6],
                  "jitter_amount": [-4, 4], "rotation_angle": [0, 45]},
    "step_urban": {"step_start_ratio": [0.55, 0.62], "step_height_ratio": [0.10, 0.22],
                   "step_width_ratio": [0.05, 0.10], "block_start_ratio": [0.62, 0.70],
                   "block_end_ratio": [0.92, 0.96], "rect_count": [6, 14],
                   "rect_size": {"w": [24, 120], "h": [24, 120]}, "rotate_angle_max": [0, 45],
                   "min_distance": [16, 32], "max_blockage_ratio": [0.75, 0.85],
                   "max_attempts": 300},
    "boundary_buffer": 64,
}


class _Canvas:
    def __init__(self, w: int, h: int, rng: np.random.Generator):
        self.w, self.h, self.rng = w, h, rng
        self.grid = np.zeros((h, w), bool)

    def uniform(self, lo_hi):
        return float(self.rng.uniform(lo_hi[0], lo_hi[1]))

    def integer(self, lo_hi):
        return int(self.rng.integers(lo_hi[0], lo_hi[1] + 1))

    def choice(self, items):
        return items[int(self.rng.integers(len(items)))]

    def polygon(self, pts: np.ndarray) -> np.ndarray:
        """bool [h, w] of the cell centres inside the convex polygon."""
        out = np.zeros_like(self.grid)
        x0, y0 = np.floor(pts.min(axis=0)).astype(int)
        x1, y1 = np.ceil(pts.max(axis=0)).astype(int)
        x0, y0, x1, y1 = max(x0, 0), max(y0, 0), min(x1 + 1, self.w), min(y1 + 1, self.h)
        if x0 >= x1 or y0 >= y1:
            return out
        yy, xx = np.mgrid[y0:y1, x0:x1] + 0.0
        inside = np.ones(yy.shape, bool)
        d1, d2 = pts[1] - pts[0], pts[2] - pts[1]
        sign = np.sign(d1[0] * d2[1] - d1[1] * d2[0])
        for a, b in zip(pts, np.roll(pts, -1, axis=0)):
            inside &= sign * ((b[0] - a[0]) * (yy - a[1]) - (b[1] - a[1]) * (xx - a[0])) >= 0
        out[y0:y1, x0:x1] = inside
        return out

    def disc(self, cx, cy, r) -> np.ndarray:
        out = np.zeros_like(self.grid)
        x0, x1 = max(int(cx - r) - 1, 0), min(int(cx + r) + 2, self.w)
        y0, y1 = max(int(cy - r) - 1, 0), min(int(cy + r) + 2, self.h)
        if x0 < x1 and y0 < y1:
            yy, xx = np.mgrid[y0:y1, x0:x1]
            out[y0:y1, x0:x1] = (xx - cx) ** 2 + (yy - cy) ** 2 <= r * r
        return out


def _rect(cx, cy, w, h, angle_deg) -> np.ndarray:
    t = np.deg2rad(angle_deg)
    c, s = np.cos(t), np.sin(t)
    corners = np.array([[-w / 2, -h / 2], [w / 2, -h / 2], [w / 2, h / 2], [-w / 2, h / 2]])
    return corners @ np.array([[c, s], [-s, c]]) + [cx, cy]


def _triangle(cx, cy, r, angle_deg, orientation) -> np.ndarray:
    base = 180.0 if orientation == "vertex_left" else 0.0
    t = np.deg2rad(base + angle_deg + np.array([0.0, 120.0, 240.0]))
    return np.stack([cx + r * np.cos(t), cy + r * np.sin(t)], axis=1)


def _shape(cv: _Canvas, kind, cx, cy, size, angle, orientation=None) -> np.ndarray:
    if kind == "circle":
        return cv.disc(cx, cy, size)
    if kind == "square":
        return cv.polygon(_rect(cx, cy, 2 * size, 2 * size, angle))
    return cv.polygon(_triangle(cx, cy, size, angle, orientation))


def hybrid_core(seed: int, width: int, height: int, params: dict = HYBRID) -> np.ndarray:
    """bool [height, width] core mask (True = solid) drawn from ``seed``."""
    cv = _Canvas(width, height, np.random.default_rng(seed))
    px = height / 768.0  # the upstream's pixel sizes are at a core height of 768
    pb = params["pinball"]
    kind = cv.choice(pb["shape"])
    cx, cy = int(width * cv.uniform(pb["center_x_ratio"])), int(height * cv.uniform(pb["center_y_ratio"]))
    size = int(height * cv.uniform(pb["size_ratio"]))
    sp = int(size * cv.uniform(pb["spacing_factor"]))
    for x, y in ((cx - sp, cy), (cx + sp, cy + sp), (cx + sp, cy - sp)):
        angle = cv.uniform(pb["rotation_angle"]) if kind != "circle" else 0.0
        orient = cv.choice(pb["triangle_orientation"])
        cv.grid |= _shape(cv, kind, x, y, size, angle, orient)

    tb = params["tube_bank"]
    kind, layout = cv.choice(tb["shape"]), cv.choice(tb["layout"])
    x_start = int(width * cv.uniform(tb["start_x_ratio"]))
    x_end = int(width * cv.uniform(tb["end_x_ratio"]))
    size = int(height * cv.uniform(tb["size_ratio"]))
    cols, rows = cv.integer(tb["num_cols"]), cv.integer(tb["num_rows"])
    dx, dy = (x_end - x_start) // cols, height // (rows + 1)
    jitter = [round(j * px) for j in tb["jitter_amount"]]
    for c in range(cols):
        off = dy // 2 if layout == "staggered" and c % 2 else 0
        for r in range(rows):
            x = x_start + c * dx + cv.integer(jitter)
            y = dy * (r + 1) + off + cv.integer(jitter)
            if size < y < height - size:
                angle = cv.uniform(tb["rotation_angle"]) if kind != "circle" else 0.0
                cv.grid |= _shape(cv, kind, x, y, size, angle)

    su = params["step_urban"]
    sx = int(width * cv.uniform(su["step_start_ratio"]))
    sh = int(height * cv.uniform(su["step_height_ratio"]))
    sw = int(width * cv.uniform(su["step_width_ratio"]))
    cv.grid[:sh, sx:sx + sw] = True
    x_lo = max(int(width * cv.uniform(su["block_start_ratio"])), sx + sw + round(20 * px))
    x_hi = int(width * cv.uniform(su["block_end_ratio"]))
    count = cv.integer(su["rect_count"])
    angle_max = cv.uniform(su["rotate_angle_max"])
    w_rng = [v * px for v in su["rect_size"]["w"]]
    h_rng = [v * px for v in su["rect_size"]["h"]]
    margin = int(np.hypot(w_rng[1], h_rng[1]) / 2) + 2
    placed = 0
    for _ in range(su["max_attempts"]):
        if placed >= count:
            break
        x = cv.uniform([x_lo + margin, max(x_lo + margin, x_hi - margin)])
        y = cv.uniform([margin, max(margin, height - margin)])
        w, h, angle = cv.uniform(w_rng), cv.uniform(h_rng), cv.uniform([0.0, angle_max])
        gap = cv.uniform([v * px for v in su["min_distance"]])
        blockage = cv.uniform(su["max_blockage_ratio"])
        body = cv.polygon(_rect(x, y, w, h, angle))
        if (cv.polygon(_rect(x, y, w + 2 * gap, h + 2 * gap, angle)) & cv.grid).any():
            continue  # closer than the gap to a part already placed
        cols_hit = body.any(axis=0)
        if ((cv.grid | body)[:, cols_hit].mean(axis=0) > blockage).any():
            continue
        cv.grid |= body
        placed += 1
    buf = max(1, round(params["boundary_buffer"] * px))
    cv.grid[:, :buf] = False
    cv.grid[:, -buf:] = False
    return cv.grid


def urban_mask(seed: int, domain: dict, padding: dict) -> np.ndarray:
    """float32 [H, W] mask (1 = solid) of the padded grid: the core of
    ``domain`` ({width, height}) inside ``padding`` ({left, right, top,
    bot})."""
    core = hybrid_core(seed, int(domain["width"]), int(domain["height"]))
    out = np.pad(core, ((int(padding["bot"]), int(padding["top"])),
                        (int(padding["left"]), int(padding["right"]))))
    return out.astype(np.float32)
