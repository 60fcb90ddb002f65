"""Procedural obstacle-mask generators (copy of
``lbm2d_tpu/tools/map_generators.py``; the same seed writes the same files).

Covers the reference's three generator families with one shared engine:
  * hybrid (tools/hybrid_map_gen.py): pinball triad + tube banks + step +
    rejection-sampled rotated-rect urban field,
  * pure urban (tools/urban_map_generator.py): rotated rects only,
  * physics-constrained rects (tools/mask_rect_gen.py): random rotated rects
    with min-distance/blockage gates and left-alignment to the inlet buffer.

All grids are [H, W] uint8 with 1 = solid; PNGs are saved with dark = solid
(the runtime mask loader thresholds at 127 with invert=False).

Unlike the reference, generators also emit the ``masks/metadata.json``
contract (file_name, domain_W_total/H_total, pad_*, optional m_per_px) that
config_batch_gen requires -- the reference outsources this to its GIS
pipeline (SURVEY.md section 3.3 note).
"""

from __future__ import annotations

import json
import os
import random
from typing import Any, Dict, List, Optional, Tuple

import numpy as np

from .sampling import get_sampled_value
from .shapes import add_circle, add_rotated_rect, add_triangle, fill_polygon, rect_points
from .validators import check_blockage_ratio, check_sdf_validity


def _save_mask_png(grid: np.ndarray, filename: str, invert_values: bool = True) -> None:
    """Save a 0/1 grid as PNG. invert_values=True -> solid is dark (0)."""
    os.makedirs(os.path.dirname(filename) or ".", exist_ok=True)
    img = (1 - grid) if invert_values else grid
    img8 = (np.asarray(img, np.float32) * 255).astype(np.uint8)
    try:
        import cv2

        cv2.imwrite(filename, img8)
    except Exception:
        from PIL import Image

        Image.fromarray(img8).save(filename)


class _ShapePlacer:
    """Shared placement helpers over a [H, W] grid."""

    def __init__(self, width: int, height: int, rng: Optional[random.Random] = None):
        self.W = width
        self.H = height
        self.rng = rng or random.Random()
        self.grid = np.zeros((height, width), dtype=np.uint8)
        # analytic geometry of every placed shape (core/solver.bouzidi_q_planes
        # schema) so generated cases can run Bouzidi with exact sub-grid wall
        # distances instead of the mask-SDF approximation
        self.geoms: List[Dict[str, Any]] = []

    def reset(self) -> None:
        self.grid.fill(0)
        self.geoms = []

    def sample(self, v):
        return get_sampled_value(v, self.rng)

    def random_rotated_rect(self, bounds: Dict[str, int], size_cfg: Dict, angle_range):
        """Sample a rotated rect fully inside bounds; returns
        (points, w, geom). Callers that rasterize the points must also
        record ``geom`` via self.geoms.append (placement is caller-gated
        by the SDF/blockage validators)."""
        max_w = size_cfg["w"][1] if isinstance(size_cfg["w"], list) else size_cfg["w"]
        max_h = size_cfg["h"][1] if isinstance(size_cfg["h"], list) else size_cfg["h"]
        margin = int(np.hypot(max_w, max_h) / 2) + 2
        x_min = bounds["min_x"] + margin
        x_max = max(x_min, bounds["max_x"] - margin)
        y_min = bounds["min_y"] + margin
        y_max = max(y_min, bounds["max_y"] - margin)
        cx = self.sample([x_min, x_max])
        cy = self.sample([y_min, y_max])
        w = self.sample(size_cfg["w"])
        h = self.sample(size_cfg["h"])
        angle = self.sample(angle_range)
        geom = {"shape": "rect", "cx": float(cx), "cy": float(cy),
                "w": float(w), "h": float(h), "angle_deg": float(angle)}
        return rect_points(cx, cy, w, h, angle), w, geom

    def place_shape(self, shape_type: str, cx, cy, size, angle, orientation=None):
        if shape_type == "circle":
            add_circle(self.grid, cx, cy, size)
            self.geoms.append({"shape": "cylinder", "cx": float(cx),
                               "cy": float(cy), "r": float(size)})
        elif shape_type == "square":
            add_rotated_rect(self.grid, cx, cy, size * 2, size * 2, angle)
            self.geoms.append({"shape": "rect", "cx": float(cx),
                               "cy": float(cy), "w": float(size * 2),
                               "h": float(size * 2),
                               "angle_deg": float(angle)})
        elif shape_type == "triangle":
            orient = orientation or "vertex_left"
            add_triangle(self.grid, cx, cy, size, angle, orient)
            self.geoms.append({"shape": "triangle", "cx": float(cx),
                               "cy": float(cy), "size": float(size),
                               "angle_deg": float(angle),
                               "orientation": orient})
        else:
            raise ValueError(f"unknown shape {shape_type}")

    def drop_buffer_clipped_geoms(self, buf: int) -> int:
        """Drop recorded geoms whose analytic footprint reaches the cleared
        boundary-buffer columns; returns the number dropped.

        Generators wipe grid columns [0, buf) and [W-buf, W) AFTER placement,
        so a shape clipped by the wipe keeps a full analytic record that
        disagrees with the mask near the clip plane -- Bouzidi q planes there
        would derive from a surface that no longer exists. Dropping the geom
        degrades that shape's remaining links to the mask-midpoint q = 0.5
        fallback (conservative and consistent with the mask) instead of a
        wrong sub-grid crossing. Extents are conservative bounding intervals
        (+1 px rasterization slack)."""
        if buf <= 0 or not self.geoms:
            return 0

        def x_extent(g) -> Tuple[float, float]:
            if g["shape"] == "cylinder":
                return g["cx"] - g["r"], g["cx"] + g["r"]
            if g["shape"] == "rect":
                th = np.deg2rad(g["angle_deg"])
                hx = (abs(g["w"] * np.cos(th)) + abs(g["h"] * np.sin(th))) / 2.0
                return g["cx"] - hx, g["cx"] + hx
            if g["shape"] == "triangle":
                r = g["size"]  # circumradius (shapes.triangle_points_f)
                return g["cx"] - r, g["cx"] + r
            return -np.inf, np.inf  # unknown shape: never keep silently

        lo_edge = buf + 1  # +1 px slack vs integer rasterization
        hi_edge = self.W - buf - 1
        kept = [
            g for g in self.geoms
            if x_extent(g)[0] >= lo_edge and x_extent(g)[1] <= hi_edge
        ]
        dropped = len(self.geoms) - len(kept)
        self.geoms = kept
        return dropped

    def geometry(self, dx: float = 0.0, dy: float = 0.0) -> Optional[Dict[str, Any]]:
        """Union geometry of all placed shapes, translated by (dx, dy)
        (the mask-embedding pad offsets); None when nothing was placed."""
        if not self.geoms:
            return None
        parts = []
        for g in self.geoms:
            g = dict(g)
            g["cx"] = g["cx"] + dx
            g["cy"] = g["cy"] + dy
            parts.append(g)
        return {"shape": "union", "parts": parts}


class HybridMapGenerator(_ShapePlacer):
    """Pinball triad + tube bank + step/urban sections on one grid."""

    def __init__(self, config: Dict[str, Any], rng: Optional[random.Random] = None):
        super().__init__(config["domain"]["width"], config["domain"]["height"], rng)
        self.config = config

    def _pinball(self) -> None:
        cfg = self.config["pinball"]
        if not cfg.get("enable", True):
            return
        shape = self.sample(cfg["shape"])
        cx = int(self.W * self.sample(cfg["center_x_ratio"]))
        cy = int(self.H * self.sample(cfg["center_y_ratio"]))
        size = int(self.H * self.sample(cfg["size_ratio"]))
        spacing = int(size * self.sample(cfg["spacing_factor"]))
        for px, py in [
            (cx - spacing, cy),
            (cx + spacing, cy + spacing),
            (cx + spacing, cy - spacing),
        ]:
            angle = self.sample(cfg.get("rotation_angle", 0)) if shape != "circle" else 0
            orient = (
                self.sample(cfg.get("triangle_orientation", "vertex_left"))
                if shape == "triangle"
                else None
            )
            self.place_shape(shape, px, py, size, angle, orient)

    def _tube_bank(self) -> None:
        cfg = self.config["tube_bank"]
        if not cfg.get("enable", True):
            return
        shape = self.sample(cfg["shape"])
        layout = self.sample(cfg["layout"])
        start_x = int(self.W * self.sample(cfg["start_x_ratio"]))
        end_x = int(self.W * self.sample(cfg["end_x_ratio"]))
        size = int(self.H * self.sample(cfg["size_ratio"]))
        cols = self.sample(cfg["num_cols"])
        rows = self.sample(cfg["num_rows"])
        col_spacing = (end_x - start_x) // cols if cols else 0
        row_spacing = self.H // (rows + 1) if rows else 0
        jitter = cfg.get("jitter_amount", [0, 0])
        for c in range(cols):
            offset_y = row_spacing // 2 if (layout == "staggered" and c % 2 == 1) else 0
            for r in range(rows):
                cx = start_x + c * col_spacing + self.sample(jitter)
                cy = row_spacing * (r + 1) + offset_y + self.sample(jitter)
                if not (size < cy < self.H - size):
                    continue
                angle = self.sample(cfg.get("rotation_angle", 0)) if shape != "circle" else 0
                orient = (
                    self.sample(cfg.get("triangle_orientation", "vertex_left"))
                    if shape == "triangle"
                    else None
                )
                self.place_shape(shape, cx, cy, size, angle, orient)

    def _step_urban(self) -> float:
        cfg = self.config["step_urban"]
        if not cfg.get("enable_step", True):
            return 0.0
        step_x = int(self.W * self.sample(cfg["step_start_ratio"]))
        step_h = int(self.H * self.sample(cfg["step_height_ratio"]))
        step_w = int(self.W * self.sample(cfg["step_width_ratio"]))
        add_rotated_rect(self.grid, step_x + step_w / 2, step_h / 2, step_w, step_h, 0)
        self.geoms.append({"shape": "rect", "cx": step_x + step_w / 2.0,
                           "cy": step_h / 2.0, "w": float(step_w),
                           "h": float(step_h), "angle_deg": 0.0})

        block_start = int(self.W * self.sample(cfg["block_start_ratio"]))
        bounds = {
            "min_x": max(block_start, step_x + step_w + 20),
            "max_x": int(self.W * self.sample(cfg["block_end_ratio"])),
            "min_y": 0,
            "max_y": self.H,
        }
        rect_count = self.sample(cfg["rect_count"])
        angle_range = self.sample(cfg["rotate_angle_max"])
        placed: List[float] = []
        for _ in range(cfg["max_attempts"]):
            if len(placed) >= rect_count:
                break
            pts, w, geom = self.random_rotated_rect(
                bounds, cfg["rect_size"], angle_range
            )
            if check_sdf_validity(
                self.grid, pts, self.sample(cfg["min_distance"])
            ) and check_blockage_ratio(self.grid, pts, self.sample(cfg["max_blockage_ratio"])):
                fill_polygon(self.grid, pts)
                self.geoms.append(geom)
                placed.append(w)
        return float(max([step_w] + placed)) if (placed or step_w) else 0.0

    def generate(self) -> float:
        """Build one mask; returns the max feature length (filename tag)."""
        self.reset()
        self._pinball()
        self._tube_bank()
        max_len = self._step_urban()
        buf = self.config["validation"]["boundary_buffer"]
        self.grid[:, :buf] = 0
        self.grid[:, -buf:] = 0
        self.drop_buffer_clipped_geoms(buf)
        return max_len


class UrbanMapGenerator(_ShapePlacer):
    """Rotated-rect building field only (reference urban_map_generator.py)."""

    def __init__(self, config: Dict[str, Any], rng: Optional[random.Random] = None):
        super().__init__(config["domain"]["width"], config["domain"]["height"], rng)
        self.config = config

    def generate_pure_urban(self) -> float:
        self.reset()
        cfg = self.config["step_urban"]
        bounds = {
            "min_x": int(self.W * self.sample(cfg["block_start_ratio"])),
            "max_x": int(self.W * self.sample(cfg["block_end_ratio"])),
            "min_y": 0,
            "max_y": self.H,
        }
        rect_count = self.sample(cfg["rect_count"])
        angle_range = self.sample(cfg["rotate_angle_max"])
        placed: List[float] = []
        for _ in range(cfg.get("max_attempts", 200)):
            if len(placed) >= rect_count:
                break
            pts, w, geom = self.random_rotated_rect(
                bounds, cfg["rect_size"], angle_range
            )
            if check_sdf_validity(
                self.grid, pts, self.sample(cfg["min_distance"])
            ) and check_blockage_ratio(self.grid, pts, self.sample(cfg["max_blockage_ratio"])):
                fill_polygon(self.grid, pts)
                self.geoms.append(geom)
                placed.append(w)
        buf = self.config["validation"]["boundary_buffer"]
        self.grid[:, :buf] = 0
        self.grid[:, -buf:] = 0
        self.drop_buffer_clipped_geoms(buf)
        return float(max(placed)) if placed else 1.0


class RectMaskGenerator(_ShapePlacer):
    """Physics-constrained random rects + left alignment to the inlet buffer
    (reference mask_rect_gen.py semantics, including the post-generation
    shift that puts the leftmost solid pixel exactly at buffer_left)."""

    def __init__(
        self,
        width: int,
        height: int,
        rect_size: Dict[str, int],
        buffers: Dict[str, int],
        min_distance: float = 30,
        max_blockage: float = 0.8,
        rotate_angle_max: float = 80,
        max_attempts: int = 200,
        rng: Optional[random.Random] = None,
    ):
        super().__init__(width, height, rng)
        self.rect_size = rect_size
        self.buffers = buffers
        self.min_distance = min_distance
        self.max_blockage = max_blockage
        self.rotate_angle_max = rotate_angle_max
        self.max_attempts = max_attempts

    def _sample_rect(self):
        max_diag = np.hypot(self.rect_size["MAX_W"], self.rect_size["MAX_H"])
        margin = int(max_diag / 2) + 10
        x_min = self.buffers["LEFT"] + margin
        x_max = self.W - self.buffers["RIGHT"] - margin
        y_min = self.buffers["TOP"] + margin
        y_max = self.H - self.buffers["BOTTOM"] - margin
        if x_max <= x_min or y_max <= y_min:
            raise ValueError("Buffer settings too large for the domain")
        cx = self.rng.randint(x_min, x_max)
        cy = self.rng.randint(y_min, y_max)
        w = self.rng.randint(self.rect_size["MIN_W"], self.rect_size["MAX_W"])
        h = self.rng.randint(self.rect_size["MIN_H"], self.rect_size["MAX_H"])
        angle = self.rng.uniform(-self.rotate_angle_max, self.rotate_angle_max)
        geom = {"shape": "rect", "cx": float(cx), "cy": float(cy),
                "w": float(w), "h": float(h), "angle_deg": float(angle)}
        return rect_points(cx, cy, w, h, angle), w, geom

    def _align_left(self) -> None:
        cols = np.where(self.grid.any(axis=0))[0]
        if len(cols) == 0:
            return
        shift = int(cols[0]) - self.buffers["LEFT"]
        if shift <= 0:
            return
        self.grid[:, :-shift] = self.grid[:, shift:]
        self.grid[:, -shift:] = 0
        for g in self.geoms:  # the analytic shapes move with the pixels
            g["cx"] -= shift

    def generate_sample(self, n_rects: int) -> np.ndarray:
        self.reset()
        added = attempts = 0
        while added < n_rects and attempts < self.max_attempts:
            attempts += 1
            pts, _, geom = self._sample_rect()
            if not check_sdf_validity(self.grid, pts, self.min_distance):
                continue
            if not check_blockage_ratio(self.grid, pts, self.max_blockage):
                continue
            fill_polygon(self.grid, pts)
            self.geoms.append(geom)
            added += 1
        if added:
            self._align_left()
        return self.grid.copy()


# ---------------------------------------------------------------------------
# metadata.json contract (input to config_batch_gen)
# ---------------------------------------------------------------------------


def metadata_entry(
    file_name: str,
    nx: int,
    ny: int,
    pad_left: int,
    pad_right: int,
    pad_top: int,
    pad_bot: int,
    m_per_px: Optional[float] = None,
    obstacle_geometry: Optional[Dict[str, Any]] = None,
) -> Dict[str, Any]:
    entry: Dict[str, Any] = {
        "file_name": file_name,
        "domain_W_total": int(nx),
        "domain_H_total": int(ny),
        "pad_left": int(pad_left),
        "pad_right": int(pad_right),
        "pad_top": int(pad_top),
        "pad_bot": int(pad_bot),
    }
    if m_per_px is not None:
        entry["m_per_px"] = float(m_per_px)
    if obstacle_geometry is not None:
        # analytic shape list in final (padded-domain) coordinates; lets a
        # bouzidi-obstacle template derive exact sub-grid wall distances
        # (core/solver.bouzidi_q_planes) instead of mask-SDF approximations
        entry["obstacle_geometry"] = obstacle_geometry
    return entry


def write_metadata(entries: List[Dict[str, Any]], mask_dir: str) -> str:
    path = os.path.join(mask_dir, "metadata.json")
    os.makedirs(mask_dir, exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        json.dump(entries, fh, indent=2)
    return path


def generate_mask_set(
    master_config: Dict[str, Any],
    out_dir: str,
    num_maps: int,
    mode: str = "hybrid",
    seed: Optional[int] = None,
    m_per_px: Optional[float] = None,
) -> List[str]:
    """Generate ``num_maps`` masks + metadata.json + map_gen_config.json."""
    rng = random.Random(seed)
    gen_cfg = master_config["map_generator"]
    pads = gen_cfg.get(
        "padding", {"left": 256, "right": 640, "top": 192, "bot": 192}
    )

    os.makedirs(out_dir, exist_ok=True)
    with open(os.path.join(out_dir, "map_gen_config.json"), "w") as fh:
        json.dump(gen_cfg, fh, indent=4)

    entries: List[Dict[str, Any]] = []
    files: List[str] = []
    for i in range(num_maps):
        if mode == "hybrid":
            g = HybridMapGenerator(gen_cfg, rng)
            l_char = g.generate()
            core = g.grid
            stem = f"L{int(l_char)}_{i:04d}"
        elif mode == "urban":
            g = UrbanMapGenerator(gen_cfg, rng)
            l_char = g.generate_pure_urban()
            core = g.grid
            stem = f"Urban_{int(l_char)}_{i:04d}"
        else:
            raise ValueError(f"unknown mode {mode}")

        # Embed the core region into the padded simulation domain and record
        # the pads -- this is the metadata contract the reference gets from
        # its external GIS pipeline.
        h, w = core.shape
        ny = h + pads["top"] + pads["bot"]
        nx = w + pads["left"] + pads["right"]
        # grow the outlet-side sponge padding (physically inert) so nx is a
        # multiple of 128 and ny a multiple of 8: the JAX package's rule,
        # kept so both packages generate the same project from the same
        # master config (the production grid 2432x1152 comes from it)
        pad_r = pads["right"] + (-nx) % 128
        pad_t = pads["top"] + (-ny) % 8
        ny = h + pad_t + pads["bot"]
        nx = w + pads["left"] + pad_r
        full = np.zeros((ny, nx), np.uint8)
        full[pads["bot"] : pads["bot"] + h, pads["left"] : pads["left"] + w] = core

        fname = f"{stem}.png"
        _save_mask_png(full, os.path.join(out_dir, fname), invert_values=True)
        entries.append(
            metadata_entry(
                fname, nx, ny, pads["left"], pad_r, pad_t, pads["bot"],
                m_per_px,
                obstacle_geometry=g.geometry(
                    dx=pads["left"], dy=pads["bot"]
                ),
            )
        )
        files.append(fname)

    write_metadata(entries, out_dir)
    return files
