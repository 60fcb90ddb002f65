"""Mask-generation CLI (hybrid / urban / rect modes).

Replaces the reference's three standalone scripts (hybrid_map_gen.py,
urban_map_generator.py, mask_rect_gen.py) with one entry point, and -- unlike
the reference -- also writes masks/metadata.json so config_batch_gen is fully
self-contained.

Usage:
  python -m lbm2d_tpu_torch.tools.gen_masks -c master_config.yaml -n 20 --mode hybrid
  python -m lbm2d_tpu_torch.tools.gen_masks --mode rect -n 4 --out some/dir
"""

from __future__ import annotations

import argparse
import os

import yaml

from .map_generators import (
    RectMaskGenerator,
    _save_mask_png,
    generate_mask_set,
    metadata_entry,
    write_metadata,
)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Generate procedural obstacle masks.")
    ap.add_argument("-c", "--config", default="master_config.yaml")
    ap.add_argument("-n", "--num_maps", type=int, default=20)
    ap.add_argument("--mode", choices=["hybrid", "urban", "rect"], default="hybrid")
    ap.add_argument("--seed", type=int, default=None)
    ap.add_argument("--out", default=None, help="override output mask dir")
    ap.add_argument("--m_per_px", type=float, default=None)
    args = ap.parse_args(argv)

    with open(args.config, "r", encoding="utf-8") as fh:
        master = yaml.safe_load(fh)

    project = master["settings"]["project_name"]
    out_dir = args.out or os.path.join("SimCases", project, "masks")

    if args.mode in ("hybrid", "urban"):
        files = generate_mask_set(
            master, out_dir, args.num_maps, mode=args.mode, seed=args.seed,
            m_per_px=args.m_per_px,
        )
        print(f"[Done] {len(files)} masks + metadata.json -> {out_dir}")
        return

    # rect mode: physics-constrained rotated rectangles
    rc = master.get("rect_generator", {})
    import random

    rng = random.Random(args.seed)
    gen = RectMaskGenerator(
        width=rc.get("nx", 2048),
        height=rc.get("ny", 1024),
        rect_size=rc.get(
            "rect_size", {"MIN_W": 10, "MAX_W": 400, "MIN_H": 10, "MAX_H": 400}
        ),
        buffers=rc.get(
            "buffers", {"TOP": 128, "BOTTOM": 128, "LEFT": 128, "RIGHT": 512}
        ),
        min_distance=rc.get("min_distance", 30),
        max_blockage=rc.get("max_blockage_ratio", 0.8),
        rotate_angle_max=rc.get("rotate_angle_max", 80),
        max_attempts=rc.get("max_attempts", 200),
        rng=rng,
    )
    entries = []
    for i in range(args.num_maps):
        grid = gen.generate_sample(rc.get("rect_count", 100))
        fname = f"mask_rect_{i:04d}.png"
        _save_mask_png(grid, os.path.join(out_dir, fname), invert_values=True)
        b = gen.buffers
        entries.append(
            metadata_entry(
                fname, gen.W, gen.H, b["LEFT"], b["RIGHT"], b["TOP"], b["BOTTOM"],
                args.m_per_px,
            )
        )
    write_metadata(entries, out_dir)
    print(f"[Done] {args.num_maps} rect masks + metadata.json -> {out_dir}")


if __name__ == "__main__":
    main()
