"""Two-pass HDF5 -> normalized Zarr dataset converter (copy of
``lbm2d_tpu/post/h5_to_zarr.py``: the same HDF5 files give the same output
directory, byte for byte).

Parity target: reference src/post_process/h5_to_zarr_pipeline.py.
Pass 1 streams per-channel global mean/std over all Success cases; pass 2
z-score-normalizes to float16 Zarr arrays (chunks (100, C, H, 64)) and
precomputes the three sampling-weight maps {vor, sdf, mix}; global_stats.json
records the normalization. Uses the self-contained zarr-v2 writer
(post/zarrlite.py) whose default codec is the reference's exact compressor
contract -- numcodecs ``blosc`` with cname zstd, clevel 5, BITSHUFFLE
(reference h5_to_zarr_pipeline.py:13-19) -- emitted as real c-blosc1 chunk
containers by post/bloscmini.py, since the environment provides no
zarr/numcodecs/blosc packages (zlib fallback if zstandard is also absent).

Usage:
  python -m lbm2d_tpu_torch.post.h5_to_zarr --project_name Urban-1
  python -m lbm2d_tpu_torch.post.h5_to_zarr --summary path.json --raw_dir d --out d2
"""

from __future__ import annotations

import argparse
import json
import os
from typing import Dict, List, Tuple

import numpy as np

from .zarrlite import ZarrGroup

CHUNK_T, CHUNK_W = 100, 64
SDF_SIGMA = 5.0


def _h5py():
    """h5py, imported at first use, so this module imports where h5py is
    missing (an ImportError names it when a call needs it)."""
    import h5py

    return h5py


def get_successful_cases(summary_json: str) -> List[Dict]:
    with open(summary_json, "r", encoding="utf-8") as fh:
        data = json.load(fh)
    return [c for c in data if c.get("status") == "Success" and "run_summary" in c]


def pass1_global_stats(cases: List[Dict], raw_dir: str) -> Tuple[np.ndarray, np.ndarray]:
    """Streaming per-channel mean/std over every frame of every case."""
    sum_x = np.zeros(9, np.float64)
    sum_x2 = np.zeros(9, np.float64)
    total = 0
    for case in cases:
        path = os.path.join(raw_dir, case["run_summary"]["h5_file"])
        # a missing file is skipped: h5py (and the in-memory stand-in of
        # tools/smoke_case) raise FileNotFoundError for it
        try:
            f = _h5py().File(path, "r")
        except FileNotFoundError:
            continue
        with f:
            turb = f["turbulence"]
            t_total, c, h, w = turb.shape
            for t in range(0, t_total, CHUNK_T):
                chunk = turb[t : min(t + CHUNK_T, t_total)].astype(np.float64)
                sum_x += chunk.sum(axis=(0, 2, 3))
                sum_x2 += (chunk**2).sum(axis=(0, 2, 3))
                total += chunk.shape[0] * h * w
    if total == 0:
        raise RuntimeError("no readable frames in any Success case")
    mean = sum_x / total
    std = np.sqrt(np.maximum(sum_x2 / total - mean**2, 1e-10))
    return mean, std


def convert_case(
    case: Dict, raw_dir: str, out_dir: str, mean: np.ndarray, std: np.ndarray
) -> str:
    path = os.path.join(raw_dir, case["run_summary"]["h5_file"])
    zarr_path = os.path.join(out_dir, f"{case['case_name']}.zarr")
    m_bc = mean.reshape(1, 9, 1, 1).astype(np.float32)
    s_bc = std.reshape(1, 9, 1, 1).astype(np.float32)

    with _h5py().File(path, "r") as h5f:
        root = ZarrGroup(zarr_path, overwrite=True)
        root.update_attrs(
            {
                "case_name": case["case_name"],
                "reynolds_number": case.get("parameters", {})
                .get("physical_scaled", {})
                .get("reynolds_number_calculated"),
            }
        )
        turb = h5f["turbulence"][:]  # [T, 9, H, W]
        t_total, c, h, w = turb.shape
        norm = ((turb.astype(np.float32) - m_bc) / s_bc).astype(np.float16)
        root.create_array("turbulence", norm, chunks=(CHUNK_T, c, h, CHUNK_W))

        mask = h5f["static_mask"][:]
        root.create_array("static_mask", mask, chunks=(2, h, CHUNK_W))

        m_vel = h5f["mean_vel_field"][:].astype(np.float32)
        m_vel_norm = (m_vel - mean.reshape(9, 1, 1)) / std.reshape(9, 1, 1)
        root.create_array(
            "mean_vel_field", m_vel_norm.astype(np.float16), chunks=(9, h, CHUNK_W)
        )

        sq = h5f["mean_vel_sq_field"][:]
        root.create_array(
            "mean_vel_sq_field", sq.astype(np.float16), chunks=(h, CHUNK_W)
        )

        # Precomputed sampling-weight maps for the downstream trainer:
        # vor = normalized mean |u|^2 (turbulence proxy); sdf = boundary
        # proximity exp(-|SDF|/sigma); mix = average of both.
        wgrp = root.create_group("sampling_weights")
        vor_w = sq.astype(np.float32)
        vor_w = (vor_w - vor_w.min()) / (vor_w.max() - vor_w.min() + 1e-6)
        sdf_w = np.exp(-np.abs(mask[1]).astype(np.float32) / SDF_SIGMA)
        mix_w = 0.5 * vor_w + 0.5 * sdf_w
        for name, data in (("vor", vor_w), ("sdf", sdf_w), ("mix", mix_w)):
            wgrp.create_array(name, data, chunks=(h, CHUNK_W), dtype=np.float32)
    return zarr_path


def run(summary_json: str, raw_dir: str, out_dir: str) -> Dict:
    _h5py()
    cases = get_successful_cases(summary_json)
    if not cases:
        raise RuntimeError("no successful cases found")
    mean, std = pass1_global_stats(cases, raw_dir)
    os.makedirs(out_dir, exist_ok=True)
    stats = {
        "mean": mean.tolist(),
        "std": std.tolist(),
        "cases": [c["case_name"] for c in cases],
    }
    with open(os.path.join(out_dir, "global_stats.json"), "w") as fh:
        json.dump(stats, fh, indent=4)
    for case in cases:
        convert_case(case, raw_dir, out_dir, mean, std)
    return stats


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="HDF5 -> normalized Zarr dataset.")
    ap.add_argument("--project_name", default=None)
    ap.add_argument("--summary", default=None)
    ap.add_argument("--raw_dir", default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if args.project_name:
        base = os.path.join("outputs", args.project_name)
        summary = args.summary or os.path.join(base, "plots", "all_cases_summary.json")
        raw_dir = args.raw_dir or os.path.join(base, "raw")
        out = args.out or os.path.join(base, "zarr")
    else:
        summary, raw_dir, out = args.summary, args.raw_dir, args.out
        if not all((summary, raw_dir, out)):
            ap.error("need --project_name or all of --summary/--raw_dir/--out")
    stats = run(summary, raw_dir, out)
    print(f"[Done] {len(stats['cases'])} cases -> {out}")


if __name__ == "__main__":
    main()
