"""One-case orchestration: resolve paths -> run -> assemble summary entry.

Counterpart of ``lbm2d_tpu/pipeline/case_executor.py`` (reference
pipeline/case_executor.py). Raises only when ``device`` is unusable; every
other exception becomes a Failed entry, and partial .h5/.mp4 outputs are
deleted on failure.
"""

from __future__ import annotations

import glob
import os
from typing import Any, Dict

from ..core.engine import resolve_device
from ..io.summary import build_summary_entry
from ..utils.config import load_config
from ..utils.scaling import calculate_physical_params
from . import run_one_case


def _cleanup_failed_outputs(h5_path: str, video_path: str) -> None:
    for path in (h5_path, video_path):
        if not path:
            continue
        for fpath in [path] + glob.glob(path + ".*"):
            if os.path.isfile(fpath):
                try:
                    os.remove(fpath)
                except OSError:
                    pass


def execute_case(
    full_config_path: str,
    project_paths: Dict[str, str],
    output_dirs: Dict[str, str],
    job_id: int,
    progress: bool = True,
    device_resize: bool = False,
    device="cuda",
    spatial_mesh=None,
) -> Dict[str, Any]:
    resolve_device(device)  # a missing GPU is a set-up error, not a case failure
    h5_path = ""
    video_path = ""
    sim_name = os.path.basename(full_config_path)
    try:
        config = load_config(full_config_path)
        mask_path_cfg = config.get("mask", {}).get("path", "")
        sim_name = config.get("simulation", {}).get("name", sim_name)
        cfg_filename = os.path.basename(full_config_path)

        mask_path = os.path.join(project_paths["masks"], os.path.basename(mask_path_cfg))
        if not os.path.exists(mask_path):
            raise FileNotFoundError(f"Mask file not found: {mask_path}")

        h5_path = os.path.join(output_dirs["raw"], f"{sim_name}.h5")
        video_path = os.path.join(output_dirs["vis"], f"{sim_name}.mp4")

        lattice_metadata = run_one_case.main(
            full_config_path, mask_path, h5_path, video_path,
            progress=progress, device_resize=device_resize, device=device,
            spatial_mesh=spatial_mesh,
        )
        if lattice_metadata.get("status") != "Success":
            raise RuntimeError(f"Simulation failed: {lattice_metadata.get('reason')}")

        sim_out = {
            "actual_reynolds_number": round(
                lattice_metadata.get("reynolds_number_lattice_actual", 0.0), 4
            ),
            "total_steps_executed": lattice_metadata.get("total_steps_executed"),
            "tensor_shapes": {
                "static_mask": lattice_metadata.get("tensor_shape_static_mask"),
                "turbulence": lattice_metadata.get("tensor_shape_turbulence"),
            },
        }
        physical_params = calculate_physical_params(config, lattice_metadata)
        source_files = {
            "config_file": cfg_filename,
            "mask_file": os.path.basename(mask_path),
        }
        entry = build_summary_entry(
            config, lattice_metadata, physical_params, source_files
        )
        entry.setdefault("parameters", {})["simulation_outputs"] = sim_out
        entry["config_filename"] = cfg_filename
        return entry
    except Exception as exc:
        if h5_path or video_path:
            _cleanup_failed_outputs(h5_path, video_path)
        return {
            "case_name": sim_name,
            "config_filename": os.path.basename(full_config_path),
            "status": "Failed",
            "reason": str(exc),
        }
