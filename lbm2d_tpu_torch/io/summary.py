"""Legacy all_cases_summary.json writer + structured summary entry builder.

Parity targets: reference io/batch_io.py (update keyed by case_name) and
pipeline/summary_builder.py (entry schema with lattice_inputs /
simulation_outputs / physical_scaled / run_summary / source_files).
"""

from __future__ import annotations

import os
from typing import Any, Dict, List

from .json_utils import file_lock, read_json, write_json_atomic


def save_summary_file(summary_data: List[Dict], output_path: str) -> None:
    write_json_atomic(summary_data, output_path, indent=4)


def init_summary_file(output_path: str) -> None:
    save_summary_file([], output_path)


def update_summary_file(summary_entry: Dict, output_path: str) -> None:
    """Append or replace the entry with the same case_name. The lock makes
    the read-modify-write safe under concurrent batch workers."""
    with file_lock(output_path):
        data = read_json(output_path, default=[]) or []
        target = summary_entry.get("case_name")
        for i, entry in enumerate(data):
            if entry.get("case_name") == target:
                data[i] = summary_entry
                break
        else:
            data.append(summary_entry)
        save_summary_file(data, output_path)


def build_summary_entry(
    config: Dict[str, Any],
    lattice_metadata: Dict[str, Any],
    physical_params: Dict[str, Any],
    source_files: Dict[str, Any],
) -> Dict[str, Any]:
    sim = config.get("simulation", {})
    lat_in = {
        "target_rho_in": config.get("outputs", {}).get("target_rho_in"),
        "rho_in": sim.get("rho_in"),
        "rho_out": sim.get("rho_out"),
        "characteristic_length_px": sim.get("characteristic_length"),
        "inlet_velocity_lu": round(lattice_metadata.get("u_inlet_lattice_lu", 0.0), 6),
        "kinematic_viscosity_lu": round(sim.get("nu", 0.0), 6),
        "resolution_px": [sim.get("nx"), sim.get("ny")],
    }
    sim_out = {
        "actual_reynolds_number": round(
            lattice_metadata.get("reynolds_number_lattice_actual", 0), 2
        ),
        "total_steps_executed": lattice_metadata.get("total_steps_executed"),
        "tensor_shapes": {
            "static_mask": lattice_metadata.get("tensor_shape_static_mask"),
            "turbulence": lattice_metadata.get("tensor_shape_turbulence"),
        },
    }
    p = physical_params
    phys_scaled = {
        "reynolds_number_calculated": round(p.get("reynolds_number_calculated", 0), 2),
        "characteristic_length_m": f'{p.get("characteristic_length_m", 0):.4e}',
        "inlet_velocity_ms": round(p.get("inlet_velocity_ms", 0), 2),
        "kinematic_viscosity_air_m2_s": f'{p.get("kinematic_viscosity_air_m2_s", 0):.2e}',
        "cell_size_m": f'{p.get("cell_size_m", 0):.4e}',
        "time_step_s": f'{p.get("time_step_s", 0):.4e}',
        "steps_per_physical_second": f'{p.get("steps_per_physical_second", 0):.4e}',
        "total_simulation_time_s": f'{p.get("total_simulation_time_s", 0):.4e}',
    }
    return {
        "case_name": sim.get("name", "UnknownCase"),
        "status": "Success",
        "parameters": {
            "lattice_inputs": lat_in,
            "simulation_outputs": sim_out,
            "physical_scaled": phys_scaled,
        },
        "run_summary": {
            "h5_file": lattice_metadata.get("h5_file"),
            "video_file": lattice_metadata.get("video_file"),
        },
        "source_files": source_files,
    }
