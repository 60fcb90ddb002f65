"""ML feature-vector NPZ builder.

Parity target: reference io/case_vector_builder.py -- fixed 21-feature schema,
NaN rows for non-Success cases, arrays {vectors, case_names, statuses,
feature_names} in one compressed NPZ.
"""

from __future__ import annotations

import json
import os
import threading
from typing import Dict, List

import numpy as np

# Byte-identical to reference io/case_vector_builder.py:27-52 -- downstream
# consumers key on these names, so they are a contract, not a style choice.
FEATURE_NAMES: List[str] = [
    # lattice_inputs
    "lat_rho_in",
    "lat_rho_out",
    "lat_characteristic_length_px",
    "lat_inlet_velocity_lu",
    "lat_kinematic_viscosity_lu",
    "lat_nx",
    "lat_ny",
    # simulation_outputs
    "sim_actual_reynolds_number",
    "sim_total_steps_executed",
    "sim_tensor_T",
    "sim_tensor_C",
    "sim_tensor_H",
    "sim_tensor_W",
    # physical_scaled
    "phys_reynolds_number",
    "phys_characteristic_length_m",
    "phys_inlet_velocity_ms",
    "phys_kinematic_viscosity_m2s",
    "phys_cell_size_m",
    "phys_time_step_s",
    "phys_steps_per_second",
    "phys_total_simulation_time_s",
]
D = len(FEATURE_NAMES)


def _safe_float(value, fallback: float = np.nan) -> float:
    if value is None:
        return fallback
    try:
        return float(value)
    except (ValueError, TypeError):
        return fallback


def _extract_vector(entry: Dict) -> np.ndarray:
    params = entry.get("parameters", {})
    lat = params.get("lattice_inputs", {})
    sim = params.get("simulation_outputs", {})
    phys = params.get("physical_scaled", {})
    res = lat.get("resolution_px") or [np.nan, np.nan]
    turb = (sim.get("tensor_shapes") or {}).get("turbulence") or [np.nan] * 4
    turb = list(turb) + [np.nan] * (4 - len(turb))
    values = [
        _safe_float(lat.get("rho_in")),
        _safe_float(lat.get("rho_out")),
        _safe_float(lat.get("characteristic_length_px")),
        _safe_float(lat.get("inlet_velocity_lu")),
        _safe_float(lat.get("kinematic_viscosity_lu")),
        _safe_float(res[0] if len(res) > 0 else np.nan),
        _safe_float(res[1] if len(res) > 1 else np.nan),
        _safe_float(sim.get("actual_reynolds_number")),
        _safe_float(sim.get("total_steps_executed")),
        _safe_float(turb[0]),
        _safe_float(turb[1]),
        _safe_float(turb[2]),
        _safe_float(turb[3]),
        _safe_float(phys.get("reynolds_number_calculated")),
        _safe_float(phys.get("characteristic_length_m")),
        _safe_float(phys.get("inlet_velocity_ms")),
        _safe_float(phys.get("kinematic_viscosity_air_m2_s")),
        _safe_float(phys.get("cell_size_m")),
        _safe_float(phys.get("time_step_s")),
        _safe_float(phys.get("steps_per_physical_second")),
        _safe_float(phys.get("total_simulation_time_s")),
    ]
    return np.asarray(values, np.float32)


def build_npz(summary_json_path: str, npz_output_path: str) -> str:
    if not os.path.exists(summary_json_path):
        raise FileNotFoundError(f"Summary JSON not found: {summary_json_path}")
    with open(summary_json_path, "r", encoding="utf-8") as fh:
        summary_data = json.load(fh)
    if not summary_data:
        return ""

    n = len(summary_data)
    vectors = np.full((n, D), np.nan, np.float32)
    case_names = np.empty(n, dtype=object)
    statuses = np.empty(n, dtype=object)
    for idx, entry in enumerate(summary_data):
        case_names[idx] = entry.get("case_name", f"case_{idx:04d}")
        statuses[idx] = entry.get("status", "Unknown")
        if statuses[idx] == "Success":
            vectors[idx] = _extract_vector(entry)

    os.makedirs(os.path.dirname(npz_output_path) or ".", exist_ok=True)
    # write-temp-then-rename: several --coordinate workers finishing at once
    # each build the NPZ; writing the path itself, one truncated the file
    # while another wrote it, and a reader found a broken zip
    tmp = f"{npz_output_path}.{os.getpid()}.{threading.get_ident()}.tmp"
    with open(tmp, "wb") as fh:
        np.savez_compressed(
            fh,
            vectors=vectors,
            case_names=case_names,
            statuses=statuses,
            feature_names=np.array(FEATURE_NAMES, dtype=object),
        )
    os.replace(tmp, npz_output_path)
    return npz_output_path
