"""Lattice -> physical unit conversion (3-tier scaling, Tier-2 wind tunnel).

Parity target: reference utils/physics_scaling.py (calculate_physical_params:3).
velocity_scale = U_phys / u_lb; dx = nu_air / (velocity_scale * nu_lb);
dt = dx / velocity_scale; physical Re cross-check.
"""

from __future__ import annotations

from typing import Any, Dict


def calculate_physical_params(
    config: Dict[str, Any], lattice_metadata: Dict[str, Any]
) -> Dict[str, Any]:
    pc = config.get("physical_constants", {})
    u_lb = lattice_metadata.get("u_inlet_lattice_lu", 0) or 0
    nu_lb = lattice_metadata.get("nu_lattice_lu", 0) or 0
    l_lb = lattice_metadata.get("l_char_lattice_px", 0) or 0

    u_phys = pc.get("inlet_velocity_ms", 0)
    if isinstance(u_phys, (list, tuple)):
        u_phys = u_phys[0] if u_phys else 0
    nu_phys = pc.get("kinematic_viscosity_air_m2_s", 0)

    velocity_scale = u_phys / u_lb if u_lb > 1e-9 else 0
    denom = velocity_scale * nu_lb
    dx_phys = nu_phys / denom if denom > 1e-9 else 0
    dt_phys = dx_phys / velocity_scale if velocity_scale > 1e-9 else 0

    l_phys = l_lb * dx_phys
    re_calc = (u_phys * l_phys) / nu_phys if nu_phys > 1e-9 else 0
    steps_per_s = 1.0 / dt_phys if dt_phys > 1e-9 else 0
    total_time_s = lattice_metadata.get("total_steps_executed", 0) * dt_phys

    return {
        "reynolds_number_target": config.get("outputs", {}).get("target_re"),
        "reynolds_number_calculated": re_calc,
        "characteristic_length_m": l_phys,
        "inlet_velocity_ms": u_phys,
        "kinematic_viscosity_air_m2_s": nu_phys,
        "cell_size_m": dx_phys,
        "time_step_s": dt_phys,
        "steps_per_physical_second": steps_per_s,
        "total_simulation_time_s": total_time_s,
    }
