"""Derived physics + CTU-based step counts.

CTU = L_char / (U_STEP_FACTOR * u_bernoulli); warmup/max/start_record steps
are passes x steps_per_ctu; the save interval is steps_per_ctu /
saves_per_ctu (reference tools/config_utils/steps_calc.py:14-77).
"""

from __future__ import annotations

import math
from typing import Any, Dict

from .constants import CS, U_STEP_FACTOR


def fill_physics_and_steps(
    case_result: Dict[str, Any], mask_ctx: Dict[str, Any], sim_ctx: Dict[str, Any]
) -> None:
    rho_in = case_result["rho_in_case"]
    rho_out = sim_ctx["rho_out"]
    nu_lb = case_result["nu_lb"]
    l_char = mask_ctx["l_char"]

    delta_rho = rho_in - rho_out
    u_b = math.sqrt((2.0 / 3.0) * delta_rho) if delta_rho > 1e-9 else 0.01
    ma = u_b / CS
    tau = 3.0 * nu_lb + 0.5
    re = u_b * l_char / nu_lb

    vel_scale = sim_ctx["U_phys"] / u_b if u_b > 1e-9 else 0
    denom = vel_scale * nu_lb
    dx_mm = (sim_ctx["nu_air"] / denom) * 1000 if denom > 1e-9 else 0

    u_conservative = u_b * U_STEP_FACTOR
    steps_per_ctu = max(1, int(l_char / u_conservative))

    case_result.update(
        {
            "u_bernoulli": u_b,
            "Ma": ma,
            "Re": re,
            "tau": tau,
            "dx_mm": dx_mm,
            "steps_per_ctu": steps_per_ctu,
            "warmup_steps": int(sim_ctx["warmup_passes"] * steps_per_ctu),
            "max_steps": int(sim_ctx["total_passes"] * steps_per_ctu),
            "start_record_step": int(sim_ctx["start_record_passes"] * steps_per_ctu),
            "interval": max(1, int(steps_per_ctu / sim_ctx["saves_per_ctu"])),
        }
    )
