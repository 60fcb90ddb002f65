"""Blockage-aware rho_in reduction.

The gap (Venturi) velocity u_gap = u_inlet / open_fraction must stay below
U_GAP_MAX, so the driving pressure difference is capped at
delta_rho_safe = 1.5 * (U_GAP_MAX * open_fraction)^2
(reference tools/config_utils/blockage_adjuster.py:16-33).
"""

from __future__ import annotations

from typing import Any, Dict

from .constants import MIN_OPEN, U_GAP_MAX


def fill_blockage_adj(
    case_result: Dict[str, Any], mask_ctx: Dict[str, Any], sim_ctx: Dict[str, Any]
) -> None:
    open_fraction = max(MIN_OPEN, 1.0 - mask_ctx["max_blockage"])
    u_inlet_safe = U_GAP_MAX * open_fraction
    delta_rho_safe = 1.5 * u_inlet_safe**2
    case_result["rho_in_case"] = min(
        sim_ctx["rho_in"], sim_ctx["rho_out"] + delta_rho_safe
    )
    case_result["u_inlet_safe"] = u_inlet_safe
    case_result["open_fraction"] = open_fraction
