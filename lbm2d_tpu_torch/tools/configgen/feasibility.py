"""Triple pre-flight feasibility gate: Mach, tau, Reynolds.

Pure function, (ok, reason) return (reference tools/config_utils/
feasibility.py:21-69). Rejects configs before any device time is spent.
"""

from __future__ import annotations

import math
from typing import Tuple

from .constants import CS, CS2, MA_LIMIT, RE_MAX, TAU_MIN


def check_feasibility(
    rho_in: float, rho_out: float, nu_lb: float, l_char: int
) -> Tuple[bool, str]:
    delta_rho = rho_in - rho_out
    u_b = math.sqrt((2.0 / 3.0) * delta_rho) if delta_rho > 0 else 0.0
    ma = u_b / CS
    tau = 3.0 * nu_lb + 0.5
    re = u_b * l_char / nu_lb if nu_lb > 0 else float("inf")

    if ma > MA_LIMIT:
        max_safe_drho = 1.5 * CS2 * MA_LIMIT**2
        return False, (
            f"Ma={ma:.4f} > {MA_LIMIT} (u={u_b:.5f} lu/step, drho={delta_rho:.5f}); "
            f"suggest rho_in <= {rho_out + max_safe_drho:.5f}"
        )
    if tau < TAU_MIN:
        return False, (
            f"tau={tau:.4f} < {TAU_MIN} (nu_lb={nu_lb:.5f}); "
            f"need nu_lb >= {(TAU_MIN - 0.5) / 3.0:.5f}"
        )
    if re > RE_MAX:
        return False, (
            f"Re={re:.0f} > RE_MAX={RE_MAX} "
            f"(nu={nu_lb:.4f}, L_char={l_char}px, u={u_b:.5f}); "
            "increase nu_lb or use a smaller-L_char mask"
        )
    return True, ""
