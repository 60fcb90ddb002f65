"""Re-preview tables and batch summaries (reference config_utils/preview.py).

Text-only helpers; no side effects beyond printing.
"""

from __future__ import annotations

import math
from typing import Any, Dict, Tuple

from .constants import CS, MA_LIMIT, RE_MAX, TAU_MIN


def print_re_preview(sim_ctx: Dict[str, Any], l_range: Tuple[int, int]) -> None:
    rho_in, rho_out = sim_ctx["rho_in"], sim_ctx["rho_out"]
    d = rho_in - rho_out
    u_b = math.sqrt(2.0 / 3.0 * d) if d > 1e-9 else 0.01
    ma = u_b / CS
    l_min, l_max = l_range
    print("=" * 64)
    print(f"[Preview] u_bernoulli={u_b:.5f} lu/step  Ma={ma:.4f} (limit {MA_LIMIT})")
    print(f"[Preview] L_char range: {l_min} .. {l_max} px")
    print(f"{'nu':>8} {'tau':>8} {'Re@Lmin':>10} {'Re@Lmax':>10} feasible")
    for nu in sorted(sim_ctx["nu_lb_list"], reverse=True):
        tau = 3 * nu + 0.5
        re_min = u_b * l_min / nu
        re_max = u_b * l_max / nu
        ok = tau >= TAU_MIN and re_max <= RE_MAX and ma <= MA_LIMIT
        print(f"{nu:8.4f} {tau:8.4f} {re_min:10.0f} {re_max:10.0f} {'yes' if ok else 'NO'}")
    print("=" * 64)


def print_summary(
    sim_ctx: Dict[str, Any], total_success: int, total_skipped: int, l_min: int, l_max: int
) -> None:
    print("=" * 64)
    print(f"[Done] project={sim_ctx['project_name']}")
    print(f"  configs generated : {total_success}")
    print(f"  masks skipped     : {total_skipped}")
    print(f"  L_char range      : {l_min} .. {l_max} px")
    print(f"  output dir        : {sim_ctx['output_dir']}")
    print("=" * 64)
