"""Feasible-nu filtering: 1/Re-weighted sampling and full expansion.

Parity targets: reference tools/config_utils/nu_sampler.py (weighted random
pick) and config_batch_gen._get_all_feasible_nu (all-nu expansion).
"""

from __future__ import annotations

import math
import random
from typing import Any, Dict, List, Optional, Tuple

from .feasibility import check_feasibility


def _bernoulli_u(rho_in: float, rho_out: float) -> float:
    d = rho_in - rho_out
    return math.sqrt(2.0 / 3.0 * d) if d > 1e-9 else 0.01


def get_all_feasible_nu(
    rho_in_case: float,
    rho_out: float,
    nu_lb_list: List[float],
    l_char: int,
    verbose: bool = True,
) -> List[Tuple[float, float]]:
    """All feasible (nu, Re) pairs, nu descending."""
    u_b = _bernoulli_u(rho_in_case, rho_out)
    feasible: List[Tuple[float, float]] = []
    for nu in sorted(nu_lb_list, reverse=True):
        ok, reason = check_feasibility(rho_in_case, rho_out, nu, l_char)
        if ok:
            feasible.append((nu, u_b * l_char / nu))
        elif verbose:
            print(f"    [skip nu={nu:.4f}] {reason}")
    return feasible


def fill_nu_sample(
    case_result: Dict[str, Any],
    mask_ctx: Dict[str, Any],
    sim_ctx: Dict[str, Any],
    rng: Optional[random.Random] = None,
) -> bool:
    """Pick one feasible nu with probability proportional to 1/Re, drawn
    from ``rng`` (a fresh generator when None)."""
    r = rng or random.Random()
    rho_in = case_result["rho_in_case"]
    rho_out = sim_ctx["rho_out"]
    l_char = mask_ctx["l_char"]

    pairs = get_all_feasible_nu(
        rho_in, rho_out, sorted(sim_ctx["nu_lb_list"]), l_char, verbose=False
    )
    if not pairs:
        return False
    feasible = sorted(nu for nu, _ in pairs)
    u = _bernoulli_u(rho_in, rho_out)
    re_vals = [u * l_char / nu for nu in feasible]
    weights = [1.0 / re for re in re_vals]
    total = sum(weights)
    probs = [w / total for w in weights]

    x = r.random()
    cum = 0.0
    chosen = feasible[-1]
    for nu, p in zip(feasible, probs):
        cum += p
        if x <= cum:
            chosen = nu
            break
    case_result["nu_lb"] = chosen
    case_result["nu_re_pairs"] = list(zip(feasible, re_vals))
    return True
