"""Lattice-unit parameter calculator CLI.

Role of the reference's notebooks/Re_calcu.ipynb + physics_utils.
print_reynolds_info: given rho_in/rho_out (or u), nu and L_char, print the
derived Bernoulli velocity, Mach number, tau, Re, and the feasibility gates.

Usage:
  python -m lbm2d_tpu_torch.tools.re_calc --rho_in 1.002 --nu 0.02 --l_char 150
  python -m lbm2d_tpu_torch.tools.re_calc -c master_config.yaml --l_min 50 --l_max 400
"""

from __future__ import annotations

import argparse
import math

from .configgen.constants import CS, MA_LIMIT, RE_MAX, TAU_MIN
from .configgen.feasibility import check_feasibility


def print_point(rho_in: float, rho_out: float, nu: float, l_char: int) -> None:
    d = rho_in - rho_out
    u = math.sqrt(2.0 / 3.0 * d) if d > 1e-9 else 0.01
    ma = u / CS
    tau = 3.0 * nu + 0.5
    re = u * l_char / nu if nu > 0 else float("inf")
    ok, reason = check_feasibility(rho_in, rho_out, nu, l_char)
    print("=" * 48)
    print("  LATTICE PARAMETER CALCULATOR")
    print("=" * 48)
    print(f"rho_in / rho_out : {rho_in:.5f} / {rho_out:.5f}")
    print(f"u_bernoulli      : {u:.5f} lu/step")
    print(f"Mach number      : {ma:.4f}  (limit {MA_LIMIT})")
    print(f"tau              : {tau:.4f}  (floor {TAU_MIN})")
    print(f"L_char           : {l_char} px")
    print(f"Reynolds number  : {re:.1f}  (cap {RE_MAX})")
    print(f"feasible         : {'YES' if ok else 'NO — ' + reason}")
    print("=" * 48)


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(description="Lattice Re/Ma/tau calculator.")
    ap.add_argument("-c", "--config", default=None, help="master config for a sweep")
    ap.add_argument("--rho_in", type=float, default=1.002)
    ap.add_argument("--rho_out", type=float, default=1.0)
    ap.add_argument("--nu", type=float, default=0.02)
    ap.add_argument("--l_char", type=int, default=150)
    ap.add_argument("--l_min", type=int, default=50)
    ap.add_argument("--l_max", type=int, default=400)
    args = ap.parse_args(argv)

    if args.config:
        import yaml

        from .configgen.context import build_sim_context
        from .configgen.preview import print_re_preview

        with open(args.config, "r", encoding="utf-8") as fh:
            master = yaml.safe_load(fh)
        print_re_preview(build_sim_context(master), (args.l_min, args.l_max))
    else:
        print_point(args.rho_in, args.rho_out, args.nu, args.l_char)


if __name__ == "__main__":
    main()
