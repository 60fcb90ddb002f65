"""Cylinder-flow physics validation: drag/lift coefficients + Strouhal number.

Counterpart of ``lbm2d_tpu/analysis/dfg_validation.py`` on the port's
engine: on a CUDA device every chunk runs on the hand-written kernels
(``ops/cuda_step.run_chunk_cuda``: K1 with the cylinder's bounce-back
scheme, K2 with the profiled inlet), on the CPU the eager step.

The reference ships DFG-benchmark machinery (momentum-exchange force,
LBM2D_MRT_LES.py:588-641; Cd/Cl, physics_utils.py:112-126; Karman-street
sine fit, :128-161) but never ran a committed validation. This script runs a
cylinder channel case, records the force series, and reports Cd and the
Strouhal number from a sine fit of the lift -- the classic vortex-shedding
check (St ~ 0.19 around Re ~ 100-200 for an unconfined cylinder; higher with
channel blockage).

Usage:
  python -m lbm2d_tpu_torch.analysis.dfg_validation [--re 150] [--steps 40000]
  python -m lbm2d_tpu_torch.analysis.dfg_validation --mode dfg \
      --obstacle bounce_back_bouzidi --inlet nebb [--device cpu]
"""

from __future__ import annotations

import argparse
import json
import math
from typing import Dict

import numpy as np
import torch

from ..core import stability
from ..core.engine import LBMEngine
from ..core.solver import obstacle_force
from ..utils.physics import compute_coefficients, fit_sine_wave, strouhal_number


def cylinder_case(nx=800, ny=400, diameter=40, u_target=0.08, re=150.0):
    """Pressure-driven channel with one cylinder; nu set from the target Re.

    With free-slip walls the only momentum sink is the cylinder, so the
    steady velocity is set by drag balance, not Bernoulli:
    dp * H = 0.5 Cd u^2 D with dp = (rho_in - rho_out)/3. A Bernoulli-sized
    drive over-accelerates the channel until the stability breaker trips.
    """
    nu = u_target * diameter / re
    cd_est = 1.3
    rho_in = 1.0 + 3.0 * 0.5 * cd_est * u_target**2 * diameter / ny
    cfg = {
        "simulation": {
            "nx": nx, "ny": ny, "name": f"dfg_re{int(re)}", "nu": nu,
            "ghost_moments_s": 1.2, "characteristic_length": diameter,
            "rho_in": rho_in, "rho_out": 1.0,
            "smagorinsky_constant": 0.0,  # laminar benchmark: LES off
            "warmup_steps": 4000,
        },
        "boundary_condition": {
            "type": [0, 2, 1, 2],
            "value": [[0.05, 0.0]] + [[0.0, 0.0]] * 3,
        },
        "domain_zones": {
            "sponge_in": max(1, nx // 40), "sponge_out": max(1, nx // 10),
            "sponge_top": 1, "sponge_bot": 1, "sponge_strength": 2.0,
        },
    }
    yy, xx = np.mgrid[0:ny, 0:nx]
    cy, cx = ny // 2 + max(2, diameter // 8), nx // 4  # offset seeds shedding
    mask = ((xx - cx) ** 2 + (yy - cy) ** 2 <= (diameter / 2) ** 2).astype(np.float32)
    return cfg, mask


def dfg_case(ny=164, u_max=0.1, re=100.0, obstacle="bounce_back",
             inlet="equilibrium", nx_cap=None):
    """The true DFG-2D cylinder benchmark (Schaefer-Turek 2D-2, Re = 100).

    Geometry: 2.2 m x 0.41 m channel, cylinder D = 0.1 m centered at
    (0.2, 0.2) -- slightly below mid-channel, which seeds the instability.
    Walls are NO-SLIP (solid bounce-back rows), the inlet is the parabolic
    velocity profile (bc type 3), the outlet Zou-He pressure. Expected:
    Cd ~ 3.22, Cl amplitude ~ 1.0, St ~ 0.30 (f D / U_mean).

    The reference carries all the pieces (parabolic helper
    LBM2D_MRT_LES.py:580-586, bounce-back archive/lbm_mrt/solver.py:181-195,
    Cd/Cl + sine fit physics_utils.py:112-161) but marks the validation
    "pending"; this framework's bc extensions make it runnable.
    """
    # Walls are NEBB no-slip: bc type 0 (prescribed-velocity) with value
    # [0, 0] on top/bottom puts an exact u = 0 Dirichlet wall ON rows 0 and
    # ny-1 -- solid mask rows in the boundary ring do NOT work (the ring is
    # excluded from collide, so bounce-back never fires there and the edge
    # BC still governs; measured as a slipping wall: St 0.264 / Cd 2.96
    # grid-converged at D = 40 and 80). With on-node walls the channel
    # height H = 0.41 m spans exactly ny - 1 cells, matching the parabolic
    # profile's zeros.
    scale = (ny - 1) / 0.41  # px per metre
    nx = int(round(2.2 * scale)) + 1
    if nx_cap is not None:
        # truncated channel for the cheap CI tier: the near-wake St/Cd don't
        # need the full 2.2 m run-out; keep >= ~10 D downstream of the
        # cylinder so the outlet never touches the shedding region
        nx = min(nx, int(nx_cap))
    diameter = int(round(0.1 * scale))
    u_mean = (2.0 / 3.0) * u_max
    nu = u_mean * diameter / re
    cfg = {
        "simulation": {
            "nx": nx, "ny": ny, "name": f"dfg2d_re{int(re)}", "nu": nu,
            "ghost_moments_s": 1.2, "characteristic_length": diameter,
            "rho_in": 1.0, "rho_out": 1.0,
            "smagorinsky_constant": 0.0,  # laminar benchmark: LES off
            "warmup_steps": 8000,
        },
        "boundary_condition": {
            # type 3 = pure-equilibrium profiled inlet; type 4 = NEBB
            # (non-equilibrium extrapolation) profiled inlet, which delivers
            # the prescribed parabola exactly (type 3 measures ~4% low)
            "type": [4 if inlet == "nebb" else 3, 0, 1, 0],
            "value": [[u_max, 0.0]] + [[0.0, 0.0]] * 3,
            # "bounce_back" (full-way) or "bounce_back_halfway": the
            # half-way scheme removes the full-way one-step reflection lag
            # (the known fix for its wall-location bias in St)
            "obstacle": obstacle,
        },
        "domain_zones": {
            "sponge_in": 1, "sponge_out": 1, "sponge_top": 1, "sponge_bot": 1,
            "sponge_strength": 0.0,  # clean benchmark: no sponge
        },
    }
    yy, xx = np.mgrid[0:ny, 0:nx]
    cy = int(round(0.2 * scale))
    cx = int(round(0.2 * scale))
    mask = ((xx - cx) ** 2 + (yy - cy) ** 2 <= (diameter / 2.0) ** 2).astype(
        np.float32
    )
    if obstacle == "bounce_back_bouzidi":
        # the exact analytic circle the mask was rasterized from: make_params
        # derives per-link sub-grid wall fractions (bouzidi_q_planes) from it
        cfg["boundary_condition"]["obstacle_geometry"] = {
            "shape": "cylinder", "cx": float(cx), "cy": float(cy),
            "r": diameter / 2.0,
        }
    return cfg, mask, diameter


def run_validation(
    re: float = 150.0,
    steps: int = 40000,
    chunk: int = 200,
    nx: int = 800,
    ny: int = 400,
    diameter: int = 40,
    u_target: float = 0.08,
    progress: bool = True,
    mode: str = "pressure",
    obstacle: str = "bounce_back",
    inlet: str = "equilibrium",
    nx_cap: int | None = None,
    device="cuda",
) -> Dict:
    if mode == "dfg":
        cfg, mask, diameter = dfg_case(
            ny=ny, u_max=u_target, re=re, obstacle=obstacle, inlet=inlet,
            nx_cap=nx_cap,
        )
        nx = cfg["simulation"]["nx"]
    else:
        cfg, mask = cylinder_case(nx, ny, diameter, u_target, re)
    engine = LBMEngine(cfg, mask, device=device)

    # DFG coefficients are defined on the CYLINDER force alone; the no-slip
    # channel walls are also mask cells and their momentum exchange dwarfs
    # the drag (measured ~140x), so measure on a walls-excluded mask.
    force_mask = None
    if mode == "dfg":
        cyl = mask.copy()
        cyl[0, :] = 0.0
        cyl[-1, :] = 0.0
        force_mask = torch.as_tensor(cyl, dtype=engine.dtype, device=engine.device)

    fx, fy, ts = [], [], []
    n_chunks = steps // chunk
    for i in range(n_chunks):
        engine.run_step(chunk)
        if force_mask is not None:
            f = obstacle_force(
                engine.state.f_post, engine.params, mask=force_mask
            ).cpu().numpy()
        else:
            f = engine.get_force()
        max_v = engine.get_max_velocity()
        ok, reason = stability.check_stability(
            f, max_v, (i + 1) * chunk,
            warmup_step=cfg["simulation"]["warmup_steps"],
        )
        if not ok:
            print(f"  [breaker] {reason}")
            break
        fx.append(float(f[0]))
        fy.append(float(f[1]))
        ts.append((i + 1) * chunk)
        if progress and (i + 1) % max(1, n_chunks // 10) == 0:
            print(f"  step {ts[-1]}/{steps}  Fx={fx[-1]:.4f} Fy={fy[-1]:+.4f}")

    fx = np.asarray(fx)
    fy = np.asarray(fy)
    ts = np.asarray(ts, float)

    # measured inlet velocity (x=1 column, walls excluded)
    u_np, _ = engine.get_physical_fields()
    u_in = float(np.mean(u_np[0, 1:-1, 1]))

    # DFG mode prescribes u_max exactly (parabolic inlet), so normalize with
    # the prescribed value (reference compute_coefficients contract,
    # physics_utils.py:112-126); pressure mode only knows the measured mean.
    # For St, U_mean = the column average: 2/3 u_max for the parabola, which
    # is what u_in measures in both modes.
    u_norm = u_target if mode == "dfg" else u_in
    u_for_st = (2.0 / 3.0) * u_target if mode == "dfg" else u_in

    # statistics over the second half (after shedding saturates)
    half = len(fx) // 2
    cd_arr, cl_arr, u_mean = compute_coefficients(
        fx[half:], fy[half:], u_max=u_norm, d=diameter
    )
    fitted, popt = fit_sine_wave(ts[half:], fy[half:])
    result = {
        "re_target": re,
        "mode": mode,
        "obstacle": obstacle if mode == "dfg" else "equilibrium",
        "inlet": inlet if mode == "dfg" else "pressure",
        "ny": ny,
        "diameter_px": diameter,
        "steps": int(ts[-1]) if len(ts) else 0,
        "u_inlet_measured": u_in,
        "re_measured": u_in * diameter / cfg["simulation"]["nu"],
        "cd_mean": float(np.mean(cd_arr)),
        "cl_amplitude": float((np.max(cl_arr) - np.min(cl_arr)) / 2),
        "shedding_detected": bool(np.std(fy[half:]) > 1e-6),
    }
    if mode == "dfg" and u_in > 0:
        # diagnostics normalized by the MEASURED mean inlet velocity: with
        # the equilibrium inlet the realized U runs ~4% below nominal, which
        # biases the nominal-U Cd by ~8% and St by ~4%; these rows separate
        # inlet-delivery error from wall-scheme error
        cd_m, _, _ = compute_coefficients(
            fx[half:], fy[half:], u_max=1.5 * u_in, d=diameter
        )
        result["cd_mean_measured_u"] = float(np.mean(cd_m))
    if popt is not None:
        # popt omega is per recorded sample; samples are `chunk` steps apart
        omega_per_step = popt[1] / chunk
        result["strouhal_sine_fit"] = strouhal_number(omega_per_step, diameter, u_for_st)
        if mode == "dfg" and u_in > 0:
            result["strouhal_measured_u"] = strouhal_number(
                omega_per_step, diameter, u_in
            )
        result["lift_fit_amplitude"] = float(abs(popt[0]))

    # FFT-peak Strouhal over the last quarter (most stationary window); the
    # mean flow still drifts slowly, so remove a quadratic trend first --
    # otherwise the lowest bin wins regardless of the shedding line.
    tail = fy[-max(16, len(fy) // 4) :]
    if len(tail) >= 16 and np.std(tail) > 0:
        tt = np.arange(len(tail), dtype=float)
        trend = np.polyval(np.polyfit(tt, tail, 2), tt)
        osc = tail - trend
        spec = np.abs(np.fft.rfft(osc * np.hanning(len(osc))))
        freqs = np.fft.rfftfreq(len(osc), d=chunk)  # cycles per lattice step
        k = 1 + int(np.argmax(spec[1:]))
        result["strouhal"] = float(freqs[k] * diameter / u_for_st)
        result["shedding_periods_in_window"] = float(freqs[k] * len(osc) * chunk)
        result["lift_oscillation_rms"] = float(np.sqrt(np.mean(osc**2)))
    return result


def main() -> None:
    ap = argparse.ArgumentParser()
    ap.add_argument(
        "--re", type=float, default=None,
        help="target Reynolds number (default: 100 in dfg mode -- the "
        "Schaefer-Turek 2D-2 benchmark value -- else 150)",
    )
    ap.add_argument("--steps", type=int, default=40000)
    ap.add_argument("--nx", type=int, default=800)
    ap.add_argument("--ny", type=int, default=400)
    ap.add_argument("--diameter", type=int, default=40)
    ap.add_argument("--chunk", type=int, default=200)
    ap.add_argument("--u", type=float, default=None,
                    help="inlet velocity (u_max in dfg mode)")
    ap.add_argument(
        "--mode", choices=("pressure", "dfg"), default="pressure",
        help="pressure = reference-style Zou-He channel; dfg = true "
        "Schaefer-Turek 2D benchmark (parabolic inlet, no-slip walls)",
    )
    ap.add_argument(
        "--obstacle",
        choices=(
            "bounce_back", "bounce_back_halfway", "bounce_back_bouzidi",
        ),
        default="bounce_back",
        help="cylinder scheme in dfg mode: full-way, half-way, or Bouzidi "
        "interpolated (sub-grid curved wall) bounce-back",
    )
    ap.add_argument(
        "--inlet", choices=("equilibrium", "nebb"), default="equilibrium",
        help="left-edge profiled inlet in dfg mode: pure-equilibrium "
        "(type 3) or non-equilibrium-extrapolation NEBB (type 4, delivers "
        "the prescribed parabola exactly)",
    )
    ap.add_argument(
        "--nx_cap", type=int, default=None,
        help="truncate the dfg-mode channel to at most this many columns "
        "(cheap smoke runs; keep >= ~10 D downstream of the cylinder)",
    )
    ap.add_argument(
        "--out", default=None,
        help="append the result to this JSON file (machine-readable "
        "benchmark artifact, e.g. docs/benchmarks/dfg2d_results.json)",
    )
    ap.add_argument(
        "--device", default="cuda",
        help="torch device (default cuda; 'cpu' runs the eager reference step)",
    )
    args = ap.parse_args()
    u_default = 0.1 if args.mode == "dfg" else 0.08
    re_default = 100.0 if args.mode == "dfg" else 150.0
    res = run_validation(
        re=args.re if args.re is not None else re_default,
        steps=args.steps, nx=args.nx, ny=args.ny,
        diameter=args.diameter, mode=args.mode, chunk=args.chunk,
        u_target=args.u if args.u is not None else u_default,
        obstacle=args.obstacle, inlet=args.inlet, nx_cap=args.nx_cap,
        device=args.device,
    )
    print(json.dumps(res, indent=2))
    if args.out:
        import os

        results = []
        if os.path.exists(args.out):
            with open(args.out) as fh:
                results = json.load(fh)
        results.append(res)
        os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
        with open(args.out, "w") as fh:
            json.dump(results, fh, indent=2)
        print(f"[saved] {args.out} ({len(results)} entries)")


if __name__ == "__main__":
    main()
