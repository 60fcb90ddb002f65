"""Batch case-config generator: every mask x every feasible nu -> YAML +
3-tier physics config_meta.json.

Parity target: reference src/tools/config_batch_gen.py. Data flow:
  master_config.yaml -> SimContext
  per mask (with a metadata.json entry): MaskContext -> geometry ->
  blockage-adjusted rho_in -> all feasible nu -> per nu: steps + YAML +
  Tier1 (lattice) / Tier2 (wind tunnel) / Tier3 (real-world, if m_per_px)
  -> SimCases/{project}/config_meta.json

Usage:
  python -m lbm2d_tpu_torch.tools.config_batch_gen -c master_config.yaml [--dry-run]
"""

from __future__ import annotations

import argparse
import copy
import glob
import json
import os
import sys
from typing import Any, Dict, List, Optional, Tuple

import yaml

from .configgen import (
    build_mask_context,
    build_sim_context,
    calc_l_char,
    fill_blockage_adj,
    fill_geometry,
    fill_physics_and_steps,
    build_config,
    get_all_feasible_nu,
    print_re_preview,
    print_summary,
)


def load_yaml(path: str) -> Dict[str, Any]:
    if not os.path.exists(path):
        raise FileNotFoundError(f"master config not found: {path}")
    with open(path, "r", encoding="utf-8") as fh:
        return yaml.safe_load(fh)


def save_yaml(config: Dict[str, Any], path: str) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    with open(path, "w", encoding="utf-8") as fh:
        yaml.dump(config, fh, sort_keys=False, default_flow_style=None)


def load_mask_metadata(mask_dir: str) -> Dict[str, dict]:
    path = os.path.join(mask_dir, "metadata.json")
    if not os.path.exists(path):
        print(f"[Warning] metadata.json missing: {path}")
        return {}
    with open(path, "r", encoding="utf-8") as fh:
        entries = json.load(fh)
    return {e["file_name"]: e for e in entries}


def validate_passes(sim_ctx: Dict[str, Any]) -> None:
    w = sim_ctx["warmup_passes"]
    s = sim_ctx["start_record_passes"]
    t = sim_ctx["total_passes"]
    if not (w < s < t):
        print(
            f"[Error] passes invalid: warmup={w} start_record={s} total={t} "
            "(must satisfy warmup < start_record < total, else the HDF5 "
            "recording window is empty)"
        )
        sys.exit(1)


def _fmt_sci(v: float, digits: int = 4) -> str:
    return f"{v:.{digits}e}"


# -- 3-tier physical scales (config_meta core) ------------------------------


def build_tier1(case: dict, mask_ctx: dict, sim_ctx: dict) -> dict:
    """Tier 1: dimensionless lattice units."""
    return {
        "target_rho_in": case["rho_in_case"],
        "rho_in": case["rho_in_case"],
        "rho_out": sim_ctx["rho_out"],
        "characteristic_length_px": float(mask_ctx["l_char"]),
        "inlet_velocity_lu": round(case["u_bernoulli"], 6),
        "kinematic_viscosity_lu": case["nu_lb"],
        "resolution_px": [mask_ctx["nx"], mask_ctx["ny"]],
    }


def build_tier2(case: dict, mask_ctx: dict, sim_ctx: dict) -> dict:
    """Tier 2: equivalent scaled wind-tunnel model via Re similarity."""
    u_lu, nu_lu = case["u_bernoulli"], case["nu_lb"]
    nu_air, u_ref = sim_ctx["nu_air"], sim_ctx["U_phys"]
    l_px, max_steps = mask_ctx["l_char"], case["max_steps"]
    dx = nu_air * u_lu / (nu_lu * u_ref)
    dt = u_lu * dx / u_ref
    return {
        "_note": (
            "Equivalent scaled wind-tunnel model; dx from Re similarity, "
            "independent of real-city geometry."
        ),
        "reference_inlet_velocity_ms": u_ref,
        "reynolds_number_calculated": round(u_lu * l_px / nu_lu, 4),
        "characteristic_length_m": _fmt_sci(l_px * dx),
        "kinematic_viscosity_air_m2_s": _fmt_sci(nu_air),
        "cell_size_m": _fmt_sci(dx),
        "time_step_s": _fmt_sci(dt),
        "steps_per_physical_second": _fmt_sci(1.0 / dt),
        "total_simulation_time_s_estimated": _fmt_sci(max_steps * dt),
    }


def build_tier3(
    case: dict, mask_ctx: dict, sim_ctx: dict, meta_entry: dict
) -> Optional[dict]:
    """Tier 3: real-world urban scale from GIS m_per_px (convective-time
    similarity for dt); None when the mask has no m_per_px."""
    m_per_px = meta_entry.get("m_per_px")
    if m_per_px is None:
        return None
    u_lu, nu_lu = case["u_bernoulli"], case["nu_lb"]
    nu_air, u_ref = sim_ctx["nu_air"], sim_ctx["U_phys"]
    l_px, max_steps = mask_ctx["l_char"], case["max_steps"]

    dx_model = nu_air * u_lu / (nu_lu * u_ref)
    dt_model = u_lu * dx_model / u_ref
    l_model = l_px * dx_model
    l_real = l_px * m_per_px
    spatial_scale = l_real / l_model

    raw_speeds = sim_ctx["physical_constants"]["inlet_velocity_ms"]
    speeds = raw_speeds if isinstance(raw_speeds, list) else [raw_speeds]
    wind_cases = {}
    for u_real in speeds:
        time_scale = spatial_scale * (u_ref / u_real)
        dt_real = dt_model * time_scale
        wind_cases[f"{u_real:.1f}_ms"] = {
            "inlet_velocity_ms": u_real,
            "reynolds_number": round(u_real * l_real / nu_air, 0),
            "cell_size_m": _fmt_sci(m_per_px, 3),
            "time_step_s": _fmt_sci(dt_real),
            "steps_per_physical_second": _fmt_sci(1.0 / dt_real),
            "total_simulation_time_s_estimated": _fmt_sci(max_steps * dt_real),
        }
    return {
        "_note": (
            "Real-world urban scale from GIS m_per_px; dt scaled by "
            "convective similarity dt_real = dt_model * (L_real/L_model) * "
            "(u_model/u_real)."
        ),
        "cell_size_m": _fmt_sci(m_per_px, 3),
        "characteristic_length_m": _fmt_sci(l_real),
        "m_per_px": m_per_px,
        "kinematic_viscosity_air_m2_s": _fmt_sci(nu_air),
        "wind_speed_cases": wind_cases,
    }


def build_case_meta(case: dict, mask_ctx: dict, sim_ctx: dict, meta_entry: dict) -> dict:
    parameters: Dict[str, Any] = {
        "lattice_inputs": build_tier1(case, mask_ctx, sim_ctx),
        "simulation_outputs": {
            "_note": "filled in after the simulation completes",
            "actual_reynolds_number": None,
            "total_steps_executed": None,
            "tensor_shapes": None,
        },
        "wind_tunnel_model_scale": build_tier2(case, mask_ctx, sim_ctx),
    }
    tier3 = build_tier3(case, mask_ctx, sim_ctx, meta_entry)
    if tier3 is not None:
        parameters["real_world_urban_scale"] = tier3
    return {
        "case_name": case["sim_name"],
        "config_filename": case["config_filename"],
        "status": "Pending",
        "parameters": parameters,
        "source_files": {
            "config_file": case["config_filename"],
            "mask_file": os.path.basename(mask_ctx["mask_path"]),
        },
    }


# -- per-mask expansion ------------------------------------------------------


def process_mask_all_nu(
    mask_path: str, meta_entry: dict, sim_ctx: dict
) -> Tuple[int, int, List[dict]]:
    mask_ctx = build_mask_context(mask_path, meta_entry)
    try:
        fill_geometry(mask_ctx, sim_ctx)
    except Exception as exc:
        print(f"  [skip] cannot read mask: {exc}")
        return 0, 1, []

    print(
        f"  [mask] {mask_ctx['mask_stem']} nx={mask_ctx['nx']} ny={mask_ctx['ny']} "
        f"L_char={mask_ctx['l_char']}px blockage={mask_ctx['max_blockage']:.1%}"
    )

    case_base: Dict[str, Any] = {}
    fill_blockage_adj(case_base, mask_ctx, sim_ctx)

    feasible = get_all_feasible_nu(
        case_base["rho_in_case"],
        sim_ctx["rho_out"],
        sim_ctx["nu_lb_list"],
        mask_ctx["l_char"],
    )
    if not feasible:
        print(f"  [skip] {mask_ctx['mask_stem']}: no feasible nu")
        return 0, 1, []

    count = 0
    metas: List[dict] = []
    for nu, _re in feasible:
        case = copy.deepcopy(case_base)
        case["nu_lb"] = nu
        case["nu_re_pairs"] = feasible
        fill_physics_and_steps(case, mask_ctx, sim_ctx)
        config, out_path = build_config(case, mask_ctx, sim_ctx)
        save_yaml(config, out_path)
        print(
            f"    -> {case['config_filename']}  Re~{case['Re']:.0f} "
            f"Ma={case['Ma']:.4f} tau={case['tau']:.4f} steps={case['max_steps']}"
        )
        metas.append(build_case_meta(case, mask_ctx, sim_ctx, meta_entry))
        count += 1
    return count, 0, metas


def generate_all(master_cfg_path: str, dry_run: bool = False) -> List[dict]:
    master_cfg = load_yaml(master_cfg_path)
    sim_ctx = build_sim_context(master_cfg)
    validate_passes(sim_ctx)
    os.makedirs(sim_ctx["output_dir"], exist_ok=True)

    mask_files = sorted(glob.glob(os.path.join(sim_ctx["mask_dir"], "*.png")))
    if not mask_files:
        print(f"[Error] no PNG masks in {sim_ctx['mask_dir']}")
        return []
    mask_meta = load_mask_metadata(sim_ctx["mask_meta_dir"])

    l_chars = []
    for mp in mask_files:
        entry = mask_meta.get(os.path.basename(mp))
        if entry is None:
            continue
        try:
            l_chars.append(
                calc_l_char(
                    mp, sim_ctx["mask_invert"],
                    int(entry["domain_W_total"]), int(entry["domain_H_total"]),
                )
            )
        except Exception as exc:
            print(f"  [warning] {os.path.basename(mp)}: {exc}")
    if not l_chars:
        print("[Error] could not compute L_char from any mask")
        return []

    print_re_preview(sim_ctx, (min(l_chars), max(l_chars)))
    if dry_run:
        print("[Dry-run] no files generated.")
        return []

    total_success = total_skipped = 0
    all_metas: List[dict] = []
    for mp in mask_files:
        entry = mask_meta.get(os.path.basename(mp))
        if entry is None:
            print(f"[skip] {os.path.basename(mp)}: not in metadata.json")
            total_skipped += 1
            continue
        ok, skipped, metas = process_mask_all_nu(mp, entry, sim_ctx)
        total_success += ok
        total_skipped += skipped
        all_metas.extend(metas)

    meta_path = os.path.join("SimCases", sim_ctx["project_name"], "config_meta.json")
    os.makedirs(os.path.dirname(meta_path), exist_ok=True)
    with open(meta_path, "w", encoding="utf-8") as fh:
        json.dump(all_metas, fh, indent=2, ensure_ascii=False)
    print(f"[Meta] saved {meta_path} ({len(all_metas)} cases)")
    print_summary(sim_ctx, total_success, total_skipped, min(l_chars), max(l_chars))
    return all_metas


def main(argv=None) -> None:
    ap = argparse.ArgumentParser(
        description="Generate per-case YAML configs + 3-tier config_meta.json."
    )
    ap.add_argument("-c", "--config", default="master_config.yaml")
    ap.add_argument("--dry-run", action="store_true")
    args = ap.parse_args(argv)
    generate_all(args.config, dry_run=args.dry_run)


if __name__ == "__main__":
    main()
