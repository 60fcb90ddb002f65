"""Case-YAML assembly from template + contexts.

Deep-copies master_config's template, overwrites every per-case placeholder
(grid dims, nu, rho_in/out, steps, intervals, sponge widths = pads - buffer),
and derives the output filename {mask_stem}_cfg_Nu{nu}.yaml
(reference tools/config_utils/config_assembler.py:18-101).
"""

from __future__ import annotations

import copy
import os
from typing import Any, Dict, Tuple


def build_config(
    case_result: Dict[str, Any], mask_ctx: Dict[str, Any], sim_ctx: Dict[str, Any]
) -> Tuple[Dict[str, Any], str]:
    config = copy.deepcopy(sim_ctx["base_template"])
    config["physical_constants"] = sim_ctx["physical_constants"]

    nu_lb = case_result["nu_lb"]
    rho_in = case_result["rho_in_case"]
    mask_stem = mask_ctx["mask_stem"]
    # The reference derives sim_name from the mask stem alone
    # (config_assembler.py:39-44), which COLLIDES when the all-feasible-nu
    # expansion emits several configs per mask: their h5/mp4/summary keys
    # would overwrite each other (the reference's practical path samples one
    # nu per mask, so it never hit this). Append the nu tag so every case's
    # outputs are unique.
    nu_str = f"{nu_lb:.4f}".replace(".", "-")
    sim_name = "_".join(mask_stem.split("_")[:2]) + f"_Nu{nu_str}"

    sim = config["simulation"]
    sim["name"] = sim_name
    sim["nu"] = float(f"{nu_lb:.6f}")
    sim["characteristic_length"] = float(mask_ctx["l_char"])
    sim["rho_in"] = float(rho_in)
    sim["rho_out"] = float(sim_ctx["rho_out"])
    sim["compute_step_size"] = case_result["interval"]
    sim["warmup_steps"] = case_result["warmup_steps"]
    sim["max_steps"] = case_result["max_steps"]
    sim["smagorinsky_constant"] = sim_ctx["c_smag"]
    sim["nx"] = mask_ctx["nx"]
    sim["ny"] = mask_ctx["ny"]

    out = config["outputs"]
    out["project_name"] = sim_ctx["project_name"]
    out["data_save_root"] = sim_ctx["data_save_root"]
    out["target_rho_in"] = float(rho_in)
    out["start_record_step"] = case_result["start_record_step"]
    out["gui"]["interval_steps"] = case_result["interval"]
    out["video"]["interval_steps"] = case_result["interval"]
    out["video"]["filename"] = f"{sim_name}.mp4"
    out["dataset"]["interval_steps"] = case_result["interval"]
    out["dataset"].pop("folder", None)

    buffer = sim_ctx.get("blockage_buffer", 128)
    dz = config.get("domain_zones", {})
    dz["sponge_top"] = max(1, mask_ctx["pad_top"] - buffer)
    dz["sponge_bot"] = max(1, mask_ctx["pad_bot"] - buffer)
    dz["sponge_out"] = max(1, mask_ctx["pad_right"] - buffer)
    dz["sponge_in"] = max(1, mask_ctx["pad_left"] - buffer)
    dz["buffer"] = buffer
    for stale in ("sponge_x", "sponge_y", "inlet_buffer", "sponge_inlet"):
        dz.pop(stale, None)
    config["domain_zones"] = dz

    # Zou-He pressure boundaries carry a dummy inlet velocity value
    config["boundary_condition"]["value"] = [[0.05, 0.0]] + [[0.0, 0.0]] * 3
    config["mask"]["path"] = mask_ctx["mask_path"]
    # generator-recorded analytic shapes (padded-domain coordinates): a
    # template whose obstacle scheme is bounce_back_bouzidi then derives
    # exact sub-grid wall distances; harmless for the other schemes
    if mask_ctx.get("obstacle_geometry") is not None:
        config["boundary_condition"]["obstacle_geometry"] = mask_ctx[
            "obstacle_geometry"
        ]

    config_filename = f"{mask_stem}_cfg_Nu{nu_str}.yaml"
    full_path = os.path.join(sim_ctx["output_dir"], config_filename)
    case_result["config_filename"] = config_filename
    case_result["sim_name"] = sim_name
    return config, full_path
