"""Context dicts flowing between config-generation stages.

SimContext: batch-wide settings parsed once from master_config.
MaskContext: per-mask geometry (dims + pads from metadata.json, l_char +
max_blockage filled by geometry).
CaseResult: per-case derived quantities (rho_in adjustment, nu, steps).

Parity target: reference tools/config_utils/context.py:11-145.
"""

from __future__ import annotations

import os
from typing import Any, Dict


def build_sim_context(master_cfg: Dict[str, Any]) -> Dict[str, Any]:
    settings = master_cfg["settings"]
    physics = master_cfg["physics_control"]
    phys_const = master_cfg["physical_constants"]
    template = master_cfg["template"]

    project = settings["project_name"]
    project_dir = os.path.join("SimCases", project)

    nu_list = physics.get("nu_lb_list") or [physics["nu"]]
    u_phys_raw = phys_const["inlet_velocity_ms"]
    u_phys = u_phys_raw[0] if isinstance(u_phys_raw, list) else u_phys_raw

    return {
        "rho_in": physics["rho_in"],
        "rho_out": physics["rho_out"],
        "nu_lb_list": nu_list,
        "warmup_passes": physics["warmup_passes"],
        "total_passes": physics["total_passes"],
        "start_record_passes": physics["start_record_passes"],
        "saves_per_ctu": physics["saves_per_physical_second"],
        "c_smag": physics["smagorinsky_constant"],
        "U_phys": u_phys,
        "nu_air": phys_const.get("kinematic_viscosity_air_m2_s", 1.5e-5),
        "blockage_buffer": settings.get("blockage_buffer", 128),
        "mask_invert": template.get("mask", {}).get("invert", False),
        "project_name": project,
        "data_save_root": os.path.join("outputs", project),
        "output_dir": os.path.join(project_dir, "configs"),
        "mask_dir": os.path.join(project_dir, "masks"),
        "mask_meta_dir": os.path.join(project_dir, "masks"),
        "base_template": template,
        "physical_constants": master_cfg["physical_constants"],
    }


def build_mask_context(mask_path: str, meta_entry: Dict[str, Any]) -> Dict[str, Any]:
    stem = os.path.splitext(os.path.basename(mask_path))[0]
    return {
        "mask_path": mask_path,
        "mask_stem": stem,
        "nx": int(meta_entry["domain_W_total"]),
        "ny": int(meta_entry["domain_H_total"]),
        "pad_right": int(meta_entry["pad_right"]),
        "pad_top": int(meta_entry["pad_top"]),
        "pad_bot": int(meta_entry["pad_bot"]),
        "pad_left": int(meta_entry["pad_left"]),
        # optional analytic shape list from the mask generator (padded-domain
        # coordinates) -- threaded into the case YAML for Bouzidi q planes
        "obstacle_geometry": meta_entry.get("obstacle_geometry"),
        "l_char": None,
        "max_blockage": None,
    }
