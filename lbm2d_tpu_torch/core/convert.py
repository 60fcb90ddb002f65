"""Build the port's CaseParams / LBMState from numpy leaves.

The JAX package's ``CaseParams`` and ``LBMState`` are pytrees of arrays plus
static fields. ``params_from_numpy`` / ``state_from_numpy`` take the same
leaves as numpy arrays (and the static fields as plain values), so the two
packages can be fed identical inputs, and a checkpoint ``.npz`` written by
either engine (keys f, f_post, rho, u, step) resumes in the other.
"""

from __future__ import annotations

from typing import Any, Dict

import numpy as np
import torch

from .solver import CaseParams, LBMState

ARRAY_FIELDS = (
    "mask", "damping", "tau0", "cs_factor", "s_ghost", "rho_in", "rho_out",
    "warmup_steps", "bc_value",
)
STATIC_FIELDS = (
    "use_les", "bc_type", "bounce_obstacle", "halfway_obstacle", "bouzidi_obstacle",
)
STATE_FIELDS = ("f", "f_post", "rho", "u")


def _t(x, dtype, device):
    return torch.as_tensor(np.array(x), dtype=dtype, device=device)


def params_from_numpy(d: Dict[str, Any], dtype=torch.float32, device="cpu") -> CaseParams:
    """CaseParams from {field: numpy array or static value}."""
    if d.get("bouzidi_obstacle"):
        raise NotImplementedError(
            "Bouzidi interpolated bounce-back is not ported yet (ROADMAP.md)"
        )
    kw = {k: _t(d[k], dtype, device) for k in ARRAY_FIELDS}
    if d.get("inlet_profile") is not None:
        kw["inlet_profile"] = _t(d["inlet_profile"], dtype, device)
    for k in STATIC_FIELDS:
        if k in d:
            kw[k] = d[k]
    if "bc_type" in kw:
        kw["bc_type"] = tuple(int(t) for t in kw["bc_type"])
    return CaseParams(**kw)


def state_from_numpy(d: Dict[str, Any], dtype=torch.float32, device="cpu") -> LBMState:
    """LBMState from {f, f_post, rho, u: numpy arrays, step: int}."""
    kw = {k: _t(d[k], dtype, device) for k in STATE_FIELDS}
    return LBMState(step=int(np.asarray(d["step"])), **kw)


def state_to_numpy(state: LBMState) -> Dict[str, np.ndarray]:
    """The state's leaves as numpy arrays, under the checkpoint keys."""
    out = {k: getattr(state, k).cpu().numpy() for k in STATE_FIELDS}
    out["step"] = np.asarray(state.step, np.int32)
    return out
