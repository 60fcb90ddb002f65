"""Numeric circuit breaker for the simulation loop.

Counterpart of ``lbm2d_tpu/core/stability.py``: NaN/Inf force or velocity
always fail; |F| > 1e6 fails; max_v > 0.25 fails only after the warmup
period. ``is_stable_device`` is the tensor form, for callers that keep the
flag on the device.
"""

from __future__ import annotations

import math
from typing import Sequence, Tuple

import torch

V_THRESHOLD = 0.25
F_THRESHOLD = 1e6


def check_stability(
    forces: Sequence[float],
    max_v: float,
    step_count: int,
    v_threshold: float = V_THRESHOLD,
    f_threshold: float = F_THRESHOLD,
    warmup_step: int = 1000,
) -> Tuple[bool, str]:
    """Host-side check; returns (is_stable, reason)."""
    fx, fy = float(forces[0]), float(forces[1])
    if math.isnan(fx) or math.isnan(fy) or math.isinf(fx) or math.isinf(fy):
        return False, f"Force becomes NaN/Inf at step {step_count} (Fx={fx}, Fy={fy})"
    if abs(fx) > f_threshold or abs(fy) > f_threshold:
        return (
            False,
            f"Force exploded (> {f_threshold:.1e}) at step {step_count} "
            f"(Fx={fx:.2e}, Fy={fy:.2e})",
        )
    max_v = float(max_v)
    if math.isnan(max_v) or math.isinf(max_v):
        return False, f"Velocity field contains NaN/Inf at step {step_count}"
    if step_count > warmup_step and max_v > v_threshold:
        return (
            False,
            f"Velocity {max_v:.4f} exceeded stability threshold "
            f"({v_threshold}) at step {step_count}",
        )
    return True, ""


def is_stable_device(
    force: torch.Tensor,
    max_v: torch.Tensor,
    step_count,
    warmup_step,
    v_threshold: float = V_THRESHOLD,
    f_threshold: float = F_THRESHOLD,
) -> torch.Tensor:
    """Boolean stability flag as a 0-d tensor on the monitors' device."""
    f_ok = torch.isfinite(force).all() & (force.abs() <= f_threshold).all()
    v_finite = torch.isfinite(max_v)
    step_count = torch.as_tensor(step_count, device=max_v.device)
    v_ok = torch.where(
        step_count > warmup_step, max_v <= v_threshold,
        torch.ones_like(v_finite),
    )
    return f_ok & v_finite & v_ok
