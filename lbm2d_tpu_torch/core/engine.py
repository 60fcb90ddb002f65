"""High-level solver facade over the functional core (PyTorch).

Counterpart of ``lbm2d_tpu/core/engine.py``, with the reference solver's
public API (run_step, get_force, get_max_velocity, get_physical_fields,
get_moments) and in-case checkpoint/restore in the same ``.npz`` format, so
a checkpoint written by either package resumes in the other.

The engine lives on one torch device, ``cuda`` unless the caller asks for
the CPU. On a CUDA device a chunk runs on the hand-written kernels
(``ops/cuda_step.run_chunk_cuda``) and a case they do not cover raises; on
the CPU it runs the eager reference step. 16-bit deviation state storage
(``store_dev`` or ``simulation.f16_state``) runs the kernels' split path in
deviation storage: on the card through the kernels, on the CPU through
their plain versions, so the flag is never ignored. The one exception is
the JAX package's own rule: half-way and Bouzidi bounce-back run exact f32,
and the engine logs why and reads ``store_dev`` False.
"""

from __future__ import annotations

import logging
import math
import os
from typing import Any, Dict, Optional, Tuple

import numpy as np
import torch

from .convert import state_from_numpy, state_to_numpy
from .solver import (
    CaseParams,
    LBMState,
    init_state,
    make_params,
    max_velocity,
    moments_output,
    obstacle_force,
    run_chunk,
)

log = logging.getLogger(__name__)


def resolve_device(device) -> torch.device:
    """``device`` as a torch.device; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            f"device {device!r} requested but no CUDA device is available; "
            "pass device='cpu' to run the eager reference step"
        )
    return dev


def resolve_store_dev(p: CaseParams, store_dev: bool) -> bool:
    """``store_dev`` under the JAX package's rule: half-way and Bouzidi
    bounce-back run exact f32 (``cuda_step.dev_storage_refusal``). A
    request that the rule turns down is logged with the reason; the kernels
    still run, in f32."""
    if not store_dev:
        return False
    from ..ops.cuda_step import dev_storage_refusal

    why = dev_storage_refusal(p)
    if why is not None:
        log.warning("16-bit deviation storage (f16_state) not engaged: %s", why)
        return False
    return True


def resolve_runner(p: CaseParams, device: torch.device, store_dev: bool):
    """The chunk runner ``(state, p, n) -> (state, monitors)`` of a case:
    the CUDA kernels on a CUDA device (raising for a case they do not
    cover), the eager step on the CPU, and the kernels' split path in
    16-bit deviation storage wherever ``store_dev`` is set and
    ``resolve_store_dev`` keeps it."""
    store_dev = resolve_store_dev(p, store_dev)
    if device.type != "cuda" and not store_dev:
        return run_chunk
    from ..ops.cuda_step import run_chunk_cuda, unsupported

    reason = unsupported(p)
    if reason is not None:
        what = "the CUDA kernels" if device.type == "cuda" else "16-bit deviation storage"
        raise NotImplementedError(f"{what} do not cover {reason}")
    if store_dev:
        return lambda state, p, n: run_chunk_cuda(state, p, n, store_dev=True)
    return run_chunk_cuda


class LBMEngine:
    """One simulation case on one device."""

    def __init__(
        self,
        config: Dict[str, Any],
        mask_yx: Optional[np.ndarray] = None,
        dtype=torch.float32,
        device="cuda",
        store_dev: Optional[bool] = None,
        spatial_mesh=None,
    ):
        self.config = config
        sim = config["simulation"]
        # 16-bit deviation state storage: lossy, opt-in through the
        # ``simulation.f16_state`` config key or the constructor argument
        if store_dev is None:
            store_dev = bool(sim.get("f16_state", False))
        self.store_dev = bool(store_dev)
        if spatial_mesh or sim.get("spatial_mesh"):
            raise NotImplementedError(
                "spatial sharding is not ported yet (ROADMAP.md queue 1, item 10)"
            )
        self.device = resolve_device(device)
        self.nx, self.ny = int(sim["nx"]), int(sim["ny"])
        self.name = sim.get("name", "case")
        self.nu = float(sim["nu"])
        self.tau0 = 3.0 * self.nu + 0.5
        self.characteristic_length = sim["characteristic_length"]
        self.rho_in_target = float(sim["rho_in"])
        self.rho_out_target = float(sim["rho_out"])
        self.warmup_steps = int(sim["warmup_steps"])

        # Bernoulli estimate of the pressure-driven inlet speed, as the
        # reference logs at init.
        delta_rho = self.rho_in_target - self.rho_out_target
        u_char = math.sqrt(2.0 / 3.0 * delta_rho) if delta_rho > 1e-9 else 0.01
        self.Re = (
            (u_char * self.characteristic_length) / self.nu
            if self.nu > 0
            else float("inf")
        )
        self.u_inlet_estimate = u_char

        self.params: CaseParams = make_params(
            config, mask_yx, dtype=dtype, device=self.device
        )
        self.dtype = dtype
        self.store_dev = resolve_store_dev(self.params, self.store_dev)
        self._runner = resolve_runner(self.params, self.device, self.store_dev)
        self.state: LBMState = init_state(self.ny, self.nx, dtype, self.device)
        self._last_monitors = None
        self._monitors_np = None

    # -- reference-compatible API --------------------------------------------

    def init(self) -> None:
        self.state = init_state(self.ny, self.nx, self.dtype, self.device)
        self._last_monitors = None
        self._monitors_np = None

    def run_step(self, steps: int = 1) -> None:
        self.state, self._last_monitors = self._runner(self.state, self.params, steps)
        self._monitors_np = None

    def _fetch_monitors(self) -> np.ndarray:
        """[Fx, Fy, max_v] in ONE device-to-host transfer."""
        if self._monitors_np is None:
            if self._last_monitors is None:
                force = obstacle_force(self.state.f_post, self.params)
                max_v = max_velocity(self.state.u)
            else:
                force = self._last_monitors["force"]
                max_v = self._last_monitors["max_v"]
            self._monitors_np = (
                torch.cat([force.reshape(-1), max_v.reshape(1)]).cpu().numpy()
            )
        return self._monitors_np

    def get_force(self) -> np.ndarray:
        return self._fetch_monitors()[:2]

    def get_max_velocity(self) -> float:
        return float(self._fetch_monitors()[2])

    def get_physical_fields(self) -> Tuple[np.ndarray, np.ndarray]:
        """(u [2,H,W], mask [H,W]) as numpy."""
        return self.state.u.cpu().numpy(), self.params.mask.cpu().numpy()

    def get_moments(self) -> np.ndarray:
        """[9, H, W] MRT moments of the post-collision field."""
        return moments_output(self.state).cpu().numpy()

    def get_moments_device(self) -> torch.Tensor:
        return moments_output(self.state)

    @property
    def step_count(self) -> int:
        return int(self.state.step)

    # -- checkpoint / restore -------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        # write-temp-then-rename: a crash mid-write must not corrupt the only
        # checkpoint
        data = state_to_numpy(self.state)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez_compressed(fh, **data)
        os.replace(tmp, path)

    def load_checkpoint(self, path: str) -> None:
        with np.load(path) as data:
            self.state = state_from_numpy(
                dict(data), dtype=self.dtype, device=self.device
            )
        self._last_monitors = None
        self._monitors_np = None
