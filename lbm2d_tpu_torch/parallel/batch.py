"""Case batches: many same-shape cases advanced together on one device.

Counterpart of ``lbm2d_tpu/parallel/batch.py``: per-case scalars are
batched leaves of a stacked CaseParams, and divergence is handled with a
per-case ``alive`` flag -- a diverged case freezes in place instead of
killing the batch (the reference circuit breaker, made batch-safe).

On the card every alive case advances through ``run_chunk_cuda`` in turn
(the JAX package's sequential Pallas runner, ``_chunk_sequential``); on the
CPU the eager step per case stands in for the vmap lockstep. A dead case
is skipped on the host and keeps its state, which is the JAX package's
freeze semantics. The JAX package's dead-case ladder compaction and buffer
donation exist to bound XLA recompiles and TPU HBM; eager PyTorch has
neither problem (a skipped case costs nothing), so they have no
counterpart here.

All cases of a batch must share (ny, nx), bc_type and the LES on/off flag.
"""

from __future__ import annotations

from dataclasses import fields
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.engine import resolve_device, resolve_runner
from ..core.solver import (
    CaseParams,
    LBMState,
    init_state,
    make_params,
    max_velocity,
    moments_output,
    obstacle_force,
)
from ..core.stability import is_stable_device


def stack_params(params: Sequence[CaseParams]) -> CaseParams:
    """Stack per-case CaseParams into one batched CaseParams (leading axis
    B on every tensor leaf)."""
    first = params[0]
    for p in params[1:]:
        if p.bc_type != first.bc_type or p.use_les != first.use_les:
            raise ValueError("batched cases must share bc_type and use_les")
        if p.mask.shape != first.mask.shape:
            raise ValueError("batched cases must share the grid shape")
    out = {}
    for fld in fields(CaseParams):
        vals = [getattr(p, fld.name) for p in params]
        if isinstance(vals[0], torch.Tensor):
            out[fld.name] = torch.stack(vals)
        elif vals[0] is None:
            out[fld.name] = None
        else:
            if any(v != vals[0] for v in vals[1:]):
                raise ValueError(f"batched cases must share {fld.name}")
            out[fld.name] = vals[0]
    return CaseParams(**out)


def init_batch_state(batch: int, ny: int, nx: int, dtype=torch.float32, device="cpu") -> LBMState:
    """A batched rest state: [B, ...] tensors and a [B] int32 step."""
    one = init_state(ny, nx, dtype, device)
    return LBMState(
        f=one.f.expand(batch, *one.f.shape).clone(),
        f_post=one.f_post.expand(batch, *one.f_post.shape).clone(),
        rho=one.rho.expand(batch, *one.rho.shape).clone(),
        u=one.u.expand(batch, *one.u.shape).clone(),
        step=torch.zeros(batch, dtype=torch.int32),
    )


def stack_states(states: Sequence[LBMState]) -> LBMState:
    """Per-case states -> one batched state ([B] int32 step)."""
    return LBMState(
        f=torch.stack([s.f for s in states]),
        f_post=torch.stack([s.f_post for s in states]),
        rho=torch.stack([s.rho for s in states]),
        u=torch.stack([s.u for s in states]),
        step=torch.tensor([int(s.step) for s in states], dtype=torch.int32),
    )


def unstack_state(state: LBMState, i: int) -> LBMState:
    """Case ``i`` of a batched state, as contiguous per-case tensors."""
    return LBMState(
        f=state.f[i].contiguous(), f_post=state.f_post[i].contiguous(),
        rho=state.rho[i].contiguous(), u=state.u[i].contiguous(),
        step=int(state.step[i]),
    )


class BatchEngine:
    """Run B same-shape cases in lockstep on one device.

    ``run_step(n)`` advances every alive case by one n-step chunk and
    returns per-case monitors {"force": [B, 2], "max_v": [B], "stable":
    [B]}; a case whose monitors fail the circuit breaker is frozen from the
    next chunk on. ``store_dev`` (or the first config's
    ``simulation.f16_state``) runs the chunks in 16-bit deviation storage.
    """

    def __init__(
        self,
        configs: Sequence[Dict[str, Any]],
        masks_yx: Sequence[np.ndarray],
        dtype=torch.float32,
        runner: str = "auto",
        store_dev: Optional[bool] = None,
        device="cuda",
    ):
        if runner == "sharded":
            raise NotImplementedError(
                "runner='sharded' (cases spread over several cards) is not ported "
                "yet (ROADMAP.md queue 1, item 4)"
            )
        if runner != "auto":
            raise ValueError(f"unknown runner {runner!r}")
        if len(configs) != len(masks_yx):
            raise ValueError("configs and masks must align")
        self.configs = list(configs)
        if store_dev is None:
            store_dev = bool(configs[0]["simulation"].get("f16_state", False))
        self._store_dev = bool(store_dev)
        self.device = resolve_device(device)
        sim0 = configs[0]["simulation"]
        self.ny, self.nx = int(sim0["ny"]), int(sim0["nx"])
        self.batch = len(configs)
        self.dtype = dtype
        self.case_params = [
            make_params(c, m, dtype=dtype, device=self.device)
            for c, m in zip(configs, masks_yx)
        ]
        self.params = stack_params(self.case_params)
        self._runners = [
            resolve_runner(p, self.device, self._store_dev) for p in self.case_params
        ]
        self._states: List[LBMState] = [
            init_state(self.ny, self.nx, dtype, self.device) for _ in range(self.batch)
        ]
        self._alive_np = np.ones((self.batch,), bool)
        self._pending = None  # a run_step(sync=False) monitor array not read yet
        self.last_monitors: Optional[Dict[str, np.ndarray]] = None

    def run_step(self, n: int = 1, sync: bool = True):
        """Advance every alive case n steps. ``sync=True`` returns host-side
        monitor arrays; ``sync=False`` returns the packed device array
        [Fx, Fy per case | max_v | stable] for :meth:`sync_monitors`, so the
        caller can overlap host work with the chunk."""
        if self._pending is not None:
            # a dead case must not advance: read the flags it left behind
            self.sync_monitors(self._pending)
        forces, maxvs, stables = [], [], []
        for i, (p, run) in enumerate(zip(self.case_params, self._runners)):
            if self._alive_np[i]:
                self._states[i], mon = run(self._states[i], p, n)
                force, max_v = mon["force"], mon["max_v"]
            else:  # frozen: the monitors of the state it keeps
                st = self._states[i]
                force, max_v = obstacle_force(st.f_post, p), max_velocity(st.u)
            forces.append(force.reshape(2))
            maxvs.append(max_v.reshape(()))
            stables.append(
                is_stable_device(force, max_v, self._states[i].step, p.warmup_steps)
            )
        # ONE device-to-host transfer for all monitors of the chunk
        packed = torch.cat([
            torch.stack(forces).reshape(-1).float(),
            torch.stack(maxvs).float(),
            torch.stack(stables).float(),
        ])
        self._pending = packed
        if not sync:
            return packed
        return self.sync_monitors(packed)

    def sync_monitors(self, packed_dev) -> Dict[str, np.ndarray]:
        """Fetch and unpack a run_step(sync=False) monitor array."""
        b = self.batch
        packed = packed_dev.cpu().numpy()
        out = {
            "force": packed[: 2 * b].reshape(b, 2),
            "max_v": packed[2 * b : 3 * b],
            "stable": packed[3 * b :] > 0.5,
        }
        if packed_dev is self._pending:
            self._pending = None
        self.last_monitors = out
        self._alive_np &= out["stable"]
        return out

    @property
    def state(self) -> LBMState:
        """The batched state ([B, ...] tensors, [B] int32 step)."""
        return stack_states(self._states)

    def set_state(self, state: LBMState, alive) -> None:
        """Restore engine state + alive flags (checkpoint resume)."""
        to = dict(device=self.device, dtype=self.dtype)
        self._states = []
        for i in range(self.batch):
            st = unstack_state(state, i)
            self._states.append(LBMState(
                f=st.f.to(**to), f_post=st.f_post.to(**to), rho=st.rho.to(**to),
                u=st.u.to(**to), step=st.step,
            ))
        self._alive_np = np.asarray(alive).astype(bool).copy()
        self._pending = None

    @property
    def alive_mask(self) -> np.ndarray:
        return self._alive_np.copy()

    def get_moments_device(self) -> torch.Tensor:
        """[B, 9, H, W] moments on the device (for on-device resize)."""
        return torch.stack([moments_output(s) for s in self._states])

    def get_moments(self) -> np.ndarray:
        return self.get_moments_device().cpu().numpy()

    def get_velocity_device(self) -> torch.Tensor:
        """[B, 2, H, W] velocity on the device (for the frame renderer)."""
        return torch.stack([s.u for s in self._states])
