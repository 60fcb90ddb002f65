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

``runner="sharded"`` spreads the cases over a 1-D case mesh of devices
(``case_mesh``; the JAX package's ``shard_map`` over a ``('cases',)``
mesh): device d owns cases d * B/D .. (d + 1) * B/D - 1 and runs them as
the ``auto`` runner does, with no host sync between devices inside a
chunk, so the devices run concurrently; each device sends its monitors
back in one transfer. A batch that does not divide by D is padded with
inert duplicates of the last case that start dead, as in the JAX package
(5 cases on 4 devices must not collapse onto one); here a dead case
launches nothing, so a pad slot holds no state and costs nothing.

All cases of a batch must share (ny, nx), bc_type and the LES on/off flag.
"""

from __future__ import annotations

import dataclasses
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


def case_mesh(n_devices: Optional[int] = None, device="cuda",
              devices: Optional[Sequence] = None) -> List[torch.device]:
    """1-D case mesh: ``devices`` as given (a device may repeat, as in a
    spatial mesh, which gives the CPU tests and the one-card machine a real
    case mesh), else the first ``n_devices`` CUDA devices (default all) for
    a CUDA ``device``, or the CPU named ``n_devices`` times (default once)."""
    if devices is not None:
        out = [torch.device(d) for d in devices]
        if n_devices is not None and n_devices != len(out):
            raise ValueError(f"n_devices={n_devices} but {len(out)} devices given")
        if not out:
            raise ValueError("a case mesh needs at least one device")
        return out
    dev = resolve_device(device)
    if dev.type != "cuda":
        return [dev] * (n_devices or 1)
    count = torch.cuda.device_count()
    n = count if n_devices is None else n_devices
    if not 1 <= n <= count:
        raise ValueError(f"n_devices={n_devices}: {count} CUDA device(s) found")
    return [torch.device("cuda", i) for i in range(n)]


def params_to(p: CaseParams, device) -> CaseParams:
    """``p`` with every tensor leaf on ``device``."""
    return dataclasses.replace(p, **{
        f.name: getattr(p, f.name).to(device) for f in fields(CaseParams)
        if isinstance(getattr(p, f.name), torch.Tensor)})


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
    ``runner="sharded"`` spreads the cases over ``case_mesh(n_devices,
    device, case_devices)``, at most one device a case; the batched
    outputs (``state``, the moments and velocity) are gathered on the
    first device of the mesh, ``device``.
    """

    def __init__(
        self,
        configs: Sequence[Dict[str, Any]],
        masks_yx: Sequence[np.ndarray],
        dtype=torch.float32,
        runner: str = "auto",
        store_dev: Optional[bool] = None,
        device="cuda",
        n_devices: Optional[int] = None,
        case_devices: Optional[Sequence] = None,
    ):
        if runner not in ("auto", "sharded"):
            raise ValueError(f"unknown runner {runner!r}")
        if runner == "auto" and (n_devices is not None or case_devices is not None):
            raise ValueError("n_devices / case_devices need runner='sharded'")
        if len(configs) != len(masks_yx):
            raise ValueError("configs and masks must align")
        self.configs = list(configs)
        if store_dev is None:
            store_dev = bool(configs[0]["simulation"].get("f16_state", False))
        self._store_dev = bool(store_dev)
        sim0 = configs[0]["simulation"]
        self.ny, self.nx = int(sim0["ny"]), int(sim0["nx"])
        self.batch = len(configs)
        self.dtype = dtype
        self.mesh: Optional[List[torch.device]] = None
        self._shard_pad = 0
        if runner == "sharded":
            mesh = case_mesh(n_devices, device, case_devices)[: self.batch]
            self._shard_pad = (-self.batch) % len(mesh)
            if self._shard_pad:
                print(f"[BatchEngine] batch {self.batch} padded with "
                      f"{self._shard_pad} inert duplicate(s) to fill "
                      f"{len(mesh)} devices")
            self.mesh = mesh
            lb = (self.batch + self._shard_pad) // len(mesh)
            # case i on device i // lb; the pad slots are the last ones, so
            # the last devices may hold pads only
            self._case_device = [mesh[i // lb] for i in range(self.batch)]
            self._parts = [r for r in (range(d * lb, min((d + 1) * lb, self.batch))
                                       for d in range(len(mesh))) if len(r)]
            self.device = mesh[0]
        else:
            self.device = resolve_device(device)
            self._case_device = [self.device] * self.batch
        self.case_params = [
            make_params(c, m, dtype=dtype, device=self.device)
            for c, m in zip(configs, masks_yx)
        ]
        self.params = stack_params(self.case_params)
        if self.mesh is not None:
            self.case_params = [params_to(p, d)
                                for p, d in zip(self.case_params, self._case_device)]
        self._runners = [
            resolve_runner(p, d, self._store_dev)
            for p, d in zip(self.case_params, self._case_device)
        ]
        self._states: List[LBMState] = [
            init_state(self.ny, self.nx, dtype, d) for d in self._case_device
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
        # every case's chunk is issued before any monitor is read, so the
        # devices of a case mesh run concurrently
        mons = [self._run_case(i, n) for i in range(self.batch)]
        if self.mesh is None:
            # ONE device-to-host transfer for all monitors of the chunk
            packed = _pack(mons)
        else:
            # one transfer a device: each packs its own cases' monitors
            packed = [_pack([mons[i] for i in part]) for part in self._parts]
        self._pending = packed
        if not sync:
            return packed
        return self.sync_monitors(packed)

    def _run_case(self, i: int, n: int):
        """Case i's chunk (alive) or the monitors of the state it keeps
        (frozen): (force [2], max_v, stable) on its device."""
        p = self.case_params[i]
        if self._alive_np[i]:
            self._states[i], mon = self._runners[i](self._states[i], p, n)
            force, max_v = mon["force"], mon["max_v"]
        else:
            st = self._states[i]
            force, max_v = obstacle_force(st.f_post, p), max_velocity(st.u)
        return (force.reshape(2), max_v.reshape(()),
                is_stable_device(force, max_v, self._states[i].step, p.warmup_steps))

    def sync_monitors(self, packed_dev) -> Dict[str, np.ndarray]:
        """Fetch and unpack a run_step(sync=False) monitor array (a list of
        one array a device under the case-sharded runner)."""
        b = self.batch
        if isinstance(packed_dev, list):
            parts = [_unpack(x.cpu().numpy(), len(part))
                     for part, x in zip(self._parts, packed_dev)]
            force, max_v, stable = (np.concatenate([q[k] for q in parts]) for k in range(3))
        else:
            force, max_v, stable = _unpack(packed_dev.cpu().numpy(), b)
        out = {"force": force, "max_v": max_v, "stable": stable}
        if packed_dev is self._pending:
            self._pending = None
        self.last_monitors = out
        self._alive_np &= out["stable"]
        return out

    @property
    def state(self) -> LBMState:
        """The batched state ([B, ...] tensors, [B] int32 step), on
        ``device``."""
        return stack_states([self._on_device(s) for s in self._states])

    def _on_device(self, st: LBMState) -> LBMState:
        if st.f.device == self.device:
            return st
        return LBMState(f=st.f.to(self.device), f_post=st.f_post.to(self.device),
                        rho=st.rho.to(self.device), u=st.u.to(self.device), step=st.step)

    def set_state(self, state: LBMState, alive) -> None:
        """Restore engine state + alive flags (checkpoint resume)."""
        self._states = []
        for i in range(self.batch):
            to = dict(device=self._case_device[i], dtype=self.dtype)
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
        return torch.stack([moments_output(s).to(self.device) for s in self._states])

    def get_moments(self) -> np.ndarray:
        return self.get_moments_device().cpu().numpy()

    def get_velocity_device(self) -> torch.Tensor:
        """[B, 2, H, W] velocity on the device (for the frame renderer)."""
        return torch.stack([s.u.to(self.device) for s in self._states])


def _pack(mons) -> torch.Tensor:
    """[(force [2], max_v, stable)] -> one array [Fx, Fy per case | max_v |
    stable] on the cases' device."""
    forces, maxvs, stables = zip(*mons)
    return torch.cat([
        torch.stack(forces).reshape(-1).float(),
        torch.stack(maxvs).float(),
        torch.stack(stables).float(),
    ])


def _unpack(packed: np.ndarray, b: int):
    """(force [b, 2], max_v [b], stable [b]) of a ``_pack`` array."""
    return packed[: 2 * b].reshape(b, 2), packed[2 * b: 3 * b], packed[3 * b:] > 0.5
