"""Case batches: many same-shape cases advanced together on one device.

Counterpart of ``lbm2d_tpu/parallel/batch.py``: per-case scalars are
batched leaves of a stacked CaseParams, and divergence is handled with a
per-case ``alive`` flag -- a diverged case freezes in place instead of
killing the batch (the reference circuit breaker, made batch-safe).

The state is stacked as the JAX BatchEngine holds it: [B, 9, H, W] f and
f_post, [B, H, W] rho, [B, 2, H, W] u, and a [B] step (on the host here,
where the chunk's scalar rows are built). On the card a lockstep group's
chunk is one program, as the JAX ``run_chunk_batched`` (the ``vmap``
runner) and ``_chunk_sequential`` (``pallas``) are: one K1 launch a step
over the group's alive cases, one for the closing full step and one
monitor launch, however many cases it holds
(``ops/cuda_step.run_chunk_group_cuda``); the alive cases are a device
table rebuilt only when a case dies, which replaces the JAX package's
dead-case ladder compaction (a dead case launches nothing and keeps every
bit). A group with temporal blocking requested (``cuda_step._FUSE_STEPS``)
runs its cases through ``run_chunk_cuda`` a case, K3 included. On the CPU
the ``pallas`` runner runs the group program's plain version, and the
others the eager step a case (the kernels' plain chunk a case under
``store_dev``), writing each case's slices of the stack.

The runners are the JAX BatchEngine's (``runner``): ``auto``, ``vmap``,
``pallas`` and ``sharded`` all run the group program on the card, and
differ in the 16-bit deviation storage rule (``core/engine.
resolve_store_dev``): ``auto`` and ``sharded`` engage it where the kernels
would and the grid has at least 65,536 cells, ``pallas`` wherever the
kernels would, ``vmap`` never (the JAX vmap chunk ignores it).

``runner="sharded"`` spreads the cases over a 1-D case mesh of devices
(``case_mesh``; the JAX package's ``shard_map`` over a ``('cases',)``
mesh): device d owns cases d * B/D .. (d + 1) * B/D - 1 and runs them as
one group program, with no host sync between devices inside a chunk, so
the devices run concurrently; each device sends its monitors back in one
transfer. A batch that does not divide by D is padded with inert
duplicates of the last case that start dead, as in the JAX package (5
cases on 4 devices must not collapse onto one); here a dead case launches
nothing, so a pad slot holds no state and costs nothing.

All cases of a batch must share (ny, nx), bc_type and the LES on/off flag.
"""

from __future__ import annotations

import dataclasses
from dataclasses import fields
from typing import Any, Dict, List, Optional, Sequence

import numpy as np
import torch

from ..core.engine import (
    LOCKSTEP_RUNNERS,
    resolve_device,
    resolve_fuse,
    resolve_runner,
    resolve_store_dev,
)
from ..core.lattice import moments_from_f
from ..core.solver import (
    CaseParams,
    LBMState,
    init_state,
    make_params,
    max_velocity,
    obstacle_force,
)
from ..core.stability import is_stable_device
from ..ops import cuda_step as cs
from ..utils.profiling import span


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


def moments_batched(state: LBMState) -> torch.Tensor:
    """[B, 9, H, W] MRT moments of a batched state's f_post (the JAX
    ``moments_batched``): ``moments_from_f`` over the whole stack."""
    return moments_from_f(state.f_post.transpose(0, 1)).transpose(0, 1).contiguous()


def _case_state(st: LBMState, k: int) -> LBMState:
    """Case ``k`` of a stacked state: views of its slices, its step an int."""
    return LBMState(f=st.f[k], f_post=st.f_post[k], rho=st.rho[k], u=st.u[k],
                    step=int(st.step[k]))


class Part:
    """The cases of one device, stacked: ``idx`` their indices in the batch,
    ``state`` their [B, ...] state, ``mask`` their [B, H, W] masks, and how
    a chunk runs them: the group program (``tables``,
    ``cuda_step.GroupParams``; ``plain`` for its plain version) or
    ``runners`` a case. ``moments()`` and ``velocity()`` read its state on
    its own device."""

    def __init__(self, idx, device, case_params, mask, ny, nx, dtype, store_dev, program,
                 plain=False):
        self.idx = list(idx)
        self.device = device
        self.case_params = list(case_params)
        self.mask = mask
        self.state = init_batch_state(len(self.idx), ny, nx, dtype, device)
        if program:
            self.tables = cs.GroupParams(self.case_params)
            self.run = cs.run_chunk_group_plain if plain else cs.run_chunk_group_cuda
            self.runners = None
        else:
            self.tables = self.run = None
            self.runners = [resolve_runner(p, device, store_dev) for p in self.case_params]

    def moments(self) -> torch.Tensor:
        """[B, 9, H, W] moments of the part's cases, on its device."""
        return moments_batched(self.state)

    def velocity(self) -> torch.Tensor:
        """[B, 2, H, W] velocity of the part's cases, on its device (a view
        the next chunk overwrites)."""
        return self.state.u


class BatchEngine:
    """Run B same-shape cases in lockstep on one device.

    ``run_step(n)`` advances every alive case by one n-step chunk and
    returns per-case monitors {"force": [B, 2], "max_v": [B], "stable":
    [B]}; a case whose monitors fail the circuit breaker is frozen from the
    next chunk on. ``runner`` is the JAX BatchEngine's (``auto``,
    ``vmap``, ``pallas``, ``sharded``; module docstring). ``store_dev``
    (or the first config's ``simulation.f16_state``) runs the chunks in
    16-bit deviation storage where the runner's rule engages it.
    ``runner="sharded"`` spreads the cases over ``case_mesh(n_devices,
    device, case_devices)``, at most one device a case; the batched
    outputs (``state``, the moments and velocity) are gathered on the
    first device of the mesh, ``device`` (span ``engine.gather``, with the
    ``bytes`` of the parts behind the first); ``parts`` are the cases of
    each device, read on their own device. On one device ``state`` and
    ``get_velocity_device`` are views of the engine's buffers, which the
    next ``run_step`` overwrites.
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
        if runner not in LOCKSTEP_RUNNERS:
            raise ValueError(f"unknown runner {runner!r}; one of {LOCKSTEP_RUNNERS}")
        if runner != "sharded" and (n_devices is not None or case_devices is not None):
            raise ValueError("n_devices / case_devices need runner='sharded'")
        if len(configs) != len(masks_yx):
            raise ValueError("configs and masks must align")
        self.configs = list(configs)
        self.runner = runner
        if store_dev is None:
            store_dev = bool(configs[0]["simulation"].get("f16_state", False))
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
            self._parts = [r for r in (range(d * lb, min((d + 1) * lb, self.batch))
                                       for d in range(len(mesh))) if len(r)]
            part_devices = [mesh[r[0] // lb] for r in self._parts]
            if len(self._parts) < len(mesh):
                print(f"[BatchEngine] {self.batch} cases at {lb} a device leave "
                      f"{len(mesh) - len(self._parts)} of {len(mesh)} devices without a case; "
                      f"a batch of a multiple of {len(mesh)} fills every device")
            self.device = mesh[0]
        else:
            self.device = resolve_device(device)
            self._parts = [range(self.batch)]
            part_devices = [self.device]
        self.case_params = [
            make_params(c, m, dtype=dtype, device=self.device)
            for c, m in zip(configs, masks_yx)
        ]
        self.params = stack_params(self.case_params)
        # the JAX lockstep engine's store_dev rule for this runner, once for
        # the group (its cases share the grid, the layout and the scheme)
        self._store_dev = resolve_store_dev(self.case_params[0], bool(store_dev),
                                            lockstep=True, runner=runner)
        # a group with temporal blocking requested keeps K3 a case; the CPU
        # runs the group program's plain version under the pallas runner
        fused = resolve_fuse(self.case_params[0])
        self._groups = []
        for part, d in zip(self._parts, part_devices):
            params = [self.case_params[i] if d == self.device else params_to(self.case_params[i], d)
                      for i in part]
            on_card = d.type == "cuda"
            program = not fused and (on_card or runner == "pallas")
            mask = self.params.mask if len(self._parts) == 1 else \
                torch.stack([p.mask for p in params])
            self._groups.append(Part(part, d, params, mask, self.ny, self.nx, dtype,
                                     self._store_dev, program, plain=not on_card))
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
        # every group's chunk is issued before any monitor is read, so the
        # devices of a case mesh run concurrently; each group's monitors are
        # ONE array, so one device-to-host transfer a device
        with span("program.issue"):
            packs = []
            for g in self._groups:
                with span("program.card", device=str(g.device), cases=len(g.idx)):
                    packs.append(self._run_group(g, n))
        packed = packs[0] if self.mesh is None else packs
        self._pending = packed
        if not sync:
            return packed
        return self.sync_monitors(packed)

    def _run_group(self, g: Part, n: int) -> torch.Tensor:
        """Group ``g``'s chunk; returns its packed monitors on its device."""
        alive = [bool(self._alive_np[i]) for i in g.idx]
        if g.tables is not None:
            g.state, _, packed = g.run(g.state, g.tables, alive, n, self._store_dev)
            return packed
        mons, st = [], g.state
        for k, p in enumerate(g.case_params):
            case = _case_state(st, k)
            if alive[k]:
                new, mon = g.runners[k](case, p, n)
                for name in ("f", "f_post", "rho", "u"):
                    getattr(case, name).copy_(getattr(new, name))
                st.step[k] = new.step
                force, max_v = mon["force"], mon["max_v"]
            elif case.f_post.is_cuda:
                mon = cs.case_monitors(case.f_post, case.u, cs.case_links(p))
                force, max_v = mon["force"], mon["max_v"]
            else:
                force, max_v = obstacle_force(case.f_post, p), max_velocity(case.u)
            mons.append((force.reshape(2), max_v.reshape(()),
                         is_stable_device(force, max_v, int(st.step[k]), p.warmup_steps)))
        return _pack(mons)

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
    def parts(self) -> List[Part]:
        """The cases of each device of the mesh (one part off a mesh), in
        batch order."""
        return list(self._groups)

    def _gathered(self, fn) -> torch.Tensor:
        """``fn(group state)`` of every group, in batch order on ``device``."""
        if len(self._groups) == 1:
            return fn(self._groups[0].state)
        with span("engine.gather") as sp:
            parts = [fn(g.state) for g in self._groups]
            sp.set(bytes=sum(t.numel() * t.element_size() for t in parts[1:]))
            return torch.cat([t.to(self.device) for t in parts])

    @property
    def state(self) -> LBMState:
        """The batched state ([B, ...] tensors on ``device``, a CPU int32 [B]
        step)."""
        return LBMState(
            f=self._gathered(lambda s: s.f), f_post=self._gathered(lambda s: s.f_post),
            rho=self._gathered(lambda s: s.rho), u=self._gathered(lambda s: s.u),
            step=torch.cat([g.state.step for g in self._groups]),
        )

    def set_state(self, state: LBMState, alive) -> None:
        """Restore engine state + alive flags (checkpoint resume)."""
        step = torch.as_tensor(state.step).to(torch.int32).cpu()
        for g in self._groups:
            idx = torch.tensor(g.idx)
            to = dict(device=g.device, dtype=self.dtype)
            new = {k: getattr(state, k)[idx.to(getattr(state, k).device)].to(**to)
                   for k in ("f", "f_post", "rho", "u")}
            for k, v in new.items():
                getattr(g.state, k).copy_(v)
            g.state = dataclasses.replace(g.state, step=step[idx].clone())
        self._alive_np = np.asarray(alive).astype(bool).copy()
        self._pending = None

    @property
    def alive_mask(self) -> np.ndarray:
        return self._alive_np.copy()

    def get_moments_device(self) -> torch.Tensor:
        """[B, 9, H, W] moments on the device (for on-device resize)."""
        return self._gathered(lambda s: moments_batched(s))

    def get_moments(self) -> np.ndarray:
        return self.get_moments_device().cpu().numpy()

    def get_velocity_device(self) -> torch.Tensor:
        """[B, 2, H, W] velocity on the device (for the frame renderer)."""
        return self._gathered(lambda s: s.u)


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
