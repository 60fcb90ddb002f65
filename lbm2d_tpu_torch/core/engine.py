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
their plain versions, so the flag is never ignored. The exceptions are the
JAX package's own rules: half-way and Bouzidi bounce-back run exact f32,
and so does every case while temporal blocking is requested; the engine
logs why and reads ``store_dev`` False. Temporal blocking
(``ops/cuda_step._FUSE_STEPS``, opt-in) runs K3 on the card and its plain
version on the CPU; Bouzidi bounce-back turns it down, logged.

With ``spatial_mesh`` (or ``simulation.spatial_mesh``: "RxC", "auto") the
case runs on the blocks of a device mesh (``parallel/sharded.py``), a 1x1
mesh included, as in the JAX package: on the card through K1 in its
sharded form, the blocks on the first ry * rx CUDA devices; on the
CPU through the eager sharded step, or the kernels' plain sharded runner
with ``store_dev``. The sharded runner never fuses (logged when temporal
blocking is requested). The state stays one global ``LBMState``: the
runner scatters it into blocks and gathers it every chunk.

Inside a ``torch.distributed`` group of several processes
(``parallel/multihost.init_multihost``) the spatial mesh is laid over the
global device list (``multihost.make_global_mesh``); when its blocks
belong to several processes the engine is multi-host (``_multihost``):
each process keeps the global-shaped state, advances its own blocks only,
and the host reads (``get_moments``, ``get_physical_fields``,
checkpoints) are collectives every process joins, of which rank 0 alone
writes files.
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


def parse_spatial_mesh(spec, device="cuda") -> Optional[Tuple[int, int]]:
    """Mesh-shape spec -> (rows, cols) | None, as the JAX package's.

    Accepts "2x4" / [2, 4] / (2, 4); "auto" means the most-square
    factorization of the CUDA devices (1x1 on the CPU ``device``), an int N
    that of N devices. None/""/0 -> no spatial sharding.
    """
    if spec in (None, "", 0, False):
        return None
    from ..parallel.topology import best_grid

    if isinstance(spec, str):
        if spec.strip().lower() == "auto":
            from ..parallel import multihost

            if multihost.is_multihost():
                return best_grid(len(multihost.global_devices()))
            on_card = torch.device(device).type == "cuda"
            return best_grid(max(1, torch.cuda.device_count()) if on_card else 1)
        parts = spec.lower().replace("x", " ").split()
        if len(parts) != 2:
            raise ValueError(f"spatial_mesh {spec!r}: expected 'RxC'")
        return int(parts[0]), int(parts[1])
    if isinstance(spec, int):
        return best_grid(spec)
    ry, rx = spec
    return int(ry), int(rx)


def make_spatial_mesh(mesh_shape: Tuple[int, int], device: torch.device, grid_shape):
    """The mesh of a sharded case: its blocks on the first ry * rx CUDA
    devices, or all on the CPU; inside a group of several processes, on
    the global device list (``multihost.make_global_mesh``, a collective).
    Raises ValueError when there are too few devices or the grid does not
    cut into the mesh's blocks."""
    from ..parallel import multihost
    from ..parallel.topology import make_mesh, mesh_refusal

    ry, rx = mesh_shape
    if multihost.is_multihost():
        n_dev = len(multihost.global_devices())
        if ry * rx != n_dev:
            raise ValueError(f"spatial_mesh {ry}x{rx} needs {ry * rx} devices; the "
                             f"{multihost.process_count()} processes hold {n_dev}")
        why = mesh_refusal(grid_shape, mesh_shape)
        if why is not None:
            raise ValueError(why)
        return multihost.make_global_mesh(mesh_shape)
    if device.type == "cuda":
        n_dev = torch.cuda.device_count()
        if ry * rx > n_dev:
            raise ValueError(f"spatial_mesh {ry}x{rx} needs {ry * rx} devices, found {n_dev}")
        devices = [torch.device("cuda", i) for i in range(ry * rx)]
    else:
        devices = [device] * (ry * rx)
    why = mesh_refusal(grid_shape, mesh_shape)
    if why is not None:
        raise ValueError(why)
    return make_mesh(mesh_shape, devices)


def resolve_store_dev(p: CaseParams, store_dev: bool, sharded: bool = False) -> bool:
    """``store_dev`` under the JAX package's rule: half-way and Bouzidi
    bounce-back run exact f32 (``cuda_step.dev_storage_refusal``). A
    request that the rule turns down is logged with the reason; the kernels
    still run, in f32."""
    if not store_dev:
        return False
    from ..ops.cuda_step import dev_storage_refusal

    why = dev_storage_refusal(p, sharded)
    if why is not None:
        log.warning("16-bit deviation storage (f16_state) not engaged: %s", why)
        return False
    return True


def resolve_fuse(p: CaseParams) -> bool:
    """True when temporal blocking (``cuda_step._FUSE_STEPS`` > 1, opt-in as
    in the JAX package) is requested and case ``p`` takes it; a request that
    ``cuda_step.fuse_refusal`` turns down is logged with the reason and the
    case runs unfused."""
    from ..ops.cuda_step import fuse_refusal, fuse_requested

    if not fuse_requested():
        return False
    why = fuse_refusal(p)
    if why is not None:
        log.warning("temporal blocking (cuda_step._FUSE_STEPS) not engaged: %s", why)
        return False
    return True


def resolve_runner(p: CaseParams, device: torch.device, store_dev: bool):
    """The chunk runner ``(state, p, n) -> (state, monitors)`` of a case:
    the CUDA kernels on a CUDA device (raising for a case they do not
    cover), the eager step on the CPU, and the kernels' split path in
    16-bit deviation storage wherever ``store_dev`` is set and
    ``resolve_store_dev`` keeps it. While temporal blocking is requested,
    a CPU case runs the kernels' plain chunk runner, K3's plain version
    included, so the request is never silently ignored."""
    store_dev = resolve_store_dev(p, store_dev)
    fuse = resolve_fuse(p)
    if device.type != "cuda" and not store_dev and not fuse:
        return run_chunk
    from ..ops.cuda_step import run_chunk_cuda, run_chunk_plain, unsupported

    reason = unsupported(p)
    if reason is not None:
        what = ("the CUDA kernels" if device.type == "cuda"
                else "16-bit deviation storage" if store_dev else "temporal blocking")
        raise NotImplementedError(f"{what} do not cover {reason}")
    if store_dev:
        return lambda state, p, n: run_chunk_cuda(state, p, n, store_dev=True)
    if device.type != "cuda":
        return run_chunk_plain
    return run_chunk_cuda


def resolve_sharded_runner(p: CaseParams, device: torch.device, store_dev: bool, mesh):
    """The chunk runner of a case on a spatial ``mesh``: K1 in its
    sharded form on a CUDA device (raising for a case it does not cover),
    the eager sharded step on the CPU, and the kernels' plain sharded
    runner on the CPU with ``store_dev``, so the flag is never ignored.
    Temporal blocking is not engaged on a mesh (logged)."""
    from ..ops.cuda_step import fuse_requested, unsupported
    from ..parallel.sharded import make_runner

    if fuse_requested():
        log.warning("temporal blocking (cuda_step._FUSE_STEPS) not engaged: the sharded "
                    "runner never fuses (the JAX run_chunk_sharded_pallas rule)")
    if device.type != "cuda" and not store_dev:
        return make_runner(mesh, "eager")
    reason = unsupported(p)
    if reason is not None:
        what = "the CUDA kernels" if device.type == "cuda" else "16-bit deviation storage"
        raise NotImplementedError(f"{what} do not cover {reason}")
    return make_runner(mesh, "cuda" if device.type == "cuda" else "plain", store_dev)


class LBMEngine:
    """One simulation case on one device, or on the blocks of a spatial
    mesh (``spatial_mesh``)."""

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
        self.device = resolve_device(device)
        self.nx, self.ny = int(sim["nx"]), int(sim["ny"])
        mesh_shape = parse_spatial_mesh(
            spatial_mesh if spatial_mesh is not None else sim.get("spatial_mesh"), self.device
        )
        self.mesh = (None if mesh_shape is None
                     else make_spatial_mesh(mesh_shape, self.device, (self.ny, self.nx)))
        from ..parallel.multihost import is_cross_rank

        self._multihost = is_cross_rank(self.mesh)
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
        self.store_dev = resolve_store_dev(self.params, self.store_dev,
                                           sharded=self.mesh is not None)
        if self.mesh is not None:
            self._runner = resolve_sharded_runner(self.params, self.device, self.store_dev,
                                                  self.mesh)
        else:
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

    def _fetch(self, x: torch.Tensor) -> np.ndarray:
        """A field of the state -> numpy for host IO. Multi-host: the
        blocks of every process, a collective every process must call at
        the same point (the loop is deterministic and the monitors are the
        same on every rank, so all processes branch identically)."""
        if self._multihost:
            from ..parallel.multihost import gather_for_io

            return gather_for_io(x, self.mesh)
        return x.cpu().numpy()

    def get_physical_fields(self) -> Tuple[np.ndarray, np.ndarray]:
        """(u [2,H,W], mask [H,W]) as numpy."""
        return self._fetch(self.state.u), self.params.mask.cpu().numpy()

    def get_moments(self) -> np.ndarray:
        """[9, H, W] MRT moments of the post-collision field."""
        return self._fetch(moments_output(self.state))

    def get_moments_device(self) -> torch.Tensor:
        return moments_output(self.state)

    @property
    def step_count(self) -> int:
        return int(self.state.step)

    # -- checkpoint / restore -------------------------------------------------

    def save_checkpoint(self, path: str) -> None:
        # write-temp-then-rename: a crash mid-write must not corrupt the only
        # checkpoint. Multi-host: the gathers are collectives every process
        # joins; rank 0 alone converts to host and writes
        state = self.state
        if self._multihost:
            from ..parallel import multihost

            state = LBMState(**{k: multihost.gather_replicated(getattr(state, k), self.mesh)
                                for k in ("f", "f_post", "rho", "u")}, step=state.step)
            if multihost.process_index() != 0:
                return
        data = state_to_numpy(state)
        os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
        tmp = path + ".tmp"
        with open(tmp, "wb") as fh:
            np.savez_compressed(fh, **data)
        os.replace(tmp, path)

    def load_checkpoint(self, path: str) -> None:
        """Resume from ``path``. Multi-host: rank 0 reads the file and
        broadcasts the state, so the other processes need not see it; a
        read that fails on rank 0 raises the same error on every rank."""
        if self._multihost:
            self.state = self._load_broadcast(path)
        else:
            with np.load(path) as data:
                self.state = state_from_numpy(
                    dict(data), dtype=self.dtype, device=self.device
                )
        self._last_monitors = None
        self._monitors_np = None

    def _load_broadcast(self, path: str) -> LBMState:
        from ..parallel import multihost

        data, err = None, None
        if multihost.process_index() == 0:
            try:
                with np.load(path) as z:
                    data = {k: z[k] for k in ("f", "f_post", "rho", "u", "step")}
            except Exception as exc:  # every rank raises it below, naming rank 0's path
                err = f"checkpoint {path!r} unreadable on rank 0: {type(exc).__name__}: {exc}"
        err = multihost.broadcast_object(err)
        if err is not None:
            raise RuntimeError(err)
        state = init_state(self.ny, self.nx, self.dtype, self.device)
        if data is not None:
            state = state_from_numpy(data, dtype=self.dtype, device=self.device)
        step = multihost.broadcast_object(int(state.step))
        fields = {k: multihost.broadcast_tensor(getattr(state, k))
                  for k in ("f", "f_post", "rho", "u")}
        return LBMState(step=step, **fields)
