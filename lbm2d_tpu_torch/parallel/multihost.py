"""Multi-host spatial decomposition: one grid sharded across processes.

Counterpart of ``lbm2d_tpu/parallel/multihost.py``. SURVEY §2.2 names two
distributed axes: case-level parallelism across processes is
``--coordinate`` (pipeline/coordination.py); this module covers the other,
one large grid whose blocks live in several processes, each owning its
local devices.

Every process runs the SAME program. ``init_multihost`` joins a
``torch.distributed`` group; ``make_global_mesh`` lays the processes'
local devices out process-major (rank r's devices after rank r - 1's, as
``jax.devices()`` is in a multi-controller job) and records each block's
owning rank. The sharded runners (``parallel/sharded.py``) then advance
only the blocks a rank owns: halos between its own blocks are
device-to-device copies, halos that cross ranks go through
``torch.distributed`` P2P, posted in one fixed order on every rank, and
the chunk's monitors are reduced over the ranks in rank order, so every
rank reads the same values and branches the same way.

Each rank holds only its own blocks of the state (``topology.BlockState``,
placed once from the identical host data every rank builds, the
counterpart of the JAX ``shard_state_global``, which materializes only
the addressable shards); the engine keeps no global-shaped copy.
``gather_replicated`` assembles a field from every rank's blocks, a
collective every rank must join at the same point, and only rank 0
writes artifacts.

Backends: ``nccl`` where each rank owns its own card; ``gloo`` for CPU
tensors and for ranks that share one card (NCCL refuses two ranks on one
GPU). Under ``gloo`` on CUDA the halos and gathers are staged through
pinned host buffers: the transport only, never a change of the compute
device. The backend in use is printed at ``init_multihost``.
"""

from __future__ import annotations

import datetime
from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from .topology import Mesh, best_grid, gather_blocks

# this process's local devices and backend, set by init_multihost
_LOCAL: dict = {}
# how long a rank waits for the others at the group's start and in a collective
_TIMEOUT = datetime.timedelta(seconds=600)


def init_multihost(
    coordinator_address: str,
    num_processes: int,
    process_id: int,
    local_device_ids: Optional[Sequence[int]] = None,
    backend: Optional[str] = None,
    device="cuda",
) -> str:
    """Join the ``torch.distributed`` group of ``num_processes`` ranks
    (idempotent per process); returns the backend.

    ``coordinator_address`` is "host:port" (rank 0 listens there; a
    ``tcp://`` prefix is accepted). ``device`` "cuda" gives this rank the
    CUDA devices ``local_device_ids`` (default: card ``process_id`` modulo
    the card count), "cpu" the CPU once per id (default once).
    ``backend`` defaults to ``nccl`` when every rank can own a card of its
    own, else ``gloo``."""
    dev = torch.device(device)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError("init_multihost(device='cuda'): no CUDA device available")
        n_cards = torch.cuda.device_count()
        ids = tuple(local_device_ids) if local_device_ids is not None else (
            process_id % n_cards,)
        local = [torch.device("cuda", i) for i in ids]
    else:
        local = [torch.device("cpu")] * len(tuple(local_device_ids or (0,)))
    if backend is None:
        backend = ("nccl" if dev.type == "cuda" and torch.cuda.device_count() >= num_processes
                   else "gloo")
    if backend not in ("nccl", "gloo"):
        raise ValueError(f"backend {backend!r}: expected 'nccl' or 'gloo'")
    if backend == "nccl" and dev.type != "cuda":
        raise ValueError("the nccl backend needs CUDA devices")
    if dist.is_initialized():
        if (dist.get_world_size(), dist.get_rank()) != (num_processes, process_id):
            raise RuntimeError("torch.distributed is already initialized with another "
                               f"world ({dist.get_world_size()}, rank {dist.get_rank()})")
        return _LOCAL["backend"]
    if dev.type == "cuda":
        torch.cuda.set_device(local[0])
    addr = coordinator_address
    if not addr.startswith("tcp://"):
        addr = "tcp://" + addr
    dist.init_process_group(backend, init_method=addr, world_size=num_processes,
                            rank=process_id, timeout=_TIMEOUT)
    _LOCAL.update(devices=local, backend=backend)
    staged = backend == "gloo" and dev.type == "cuda"
    print(f"[multihost] rank {process_id}/{num_processes} backend={backend}"
          f"{' (halos staged through pinned host buffers)' if staged else ''} "
          f"local devices={[str(d) for d in local]}", flush=True)
    return backend


def is_multihost() -> bool:
    """True inside a ``torch.distributed`` group of more than one rank."""
    return dist.is_available() and dist.is_initialized() and dist.get_world_size() > 1


def process_index() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() else 0


def process_count() -> int:
    return dist.get_world_size() if dist.is_available() and dist.is_initialized() else 1


def local_devices() -> List[torch.device]:
    """This rank's devices (``init_multihost``)."""
    if "devices" not in _LOCAL:
        raise RuntimeError("init_multihost has not run in this process")
    return list(_LOCAL["devices"])


def backend() -> Optional[str]:
    return _LOCAL.get("backend")


def global_devices() -> List[Tuple[int, torch.device]]:
    """(owning rank, device) of every device of the group, process-major.
    A collective."""
    mine = [str(d) for d in local_devices()]
    everyone: List[List[str]] = [None] * process_count()  # type: ignore[list-item]
    dist.all_gather_object(everyone, mine)
    return [(r, torch.device(d)) for r, devs in enumerate(everyone) for d in devs]


def make_global_mesh(shape: Optional[Tuple[int, int]] = None) -> Mesh:
    """2D mesh over the GLOBAL device list (all processes), process-major,
    so a ``(num_processes, devices_per_process)`` shape puts each row of
    blocks on one process: y halos cross processes, x halos stay local.
    Each block records its owning rank. A collective."""
    devs = global_devices()
    if shape is None:
        shape = best_grid(len(devs))
    ry, rx = shape
    if ry * rx != len(devs):
        raise ValueError(f"mesh shape {tuple(shape)} != {len(devs)} global devices")
    rows = [devs[iy * rx:(iy + 1) * rx] for iy in range(ry)]
    return Mesh(devices=tuple(tuple(d for _, d in row) for row in rows),
                owners=tuple(tuple(r for r, _ in row) for row in rows),
                rank=process_index())


def is_cross_rank(mesh: Optional[Mesh]) -> bool:
    """True when ``mesh``'s blocks belong to more than one rank."""
    return mesh is not None and mesh.owners is not None and len(
        {r for row in mesh.owners for r in row}) > 1


def _transport(t: torch.Tensor) -> torch.Tensor:
    """``t`` as the backend moves it: gloo takes host tensors, so a CUDA
    tensor is staged through a pinned host buffer."""
    if t.is_cuda and backend() != "nccl":
        return t.to("cpu", non_blocking=False).pin_memory()
    return t.contiguous()


def _empty_transport(shape, dtype, device) -> torch.Tensor:
    if torch.device(device).type == "cuda" and backend() != "nccl":
        return torch.empty(shape, dtype=dtype, pin_memory=True)
    return torch.empty(shape, dtype=dtype, device=device)


def exchange(sends, recvs) -> None:
    """One round of P2P transfers, every rank posting its part of one
    global list in the same order: ``sends`` [(tensor, dst rank, tag)],
    ``recvs`` [(tensor to fill, src rank, tag)], each in that global order.
    Tags are unique within the round."""
    ops = [dist.P2POp(dist.isend, _transport(t), dst, tag=tag) for t, dst, tag in sends]
    staged = []
    for t, src, tag in recvs:
        buf = _empty_transport(t.shape, t.dtype, t.device)
        staged.append((t, buf))
        ops.append(dist.P2POp(dist.irecv, buf, src, tag=tag))
    if not ops:
        return
    for w in dist.batch_isend_irecv(ops):
        w.wait()
    for t, buf in staged:
        if buf.data_ptr() != t.data_ptr():
            t.copy_(buf)


def all_gather(t: torch.Tensor) -> List[torch.Tensor]:
    """Every rank's ``t`` (same shape and dtype on every rank), in rank
    order, on ``t``'s device."""
    src = _transport(t)
    out = [torch.empty_like(src) for _ in range(process_count())]
    dist.all_gather(out, src)
    return [o.to(t.device) for o in out]


def reduce_monitors(force: torch.Tensor, max_v: torch.Tensor):
    """The global monitors from this rank's partial force sum [2] (float64)
    and maximum speed: gathered from every rank and reduced in rank order
    in float64, so every rank computes the same bits (a NaN anywhere gives
    NaN); returned in ``max_v``'s dtype."""
    part = torch.cat([force.reshape(2).to(torch.float64),
                      max_v.reshape(1).to(torch.float64)])
    parts = torch.stack(all_gather(part))
    f = parts[0, :2]
    for r in range(1, parts.shape[0]):
        f = f + parts[r, :2]
    return f.to(max_v.dtype), parts[:, 2].max().to(max_v.dtype)


def gather_replicated(blocks, mesh: Mesh) -> torch.Tensor:
    """The global [..., H, W] field from every rank's own blocks:
    ``blocks`` [ry][rx] holds this rank's [..., hl, wl] blocks (None where
    another rank owns one). On every rank, on the device of its first
    block. A collective every rank must join on a mesh that spans ranks."""
    ry, rx = mesh.grid
    per_rank = {}
    for iy in range(ry):
        for ix in range(rx):
            per_rank.setdefault(mesh.owner(iy, ix), []).append((iy, ix))
    mine = per_rank[mesh.rank]
    first = blocks[mine[0][0]][mine[0][1]]
    if not is_cross_rank(mesh):
        return gather_blocks(blocks, first.device)
    k = max(len(v) for v in per_rank.values())
    pack = torch.zeros((k,) + tuple(first.shape), dtype=first.dtype, device=first.device)
    for j, (iy, ix) in enumerate(mine):
        pack[j] = blocks[iy][ix]
    packs = all_gather(pack)
    hl, wl = first.shape[-2:]
    out = torch.empty(tuple(first.shape[:-2]) + (ry * hl, rx * wl), dtype=first.dtype,
                      device=first.device)
    for r, coords in per_rank.items():
        for j, (iy, ix) in enumerate(coords):
            out[..., iy * hl:(iy + 1) * hl, ix * wl:(ix + 1) * wl] = packs[r][j]
    return out


def gather_for_io(blocks, mesh: Mesh) -> np.ndarray:
    """``gather_replicated`` as numpy, for host-side IO."""
    return gather_replicated(blocks, mesh).cpu().numpy()


def broadcast_object(obj, src: int = 0):
    """``obj`` of rank ``src`` on every rank (a collective)."""
    box = [obj]
    dist.broadcast_object_list(box, src=src)
    return box[0]


def broadcast_tensor(t: torch.Tensor, src: int = 0) -> torch.Tensor:
    """Rank ``src``'s ``t`` on every rank (same shape and dtype everywhere),
    on ``t``'s device. A collective."""
    buf = _transport(t)
    dist.broadcast(buf, src=src)
    return buf.to(t.device)


def sync() -> None:
    """Barrier across processes (checkpoint/artifact ordering)."""
    if is_multihost():
        dist.barrier()
