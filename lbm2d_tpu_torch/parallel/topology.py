"""Device meshes for spatial domain decomposition (counterpart of
``lbm2d_tpu/parallel/topology.py``).

A mesh is an ry x rx grid of torch devices. The lattice is cut into
[H / ry, W / rx] blocks, block (iy, ix) holding rows iy * hl .. and columns
ix * wl .. on ``devices[iy][ix]``. One process drives every block, as the
JAX package's ``shard_map`` runs over the local devices of one process;
the halos move by device-to-device copies (``parallel/sharded.py``). A
device may appear more than once: the blocks then share it and their seams
are real all the same, which is how the CPU tests and one card run a mesh.
A mesh made by ``multihost.make_global_mesh`` spans processes: each block
records its owning rank, and a process holds and advances only its own
blocks (``Mesh.owns``).
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.solver import CaseParams, LBMState

AXIS_Y, AXIS_X = "dy", "dx"


def best_grid(n_devices: int) -> Tuple[int, int]:
    """Most-square (rows, cols) factorization of n_devices."""
    best = (1, n_devices)
    for r in range(1, int(np.sqrt(n_devices)) + 1):
        if n_devices % r == 0:
            best = (r, n_devices // r)
    return best


@dataclass(frozen=True)
class Mesh:
    """An ry x rx grid of torch devices, ``devices[iy][ix]``. ``owners``
    (a global mesh) gives each block's rank, ``rank`` this process's; with
    no ``owners`` every block is this process's."""

    devices: Tuple[Tuple[torch.device, ...], ...]
    owners: Optional[Tuple[Tuple[int, ...], ...]] = None
    rank: int = 0

    def owns(self, iy: int, ix: int) -> bool:
        """Whether this process holds block (iy, ix)."""
        return self.owners is None or self.owners[iy][ix] == self.rank

    def owner(self, iy: int, ix: int) -> int:
        return self.rank if self.owners is None else self.owners[iy][ix]

    @property
    def grid(self) -> Tuple[int, int]:
        return len(self.devices), len(self.devices[0])

    @property
    def shape(self) -> Dict[str, int]:
        """{AXIS_Y: ry, AXIS_X: rx}, as a JAX mesh's shape."""
        ry, rx = self.grid
        return {AXIS_Y: ry, AXIS_X: rx}


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """2D mesh over ``devices`` (the CUDA devices, else the CPU, by
    default); shape defaults to most-square."""
    if devices is None:
        n = torch.cuda.device_count() if torch.cuda.is_available() else 0
        devices = [torch.device("cuda", i) for i in range(n)] or [torch.device("cpu")]
    devices = [torch.device(d) for d in devices]
    if shape is None:
        shape = best_grid(len(devices))
    ry, rx = shape
    if ry * rx != len(devices):
        raise ValueError(f"mesh shape {tuple(shape)} != {len(devices)} devices")
    return Mesh(tuple(tuple(devices[iy * rx:(iy + 1) * rx]) for iy in range(ry)))


def mesh_refusal(shape, mesh_shape) -> Optional[str]:
    """Why a grid of ``shape`` (H, W) cannot be cut into the blocks of an
    ``mesh_shape`` (ry, rx) spatial mesh, or None: the grid must divide by
    the mesh, and each block must be at least 3x3 (K1's ring threads then
    find the inward neighbour of every ring cell on the block that holds
    it)."""
    (H, W), (ry, rx) = shape, mesh_shape
    if H % ry or W % rx:
        return f"grid {H}x{W} (HxW) not divisible by spatial_mesh {ry}x{rx}"
    if H // ry < 3 or W // rx < 3:
        return (f"spatial_mesh {ry}x{rx} cuts the {H}x{W} grid into "
                f"{H // ry}x{W // rx} blocks, smaller than 3x3")
    return None


def block_shape(shape, mesh: Mesh) -> Tuple[int, int]:
    """(hl, wl) of the blocks of an (H, W) grid on ``mesh``; ValueError
    when ``mesh_refusal`` turns the mesh down."""
    why = mesh_refusal(shape, mesh.grid)
    if why is not None:
        raise ValueError(why)
    (H, W), (ry, rx) = shape, mesh.grid
    return H // ry, W // rx


def _cut(x: torch.Tensor, iy: int, ix: int, hl: int, wl: int, dev) -> torch.Tensor:
    return x[..., iy * hl:(iy + 1) * hl, ix * wl:(ix + 1) * wl].to(dev).contiguous()


def shard_state(state: LBMState, p: CaseParams, mesh: Mesh):
    """(state blocks, params blocks), [ry][rx] lists: each block's
    [hl, wl] part of f, f_post, rho and u, and of mask, damping and
    bouzidi_q ([8, hl, wl]), its rows of inlet_profile ([hl]), the scalars
    replicated -- the JAX ``state_specs`` / ``params_specs`` -- each on its
    mesh device. Blocks another process owns are None."""
    hl, wl = block_shape(p.shape, mesh)
    scalars = ("tau0", "cs_factor", "s_ghost", "rho_in", "rho_out", "warmup_steps", "bc_value")
    states: List[List[LBMState]] = []
    params: List[List[CaseParams]] = []
    for iy, row in enumerate(mesh.devices):
        states.append([])
        params.append([])
        for ix, dev in enumerate(row):
            if not mesh.owns(iy, ix):
                states[-1].append(None)
                params[-1].append(None)
                continue
            states[-1].append(LBMState(
                f=_cut(state.f, iy, ix, hl, wl, dev), f_post=_cut(state.f_post, iy, ix, hl, wl, dev),
                rho=_cut(state.rho, iy, ix, hl, wl, dev), u=_cut(state.u, iy, ix, hl, wl, dev),
                step=state.step,
            ))
            fields = {k: getattr(p, k).to(dev) for k in scalars}
            fields.update(mask=_cut(p.mask, iy, ix, hl, wl, dev),
                          damping=_cut(p.damping, iy, ix, hl, wl, dev))
            if p.bouzidi_q is not None:
                fields["bouzidi_q"] = _cut(p.bouzidi_q, iy, ix, hl, wl, dev)
            if p.inlet_profile is not None:
                fields["inlet_profile"] = p.inlet_profile[iy * hl:(iy + 1) * hl].to(dev)
            params[-1].append(dataclasses.replace(p, **fields))
    return states, params


def gather_blocks(blocks, device) -> torch.Tensor:
    """The global [..., H, W] tensor on ``device`` from [ry][rx] blocks
    [..., hl, wl]."""
    return torch.cat([torch.cat([b.to(device) for b in row], dim=-1) for row in blocks], dim=-2)


def gather_state(states, device) -> LBMState:
    """The global LBMState on ``device`` from [ry][rx] state blocks."""
    def field(k):
        return gather_blocks([[getattr(s, k) for s in row] for row in states], device)

    return LBMState(f=field("f"), f_post=field("f_post"), rho=field("rho"), u=field("u"),
                    step=states[0][0].step)
