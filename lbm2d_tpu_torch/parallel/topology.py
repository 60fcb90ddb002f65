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
blocks (``Mesh.owns``). A case's state lives on the blocks as a
``BlockState``, placed once and gathered only where a field is read.
"""

from __future__ import annotations

import dataclasses
from dataclasses import dataclass
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.solver import CaseParams, LBMState

AXIS_Y, AXIS_X = "dy", "dx"
FIELDS = ("f", "f_post", "rho", "u")


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
    def single_device(self) -> Optional[torch.device]:
        """The device of every block when this process holds them all on
        one device (a 1x1 mesh, or one card named for every block), else
        None."""
        devices = {d for row in self.devices for d in row}
        ranks = {self.rank} if self.owners is None else {r for row in self.owners for r in row}
        return next(iter(devices)) if len(devices) == 1 and ranks == {self.rank} else None

    @property
    def shape(self) -> Dict[str, int]:
        """{AXIS_Y: ry, AXIS_X: rx}, as a JAX mesh's shape."""
        ry, rx = self.grid
        return {AXIS_Y: ry, AXIS_X: rx}


def make_mesh(shape: Optional[Tuple[int, int]] = None,
              devices: Optional[Sequence] = None) -> Mesh:
    """2D mesh over ``devices`` (by default the CUDA devices, which must
    exist: a CPU mesh is asked for by naming its devices, as
    ``engine.resolve_device`` asks for the CPU); shape defaults to
    most-square."""
    if devices is None:
        if not torch.cuda.is_available():
            raise RuntimeError("make_mesh: no CUDA device is available; pass devices "
                               "(e.g. ['cpu'] * n) for a mesh on the CPU")
        devices = [torch.device("cuda", i) for i in range(torch.cuda.device_count())]
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
    [hl, wl] part of f, f_post, rho and u, and ``shard_params``'s blocks of
    ``p`` -- the JAX ``state_specs`` / ``params_specs`` -- each on its mesh
    device. Blocks another process owns are None."""
    hl, wl = block_shape(p.shape, mesh)
    states = [[LBMState(**{k: _cut(getattr(state, k), iy, ix, hl, wl, dev) for k in FIELDS},
                        step=state.step) if mesh.owns(iy, ix) else None
               for ix, dev in enumerate(row)] for iy, row in enumerate(mesh.devices)]
    return states, shard_params(p, mesh)


def shard_params(p: CaseParams, mesh: Mesh):
    """[ry][rx] blocks of ``p``: each block's [hl, wl] part of mask,
    damping and bouzidi_q ([8, hl, wl]), its rows of inlet_profile
    ([hl]), the scalars replicated -- the JAX ``params_specs`` -- each on
    its mesh device. Blocks another process owns are None."""
    hl, wl = block_shape(p.shape, mesh)
    scalars = ("tau0", "cs_factor", "s_ghost", "rho_in", "rho_out", "warmup_steps", "bc_value")
    params: List[List[Optional[CaseParams]]] = []
    for iy, row in enumerate(mesh.devices):
        params.append([])
        for ix, dev in enumerate(row):
            if not mesh.owns(iy, ix):
                params[-1].append(None)
                continue
            fields = {k: getattr(p, k).to(dev) for k in scalars}
            fields.update(mask=_cut(p.mask, iy, ix, hl, wl, dev),
                          damping=_cut(p.damping, iy, ix, hl, wl, dev))
            if p.bouzidi_q is not None:
                fields["bouzidi_q"] = _cut(p.bouzidi_q, iy, ix, hl, wl, dev)
            if p.inlet_profile is not None:
                fields["inlet_profile"] = p.inlet_profile[iy * hl:(iy + 1) * hl].to(dev)
            params[-1].append(dataclasses.replace(p, **fields))
    return params


def halo_blocks(x: torch.Tensor, mesh: Mesh, fill, pitch: Optional[int] = None):
    """[ry][rx] blocks [..., hl + 2, pitch] of the global [..., H, W]
    tensor ``x``, each on its mesh device, with the 1-cell halo ring cut
    from the neighbours' cells; halo cells beyond the global edge and the
    padding columns hold ``fill``. Blocks another process owns are None."""
    hl, wl = block_shape(x.shape[-2:], mesh)
    pitch = pitch or wl + 2
    lead = tuple(x.shape[:-2])
    xp = torch.full(lead + (x.shape[-2] + 2, x.shape[-1] + 2), fill, dtype=x.dtype,
                    device=x.device)
    xp[..., 1:-1, 1:-1] = x
    out = []
    for iy, row in enumerate(mesh.devices):
        out.append([])
        for ix, dev in enumerate(row):
            if not mesh.owns(iy, ix):
                out[-1].append(None)
                continue
            b = torch.full(lead + (hl + 2, pitch), fill, dtype=x.dtype, device=dev)
            b[..., :, :wl + 2] = xp[..., iy * hl:iy * hl + hl + 2, ix * wl:ix * wl + wl + 2]
            out[-1].append(b)
    return out


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


@dataclass
class BlockState:
    """A case's state resident on the blocks of a mesh, the counterpart of
    the JAX package's sharded ``LBMState``: placed once (``place``), then
    advanced chunk by chunk by the runners of ``parallel/sharded.py`` and
    gathered only where the host reads a field (``gather``).

    For each block this process owns, ``f``, ``f_post``, ``rho`` and ``u``
    are planes [C, hl + 2 halo, pitch] whose own cells start at (halo,
    halo): K1's halo'd layout (halo 1, ``f_alt`` the second buffer of the
    ping-pong), or the bare [C, hl, wl] blocks of the eager step (halo 0).
    Blocks another process owns are None. No tensor of the global shape
    is held, except, on a mesh whose blocks all share one device
    (``Mesh.single_device``), ``f_post_global``: the chunk's closing
    f_post gathered there, which the force and the moments read as the
    single-device path does. f_post's cells on the global ring keep their
    placed values, as the single-device runners keep them."""

    mesh: Mesh
    hl: int
    wl: int
    halo: int
    f: list
    f_post: list
    rho: list
    u: list
    step: int
    f_alt: Optional[list] = None
    f_post_global: Optional[torch.Tensor] = None

    @classmethod
    def place(cls, state: LBMState, mesh: Mesh, halo: int = 0,
              pitch: Optional[int] = None) -> "BlockState":
        """This process's blocks of the global ``state`` (the JAX
        ``shard_state``; on a mesh spanning processes, ``shard_state_global``:
        each process cuts its own blocks from the identical host data).
        ``halo`` 1 cuts K1's halo'd planes of width ``pitch``, f's halo ring
        from the neighbours' cells and NaN beyond the global edge (never
        read), f_post's zero there (the force's reads on a block's edge)."""
        hl, wl = block_shape(state.rho.shape, mesh)
        if halo:
            def cut(x, fill):
                return halo_blocks(x, mesh, fill, pitch)
        else:
            def cut(x, fill):
                return [[_cut(x, iy, ix, hl, wl, dev) if mesh.owns(iy, ix) else None
                         for ix, dev in enumerate(row)] for iy, row in enumerate(mesh.devices)]
        nan = float("nan")
        f = cut(state.f, nan)
        dev = mesh.single_device
        return cls(mesh=mesh, hl=hl, wl=wl, halo=halo, f=f, f_post=cut(state.f_post, 0.0),
                   rho=cut(state.rho, nan), u=cut(state.u, nan), step=int(state.step),
                   f_alt=_clone(f) if halo else None,
                   f_post_global=None if dev is None else state.f_post.to(dev, copy=True))

    def own(self, name: str):
        """[ry][rx] views of field ``name``'s own cells [..., hl, wl] (None
        where another process owns the block)."""
        h, hl, wl = self.halo, self.hl, self.wl
        return [[None if b is None else b[..., h:h + hl, h:h + wl] for b in row]
                for row in getattr(self, name)]

    @property
    def device(self) -> torch.device:
        """The device a gathered field lands on: the first block this
        process owns."""
        iy, ix = next((iy, ix) for iy, row in enumerate(self.mesh.devices)
                      for ix in range(len(row)) if self.mesh.owns(iy, ix))
        return self.mesh.devices[iy][ix]

    def gather(self, name: str) -> torch.Tensor:
        """The global field ``name`` on ``device``
        (``multihost.gather_replicated``: ``gather_blocks`` in one process,
        a collective every process must join on a mesh spanning several).
        On a one-device mesh f_post is ``f_post_global`` itself, which the
        next chunk overwrites."""
        if name == "f_post" and self.f_post_global is not None:
            return self.f_post_global
        from .multihost import gather_replicated

        return gather_replicated(self.own(name), self.mesh)

    def collect_f_post(self) -> None:
        """Copy the blocks' own f_post cells into ``f_post_global`` (a
        one-device mesh, after each chunk)."""
        hl, wl = self.hl, self.wl
        for iy, row in enumerate(self.own("f_post")):
            for ix, b in enumerate(row):
                self.f_post_global[:, iy * hl:(iy + 1) * hl, ix * wl:(ix + 1) * wl].copy_(b)

    def snapshot(self) -> LBMState:
        """The global ``LBMState`` (four gathers, collectives on a mesh
        spanning processes), sharing no storage with the blocks."""
        fields = {k: self.gather(k) for k in FIELDS}
        fields["f_post"] = fields["f_post"].clone() if self.f_post_global is not None \
            else fields["f_post"]
        return LBMState(step=self.step, **fields)


def _clone(blocks):
    return [[None if b is None else b.clone() for b in row] for row in blocks]
