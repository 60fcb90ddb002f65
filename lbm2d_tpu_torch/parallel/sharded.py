"""Spatially sharded chunk runners (counterpart of
``lbm2d_tpu/parallel/sharded.py``).

Large grids (README step 3c: 4096^2 class) are cut into the blocks of a
device mesh (``parallel/topology.py``). Each lattice step a block needs a
1-cell halo of its neighbours' cells, refreshed in two phases as in the
JAX package: x edges first, then y edges carrying the x halos just
written, so the corner cells the diagonal velocities read arrive in two
hops. One process drives every block, as ``shard_map`` does; the halos
move by device-to-device copies where the JAX package uses
``lax.ppermute``. Halos beyond the global edge are never read: only cells
interior in the global grid are collided, and the boundary conditions act
on the blocks that hold the global ring, gated by each block's global
origin, in the reference order. So a mesh of any shape runs the same
arithmetic on every cell as the single-device step, bitwise.

Three chunk runners, each with ``solver.run_chunk``'s contract
``(state, p, n) -> (state, {"force", "max_v"})``:

* ``run_chunk_sharded``: the eager per-shard step (the JAX package's
  ``make_local_step``, ``exchange_halo_f`` and ``_sharded_apply_bc``);
  the engine's runner on the CPU.
* ``run_chunk_sharded_cuda``: the counterpart of
  ``run_chunk_sharded_pallas``. Each step runs K1 in its sharded form
  (``cuda_step.k1_step`` given each block's ``BlockGeom``; one launch a
  block, the global ring written by the blocks that hold it) on every
  block, then refreshes the halos; the last step is K1's full variant.
  With ``store_dev`` the blocks and their halos stay bf16 deviations and
  the closing full step dequantizes, as the single-device runner does.
* ``run_chunk_sharded_plain``: the same through the kernels' plain
  versions.

Each runner scatters the global state into blocks at the start of a chunk
and gathers it at the end, so the engine, checkpoints and writers see one
global ``LBMState``; the monitors are computed on the gathered f_post and
u, as the JAX package's are global reductions. f_post keeps the global
ring's initial values.

On a mesh whose blocks belong to several processes
(``multihost.make_global_mesh``) each process cuts, advances and writes
back only its own blocks, into its global-shaped state: the other
processes' parts of it are stale, and ``multihost.gather_for_io`` reads
the whole field. Halos between a process's own blocks are device copies,
halos that cross processes go through ``multihost.exchange`` (P2P in one
fixed order), and the monitors are each process's sums and maxima over
its own cells, reduced over the processes in rank order. The f_post
halos are refreshed once at the end of the chunk, so the force's
neighbour reads across a seam see the neighbour's values.
"""

from __future__ import annotations

from typing import List, Optional

import torch

from ..core.lattice import E
from ..core.lattice import W as W_LAT
from ..core.solver import (
    CaseParams,
    LBMState,
    bc_horizontal_values,
    bc_left_values,
    bc_right_values,
    full_way_bounce,
    link_bounce_at,
    max_velocity,
    mrt_collide_arrays,
    obstacle_force,
    warmup_ramp,
)
from ..ops import cuda_step as cs
from .topology import Mesh, block_shape, gather_blocks, gather_state, shard_state

NAN = float("nan")


def _coords(mesh: Mesh):
    """This process's blocks of ``mesh`` (every block unless the mesh
    spans processes)."""
    ry, rx = mesh.grid
    return [(iy, ix) for iy in range(ry) for ix in range(rx) if mesh.owns(iy, ix)]


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


def gather_halo_blocks(blocks, hl: int, wl: int, device) -> torch.Tensor:
    """The global [..., H, W] tensor from halo'd blocks (their own cells)."""
    return gather_blocks([[b[..., 1:hl + 1, 1:wl + 1] for b in row] for row in blocks], device)


# ---------------------------------------------------------------------------
# Eager per-shard step (make_local_step)
# ---------------------------------------------------------------------------


def exchange_halo_f(blocks, mesh: Mesh):
    """[ry][rx] blocks [C, h, w] -> [C, h + 2, w + 2] with the neighbours'
    cells in the halo, corners included: x edges first, then y edges of
    the x-extended blocks (``exchange_halos``). Sides on the global edge
    get zeros, which no interior cell reads."""
    ry, rx = mesh.grid
    out = [[None] * rx for _ in range(ry)]
    hl = wl = 0
    for iy, ix in _coords(mesh):
        b = blocks[iy][ix]
        hl, wl = b.shape[-2:]
        out[iy][ix] = torch.zeros(b.shape[:-2] + (hl + 2, wl + 2), dtype=b.dtype,
                                  device=b.device)
        out[iy][ix][..., 1:hl + 1, 1:wl + 1] = b
    exchange_halos(out, mesh, hl, wl)
    return out


def _sharded_apply_bc(f, rho, u, step: int, p: CaseParams, y0: int, x0: int, ny: int, nx: int):
    """``solver.apply_bc`` on one block, in place: a BC acts where the
    block's global origin puts it on the global edge, the side columns on
    global inner rows only."""
    h, w = rho.shape
    ramp = warmup_ramp(step, float(p.warmup_steps), f.dtype)
    gy = y0 + torch.arange(h, device=f.device)
    inner_rows = (gy >= 1) & (gy <= ny - 2)

    def set_col(col, vals):
        fb, rho_b, ux_b, uy_b = vals
        f[:, :, col] = torch.where(inner_rows[None], fb, f[:, :, col])
        rho[:, col] = torch.where(inner_rows, rho_b, rho[:, col])
        u[0, :, col] = torch.where(inner_rows, ux_b, u[0, :, col])
        u[1, :, col] = torch.where(inner_rows, uy_b, u[1, :, col])

    if x0 == 0:
        vals = bc_left_values(f[:, :, 1], rho[:, 1], u[0, :, 1], u[1, :, 1], ramp,
                              p.bc_type[0], p.rho_in, u_prof=p.inlet_profile)
        if vals is not None:
            set_col(0, vals)
    if x0 + w == nx:
        vals = bc_right_values(f[:, :, -2], rho[:, -2], u[0, :, -2], u[1, :, -2], ramp,
                               p.bc_type[2], p.rho_out, p.bc_value[2])
        if vals is not None:
            set_col(w - 1, vals)
    for side, row, nbr, on_edge in ((1, h - 1, h - 2, y0 + h == ny), (3, 0, 1, y0 == 0)):
        if not on_edge:
            continue
        vals = bc_horizontal_values(f[:, nbr, :], rho[nbr, :], u[0, nbr, :], u[1, nbr, :],
                                    ramp, p.bc_type[side], p.bc_value[side])
        if vals is not None:
            fb, rho_b, ux_b, uy_b = vals
            f[:, row, :] = fb
            rho[row, :] = rho_b
            u[0, row, :] = ux_b
            u[1, row, :] = uy_b
    # obstacles (full-way bounce-back handled in the collide, as solver)
    solid = p.mask > 0.5
    if not p.bounce_obstacle:
        w9 = torch.as_tensor(W_LAT, dtype=f.dtype, device=f.device).reshape(9, 1, 1)
        f = torch.where(solid[None], w9 * rho[None], f)
    u = torch.where(solid[None], torch.zeros_like(u), u)
    return f, rho, u


def local_step(st: LBMState, p: CaseParams, f_halo: torch.Tensor, solid_halo: torch.Tensor,
               y0: int, x0: int, ny: int, nx: int) -> LBMState:
    """One lattice update of a block whose origin is (y0, x0) in the
    ny x nx grid: ``f_halo`` [9, h + 2, w + 2] is its f with the
    neighbours' cells around it, ``solid_halo`` the solid flags likewise
    (the half-way and Bouzidi link predicate reads the pull source, which
    may lie across a seam). Only globally interior cells are collided."""
    h, w = st.rho.shape
    gy = y0 + torch.arange(h, device=st.f.device)
    gx = x0 + torch.arange(w, device=st.f.device)
    interior = ((gy >= 1) & (gy <= ny - 2))[:, None] & ((gx >= 1) & (gx <= nx - 2))[None, :]

    def f_at(k, dy, dx):
        return f_halo[k, 1 + dy:1 + dy + h, 1 + dx:1 + dx + w]

    fs = torch.stack([f_at(k, -int(E[k, 1]), -int(E[k, 0])) for k in range(9)])
    if p.halfway_obstacle or p.bouzidi_obstacle:
        fs = link_bounce_at(f_at, lambda dy, dx: solid_halo[1 + dy:1 + dy + h, 1 + dx:1 + dx + w],
                            fs, p.bouzidi_q if p.bouzidi_obstacle else None)
    f_c, rho_c, ux_c, uy_c = mrt_collide_arrays(fs, p.damping, p.tau0, p.cs_factor, p.s_ghost,
                                                p.use_les)
    if p.bounce_obstacle:
        f_c = full_way_bounce(fs, f_c, p.mask > 0.5)
    f_post = torch.where(interior[None], f_c, st.f_post)
    f = torch.where(interior[None], f_c, st.f)
    rho = torch.where(interior, rho_c, st.rho)
    u = torch.stack([torch.where(interior, ux_c, st.u[0]), torch.where(interior, uy_c, st.u[1])])
    new_step = st.step + 1
    f, rho, u = _sharded_apply_bc(f, rho, u, new_step, p, y0, x0, ny, nx)
    return LBMState(f=f, f_post=f_post, rho=rho, u=u, step=new_step)


def _monitors(state: LBMState, p: CaseParams):
    return {"force": obstacle_force(state.f_post, p), "max_v": max_velocity(state.u)}


def _own_region(mesh: Mesh, shape, hl: int, wl: int, device) -> torch.Tensor:
    """bool [H, W]: the cells of this process's blocks."""
    own = torch.zeros(shape, dtype=torch.bool, device=device)
    for iy, ix in _coords(mesh):
        own[iy * hl:(iy + 1) * hl, ix * wl:(ix + 1) * wl] = True
    return own


def _own_state(state: LBMState, n_steps: int, mesh: Mesh, hl: int, wl: int, off: int,
               f, f_post, rho, u, p: CaseParams):
    """The chunk's new global-shaped state on a mesh spanning processes:
    ``state`` with this process's blocks written back (``f``, ``rho``,
    ``u`` [ry][rx] blocks whose own cells start at (off, off)), and f_post
    from the halo'd blocks ``f_post`` (halos refreshed) on the blocks'
    cells and their halo ring, inside the global ring; and the global
    monitors."""
    from . import multihost

    H, W = p.shape
    out = {k: getattr(state, k).clone() for k in ("f", "f_post", "rho", "u")}
    for iy, ix in _coords(mesh):
        ys, xs = slice(iy * hl, (iy + 1) * hl), slice(ix * wl, (ix + 1) * wl)
        for k, blocks in (("f", f), ("rho", rho), ("u", u)):
            out[k][..., ys, xs] = blocks[iy][ix][..., off:off + hl, off:off + wl]
        y0, y1 = max(iy * hl - 1, 1), min((iy + 1) * hl + 1, H - 1)
        x0, x1 = max(ix * wl - 1, 1), min((ix + 1) * wl + 1, W - 1)
        by, bx = iy * hl - 1, ix * wl - 1  # the halo'd block's origin
        out["f_post"][:, y0:y1, x0:x1] = f_post[iy][ix][:, y0 - by:y1 - by, x0 - bx:x1 - bx]
    new_state = LBMState(step=state.step + n_steps, **out)
    own = _own_region(mesh, (H, W), hl, wl, new_state.f.device)
    force = obstacle_force(new_state.f_post, p, region=own)
    speed = torch.sqrt(new_state.u[0] * new_state.u[0] + new_state.u[1] * new_state.u[1])
    max_v = torch.where(own, speed, torch.zeros_like(speed)).max()
    force, max_v = multihost.reduce_monitors(force, max_v)
    return new_state, {"force": force, "max_v": max_v}


def run_chunk_sharded(state: LBMState, p: CaseParams, n_steps: int, mesh: Mesh):
    """Advance ``n_steps`` on ``mesh`` with the eager per-shard step;
    monitors computed on the gathered state."""
    ny, nx = p.shape
    hl, wl = block_shape(p.shape, mesh)
    blocks, params = shard_state(state, p, mesh)
    solid = halo_blocks(p.mask > 0.5, mesh, False)
    for _ in range(n_steps):
        halos = exchange_halo_f([[b and b.f for b in row] for row in blocks], mesh)
        blocks = [[local_step(blocks[iy][ix], params[iy][ix], halos[iy][ix], solid[iy][ix],
                              iy * hl, ix * wl, ny, nx) if mesh.owns(iy, ix) else None
                   for ix in range(len(row))] for iy, row in enumerate(blocks)]
    if mesh.owners is not None:
        def part(k):
            return [[b and getattr(b, k) for b in row] for row in blocks]

        f_post = exchange_halo_f(part("f_post"), mesh)
        return _own_state(state, n_steps, mesh, hl, wl, 0, part("f"), f_post, part("rho"),
                          part("u"), p)
    new_state = gather_state(blocks, state.f.device)
    return new_state, _monitors(new_state, p)


# ---------------------------------------------------------------------------
# K1 on every block (run_chunk_sharded_pallas)
# ---------------------------------------------------------------------------


class ShardedCase:
    """The inputs of a case on a mesh that do not change between chunks,
    cut once: each block's geometry, its aux plane with the 1-cell halo
    (the link predicate reads the pull source's solid flag across a seam;
    a zero halo would turn seam links into fluid links), its Bouzidi q
    planes and its rows of the inlet profile."""

    def __init__(self, p: CaseParams, mesh: Mesh):
        why = cs.unsupported(p)
        if why is not None:
            raise ValueError(f"the sharded kernels do not support this case: {why}")
        H, W = p.shape
        self.p, self.mesh = p, mesh
        self.hl, self.wl = hl, wl = block_shape(p.shape, mesh)  # raises for a refused mesh
        self.geoms = [[cs.BlockGeom.shard(hl, wl, iy * hl, ix * wl, H, W)
                       for ix in range(len(row))] for iy, row in enumerate(mesh.devices)]
        self.pitch = self.geoms[0][0].pitch
        self.obstacle = cs.obstacle_scheme(p)
        self.aux = halo_blocks(cs.pack_aux(p.damping, p.mask), mesh, NAN, self.pitch)
        self.q = (halo_blocks(p.bouzidi_q, mesh, NAN, self.pitch)
                  if self.obstacle == cs.OBSTACLE_BOUZIDI else None)
        self.prof = None
        if p.bc_type[0] in (cs.BC_VEL_INLET, cs.BC_VEL_INLET_NEBB):
            self.prof = [[p.inlet_profile[iy * hl:(iy + 1) * hl].to(dev).contiguous()
                          if mesh.owns(iy, ix) else None
                          for ix, dev in enumerate(row)] for iy, row in enumerate(mesh.devices)]


def _at(blocks, iy: int, ix: int):
    """Block (iy, ix) of optional per-block inputs."""
    return None if blocks is None else blocks[iy][ix]


def exchange_halos(blocks, mesh: Mesh, hl: int, wl: int) -> None:
    """Refresh the 1-cell halo of halo'd blocks [C, hl + 2, pitch] in place:
    the x edges first, then the y edges with the x halos just written
    (corners in two hops). Block sides on the global edge are left alone:
    no interior cell reads them, and a 1x1 mesh copies nothing. On a mesh
    spanning processes only this process's blocks are given (others None):
    a seam between two of them is a device copy, a seam to another
    process's block a P2P transfer (``_exchange_cross``)."""
    if mesh.owners is not None:
        _exchange_cross(blocks, mesh, hl, wl)
        return
    ry, rx = mesh.grid
    rows = slice(1, hl + 1)
    for iy, ix in _coords(mesh):
        b = blocks[iy][ix]
        if ix > 0:
            b[:, rows, 0].copy_(blocks[iy][ix - 1][:, rows, wl])
        if ix + 1 < rx:
            b[:, rows, wl + 1].copy_(blocks[iy][ix + 1][:, rows, 1])
    cols = slice(0, wl + 2)
    for iy, ix in _coords(mesh):
        b = blocks[iy][ix]
        if iy > 0:
            b[:, 0, cols].copy_(blocks[iy - 1][ix][:, hl, cols])
        if iy + 1 < ry:
            b[:, hl + 1, cols].copy_(blocks[iy + 1][ix][:, 1, cols])


def _exchange_cross(blocks, mesh: Mesh, hl: int, wl: int) -> None:
    """``exchange_halos`` on a mesh spanning processes. Each phase walks
    every seam of the mesh in one global order, the same on every
    process; a transfer between two blocks this process owns is a copy,
    one to or from another process's block a tagged P2P send or receive,
    so the posts of every process pair match and cannot deadlock. The
    x phase completes before the y phase reads the x halos."""
    from . import multihost

    ry, rx = mesh.grid
    rows, cols = slice(1, hl + 1), slice(0, wl + 2)
    # (source block, its edge, destination block, its halo) per transfer
    x_phase = []
    for iy in range(ry):
        for ix in range(rx - 1):
            x_phase.append(((iy, ix), (rows, wl), (iy, ix + 1), (rows, 0)))
            x_phase.append(((iy, ix + 1), (rows, 1), (iy, ix), (rows, wl + 1)))
    y_phase = []
    for iy in range(ry - 1):
        for ix in range(rx):
            y_phase.append(((iy, ix), (hl, cols), (iy + 1, ix), (0, cols)))
            y_phase.append(((iy + 1, ix), (1, cols), (iy, ix), (hl + 1, cols)))
    for phase in (x_phase, y_phase):
        sends, recvs = [], []
        for tag, (src, (sr, sc), dst, (dr, dc)) in enumerate(phase):
            mine_src, mine_dst = mesh.owns(*src), mesh.owns(*dst)
            if mine_src and mine_dst:
                b = blocks[dst[0]][dst[1]]
                b[:, dr, dc].copy_(blocks[src[0]][src[1]][:, sr, sc])
            elif mine_src:
                sends.append((blocks[src[0]][src[1]][:, sr, sc], mesh.owner(*dst), tag))
            elif mine_dst:
                recvs.append((blocks[dst[0]][dst[1]][:, dr, dc], mesh.owner(*src), tag))
        multihost.exchange(sends, recvs)


def _kernels(plain: bool):
    """(K1, K1 dev) wrappers or plain versions, looked up at call time."""
    names = ("k1_step", "k1_step_dev")
    return tuple(getattr(cs, n + ("_plain" if plain else "")) for n in names)


def fast_step(src, dst, case: ShardedCase, scal: torch.Tensor, dev_store: bool,
              plain: bool = False) -> None:
    """One fast step on every block, ``src`` -> ``dst`` ([ry][rx] halo'd
    blocks, bf16 deviations when ``dev_store``): one K1 launch a block, then
    the halo refresh of ``dst``."""
    k1, k1d = _kernels(plain)
    p, obst = case.p, case.obstacle
    for iy, ix in _coords(case.mesh):
        g, aux, prof = case.geoms[iy][ix], case.aux[iy][ix], _at(case.prof, iy, ix)
        if dev_store:
            k1d(src[iy][ix], dst[iy][ix], aux, scal, p.use_les, p.bc_type, obst, prof, geom=g)
        else:
            k1(src[iy][ix], dst[iy][ix], aux, scal, p.use_les, p.bc_type, obstacle=obst,
               q=_at(case.q, iy, ix), prof=prof, geom=g)
    exchange_halos(dst, case.mesh, case.hl, case.wl)


def run_chunk_sharded_cuda(state: LBMState, p: CaseParams, n_steps: int, mesh: Mesh,
                           store_dev: bool = False, case: Optional[ShardedCase] = None):
    """Advance ``n_steps`` on ``mesh`` through K1 in its sharded form; the
    contract and the rules of ``cuda_step.run_chunk_cuda`` (``store_dev``
    for chunks of more than one step, equilibrium and full-way bounce-back
    only; never fused). ``case`` is the
    ``ShardedCase`` of (p, mesh), cut here when not given."""
    return _run_chunk_blocks(state, p, n_steps, mesh, store_dev, False, case)


def run_chunk_sharded_plain(state: LBMState, p: CaseParams, n_steps: int, mesh: Mesh,
                            store_dev: bool = False, case: Optional[ShardedCase] = None):
    """``run_chunk_sharded_cuda`` through the kernels' plain versions on
    any device."""
    return _run_chunk_blocks(state, p, n_steps, mesh, store_dev, True, case)


def _run_chunk_blocks(state, p, n_steps, mesh, store_dev, plain, case):
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if case is None or case.p is not p or case.mesh != mesh:
        case = ShardedCase(p, mesh)
    k1, _ = _kernels(plain)
    dev_store = (bool(store_dev) and n_steps > 1
                 and cs.dev_storage_refusal(p, sharded=True) is None)
    hl, wl = case.hl, case.wl
    src = halo_blocks(state.f, mesh, NAN, case.pitch)
    if mesh.owners is not None:
        # the halos cut from this process's state are other processes'
        # stale cells: refresh them from their owners
        exchange_halos(src, mesh, hl, wl)
    if dev_store:
        # quantize once per chunk, halos included: the halo copies then move
        # bf16 deviations, as the JAX package's ppermute rows do
        src = [[b if b is None else cs.quantize(b) for b in row] for row in src]
    dst = [[b if b is None else b.clone() for b in row] for row in src]
    row, warmup = cs._host_scalars(p)
    step = state.step
    for _ in range(n_steps - 1):
        step += 1
        fast_step(src, dst, case, cs._with_ramp(row, warmup, step), dev_store, plain)
        src, dst = dst, src
    if dev_store:
        # the closing full step runs in exact f32
        src = [[b if b is None else cs.dequantize(b) for b in r] for r in src]
        dst = [[b if b is None else torch.empty_like(b) for b in r] for r in src]
    scal = cs._with_ramp(row, warmup, step + 1)
    rho, u, f_post = ([[None] * len(r) for r in src] for _ in range(3))
    for iy, ix in _coords(mesh):
        g, aux, b = case.geoms[iy][ix], case.aux[iy][ix], src[iy][ix]
        rho[iy][ix] = torch.empty(g.plane, dtype=torch.float32, device=b.device)
        u[iy][ix] = torch.empty((2,) + g.plane, dtype=torch.float32, device=b.device)
        f_post[iy][ix] = torch.empty_like(b)
        k1(b, dst[iy][ix], aux, scal, p.use_les, p.bc_type, rho[iy][ix], u[iy][ix],
           f_post[iy][ix], obstacle=case.obstacle, q=_at(case.q, iy, ix),
           prof=_at(case.prof, iy, ix), geom=g)
    if mesh.owners is not None:
        exchange_halos(f_post, mesh, hl, wl)
        return _own_state(state, n_steps, mesh, hl, wl, 1, dst, f_post, rho, u, p)
    out = state.f.device
    fp = gather_halo_blocks(f_post, hl, wl, out)
    new_f_post = state.f_post.clone()
    new_f_post[:, 1:-1, 1:-1] = fp[:, 1:-1, 1:-1]
    new_state = LBMState(
        f=gather_halo_blocks(dst, hl, wl, out), f_post=new_f_post,
        rho=gather_halo_blocks(rho, hl, wl, out), u=gather_halo_blocks(u, hl, wl, out),
        step=state.step + n_steps,
    )
    return new_state, _monitors(new_state, p)


def make_runner(mesh: Mesh, kind: str, store_dev: bool = False):
    """The engine's chunk runner ``(state, p, n) -> (state, monitors)`` on
    ``mesh``: ``kind`` "cuda" (the kernels), "plain" (their plain versions)
    or "eager" (``run_chunk_sharded``). The kernel runners cut a case's
    blocks once per params object."""
    if kind == "eager":
        return lambda state, p, n: run_chunk_sharded(state, p, n, mesh)
    run = {"cuda": run_chunk_sharded_cuda, "plain": run_chunk_sharded_plain}[kind]
    cache: List[ShardedCase] = []

    def runner(state, p, n):
        if not cache or cache[0].p is not p:
            cache[:] = [ShardedCase(p, mesh)]
        return run(state, p, n, mesh, store_dev, cache[0])

    return runner
