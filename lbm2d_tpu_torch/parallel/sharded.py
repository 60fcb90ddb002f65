"""Spatially sharded chunk runners (counterpart of
``lbm2d_tpu/parallel/sharded.py``).

Large grids (README step 3c: 4096^2 class) are cut into the blocks of a
device mesh (``parallel/topology.py``). Each lattice step a block needs a
1-cell halo of its neighbours' cells, refreshed in two phases as in the
JAX package: x edges first, then y edges carrying the x halos just
written, so the corner cells the diagonal velocities read arrive in two
hops. One process drives every block, as ``shard_map`` does; where the
JAX package uses ``lax.ppermute`` the halos move by K1's own stores into
its neighbours' halos (the library loop below) or by device-to-device
copies (the per-step loop), the same cells either way. Halos beyond the
global edge are never read: only cells interior in the global grid are
collided, and the boundary conditions act on the blocks that hold the
global ring, gated by each block's global origin, in the reference order. So a mesh of any shape runs the same
arithmetic on every cell as the single-device step, bitwise.

A case's state lives on its blocks (``topology.BlockState``), as the JAX
package's sharded arrays outlive a chunk: ``BlockRunner.place`` cuts it
once, ``BlockRunner.advance`` runs a chunk on the resident blocks in
place, and ``BlockState.gather`` assembles a field only where the host
reads one. Two runners advance the blocks:

* the eager per-shard step (the JAX package's ``make_local_step``,
  ``exchange_halo_f`` and ``_sharded_apply_bc``) on bare [C, hl, wl]
  blocks; the engine's runner on the CPU;
* K1 in its sharded form (the counterpart of ``run_chunk_sharded_pallas``;
  K1 given each block's ``BlockGeom``, one launch a block, the global
  ring written by the blocks that hold it) on halo'd [C, hl + 2, pitch]
  blocks, ping-ponging two resident buffers, the last step K1's full
  variant, which writes the resident rho, u and f_post. On a mesh whose
  blocks all live in this process -- a card each, as the engine lays out
  ``--spatial_mesh`` over a host's cards (peer access between them), or
  one device for all -- a chunk is one program, as the JAX package's jit
  over shard_map and lax.scan is: ``cuda_step.k1_shard_steps`` runs its
  fast steps in the library and ``cuda_step.k1_shard_full`` closes it,
  from host tables cut once a case (``ShardedCase.tables``). There a step
  is one K1 launch a block and nothing else: each thread that stores a
  cell on its block's edge also stores it into the halo slot of each
  neighbour that reads it (the push, ``csrc/halo.cuh``; over peer access
  when the neighbour is on another card), and each card's step i waits
  for its neighbouring cards' step i - 1 (two events a card, by the
  step's parity), which covers both the halos it reads and the buffers
  it pushes into. A mesh spanning processes, or cards without peer
  access, issues each step from Python (``fast_step``: a K1 call a block,
  pushing nothing, then ``exchange_halos``); the mesh decides
  (``shard_loop_refusal``), never a failure. That per-step loop,
  through the kernels' plain versions, is also the "plain" runner, and
  through the kernels the "stepwise" runner the library loop is held to on
  the card. With ``store_dev`` the resident blocks stay f32: the fast
  steps run on bf16 deviations quantized once a chunk, halos included,
  and the closing full step dequantizes, as the single-device runner does.

The monitors come from the blocks, in one launch of the monitor kernel
a card (``cuda_step.launch_monitors``, ``BlockMonitors``; the eager
per-shard runner keeps the eager reductions). ``max_v`` is the largest of
the blocks' maxima over their own cells, exact in any order. On a mesh
whose blocks all share one device the closing f_post is copied into one
resident global f_post there (``BlockState.f_post_global``), whose force
is the single-device runner's, bitwise: one launch reads its links and
the blocks' u. Elsewhere each block's force is its float64 sum over the
links of its window (``window_links``: the scheme's rule), the f_post
halos refreshed once at the chunk's end so a seam link reads its
neighbour's values; a card's blocks are one launch, and their sums are
added in block order and then over the processes in rank order.

On a mesh whose blocks belong to several processes
(``multihost.make_global_mesh``) each process places and advances only
its own blocks. Halos between a process's own blocks are device copies,
halos that cross processes go through ``multihost.exchange`` (P2P in one
fixed order), and a gather is a collective every process joins.

``run_chunk_sharded`` (eager), ``run_chunk_sharded_cuda`` and
``run_chunk_sharded_plain`` keep ``solver.run_chunk``'s contract
``(state, p, n) -> (state, {"force", "max_v"})`` as thin wrappers: place,
advance, gather all four fields.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

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
from .topology import BlockState, Mesh, block_shape, gather_blocks, halo_blocks, shard_params

NAN = float("nan")


def gather_halo_blocks(blocks, hl: int, wl: int, device) -> torch.Tensor:
    """The global [..., H, W] tensor from halo'd blocks (their own cells)."""
    return gather_blocks([[b[..., 1:hl + 1, 1:wl + 1] for b in row] for row in blocks], device)


def _coords(mesh: Mesh):
    """This process's blocks of ``mesh`` (every block unless the mesh
    spans processes)."""
    ry, rx = mesh.grid
    return [(iy, ix) for iy in range(ry) for ix in range(rx) if mesh.owns(iy, ix)]


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


class EagerCase:
    """The inputs of a case on a mesh for the eager step, cut once: each
    block's params (``topology.shard_params``) and solid flags with the
    1-cell halo, and the eager force's windows (``force_windows``) on a
    mesh that is not on one device."""

    def __init__(self, p: CaseParams, mesh: Mesh):
        self.p, self.mesh = p, mesh
        self.hl, self.wl = block_shape(p.shape, mesh)  # raises for a refused mesh
        self.params = shard_params(p, mesh)
        self.solid = halo_blocks(p.mask > 0.5, mesh, False)
        self.windows = None if mesh.single_device is not None else force_windows(p, mesh)


def advance_eager(bs: BlockState, case: EagerCase, n_steps: int):
    """Advance the resident bare blocks ``bs`` ``n_steps`` in place with the
    eager per-shard step; returns the chunk's monitors."""
    mesh, p = case.mesh, case.p
    ny, nx = p.shape
    hl, wl = case.hl, case.wl
    blocks = [[LBMState(f=bs.f[iy][ix], f_post=bs.f_post[iy][ix], rho=bs.rho[iy][ix],
                        u=bs.u[iy][ix], step=bs.step) if mesh.owns(iy, ix) else None
               for ix in range(len(row))] for iy, row in enumerate(mesh.devices)]
    for _ in range(n_steps):
        halos = exchange_halo_f([[b and b.f for b in row] for row in blocks], mesh)
        blocks = [[local_step(blocks[iy][ix], case.params[iy][ix], halos[iy][ix],
                              case.solid[iy][ix], iy * hl, ix * wl, ny, nx)
                   if mesh.owns(iy, ix) else None
                   for ix in range(len(row))] for iy, row in enumerate(blocks)]
    for k in ("f", "f_post", "rho", "u"):
        setattr(bs, k, [[b and getattr(b, k) for b in row] for row in blocks])
    bs.step += n_steps
    return _close_chunk(bs, case)


# ---------------------------------------------------------------------------
# Monitors from the blocks
# ---------------------------------------------------------------------------


def force_windows(p: CaseParams, mesh: Mesh):
    """[ry][rx] (params, region) of the eager force on each of this
    process's blocks: ``p`` with the mask and Bouzidi q planes of the
    block and its halo ring ([hl + 2, wl + 2]; fluid beyond the global
    edge, where the f_post halo holds zeros, so a link there adds 0 as the
    global sum's fill does), and the region of the block's own cells."""
    mask = halo_blocks(p.mask, mesh, 0.0)
    q = None if p.bouzidi_q is None else halo_blocks(p.bouzidi_q, mesh, 0.5)
    out = [[None] * len(row) for row in mesh.devices]
    for iy, ix in _coords(mesh):
        m = mask[iy][ix]
        region = torch.zeros(m.shape, dtype=torch.bool, device=m.device)
        region[1:-1, 1:-1] = True
        out[iy][ix] = (dataclasses.replace(p, mask=m, bouzidi_q=_at(q, iy, ix)), region)
    return out


def window_links(links: torch.Tensor, W: int, obstacle: int, y0: int, x0: int, hl: int,
                 wl: int, pitch: int) -> torch.Tensor:
    """The global boundary links (``cuda_step.boundary_links`` of a grid W
    wide) that the block at (y0, x0) sums, re-indexed into its halo'd
    layout [hl + 2, pitch]. The window rule is the eager force's
    (``solver.force_on_obstacle``'s ``region`` keeps a link whose solid
    cell x + e_j lies in the block, equilibrium and full-way;
    ``force_on_obstacle_halfway`` / ``_bouzidi`` one whose fluid cell x
    does), so each link falls in one block; a link's fluid or upstream
    cell on a seam lies in the block's halo. The upstream flag stays the
    global grid's: beyond the global edge it adds 0, as ``shift2d``'s fill
    does."""
    if (hl + 2) * pitch >= 1 << (31 - cs.LINK_CELL_SHIFT):
        raise ValueError(f"block {hl}x{wl} (pitch {pitch}): a link's cell index does not fit")
    lk = links.long()
    cell, flags = lk >> cs.LINK_CELL_SHIFT, lk & 31
    j = lk & 15
    y, x = cell // W, cell % W
    if obstacle in (cs.OBSTACLE_EQ, cs.OBSTACLE_BOUNCE):
        e = torch.as_tensor(E, dtype=torch.long)
        ry, rx = y + e[j, 1], x + e[j, 0]
    else:
        ry, rx = y, x
    keep = (ry >= y0) & (ry < y0 + hl) & (rx >= x0) & (rx < x0 + wl)
    local = (y - y0 + 1) * pitch + (x - x0 + 1)
    return ((local << cs.LINK_CELL_SHIFT) | flags)[keep].to(torch.int32)


class BlockMonitors:
    """The monitor kernel's inputs of a case on a mesh of K1's halo'd
    blocks [C, hl + 2, pitch], cut once (``ShardedCase``). On a mesh whose
    blocks share one device: one ``MonitorLinks`` of 1 + n items, the
    global f_post's links (``boundary_links``) and each block's u, summed
    into one total. Elsewhere, for each card of this process (in the order
    its first block comes), one of its blocks' window links
    (``window_links``) in block order. The device item tables
    (``cuda_step.monitor_item`` rows) are uploaded when the blocks'
    buffers change (they are resident: once a placement)."""

    def __init__(self, p: CaseParams, mesh: Mesh, hl: int, wl: int, pitch: int, q_blocks,
                 per_card: bool = False):
        H, W = p.shape
        self.hl, self.wl, self.pitch = hl, wl, pitch
        self.obstacle = cs.obstacle_scheme(p)
        self.bouzidi = self.obstacle == cs.OBSTACLE_BOUZIDI
        self.q_blocks = q_blocks
        self.coords = _coords(mesh)
        # ``per_card`` True takes the block form on a one-device mesh too
        # (its blocks one card's launch: how the checks hold that form on
        # one card)
        self.single = None if per_card else mesh.single_device
        links = cs.boundary_links(p)
        self.cards = {}
        if self.single is not None:
            self.W = W
            self.q_global = p.bouzidi_q.to(self.single) if self.bouzidi else None
            empty = torch.zeros(0, dtype=torch.int32)
            self.cards[self.single] = (cs.MonitorLinks([links] + [empty] * len(self.coords),
                                                       self.single), list(self.coords))
        else:
            by_dev = {}
            for iy, ix in self.coords:
                by_dev.setdefault(mesh.devices[iy][ix], []).append((iy, ix))
            for dev, blocks in by_dev.items():
                lists = [window_links(links, W, self.obstacle, iy * hl, ix * wl, hl, wl, pitch)
                         for iy, ix in blocks]
                self.cards[dev] = (cs.MonitorLinks(lists, dev), blocks)
        self._tables = {}

    def _u_item(self, u_block, f_post=None, q=None):
        plane = (self.hl + 2) * self.pitch
        return cs.monitor_item(f_post, q, u_block[:, 1:], self.pitch, plane,
                               (plane, self.hl, self.pitch, 1, self.wl))

    def rows(self, bs: BlockState, dev):
        """The item rows of card ``dev``'s launch."""
        ml, blocks = self.cards[dev]
        if self.single is not None:
            H = bs.f_post_global.shape[-2]
            return [cs.whole_item(bs.f_post_global, self.q_global, None, H, self.W)] + [
                self._u_item(bs.u[iy][ix]) for iy, ix in blocks]
        return [self._u_item(bs.u[iy][ix], bs.f_post[iy][ix], _at(self.q_blocks, iy, ix))
                for iy, ix in blocks]

    def table(self, bs: BlockState, dev) -> torch.Tensor:
        rows = self.rows(bs, dev)
        key = tuple(map(tuple, rows))
        hit = self._tables.get(dev)
        if hit is None or hit[0] != key:
            hit = self._tables[dev] = (key, cs._upload(torch.tensor(rows, dtype=torch.int64),
                                                       dev))
        return hit[1]


def _block_parts_plain(bs: BlockState, bm: BlockMonitors, dev):
    """Plain version of a card's launch: its items' part rows f64 [n, 3]
    (Fx, Fy, max_v) in the kernel's order."""
    ml, blocks = bm.cards[dev]
    own_u = bs.own("u")
    rows = []
    for c, (iy, ix) in enumerate(blocks):
        fp = bs.f_post[iy][ix]
        links = ml.item_links(c).to(fp.device)
        force = cs.item_force_plain(fp, _at(bm.q_blocks, iy, ix), links, bm.pitch, bm.bouzidi)
        rows.append(torch.cat([force, cs.speed_max_plain(own_u[iy][ix]).double().reshape(1)]))
    return torch.stack(rows)


def _single_plain(bs: BlockState, bm: BlockMonitors):
    """Plain version of the one-device mesh's launch: (force, max_v)."""
    ml, blocks = bm.cards[bm.single]
    own_u = bs.own("u")
    fp = bs.f_post_global
    force = cs.item_force_plain(fp, bm.q_global, ml.item_links(0).to(fp.device), bm.W,
                                bm.bouzidi)
    max_v = torch.stack([cs.speed_max_plain(own_u[iy][ix]) for iy, ix in blocks]).amax()
    return force.to(max_v.dtype), max_v


def kernel_block_monitors(bs: BlockState, bm: BlockMonitors, plain: bool = False):
    """{"force", "max_v"} of the resident halo'd blocks through the monitor
    kernel (its plain version with ``plain`` or on CPU tensors): one launch
    a card. On a mesh spanning processes a collective."""
    from . import multihost

    mesh, dev = bs.mesh, bs.device
    if bm.single is not None:
        if plain or not bs.f_post_global.is_cuda:
            force, max_v = _single_plain(bs, bm)
            return {"force": force, "max_v": max_v}
        ml, blocks = bm.cards[bm.single]
        total = torch.empty(3, dtype=torch.float32, device=bm.single)
        cs.launch_monitors(ml, [0] * 10, table=bm.table(bs, bm.single), bouzidi=bm.bouzidi,
                           cells=bm.hl * bm.wl, total=total)
        return {"force": total[:2], "max_v": total[2]}
    exchange_halos(bs.f_post, mesh, bs.hl, bs.wl)
    parts = {}
    for d, (ml, blocks) in bm.cards.items():
        if plain or d.type != "cuda":
            part = _block_parts_plain(bs, bm, d)
        else:
            part = cs.launch_monitors(ml, [0] * 10, table=bm.table(bs, d), bouzidi=bm.bouzidi,
                                      cells=bm.hl * bm.wl)
        parts[d] = part.to(dev)
    # each block's sum in block order, as the eager partial sums add
    rows = {b: parts[d][c] for d, (ml, blocks) in bm.cards.items()
            for c, b in enumerate(blocks)}
    force = None
    for b in bm.coords:
        force = rows[b][:2] if force is None else force + rows[b][:2]
    max_v = torch.cat([p[:, 2] for p in parts.values()]).amax().float()
    if multihost.is_cross_rank(mesh):
        force, max_v = multihost.reduce_monitors(force, max_v)
    return {"force": force.to(max_v.dtype), "max_v": max_v}


def _close_chunk(bs: BlockState, case, plain: bool = False):
    """After a chunk: on a one-device mesh the blocks' f_post copied into
    ``bs.f_post_global``; then the monitors (``block_monitors``)."""
    if bs.f_post_global is not None:
        bs.collect_f_post()
    return block_monitors(bs, case, plain)


def block_monitors(bs: BlockState, case, plain: bool = False):
    """{"force", "max_v"} of the resident state (module docstring): through
    the monitor kernel for a ``ShardedCase`` (``kernel_block_monitors``),
    the eager reductions for an ``EagerCase`` (``eager_block_monitors``)."""
    if isinstance(case, ShardedCase):
        return kernel_block_monitors(bs, case.monitors, plain)
    return eager_block_monitors(bs, case.p, case.windows)


def eager_block_monitors(bs: BlockState, p: CaseParams, windows):
    """The eager monitors of bare blocks: on a one-device mesh the force of
    ``bs.f_post_global``; elsewhere the blocks' float64 partial sums over
    ``windows`` (``force_windows``), after refreshing the f_post halos,
    added in block order and over the processes in rank order. On a mesh
    spanning processes a collective."""
    from . import multihost

    mesh, dev = bs.mesh, bs.device
    coords = _coords(mesh)
    u = bs.own("u")
    max_v = torch.stack([max_velocity(u[iy][ix]).to(dev) for iy, ix in coords]).max()
    if bs.f_post_global is not None:
        return {"force": obstacle_force(bs.f_post_global, p), "max_v": max_v}
    fp = exchange_halo_f(bs.f_post, mesh)
    force = None
    for iy, ix in coords:
        wp, region = windows[iy][ix]
        part = obstacle_force(fp[iy][ix], wp, region=region).to(dev)
        force = part if force is None else force + part
    if multihost.is_cross_rank(mesh):
        force, max_v = multihost.reduce_monitors(force, max_v)
    return {"force": force.to(max_v.dtype), "max_v": max_v}


# ---------------------------------------------------------------------------
# K1 on every block (run_chunk_sharded_pallas)
# ---------------------------------------------------------------------------


class ShardedCase:
    """The inputs of a case on a mesh that do not change between chunks,
    cut once: each block's geometry, its aux plane with the 1-cell halo
    (the link predicate reads the pull source's solid flag across a seam;
    a zero halo would turn seam links into fluid links), its Bouzidi q
    planes, its rows of the inlet profile, and the monitor kernel's inputs
    (``BlockMonitors``)."""

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
        self.monitors = BlockMonitors(p, mesh, hl, wl, self.pitch, self.q)
        # the library loop's host tables; the mesh decides (others keep the
        # per-step loop)
        self.tables = None
        if shard_loop_refusal(mesh) is None:
            self.tables = cs.ShardTables(self.aux, self.geoms, self.q, self.prof)


def shard_loop_refusal(mesh: Mesh) -> Optional[str]:
    """Why a sharded chunk on ``mesh`` cannot run in the library loop
    (``cuda_step.k1_shard_steps``), or None: every block must be this
    process's, at most ``cuda_step.MAX_MESH_BLOCKS`` of them, on one device
    or on CUDA devices with peer access between every pair (K1 on a card
    pushes its edges into its neighbours' halos where they live)."""
    ry, rx = mesh.grid
    if any(not mesh.owns(iy, ix) for iy in range(ry) for ix in range(rx)):
        return "the mesh spans processes (halos through multihost.exchange)"
    if ry * rx > cs.MAX_MESH_BLOCKS:
        return f"{ry}x{rx} blocks, the library loop takes {cs.MAX_MESH_BLOCKS}"
    devices = sorted({d for row in mesh.devices for d in row}, key=str)
    if len(devices) == 1:
        return None
    if any(d.type != "cuda" for d in devices):
        return f"blocks on several devices that are not CUDA devices: {list(map(str, devices))}"
    idx = [d.index for d in devices]
    for a in idx:
        for b in idx:
            if a != b and not torch.cuda.can_device_access_peer(a, b):
                return f"cards {a} and {b} have no peer access"
    return None


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
    cs.halo_exchange_plain(blocks, hl, wl)


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


def fast_step(src, dst, case: ShardedCase, scal: torch.Tensor, dev_store: bool,
              plain: bool = False, prev: Optional[cs.RingPrev] = None) -> None:
    """One fast step on every block, ``src`` -> ``dst`` ([ry][rx] halo'd
    blocks, bf16 deviations when ``dev_store``): one K1 call a block
    (``cuda_step.k1_blocks``; ``prev`` the blocks' ``RingPrev`` where a
    side is a no-op), then the halo refresh of ``dst``."""
    p = case.p
    cs.k1_blocks(src, dst, case, scal, p.use_les, p.bc_type, case.obstacle, dev_store,
                 plain=plain, prev=prev)
    exchange_halos(dst, case.mesh, case.hl, case.wl)


def advance_blocks(bs: BlockState, case: ShardedCase, n_steps: int, store_dev: bool = False,
                   plain: bool = False, stepwise: bool = False):
    """Advance the resident halo'd blocks ``bs`` ``n_steps`` in place
    through K1 in its sharded form (its plain versions with ``plain``);
    returns the chunk's monitors. The rules of ``cuda_step.run_chunk_cuda``
    hold: ``store_dev`` for chunks of more than one step, equilibrium and
    full-way bounce-back only; never fused.

    Where the mesh takes the library loop (``case.tables``) the chunk is
    one program, as run_chunk_sharded_pallas's jit over shard_map and
    lax.scan is: two library calls, ``cuda_step.k1_shard_steps`` (every
    fast step, each block's K1 pushing its edges into its neighbours'
    halos) and ``cuda_step.k1_shard_full`` (the closing step). Other
    meshes, ``plain``
    and ``stepwise`` issue each step from Python (``fast_step``: a K1 call a
    block, then ``exchange_halos``), the reference the library loop is held
    to, bitwise.

    Where a side is a no-op K1 reads the resident rho and u there
    (``cuda_step.RingPrev``): fresh on the chunk's first step, and copied
    for a one-step chunk, whose full step writes them."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    p, mesh = case.p, case.mesh
    dev_store = (bool(store_dev) and n_steps > 1
                 and cs.dev_storage_refusal(p, sharded=True) is None)
    prev = None
    if cs.noop_sides(p.bc_type):
        prev = cs.RingPrev(bs.rho, bs.u)
        if n_steps == 1:
            prev = cs.RingPrev(*([[b if b is None else b.clone() for b in row] for row in x]
                                 for x in (bs.rho, bs.u)))
    f_in, f_a = bs.f, bs.f_alt
    if dev_store:
        # quantize once per chunk, halos included (the halos the last
        # chunk's full step pushed in f32): the halo refresh then moves
        # bf16 deviations, as the JAX package's ppermute rows do
        f_in = [[b if b is None else cs.quantize(b) for b in row] for row in f_in]
        f_a = [[b if b is None else b.clone() for b in row] for row in f_in]
    rows = cs.scalar_rows(p, bs.step, n_steps)
    loop = case.tables is not None and not (plain or stepwise)
    if loop:
        src = cs.k1_shard_steps(f_in, f_a, f_in, case.tables, rows[:n_steps - 1], p.use_les,
                                p.bc_type, case.obstacle, dev_store,
                                prev) if n_steps > 1 else f_in
    else:
        src, dst = f_in, f_a
        for i in range(n_steps - 1):
            fast_step(src, dst, case, rows[i], dev_store, plain, cs.prev_at_step(prev, i))
            src, dst = dst, src
    if dev_store:
        # the closing full step runs in exact f32, into the resident buffer
        # the chunk quantized
        src = [[b if b is None else cs.dequantize(b) for b in r] for r in src]
        dst = bs.f
    else:
        dst = bs.f_alt if src is bs.f else bs.f
    prev = cs.prev_at_step(prev, n_steps - 1)
    if loop:
        cs.k1_shard_full(src, dst, case.tables, rows[-1], p.use_les, p.bc_type, bs.rho, bs.u,
                         bs.f_post, case.obstacle, prev)
    else:
        cs.k1_blocks(src, dst, case, rows[-1], p.use_les, p.bc_type, case.obstacle,
                     rho=bs.rho, u=bs.u, f_post=bs.f_post, plain=plain, prev=prev)
        exchange_halos(dst, mesh, case.hl, case.wl)  # the next chunk reads f's halos
    if not dev_store:
        bs.f_alt = src
    bs.f = dst
    bs.step += n_steps
    return _close_chunk(bs, case, plain)


class BlockRunner:
    """The engine's chunk runner on ``mesh``: ``kind`` "cuda" (K1 in its
    sharded form), "stepwise" (the same kernels issued a step at a time
    from Python, ``advance_blocks(stepwise=True)``), "plain" (their plain
    versions) or "eager" (the eager per-shard step). ``place`` puts a
    case's state on the blocks once, ``advance`` runs a chunk on them in
    place and returns the monitors.
    The inputs of a case (``ShardedCase`` / ``EagerCase``) are cut once per
    params object."""

    def __init__(self, mesh: Mesh, kind: str, store_dev: bool = False, case=None):
        if kind not in ("cuda", "stepwise", "plain", "eager"):
            raise ValueError(f"runner kind {kind!r}: expected 'cuda', 'stepwise', 'plain' "
                             "or 'eager'")
        self.mesh, self.kind, self.store_dev = mesh, kind, store_dev
        self._case = case

    def case(self, p: CaseParams):
        c = self._case
        if c is None or c.p is not p or c.mesh != self.mesh:
            self._case = c = (EagerCase if self.kind == "eager" else ShardedCase)(p, self.mesh)
        return c

    def place(self, state: LBMState, p: CaseParams) -> BlockState:
        """This process's blocks of the global ``state``, in the runner's
        layout."""
        case = self.case(p)
        if self.kind == "eager":
            return BlockState.place(state, self.mesh)
        return BlockState.place(state, self.mesh, halo=1, pitch=case.pitch)

    def advance(self, bs: BlockState, p: CaseParams, n_steps: int):
        case = self.case(p)
        if self.kind == "eager":
            return advance_eager(bs, case, n_steps)
        return advance_blocks(bs, case, n_steps, self.store_dev, self.kind == "plain",
                              self.kind == "stepwise")

    def monitors(self, bs: BlockState, p: CaseParams):
        """The monitors of ``bs`` as placed (before its first chunk)."""
        return block_monitors(bs, self.case(p), self.kind == "plain")


def _run_wrapped(state, p, n_steps, mesh, kind, store_dev=False, case=None):
    """Place ``state``, advance ``n_steps`` and gather every field."""
    runner = BlockRunner(mesh, kind, store_dev, case)
    bs = runner.place(state, p)
    monitors = runner.advance(bs, p, n_steps)
    return bs.snapshot(), monitors


def run_chunk_sharded(state: LBMState, p: CaseParams, n_steps: int, mesh: Mesh):
    """Advance ``n_steps`` on ``mesh`` with the eager per-shard step."""
    return _run_wrapped(state, p, n_steps, mesh, "eager")


def run_chunk_sharded_cuda(state: LBMState, p: CaseParams, n_steps: int, mesh: Mesh,
                           store_dev: bool = False, case: Optional[ShardedCase] = None):
    """Advance ``n_steps`` on ``mesh`` through K1 in its sharded form
    (``advance_blocks``). ``case`` is the ``ShardedCase`` of (p, mesh), cut
    here when not given."""
    return _run_wrapped(state, p, n_steps, mesh, "cuda", store_dev, case)


def run_chunk_sharded_plain(state: LBMState, p: CaseParams, n_steps: int, mesh: Mesh,
                            store_dev: bool = False, case: Optional[ShardedCase] = None):
    """``run_chunk_sharded_cuda`` through the kernels' plain versions on
    any device."""
    return _run_wrapped(state, p, n_steps, mesh, "plain", store_dev, case)
