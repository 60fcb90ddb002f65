"""Chunk runner on the hand-written CUDA kernels (counterpart of
``lbm2d_tpu/ops/pallas_step.py``).

Each step is one launch on the current stream: K1 ``k1_step``
(csrc/k1_step.cu, replaces ``_step_kernel`` in its in-kernel-BC form)
streams, collides and writes the next f buffer, the boundary ring
included: the threads of the cells next to the ring write it from the
collide output they hold, in ``apply_bc`` order, the profiled velocity
inlets (left types 3/4) from the case's ``inlet_profile``. The JAX
package's split form (``_step_kernel`` with an edge export, then
``_edge_bc_kernel`` rebuilding the ring) is folded into that one launch.
Its full variant, on a chunk's last step, also writes rho, u and f_post.
The obstacle scheme (``OBSTACLE_*``: equilibrium, full-way, half-way or
Bouzidi bounce-back) picks a compiled variant. Every BC layout apply_bc
runs is covered: a side whose type has no rule there (``noop_sides``)
keeps its cells, which K1's ring threads store from f_in and the state's
rho and u (``RingPrev``), as the eager step leaves them. The JAX package
runs those layouts on its jnp step (``layout_refusal``), so they never
run K3 or deviation storage here either.

With 16-bit deviation storage (``store_dev``, the JAX package's
``run_chunk_pallas(store_dev=True)``) a chunk's fast steps run
``k1_step_dev`` on bf16 buffers of f - w: the state is quantized once at
the start of the chunk and dequantized for the f32 full step that closes
it. Lossy by design (one bf16 rounding of each deviation per step),
opt-in, only for chunks of more than one step, and, as in the JAX package,
not for half-way or Bouzidi bounce-back or a layout with a no-op side
(``dev_storage_refusal``); the engines engage it only on the grids where
the JAX package's runners do (``engine_dev_storage_refusal``).

Temporal blocking is opt-in, as in the JAX package (``_FUSE_STEPS`` = S >
1): a chunk's first n - 1 steps then run as passes of K3 ``k3_fused``
(csrc/k3_fused.cu, replaces ``_fused_kernel``: S steps a pass, each tile's
window swept row by row with its S levels skewed in shared memory, the
BCs inside every window at each sub-step), the remainder as single K1
steps; Bouzidi bounce-back is never fused
(``fuse_refusal``) and deviation storage is off while it is requested.

On a spatial mesh (``parallel/sharded.py``) K1 runs in its sharded form on
one block of the grid each: the same wrappers and kernels given the
block's ``BlockGeom`` (``geom=``), a [hl, wl] block inside a 1-cell halo
ring of its neighbours' cells, whose ring cells are written only where the
block lies on the global edge; they count as the ``_shard`` variants. On
a mesh whose blocks live on the cards of one process (a card each over
peer access, or several on one) a sharded chunk is one program too:
``k1_shard_steps`` (C entry ``k1_shard_steps_launch``) runs every block's
fast K1 on its card's stream step after step inside the library, from
host tables cut once a case (``ShardTables``), and ``k1_shard_full``
closes the chunk with every block's full step. There the halo has no
launch of its own: each K1 thread that stores a cell on its block's edge
also stores it into the halo slot of each neighbour that reads it (the
push, ``csrc/halo.cuh``), so a step is one K1 launch a block, and each
card's step waits for its neighbouring cards' previous one (two events a
card, by the step's parity). A ``_shard`` launch through ``k1_step`` /
``k1_step_dev`` pushes nothing: the per-step loop refreshes the halos by
copies (``halo_exchange_plain``). The library loop's plain version is the
same per-block plain step followed by ``halo_exchange_plain``.

A chunk is issued as one program, as the JAX package's jit over lax.scan
issues it: its scalar rows are one host table built once (``scalar_rows``;
the ramp-free row is read from the device once per params object), and
its fast steps run in the shared libraries' step loops (``k1_steps``, C
entry ``k1_steps_launch``; ``k3_passes``, ``k3_passes_launch``), the
arguments checked once a call; the closing full step is one ``k1_step``.
The per-step wrappers (``k1_step``, ``k1_step_dev``, ``k3_fused``) serve
the sharded runner and the tools, and ``run_chunk_stepwise`` issues a chunk
through them, one call a step.

A lockstep group's chunk is one program too, as the JAX BatchEngine's
``run_chunk_batched`` / ``_chunk_sequential`` are: ``run_chunk_group_cuda``
runs the group's stacked state ([B, 9, H, W] f) through ``k1_group_steps``
(C entry ``k1_group_steps_launch``: one K1 launch a step over the alive
cases, K1's ``_group`` instances), ``k1_group_full`` and ``group_monitors``
(every case's force, max |u| and stability flag in one launch, into the
packed array the engine fetches), from ``GroupParams`` cut once a group;
the alive cases are a device table rebuilt only when one dies.
``CASE_STEPS`` counts the cases a group launch advanced.

The monitors are one launch of the monitor kernel (csrc/monitors.cu) on
every chunk path, as the JAX package's are part of its chunk program: a
group's cases (``group_monitors``), a serial chunk's case
(``case_monitors``, a group of one), the DFG path's cylinder-only force
(``case_force`` on a ``CaseLinks`` of another mask) and a mesh's blocks
(``parallel/sharded.py``, ``block_monitors``, from a device table of
``monitor_item`` rows). The force's f64 sum has one fixed order whatever
the grid (``monitor_sum_plain`` repeats it), so every form is bitwise its
plain version.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes its
plain PyTorch version (``k1_step_plain``, ``k1_step_dev_plain``,
``k1_steps_plain``, ``k3_fused_plain`` and ``k3_passes_plain``, each with
the same arguments) only for CPU tensors.
``LAUNCHES`` counts kernel launches by variant (``k1_variant`` /
``k3_variant`` / ``monitor_variant`` names), so a run can show that it went
through the kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
import weakref
from dataclasses import astuple, dataclass
from typing import Dict, NamedTuple, Optional, Tuple

import numpy as np
import torch

from ..core.lattice import E as E_LAT
from ..core.lattice import OPP as OPP_LAT
from ..core.lattice import W as W_LAT
from ..core.solver import (
    BC_FREE_SLIP,
    BC_INLET,
    BC_OUTLET,
    BC_VEL_INLET,
    BC_VEL_INLET_NEBB,
    CaseParams,
    LBMState,
    bc_horizontal_values,
    bc_left_values,
    bc_right_values,
    full_way_bounce,
    link_bounce_at,
    mrt_collide_arrays,
    warmup_ramp,
)
from . import cuda_build

# the per-step scalar row (the JAX package's _scalars (1, 14) SMEM row)
SCALAR_FIELDS = (
    "tau0", "cs_factor", "s_ghost", "ramp", "rho_in", "rho_out",
    "bc_value[0,0]", "bc_value[0,1]", "bc_value[1,0]", "bc_value[1,1]",
    "bc_value[2,0]", "bc_value[2,1]", "bc_value[3,0]", "bc_value[3,1]",
)
_S_RAMP = 3

# storage type of f under 16-bit deviation storage (the JAX package's
# _DEV_DTYPE): bf16 keeps f32's exponent range, and storing f - w keeps the
# absolute rounding near |f - w| / 512 ~ 1e-4 per step
DEV_DTYPE = torch.bfloat16

# obstacle schemes (csrc/lbm_common.cuh LBM_OBST_*)
OBSTACLE_EQ, OBSTACLE_BOUNCE, OBSTACLE_HALFWAY, OBSTACLE_BOUZIDI = 0, 1, 2, 3
_OBSTACLE_SUFFIX = ("", "_bounce", "_halfway", "_bouzidi")
# the schemes deviation storage runs (the JAX package's store_dev rule)
DEV_OBSTACLES = (OBSTACLE_EQ, OBSTACLE_BOUNCE)


def obstacle_scheme(p: CaseParams) -> int:
    if p.bouzidi_obstacle:
        return OBSTACLE_BOUZIDI
    if p.halfway_obstacle:
        return OBSTACLE_HALFWAY
    if p.bounce_obstacle:
        return OBSTACLE_BOUNCE
    return OBSTACLE_EQ


def k1_variant(obstacle: int, full: bool = False, dev: bool = False,
               shard: bool = False, group: bool = False) -> str:
    """Launch-count name of a K1 variant: k1_step[_bounce|_halfway|_bouzidi]
    [_shard|_group][_full|_dev]; ``_group`` is one launch over a lockstep
    group's alive cases."""
    return ("k1_step" + _OBSTACLE_SUFFIX[obstacle] + ("_shard" if shard else "")
            + ("_group" if group else "") + ("_full" if full else "_dev" if dev else ""))


def monitor_variant(obstacle: int) -> str:
    """Launch-count name of the group monitor kernel's instance for an
    obstacle scheme: group_monitors (the 2 f_j links of equilibrium,
    full-way and half-way) or group_monitors_bouzidi."""
    return "group_monitors" + ("_bouzidi" if obstacle == OBSTACLE_BOUZIDI else "")


def k3_variant(obstacle: int, left_type: int) -> str:
    """Launch-count name of a K3 variant: k3_fused[_bounce|_halfway][_vel],
    ``_vel`` for the profiled velocity inlets (left types 3/4)."""
    vel = left_type in (BC_VEL_INLET, BC_VEL_INLET_NEBB)
    return "k3_fused" + _OBSTACLE_SUFFIX[obstacle] + ("_vel" if vel else "")


# the schemes temporal blocking runs (the JAX package's rule: no Bouzidi)
FUSE_OBSTACLES = (OBSTACLE_EQ, OBSTACLE_BOUNCE, OBSTACLE_HALFWAY)

KERNEL_VARIANTS = (
    [k1_variant(o, full) for o in range(4) for full in (False, True)]
    + [k1_variant(o, dev=True) for o in DEV_OBSTACLES]
    + [k3_variant(o, t) for o in FUSE_OBSTACLES for t in (BC_INLET, BC_VEL_INLET)]
    + [k1_variant(o, full, shard=True) for o in range(4) for full in (False, True)]
    + [k1_variant(o, dev=True, shard=True) for o in DEV_OBSTACLES]
    + [k1_variant(o, full, group=True) for o in range(4) for full in (False, True)]
    + [k1_variant(o, dev=True, group=True) for o in DEV_OBSTACLES]
    + [monitor_variant(o) for o in (OBSTACLE_EQ, OBSTACLE_BOUZIDI)]
)
GROUP_VARIANTS = tuple(v for v in KERNEL_VARIANTS if "_group" in v or v.startswith("group_"))

# launches of each kernel variant, added to where the launch is made; and
# of each group variant the cases it advanced times its launches (K1) or
# the cases it read (the monitors)
LAUNCHES = {name: 0 for name in KERNEL_VARIANTS}
CASE_STEPS = {name: 0 for name in GROUP_VARIANTS}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0
    for k in CASE_STEPS:
        CASE_STEPS[k] = 0


def pack_aux(damping: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Sponge damping and solid mask in ONE plane: damping is >= 0, so the
    solid flag rides the sign bit (solid cells store -damp, -0.0 for 0)."""
    return torch.where(mask > 0.5, torch.copysign(damping, -1.0), damping)


def unpack_aux(aux: torch.Tensor):
    """(solid bool, damp) from a packed aux plane, bit-exactly."""
    return torch.signbit(aux), aux.abs()


# a shard's row pitch is rounded up to this many floats, so its rows start
# 128-byte aligned as the whole grid's rows do
SHARD_PITCH_ALIGN = 32


@dataclass(frozen=True)
class BlockGeom:
    """Where K1 finds a block of the lattice (csrc/lbm_common.cuh
    BlockGeom): local cell (i, j), i < hl, j < wl, is element (i + halo,
    j + halo) of each [hl + 2 halo, pitch] plane and cell (y_off + i,
    x_off + j) of the Hg x Wg grid. The single-device step runs
    ``whole(H, W)``; a shard of a spatial mesh a halo'd block (``shard``).
    A block without a halo is the whole grid, whose geometry the kernels
    fold at compile time."""

    hl: int
    wl: int
    pitch: int
    halo: int
    y_off: int
    x_off: int
    Hg: int
    Wg: int

    def __post_init__(self):
        if self.halo == 0 and (self.pitch, self.y_off, self.x_off, self.Hg, self.Wg) != (
                self.wl, 0, 0, self.hl, self.wl):
            raise ValueError(f"a block without a halo must be the whole grid, got {self}")

    @classmethod
    def whole(cls, H: int, W: int) -> "BlockGeom":
        return _whole_grid(H, W)

    @classmethod
    def shard(cls, hl: int, wl: int, y_off: int, x_off: int, Hg: int, Wg: int) -> "BlockGeom":
        pitch = -(-(wl + 2) // SHARD_PITCH_ALIGN) * SHARD_PITCH_ALIGN
        return cls(hl, wl, pitch, 1, y_off, x_off, Hg, Wg)

    @property
    def plane(self) -> Tuple[int, int]:
        """Shape of one stored plane."""
        return (self.hl + 2 * self.halo, self.pitch)

    def interior(self):
        """(i0, i1, j0, j1), inclusive local bounds of the block's cells that
        are interior in the global grid, or None if it has none."""
        i0, i1 = max(0, 1 - self.y_off), min(self.hl - 1, self.Hg - 2 - self.y_off)
        j0, j1 = max(0, 1 - self.x_off), min(self.wl - 1, self.Wg - 2 - self.x_off)
        return None if i1 < i0 or j1 < j0 else (i0, i1, j0, j1)

    def cells(self, i0: int, i1: int, j0: int, j1: int):
        """(rows, columns) slices of the stored planes for local cells
        [i0, i1] x [j0, j1]."""
        h = self.halo
        return slice(i0 + h, i1 + h + 1), slice(j0 + h, j1 + h + 1)

    @functools.cached_property
    def c_row(self):
        """The geometry as the kernels' host row of 8 ints (lbm_common.cuh
        load_geom), built once: the launch path reuses it."""
        return (ctypes.c_int * 8)(*astuple(self))


@functools.lru_cache(maxsize=None)
def _whole_grid(H: int, W: int) -> BlockGeom:
    return BlockGeom(H, W, W, 0, 0, 0, H, W)


# the BC types each side has a rule for in apply_bc (solver.bc_left_values,
# bc_right_values, bc_horizontal_values; csrc/lbm_cell.cuh bc_*_active):
# any other type is a no-op there, and the side's cells keep the previous
# step's values, the obstacle pass aside
LEFT_ACTIVE = (BC_INLET, BC_FREE_SLIP, BC_VEL_INLET, BC_VEL_INLET_NEBB)
RIGHT_ACTIVE = (BC_INLET, BC_OUTLET, BC_FREE_SLIP)
ROW_ACTIVE = (BC_INLET, BC_FREE_SLIP)


def noop_sides(bc_type) -> Tuple[str, ...]:
    """The sides of ``bc_type`` (left, top, right, bottom) whose type is a
    no-op in apply_bc."""
    lt, tt, rt, bt = (int(t) for t in bc_type)
    return tuple(side for side, t, active in (("left", lt, LEFT_ACTIVE), ("top", tt, ROW_ACTIVE),
                                              ("right", rt, RIGHT_ACTIVE),
                                              ("bottom", bt, ROW_ACTIVE)) if t not in active)


def layout_refusal(p: CaseParams) -> Optional[str]:
    """Why the JAX package's kernels do not run case ``p``'s layout
    (``lbm2d_tpu/ops/pallas_step.py`` ``supports``: every side active, the
    inlet profile of left types 3/4, Bouzidi's q planes), or None. Such a
    case runs on the JAX jnp step (``lbm2d_tpu/core/engine.py:213-239``),
    exact f32, never fused and never in deviation storage; the port runs it
    on K1."""
    noop = noop_sides(p.bc_type)
    if noop:
        return (f"bc_type {tuple(p.bc_type)} has no-op sides ({', '.join(noop)}), which the "
                "JAX kernels do not run (pallas_step.supports): the JAX package runs them on "
                "its jnp step")
    lt = p.bc_type[0]
    if lt in (BC_VEL_INLET, BC_VEL_INLET_NEBB) and p.inlet_profile is None:
        return f"left bc_type {lt} without CaseParams.inlet_profile"
    if p.bouzidi_obstacle and p.bouzidi_q is None:
        return "Bouzidi bounce-back without its q planes (CaseParams.bouzidi_q)"
    return None


def unsupported(p: CaseParams) -> Optional[str]:
    """Why the kernels cannot run case ``p``, or None when they can (a
    spatial mesh's own rule is ``parallel/topology.mesh_refusal``). Every
    layout apply_bc runs is covered, no-op sides included."""
    lt = p.bc_type[0]
    if lt in (BC_VEL_INLET, BC_VEL_INLET_NEBB) and p.inlet_profile is None:
        return f"left bc_type {lt} without CaseParams.inlet_profile"
    if p.bouzidi_obstacle and p.bouzidi_q is None:
        return "Bouzidi bounce-back without its q planes (CaseParams.bouzidi_q)"
    if p.dtype != torch.float32:
        return f"dtype {p.dtype}: the kernels are f32 only"
    h, w = p.shape
    if min(h, w) < 3:
        return f"grid {h}x{w} is smaller than 3x3"
    return None


def supports(p: CaseParams) -> bool:
    """True if K1 implements case ``p``: every BC layout apply_bc runs
    (left 3/4 with the inlet profile; a side of another type than its
    active ones is a no-op, its cells kept), any obstacle scheme (Bouzidi
    with its q planes), f32, LES on or off."""
    return unsupported(p) is None


def dev_storage_refusal(p: CaseParams, sharded: bool = False) -> Optional[str]:
    """Why 16-bit deviation storage does not engage in a chunk runner for
    case ``p``, or None. The JAX package's rules that do not depend on the
    grid: a layout its kernels refuse runs on its jnp step, exact f32
    (``layout_refusal``); half-way and Bouzidi bounce-back read the cell's
    own previous populations on their links and run exact f32
    (``run_chunk_pallas``, ``lbm2d_tpu/ops/pallas_step.py:1815-1819``); and
    while temporal blocking is requested the state stays f32 (``:1818``).
    The sharded runner (``sharded``) never fuses, so the last rule does not
    hold there (``run_chunk_sharded_pallas``,
    ``lbm2d_tpu/parallel/sharded.py:365-369``). The engines add the grid's
    rules (``engine_dev_storage_refusal``)."""
    why = layout_refusal(p)
    if why is not None:
        return f"{why}, exact f32"
    if obstacle_scheme(p) not in DEV_OBSTACLES:
        return "half-way and Bouzidi bounce-back run exact f32 (the JAX run_chunk_pallas rule)"
    if fuse_requested() and not sharded:
        return (f"temporal blocking is requested (cuda_step._FUSE_STEPS = {_FUSE_STEPS}): "
                "the state stays f32 (the JAX run_chunk_pallas rule)")
    return None


# the lockstep engine's smallest grid for its kernels' runner: below it the
# JAX BatchEngine runs its vmap jnp chunk, which ignores store_dev
# (lbm2d_tpu/parallel/batch.py:342-347, :428-430)
LOCKSTEP_MIN_CELLS = 1 << 16


def engine_dev_storage_refusal(p: CaseParams, mesh_grid: Optional[Tuple[int, int]] = None,
                               lockstep: bool = False) -> Optional[str]:
    """Why 16-bit deviation storage does not engage for case ``p`` in an
    engine, or None: ``dev_storage_refusal``, then the rules the JAX
    package's engines and runners take from the grid, each of which leaves
    that package on an exact f32 chunk.

    * One device (``mesh_grid`` None): its split-BC mode, which store_dev
      needs, engages only on W % 128 == 0, H % 8 == 0 and H >= 16
      (``run_chunk_pallas``, ``lbm2d_tpu/ops/pallas_step.py:1793-1822``).
    * A spatial mesh (ry, rx) of [hl, wl] blocks: with rx > 1 the kernels
      need wl % 128 == 0, else the jnp sharded step runs
      (``lbm2d_tpu/core/engine.py:155-180``); and the block's split-BC mode
      needs wl % 128 == 0, hl % 8 == 0 and hl >= 16
      (``run_chunk_sharded_pallas``, ``lbm2d_tpu/parallel/sharded.py:
      351-369``).
    * The lockstep engine (``lockstep``): below H W = 65536 cells it runs
      the vmap jnp chunk (``lbm2d_tpu/parallel/batch.py:342-347``)."""
    why = dev_storage_refusal(p, sharded=mesh_grid is not None)
    if why is not None:
        return why
    H, W = p.shape
    if mesh_grid is not None:
        ry, rx = mesh_grid
        hl, wl = H // ry, W // rx
        if rx > 1 and wl % 128:
            return (f"a {ry}x{rx} mesh of {hl}x{wl} blocks: the JAX engine runs its jnp sharded "
                    "step where rx > 1 and the block width is not a multiple of 128, exact f32")
        if wl % 128 or hl % 8 or hl < 16:
            return (f"{hl}x{wl} blocks: the JAX sharded runner's split-BC mode needs "
                    "wl % 128 == 0, hl % 8 == 0 and hl >= 16; outside it, exact f32")
    elif W % 128 or H % 8 or H < 16:
        return (f"grid {H}x{W}: the JAX run_chunk_pallas split-BC mode needs W % 128 == 0, "
                "H % 8 == 0 and H >= 16; outside it, exact f32")
    if lockstep and H * W < LOCKSTEP_MIN_CELLS:
        return (f"grid {H}x{W}: the JAX lockstep engine runs its vmap jnp chunk below "
                f"{LOCKSTEP_MIN_CELLS} cells, exact f32")
    return None


# Temporal blocking (K3), opt-in as in the JAX package: _FUSE_STEPS = S > 1
# runs a chunk's steps S at a time through K3 (S capped at FUSE_MAX_STEPS);
# None or 1 leaves it off. The chunk runner takes K3's centre tile from
# k3_tile (tests patch it for tiny tiles, as the JAX tests set _FUSE_BH).
_FUSE_STEPS = None
FUSE_MAX_STEPS = 8
# K3's block (csrc/k3_fused.cu): S levels of WW window columns, one
# thread a column, WW = 64 where the tile's TW + 2 S fits, else 128. The
# default centre tiles (rows of the sweep, columns), the fastest of those
# measured at 2432x1152 on an H100 (PERF.md; tools/kernel_ab.py): 24 x 112
# (128-column windows) up to S = 4, 48 x 48 (64-column windows) above;
# both widths are multiples of 8, so the windows' rows start 32-byte
# aligned, and both hold two blocks a SM.
K3_TILE_SHORT = (24, 112)
K3_TILE_DEEP = (48, 48)
# shared memory of an H100 SM (1 KB of it reserved per resident block),
# what one block can opt into (232,448 bytes), and the registers a thread
# K3's launch bounds allow
SM_SMEM = 228 * 1024
K3_SMEM_LIMIT = 227 * 1024
K3_MAX_REGISTERS = 64


def fuse_requested() -> bool:
    return bool(_FUSE_STEPS) and int(_FUSE_STEPS) > 1


def fuse_refusal(p: CaseParams) -> Optional[str]:
    """Why temporal blocking does not engage for case ``p`` while it is
    requested, or None: the JAX package's rules, a layout its kernels
    refuse runs on its jnp step (``layout_refusal``), and Bouzidi
    bounce-back is never fused. K3 runs no no-op side."""
    why = layout_refusal(p)
    if why is not None:
        return f"{why}, unfused"
    if p.bouzidi_obstacle:
        return "Bouzidi bounce-back is never fused (the JAX run_chunk_pallas rule)"
    return None


def fuse_steps(p: CaseParams, n_steps: int) -> int:
    """K3's sub-steps per pass for a chunk of ``n_steps`` of case ``p``, or
    0 when the chunk runs unfused."""
    if not fuse_requested() or n_steps <= 1 or fuse_refusal(p) is not None:
        return 0
    return min(int(_FUSE_STEPS), FUSE_MAX_STEPS)


def k3_window_w(S: int, tw: int) -> int:
    """Window columns of a K3 block (csrc/k3_fused.cu k3_window_w): 64 where
    the tile's TW + 2 S fits them, else 128."""
    return 64 if tw + 2 * S <= 64 else 128


def k3_smem_bytes(S: int, tw: int) -> int:
    """Shared memory of one K3 block (csrc/k3_fused.cu k3_smem_floats): an
    8-row ring of level 0 and a 4-row ring of each level 1 .. S - 1, rows
    of 9 x WW floats, and a 32-row ring of aux. The tile's height does not
    change it."""
    ww = k3_window_w(S, tw)
    return 4 * ww * (9 * (8 + 4 * (S - 1)) + 32)


def k3_blocks_per_sm(S: int, tw: int) -> int:
    """K3 blocks an H100 SM holds at S sub-steps: by shared memory, and by
    registers at K3_MAX_REGISTERS a thread (the kernel's launch bounds)."""
    by_smem = SM_SMEM // (k3_smem_bytes(S, tw) + 1024)
    by_regs = 65536 // (K3_MAX_REGISTERS * k3_window_w(S, tw) * S)
    return min(by_smem, by_regs)


def k3_window_x0(xc: int, S: int, tw: int, W: int) -> int:
    """The first global column of the K3 window whose shifted centre starts
    on column ``xc`` (csrc/k3_fused.cu xw0): 8 columns (32 bytes) aligned
    where the window still covers the level-0 columns the tile reads, else
    S columns left of the centre."""
    xa = (xc - S) // 8 * 8
    return xa if xa + k3_window_w(S, tw) >= min(W, xc + tw + S) else xc - S


def k3_tile(S: int):
    """K3's (TH, TW) centre tile for S sub-steps. The block's shared memory
    depends on S and TW only."""
    return K3_TILE_SHORT if S <= 4 else K3_TILE_DEEP


# the ramp-free scalar row and warmup of each live params object, read
# from the device once (``_host_scalars``); an entry leaves with its object
_HOST_ROWS: Dict[int, Tuple[torch.Tensor, float]] = {}


def _read_host_row(p: CaseParams) -> Tuple[torch.Tensor, float]:
    """(scalar row without the ramp, warmup) read from ``p``'s device: the
    read waits for the stream."""
    row = torch.cat(
        [
            torch.stack([p.tau0, p.cs_factor, p.s_ghost, p.tau0, p.rho_in, p.rho_out]),
            p.bc_value.reshape(-1),
        ]
    ).cpu()
    return row, float(p.warmup_steps)


def _host_scalars(p: CaseParams) -> Tuple[torch.Tensor, float]:
    """(scalar row without the ramp, warmup) on the host, read once per
    params object (a new ``CaseParams`` reads again), so no chunk waits on
    the stream for them. The row is shared: callers copy it."""
    key = id(p)
    hit = _HOST_ROWS.get(key)
    if hit is None:
        hit = _HOST_ROWS[key] = _read_host_row(p)
        weakref.finalize(p, _HOST_ROWS.pop, key, None)
    return hit


def scalar_row(p: CaseParams, step: int) -> torch.Tensor:
    """The scalar row of lattice step ``step`` as a CPU tensor [14] of the
    case dtype (counterpart of ``pallas_step._scalars``)."""
    row, warmup = _host_scalars(p)
    row = row.clone()
    row[_S_RAMP] = warmup_ramp(step, warmup, row.dtype)
    return row


@functools.lru_cache(maxsize=None)
def _full_ramp(dtype: torch.dtype) -> float:
    """``warmup_ramp`` of any step at or past the warmup, where min(1, s /
    warmup) is exactly 1."""
    return warmup_ramp(1, 1.0, dtype)


@functools.lru_cache(maxsize=1 << 17)
def _warm_ramp(step: int, warmup: float, dtype: torch.dtype) -> float:
    """``warmup_ramp`` of a step below the warmup, computed once for every
    case that shares the warmup (a lockstep group's cases do)."""
    return warmup_ramp(step, warmup, dtype)


def scalar_rows(p: CaseParams, step0: int, n: int) -> torch.Tensor:
    """The scalar rows of lattice steps step0 + 1 .. step0 + n as one
    contiguous CPU tensor [n, 14] of the case dtype: row i is bitwise
    ``scalar_row(p, step0 + 1 + i)``. Below the warmup each ramp comes from
    ``warmup_ramp`` one step at a time (a cos over a tensor of steps may
    round otherwise); from the warmup on it is one constant."""
    row, warmup = _host_scalars(p)
    rows = row.repeat(n, 1)
    rows[:, _S_RAMP] = _full_ramp(row.dtype)
    for i in range(n):
        step = step0 + 1 + i
        if step >= warmup:
            break
        rows[i, _S_RAMP] = _warm_ramp(step, warmup, row.dtype)
    return rows


@dataclass(frozen=True)
class ChunkPlan:
    """How a chunk of ``n`` steps is issued, rows of its ``scalar_rows``
    table by step: ``passes`` K3 passes of ``fuse`` steps (rows
    ``k3_rows``), then ``singles`` K1 fast steps (rows ``k1_rows``), then
    the full step (the last row). The fast launches write the two
    ping-pong buffers in turn, the first buffer 0, so the full step reads
    the state's f (no fast launch) or buffer ``1 - parity``, and in f32
    writes buffer ``parity``."""

    n: int
    fuse: int
    passes: int
    singles: int

    @property
    def k3_rows(self) -> slice:
        return slice(0, self.passes * self.fuse)

    @property
    def k1_rows(self) -> slice:
        return slice(self.passes * self.fuse, self.n - 1)

    @property
    def parity(self) -> int:
        return (self.passes + self.singles) % 2


def chunk_plan(n_steps: int, fuse: int) -> ChunkPlan:
    """The plan of a chunk of ``n_steps`` at ``fuse`` K3 steps a pass (0:
    unfused): steps 1 .. n - 1 as ``divmod(n - 1, fuse)`` = (passes,
    singles), as the JAX package's run_chunk_pallas splits them."""
    passes, singles = divmod(n_steps - 1, fuse) if fuse else (0, n_steps - 1)
    return ChunkPlan(n_steps, fuse, passes, singles)


def _ptr(t: Optional[torch.Tensor]):
    return None if t is None else t.data_ptr()


def _check(name: str, t: torch.Tensor, shape, device, dtype=torch.float32) -> None:
    if t.device != device or t.dtype != dtype or not t.is_contiguous():
        raise ValueError(
            f"{name}: need a contiguous {dtype} tensor on {device}, got "
            f"{t.dtype} on {t.device} (contiguous={t.is_contiguous()})"
        )
    if tuple(t.shape) != tuple(shape):
        raise ValueError(f"{name}: shape {tuple(t.shape)} != {tuple(shape)}")


def _scal_c(scal: torch.Tensor):
    if scal.numel() != len(SCALAR_FIELDS):
        raise ValueError(f"scalar row has {scal.numel()} entries, not 14")
    return (ctypes.c_float * len(SCALAR_FIELDS))(*scal.tolist())


def _w_col(f: torch.Tensor) -> torch.Tensor:
    """The lattice weights as f32, shaped to broadcast over f's population
    axis: the first, or the second of a lockstep group's [B, 9, H, W]."""
    return _w_on(f.device).reshape((9,) + (1,) * (min(f.dim(), 3) - 1))


@functools.lru_cache(maxsize=None)
def _w_on(device: torch.device) -> torch.Tensor:
    """The lattice weights as f32 on ``device``, copied there once: a copy
    from host memory waits for the stream, and (de)quantize runs every
    chunk."""
    return torch.as_tensor(W_LAT, dtype=torch.float32, device=device)


def quantize(f: torch.Tensor) -> torch.Tensor:
    """f32 populations [9, ...] -> bf16 deviations f - w (round to nearest
    even), as the JAX package's ``(f - w).astype(bfloat16)``."""
    return (f - _w_col(f)).to(DEV_DTYPE)


def dequantize(dev: torch.Tensor) -> torch.Tensor:
    """bf16 deviations [9, ...] -> f32 populations float(dev) + w."""
    return dev.float() + _w_col(dev)


# ---------------------------------------------------------------------------
# K1: one lattice step, the boundary ring included
# ---------------------------------------------------------------------------


def _geom(geom: Optional[BlockGeom], t: torch.Tensor) -> BlockGeom:
    """``geom``, or the whole grid of the [C, H, W] buffer ``t``."""
    return geom or BlockGeom.whole(*t.shape[1:])


def _launch_device(dev: torch.device):
    """The device context a launch on ``dev`` needs: none when ``dev`` is
    current (a mesh may put blocks on other cards)."""
    if dev.index is None or dev.index == torch.cuda.current_device():
        return contextlib.nullcontext()
    return torch.cuda.device(dev)


class RingPrev(NamedTuple):
    """What K1's ring threads of a no-op side read besides f_in
    (csrc/k1_step.cu ``RingPrev``): the state's ``rho`` [plane] and ``u``
    [2, plane] at the start of the chunk (on a mesh, [ry][rx] lists of the
    blocks'), and ``fresh``: whether they are those of the step before f_in,
    the chunk's first step. A no-op cell keeps its rho over a chunk, and
    every step's obstacle pass zeroes a solid cell's u, so on a later step
    (``fresh`` False) a solid cell's u reads as 0. Needed only where a side
    is a no-op (``noop_sides``); with ``fresh`` it must not be the buffers
    the full step writes, which the ring threads of a corner would read
    while another thread writes them."""

    rho: object
    u: object
    fresh: bool = True


def _ring_plain(f_in, f, aux, cell, box, scal, bc_type, rho, u, to_store, prof, bounce,
                g: BlockGeom, prev: Optional[RingPrev]):
    """The global ring cells that block ``g`` holds, of ``f`` (and of rho/u
    when given), in apply_bc order, from ``cell`` [12, ni, nj]: the collide
    output (f_post before the obstacle overwrite, rho, ux, uy) of the
    block's globally interior cells ``box`` = (i0, i1, j0, j1), the values
    the kernel's ring threads compute for a ring cell's inward neighbour.
    A no-op side's cells, and an active row's corner next to a no-op side,
    read their previous values instead: f from ``f_in`` (f32), rho and u
    from ``prev``. ``prof`` is the block's rows of the inlet profile and
    ``to_store`` maps the f32 ring values [9, n] to f's storage."""
    i0, i1, j0, j1 = box
    ctype = cell.dtype
    s = scal.to(device=f.device, dtype=ctype)
    ramp = float(scal[_S_RAMP])
    bcv = s[6:].view(4, 2)
    hl, wl, h = g.hl, g.wl, g.halo
    lt, tt, rt, bt = bc_type
    solid, _ = unpack_aux(aux)

    def prev_at(idx):
        """(f [9, n], rho, ux, uy) of the cells ``idx`` as the previous step
        left them (``RingPrev``)."""
        ux, uy = prev.u[(0,) + idx], prev.u[(1,) + idx]
        if not prev.fresh:
            zero = torch.zeros_like(ux)
            ux, uy = torch.where(solid[idx], zero, ux), torch.where(solid[idx], zero, uy)
        return f_in[(slice(None),) + idx], prev.rho[idx], ux, uy

    # the side columns on the block's inner rows i0..i1, from global column
    # 1 / Wg-2 (the first / last column of the box on such a block)
    rows = slice(i0 + h, i1 + h + 1)
    cols = {}  # local column -> its BC values, for the corners
    writes = []
    if g.x_off == 0:
        vl = bc_left_values(cell[:9, :, 0], cell[9, :, 0], cell[10, :, 0], cell[11, :, 0],
                            ramp, lt, s[4], u_prof=None if prof is None else prof[i0:i1 + 1])
        writes.append(((rows, h), vl if vl is not None else prev_at((rows, h))))
        cols[0] = vl
    if g.x_off + wl == g.Wg:
        vr = bc_right_values(cell[:9, :, -1], cell[9, :, -1], cell[10, :, -1], cell[11, :, -1],
                             ramp, rt, s[5], bcv[2])
        writes.append(((rows, wl - 1 + h), vr if vr is not None else prev_at((rows, wl - 1 + h))))
        cols[wl - 1] = vr
    # rows from global row 1 / Hg-2 (the first / last row of the box), the
    # corner-adjacent neighbours taken from the side BCs, or where a side is
    # a no-op from its cell as it stood; a no-op row keeps all its cells
    for side, t, r_box, y, y_nb, on in ((1, tt, -1, hl - 1, hl - 2, g.y_off + hl == g.Hg),
                                        (3, bt, 0, 0, 1, g.y_off == 0)):
        if not on:
            continue
        row = (y + h, slice(h, wl + h))
        if int(t) not in ROW_ACTIVE:
            writes.append((row, prev_at(row)))
            continue
        nb = torch.zeros((12, wl), dtype=ctype, device=f.device)
        nb[:, j0:j1 + 1] = cell[:, r_box]
        for x, vals in cols.items():
            if vals is None:
                fb, rho_b, ux_b, uy_b = prev_at((y_nb + h, x + h))
            else:
                k = y_nb - i0
                fb, rho_b, ux_b, uy_b = vals[0][:, k], vals[1][k], vals[2][k], vals[3][k]
            nb[:9, x] = fb
            nb[9, x], nb[10, x], nb[11, x] = rho_b, ux_b, uy_b
        writes.append((row, bc_horizontal_values(nb[:9], nb[9], nb[10], nb[11], ramp, t,
                                                 bcv[side])))
    w9 = torch.as_tensor(W_LAT, dtype=ctype, device=f.device).reshape(9, 1)
    for idx, (fb, rho_b, ux_b, uy_b) in writes:
        sol = solid[idx]
        # full-way bounce-back keeps the BC values on solid ring cells
        f[(slice(None),) + idx] = to_store(
            fb if bounce else torch.where(sol[None], w9 * rho_b[None], fb)
        )
        if rho is not None:
            zero = torch.zeros_like(ux_b)
            rho[idx] = rho_b
            u[(0,) + idx] = torch.where(sol, zero, ux_b)
            u[(1,) + idx] = torch.where(sol, zero, uy_b)


def _check_prev(bc_type, prev: Optional[RingPrev], rho=None, u=None) -> bool:
    """Whether K1 on ``bc_type`` reads ``prev`` (a no-op side); raise when
    it is missing, or given ``fresh`` on the buffers the full step writes."""
    if not noop_sides(bc_type):
        return False
    if prev is None:
        raise ValueError(f"bc_type {tuple(bc_type)} has no-op sides {noop_sides(bc_type)}: K1 "
                         "needs the state's rho and u (cuda_step.RingPrev)")
    if prev.fresh and rho is not None and (prev.rho.data_ptr() == rho.data_ptr()
                                           or prev.u.data_ptr() == u.data_ptr()):
        raise ValueError("K1: a fresh RingPrev must not be the rho / u the full step writes")
    return True


def _k1_plain(f_in, f_out, aux, scal, use_les, bc_type, rho, u, f_post, obstacle, q, prof,
              g: BlockGeom, to_store, prev=None):
    """K1's plain version on block ``g``: the interior update, then the ring
    from the interior's collide output (no-op sides from ``prev``);
    ``to_store`` maps f32 populations to f_out's storage."""
    if obstacle == OBSTACLE_BOUZIDI and q is None:
        raise ValueError("Bouzidi bounce-back needs the q planes")
    _check_prev(bc_type, prev, rho, u)
    box = g.interior()
    if box is None:
        return
    i0, i1, j0, j1 = box
    ni, nj, h = i1 - i0 + 1, j1 - j0 + 1, g.halo

    def at(a, dy=0, dx=0):
        """``a`` at the interior cells shifted by (dy, dx)."""
        r, c = i0 + h + dy, j0 + h + dx
        return a[..., r:r + ni, c:c + nj]

    def f_at(k, dy, dx):
        return at(f_in[k], dy, dx)

    s = scal.to(device=f_in.device, dtype=f_in.dtype)
    solid, damp = unpack_aux(at(aux))
    fs = torch.stack([f_at(k, -int(E_LAT[k, 1]), -int(E_LAT[k, 0])) for k in range(9)])
    if obstacle in (OBSTACLE_HALFWAY, OBSTACLE_BOUZIDI):
        fs = link_bounce_at(f_at, lambda dy, dx: torch.signbit(at(aux, dy, dx)), fs,
                            at(q) if obstacle == OBSTACLE_BOUZIDI else None)
    fp, r, ux, uy = mrt_collide_arrays(fs, damp, s[0], s[1], s[2], use_les)
    if obstacle == OBSTACLE_BOUNCE:
        fp = full_way_bounce(fs, fp, solid)
        f_store = fp
    else:
        w9 = torch.as_tensor(W_LAT, dtype=f_in.dtype, device=f_in.device).reshape(9, 1, 1)
        f_store = torch.where(solid[None], w9 * r[None], fp)
    rows_, cols_ = g.cells(i0, i1, j0, j1)
    f_out[:, rows_, cols_] = to_store(f_store)
    if rho is not None:
        zero = torch.zeros_like(ux)
        rho[rows_, cols_] = r
        u[0, rows_, cols_] = torch.where(solid, zero, ux)
        u[1, rows_, cols_] = torch.where(solid, zero, uy)
        f_post[:, rows_, cols_] = fp
    cell = torch.cat([fp, torch.stack([r, ux, uy])])
    _ring_plain(f_in, f_out, aux, cell, box, scal, bc_type, rho, u, to_store, prof,
                obstacle == OBSTACLE_BOUNCE, g, prev)


def k1_step_plain(f_in, f_out, aux, scal, use_les, bc_type, rho=None, u=None, f_post=None,
                  obstacle=OBSTACLE_EQ, q=None, prof=None, geom=None, prev=None):
    """Plain PyTorch version of K1 on block ``geom`` (the whole grid by
    default), writing the same cells of the same buffers: the cells
    interior in the global grid of f_out (and of rho/u/f_post when given),
    then the global ring cells the block holds (f_out, and rho/u when
    given) from the interior's collide output, the values the kernel's
    ring threads compute for themselves. Every read goes through the
    block's own cells and halo; the link predicate of half-way and Bouzidi
    bounce-back is the solid flag of ``aux`` at the pull source, as in the
    kernel. A no-op side's cells come from f_in and ``prev``."""
    _k1_plain(f_in, f_out, aux, scal, use_les, bc_type, rho, u, f_post, obstacle, q, prof,
              _geom(geom, f_in), lambda v: v, prev)


def _check_obstacle(obstacle: int, q, shape, device, allowed=tuple(range(4))) -> None:
    if obstacle not in allowed:
        raise ValueError(f"obstacle scheme {obstacle!r} not in {allowed}")
    if obstacle == OBSTACLE_BOUZIDI:
        if q is None:
            raise ValueError("Bouzidi bounce-back needs the q planes")
        _check("q", q, (8,) + tuple(shape), device)


def _prof_ptr(bc_type, prof, H: int, dev):
    """The inlet profile's pointer for left types 3/4 (checked), else None."""
    if int(bc_type[0]) not in (BC_VEL_INLET, BC_VEL_INLET_NEBB):
        return None
    if prof is None:
        raise ValueError(f"left bc_type {bc_type[0]} needs the inlet profile")
    _check("prof", prof, (H,), dev)
    return _ptr(prof)


def _prev_args(bc_type, prev: Optional[RingPrev], g: BlockGeom, dev, rho=None, u=None):
    """(rho_prev, u_prev, fresh) of a K1 entry: ``prev``'s pointers where a
    side is a no-op (checked), else nulls."""
    if not _check_prev(bc_type, prev, rho, u):
        return None, None, 0
    _check("prev.rho", prev.rho, g.plane, dev)
    _check("prev.u", prev.u, (2,) + g.plane, dev)
    return _ptr(prev.rho), _ptr(prev.u), int(bool(prev.fresh))


def _check_k1(f_in, f_out, aux, g: BlockGeom, dtype, obstacle, q, rho, u, f_post,
              allowed=tuple(range(4))):
    """K1's argument checks, for the stored planes of block ``g``."""
    dev, plane = f_in.device, g.plane
    _check("f_in", f_in, (9,) + plane, dev, dtype)
    _check("f_out", f_out, (9,) + plane, dev, dtype)
    _check("aux", aux, plane, dev)
    _check_obstacle(obstacle, q, plane, dev, allowed)
    if rho is not None:
        _check("rho", rho, plane, dev)
        _check("u", u, (2,) + plane, dev)
        _check("f_post", f_post, (9,) + plane, dev)
    if f_in.data_ptr() == f_out.data_ptr():
        raise ValueError("K1: pull streaming needs distinct in/out buffers")


def k1_step(f_in, f_out, aux, scal, use_les, bc_type, rho=None, u=None, f_post=None,
            obstacle=OBSTACLE_EQ, q=None, prof=None, geom=None, prev=None):
    """K1 on ``f_in`` -> ``f_out``: one lattice step, one launch. Distinct
    [9, H, W] buffers, or with ``geom`` the [9, hl + 2, pitch] blocks of one
    shard of a spatial mesh, halos filled, of which the cells interior in
    the global grid are updated and the global ring cells held are written
    from ``bc_type`` (left, top, right, bottom). The full variant runs when
    ``rho``, ``u`` [2, ...] and ``f_post`` [9, ...] are given; aux, q and
    those share f's geometry. ``scal`` is the CPU scalar row of this step;
    ``obstacle`` an ``OBSTACLE_*`` scheme, Bouzidi with ``q`` [8, ...];
    ``prof`` [hl] the block's rows of the inlet profile of left types 3/4;
    ``prev`` (``RingPrev``) the state's rho and u where a side is a no-op.
    Counted as ``k1_variant(obstacle, full, shard=geom.halo > 0)``."""
    if not f_in.is_cuda:
        return k1_step_plain(f_in, f_out, aux, scal, use_les, bc_type, rho, u, f_post,
                             obstacle, q, prof, geom, prev)
    g = _geom(geom, f_in)
    full = rho is not None
    dev = f_in.device
    _check_k1(f_in, f_out, aux, g, torch.float32, obstacle, q, rho, u, f_post)
    prof_ptr = _prof_ptr(bc_type, prof, g.hl, dev)
    pv = _prev_args(bc_type, prev, g, dev, rho, u)
    sc = _scal_c(scal)
    q_ptr = _ptr(q) if obstacle == OBSTACLE_BOUZIDI else None
    lt, tt, rt, bt = (int(t) for t in bc_type)
    with _launch_device(dev):
        rc = cuda_build.load("k1_step")(
            _ptr(f_in), _ptr(f_out), _ptr(aux), q_ptr, prof_ptr, _ptr(rho), _ptr(u),
            _ptr(f_post), ctypes.addressof(sc), ctypes.addressof(g.c_row), lt, tt, rt, bt,
            int(bool(use_les)), int(full), obstacle, torch.cuda.current_stream(dev).cuda_stream,
            *pv,
        )
    if rc != 0:
        raise RuntimeError(f"k1_step launch failed: CUDA error {rc}")
    LAUNCHES[k1_variant(obstacle, full, shard=g.halo > 0)] += 1


def k1_step_dev_plain(f_in, f_out, aux, scal, use_les, bc_type, obstacle=OBSTACLE_EQ,
                      prof=None, geom=None, prev=None):
    """Plain PyTorch version of K1's deviation-storage fast step: dequantize
    f_in, step in f32 as ``k1_step_plain``, ring included, and quantize each
    written cell of f_out."""
    g = _geom(geom, f_in)
    _check_obstacle(obstacle, None, g.plane, f_in.device, DEV_OBSTACLES)
    _k1_plain(dequantize(f_in), f_out, aux, scal, use_les, bc_type, None, None, None,
              obstacle, None, prof, g, quantize, prev)


def k1_step_dev(f_in, f_out, aux, scal, use_les, bc_type, obstacle=OBSTACLE_EQ, prof=None,
                geom=None, prev=None):
    """K1's fast step on bf16 deviation buffers ``f_in`` -> ``f_out``
    ([9, H, W], distinct, or one shard's blocks of ``geom``, halos
    included), ring included. Equilibrium and full-way bounce-back only.
    ``prev`` as for ``k1_step`` (the engines never run deviation storage
    with a no-op side: ``dev_storage_refusal``)."""
    if not f_in.is_cuda:
        return k1_step_dev_plain(f_in, f_out, aux, scal, use_les, bc_type, obstacle, prof,
                                 geom, prev)
    g = _geom(geom, f_in)
    dev = f_in.device
    _check_k1(f_in, f_out, aux, g, DEV_DTYPE, obstacle, None, None, None, None,
              DEV_OBSTACLES)
    prof_ptr = _prof_ptr(bc_type, prof, g.hl, dev)
    pv = _prev_args(bc_type, prev, g, dev)
    sc = _scal_c(scal)
    lt, tt, rt, bt = (int(t) for t in bc_type)
    with _launch_device(dev):
        rc = cuda_build.load("k1_step_dev")(
            _ptr(f_in), _ptr(f_out), _ptr(aux), prof_ptr, ctypes.addressof(sc),
            ctypes.addressof(g.c_row), lt, tt, rt, bt, int(bool(use_les)), obstacle,
            torch.cuda.current_stream(dev).cuda_stream, *pv,
        )
    if rc != 0:
        raise RuntimeError(f"k1_step_dev launch failed: CUDA error {rc}")
    LAUNCHES[k1_variant(obstacle, dev=True, shard=g.halo > 0)] += 1


def _ping_pong(f_in, f_a, f_b, n: int):
    """The buffer that holds f after ``n`` launches of a loop entry."""
    return f_in if n == 0 else (f_a if n % 2 else f_b)


def _check_rows(name: str, rows: torch.Tensor, n: int) -> None:
    """A loop entry's host table: ``n`` contiguous f32 CPU rows of 14."""
    if rows.is_cuda or rows.dtype != torch.float32 or not rows.is_contiguous() or tuple(
            rows.shape) != (n, len(SCALAR_FIELDS)):
        raise ValueError(f"{name}: need a contiguous f32 CPU table [{n}, 14], got "
                         f"{tuple(rows.shape)} {rows.dtype} on {rows.device}")


def _loop_failed(name: str, rc: int, failed: int, n: int) -> RuntimeError:
    at = "refused its arguments" if failed < 0 else f"failed at launch {failed} of {n}"
    return RuntimeError(f"{name} {at}: CUDA error {rc}")


def prev_at_step(prev: Optional[RingPrev], i: int) -> Optional[RingPrev]:
    """``prev`` for step ``i`` of a loop: fresh only for step 0."""
    return prev if prev is None or i == 0 else prev._replace(fresh=False)


def k1_steps_plain(f_in, f_a, f_b, aux, rows, use_les, bc_type, obstacle=OBSTACLE_EQ, q=None,
                   prof=None, dev=False, prev=None):
    """Plain version of ``k1_steps``: step i of the whole grid by
    ``k1_step_plain`` (``k1_step_dev_plain`` with ``dev``) with row i of
    ``rows``, reading f_in (step 0) or the previous step's output and
    writing f_a (even i) or f_b (odd i), ``prev`` fresh for step 0 only.
    Returns the buffer holding f."""
    src = f_in
    for i in range(rows.shape[0]):
        dst = f_b if i % 2 else f_a
        if dev:
            k1_step_dev_plain(src, dst, aux, rows[i], use_les, bc_type, obstacle, prof,
                              prev=prev_at_step(prev, i))
        else:
            k1_step_plain(src, dst, aux, rows[i], use_les, bc_type, obstacle=obstacle, q=q,
                          prof=prof, prev=prev_at_step(prev, i))
        src = dst
    return src


def k1_steps(f_in, f_a, f_b, aux, rows, use_les, bc_type, obstacle=OBSTACLE_EQ, q=None,
             prof=None, dev=False, prev=None):
    """n = len(rows) fast K1 steps of the whole grid in one call of the
    shared library: step i takes row i of the CPU table ``rows`` [n, 14],
    reads f_in (step 0) or the previous step's output, writes f_a (even i)
    or f_b (odd i); f_b may be f_in. f32 buffers, or with ``dev`` bf16
    deviations (equilibrium and full-way bounce-back). ``prev`` as for
    ``k1_step``, fresh (if so) for step 0 only. The arguments are checked
    once for the n launches. Returns the buffer holding f; counted as n
    launches of ``k1_variant(obstacle, dev=dev)``."""
    if not f_in.is_cuda:
        return k1_steps_plain(f_in, f_a, f_b, aux, rows, use_les, bc_type, obstacle, q, prof,
                              dev, prev)
    n = int(rows.shape[0])
    g = BlockGeom.whole(*f_in.shape[1:])
    d = f_in.device
    if dev:
        _check_k1(f_in, f_a, aux, g, DEV_DTYPE, obstacle, None, None, None, None,
                  DEV_OBSTACLES)
    else:
        _check_k1(f_in, f_a, aux, g, torch.float32, obstacle, q, None, None, None)
    _check("f_b", f_b, (9,) + g.plane, d, f_in.dtype)
    if f_a.data_ptr() == f_b.data_ptr():
        raise ValueError("k1_steps: f_a and f_b must be distinct buffers")
    _check_rows("k1_steps", rows, n)
    prof_ptr = _prof_ptr(bc_type, prof, g.hl, d)
    pv = _prev_args(bc_type, prev, g, d)
    q_ptr = _ptr(q) if obstacle == OBSTACLE_BOUZIDI else None
    lt, tt, rt, bt = (int(t) for t in bc_type)
    failed = ctypes.c_int(-1)
    with _launch_device(d):
        rc = cuda_build.load("k1_steps")(
            _ptr(f_in), _ptr(f_a), _ptr(f_b), _ptr(aux), q_ptr, prof_ptr, _ptr(rows), n,
            ctypes.addressof(g.c_row), lt, tt, rt, bt, int(bool(use_les)), int(bool(dev)),
            obstacle, torch.cuda.current_stream(d).cuda_stream, ctypes.addressof(failed), *pv,
        )
    LAUNCHES[k1_variant(obstacle, dev=bool(dev))] += n if rc == 0 else max(failed.value, 0)
    if rc != 0:
        raise _loop_failed("k1_steps", rc, failed.value, n)
    return _ping_pong(f_in, f_a, f_b, n)


# ---------------------------------------------------------------------------
# A sharded chunk on a mesh whose blocks live on the cards of one process
# ---------------------------------------------------------------------------

# the blocks a mesh may have for the kernels' host tables (csrc/halo.cuh
# LBM_HALO_MAX_BLOCKS); a larger mesh takes the per-step loop
MAX_MESH_BLOCKS = 64


def _flat(blocks):
    return [b for row in blocks for b in row]


def _table(blocks):
    """A host array of the blocks' device pointers, row major, or None."""
    if blocks is None:
        return None
    flat = _flat(blocks)
    return (ctypes.c_void_p * len(flat))(*[b.data_ptr() for b in flat])


def _c_addr(table):
    return None if table is None else ctypes.addressof(table)


def _at(blocks, iy: int, ix: int):
    """Block (iy, ix) of optional per-block inputs."""
    return None if blocks is None else blocks[iy][ix]


def _block_prev(prev: Optional[RingPrev], iy: int, ix: int) -> Optional[RingPrev]:
    """Block (iy, ix)'s ``RingPrev`` of a mesh's (lists of blocks)."""
    return None if prev is None else RingPrev(prev.rho[iy][ix], prev.u[iy][ix], prev.fresh)


def k1_blocks(src, dst, inputs, scal, use_les, bc_type, obstacle=OBSTACLE_EQ, dev=False,
              rho=None, u=None, f_post=None, plain=False, prev=None) -> None:
    """One K1 step on every block held, ``src`` -> ``dst`` ([ry][rx] halo'd
    blocks; a None block is another process's): ``k1_step`` on each, or
    ``k1_step_dev`` with ``dev`` (bf16 deviations), the full step when
    rho, u and f_post are given; their plain versions with ``plain``.
    ``inputs`` holds the case's [ry][rx] ``geoms``, ``aux``, ``q`` and
    ``prof`` (``ShardTables``, ``sharded.ShardedCase``), ``prev`` the
    blocks' ``RingPrev`` where a side is a no-op. The per-block body of
    every sharded loop: the per-step loop and the library loop's plain
    versions. No halo is refreshed."""
    k1, k1d = (k1_step_plain, k1_step_dev_plain) if plain else (k1_step, k1_step_dev)
    for iy, row in enumerate(src):
        for ix, b in enumerate(row):
            if b is None:
                continue
            g, aux, prof = inputs.geoms[iy][ix], inputs.aux[iy][ix], _at(inputs.prof, iy, ix)
            pv = _block_prev(prev, iy, ix)
            if dev:
                k1d(b, dst[iy][ix], aux, scal, use_les, bc_type, obstacle, prof, geom=g, prev=pv)
            else:
                k1(b, dst[iy][ix], aux, scal, use_les, bc_type, _at(rho, iy, ix), _at(u, iy, ix),
                   _at(f_post, iy, ix), obstacle=obstacle, q=_at(inputs.q, iy, ix), prof=prof,
                   geom=g, prev=pv)


def halo_exchange_plain(blocks, hl: int, wl: int) -> None:
    """Refresh the 1-cell halo ring of the [ry][rx] halo'd blocks [C, hl +
    2, pitch] in place, on blocks anywhere (one device or several): the x
    edges first, then the y edges with the x halos just written (corners in
    two hops); block sides on the global edge are left alone, and a 1x1
    mesh copies nothing. The single-process body of
    ``parallel/sharded.exchange_halos``, and the halo half of the plain
    version of the library loop, whose K1 pushes the same cells."""
    ry, rx = len(blocks), len(blocks[0])
    rows = slice(1, hl + 1)
    for iy in range(ry):
        for ix in range(rx):
            b = blocks[iy][ix]
            if ix > 0:
                b[:, rows, 0].copy_(blocks[iy][ix - 1][:, rows, wl])
            if ix + 1 < rx:
                b[:, rows, wl + 1].copy_(blocks[iy][ix + 1][:, rows, 1])
    cols = slice(0, wl + 2)
    for iy in range(ry):
        for ix in range(rx):
            b = blocks[iy][ix]
            if iy > 0:
                b[:, 0, cols].copy_(blocks[iy - 1][ix][:, hl, cols])
            if iy + 1 < ry:
                b[:, hl + 1, cols].copy_(blocks[iy + 1][ix][:, 1, cols])


def _check_blocks(name: str, blocks, grid, shape, devices, dtypes) -> None:
    """[ry][rx] contiguous blocks of one ``shape`` and a dtype of
    ``dtypes``, block i on ``devices[i]`` (row major)."""
    if len(blocks) != grid[0] or any(len(row) != grid[1] for row in blocks):
        raise ValueError(f"{name}: need {grid[0]}x{grid[1]} blocks, got "
                         f"{[len(row) for row in blocks]} a row")
    dtype = blocks[0][0].dtype
    if dtype not in dtypes:
        raise ValueError(f"{name}: dtype {dtype} not in {dtypes}")
    for i, (b, d) in enumerate(zip(_flat(blocks), devices)):
        _check(f"{name}[{i}]", b, shape, d, dtype)


_PEERS = set()  # device tuples whose peer access is enabled


def _mesh_devices(devices):
    """(host table of each block's CUDA ordinal, the distinct devices),
    peer access enabled between them once a process (C ``mesh_peers``)."""
    ords = tuple(d.index if d.index is not None else torch.cuda.current_device()
                 for d in devices)
    distinct = tuple(sorted(set(ords)))
    if len(distinct) > 1 and distinct not in _PEERS:
        rc = cuda_build.load("mesh_peers")((ctypes.c_int * len(distinct))(*distinct),
                                           len(distinct))
        if rc != 0:
            raise RuntimeError(f"peer access between cards {distinct} failed: CUDA error {rc}")
        _PEERS.add(distinct)
    return (ctypes.c_int * len(ords))(*ords), distinct


def _streams(devices):
    """A host table of each block's device's current stream."""
    return (ctypes.c_void_p * len(devices))(
        *[torch.cuda.current_stream(d).cuda_stream for d in devices])


class ShardTables:
    """What a sharded chunk's library calls take of a case on a mesh whose
    blocks all live in this process (one device, or CUDA devices with peer
    access between them: ``sharded.shard_loop_refusal``), cut once a case
    (``sharded.ShardedCase``): each block's aux plane, Bouzidi q planes and
    inlet profile rows (the tensors, [ry][rx] lists, and host tables of
    their pointers), its ``BlockGeom`` (a host table of 8 ints a block) and
    its device. Checked here, once: at most ``MAX_MESH_BLOCKS`` blocks of
    one shape, each the 1-cell-halo shard at its origin of the mesh's grid,
    each input on its block's device."""

    def __init__(self, aux, geoms, q=None, prof=None):
        self.grid = (len(geoms), len(geoms[0]))
        ry, rx = self.grid
        if ry * rx > MAX_MESH_BLOCKS:
            raise ValueError(f"{ry}x{rx} mesh: the shard loop takes {MAX_MESH_BLOCKS} blocks")
        g0 = geoms[0][0]
        for iy in range(ry):
            for ix in range(rx):
                want = BlockGeom.shard(g0.hl, g0.wl, iy * g0.hl, ix * g0.wl, ry * g0.hl,
                                       rx * g0.wl)
                if geoms[iy][ix] != want:
                    raise ValueError(f"block ({iy}, {ix}): geometry {geoms[iy][ix]}, want {want}")
        self.geom = g0
        if len(aux) != ry or any(len(row) != rx for row in aux):
            raise ValueError(f"aux: need {ry}x{rx} blocks, got {[len(r) for r in aux]} a row")
        self.devices = [b.device for b in _flat(aux)]
        if len({d.type for d in self.devices}) > 1:
            raise ValueError(f"blocks on {sorted(set(map(str, self.devices)))}: one device "
                             "type")
        _check_blocks("aux", aux, self.grid, g0.plane, self.devices, (torch.float32,))
        if q is not None:
            _check_blocks("q", q, self.grid, (8,) + g0.plane, self.devices, (torch.float32,))
        if prof is not None:
            _check_blocks("prof", prof, self.grid, (g0.hl,), self.devices, (torch.float32,))
        self.aux, self.geoms, self.q, self.prof = aux, geoms, q, prof
        self.c_aux, self.c_q, self.c_prof = _table(aux), _table(q), _table(prof)
        self.c_geoms = (ctypes.c_int * (8 * ry * rx))(*[v for g in _flat(geoms)
                                                         for v in astuple(g)])
        self.n_devices = len(set(self.devices))

    @property
    def n_blocks(self) -> int:
        return self.grid[0] * self.grid[1]

    def check_f(self, name: str, blocks, dtype) -> None:
        _check_blocks(name, blocks, self.grid, (9,) + self.geom.plane, self.devices, (dtype,))

    def needs(self, obstacle: int, bc_type, allowed=tuple(range(4))) -> None:
        """Raise unless the tables hold what ``obstacle`` and ``bc_type``
        read: q for Bouzidi, the inlet profile for left types 3/4."""
        if obstacle not in allowed:
            raise ValueError(f"obstacle scheme {obstacle!r} not in {allowed}")
        if obstacle == OBSTACLE_BOUZIDI and self.q is None:
            raise ValueError("Bouzidi bounce-back needs the q planes")
        if int(bc_type[0]) in (BC_VEL_INLET, BC_VEL_INLET_NEBB) and self.prof is None:
            raise ValueError(f"left bc_type {bc_type[0]} needs the inlet profile")

    def prev_args(self, bc_type, prev: Optional[RingPrev], rho=None, u=None):
        """(host tables of the blocks' rho_prev and u_prev, fresh) of a
        library call: ``prev``'s where a side is a no-op (checked), else
        nulls. The tables are kept by the caller for the call."""
        if not _check_prev(bc_type, prev):
            return None, None, 0
        _check_blocks("prev.rho", prev.rho, self.grid, self.geom.plane, self.devices,
                      (torch.float32,))
        _check_blocks("prev.u", prev.u, self.grid, (2,) + self.geom.plane, self.devices,
                      (torch.float32,))
        if rho is not None:
            for iy in range(self.grid[0]):
                for ix in range(self.grid[1]):
                    _check_prev(bc_type, _block_prev(prev, iy, ix), rho[iy][ix], u[iy][ix])
        return _table(prev.rho), _table(prev.u), int(bool(prev.fresh))

    def launch_args(self):
        """(the device to make current, host tables of each block's CUDA
        ordinal and stream) for a call, peer access enabled between the
        cards."""
        ords, _ = _mesh_devices(self.devices)
        return self.devices[0], ords, _streams(self.devices)


def k1_shard_steps_plain(f_in, f_a, f_b, tables: ShardTables, rows, use_les, bc_type,
                         obstacle=OBSTACLE_EQ, dev=False, prev=None):
    """Plain version of ``k1_shard_steps``: step i by ``k1_blocks(plain=
    True)`` with row i of ``rows``, then ``halo_exchange_plain`` of what
    it wrote; reading f_in (step 0) or the previous step's output and
    writing f_a (even i) or f_b (odd i), ``prev`` fresh for step 0 only.
    Returns the blocks holding f."""
    src = f_in
    for i in range(rows.shape[0]):
        dst = f_b if i % 2 else f_a
        k1_blocks(src, dst, tables, rows[i], use_les, bc_type, obstacle, dev, plain=True,
                  prev=prev_at_step(prev, i))
        halo_exchange_plain(dst, tables.geom.hl, tables.geom.wl)
        src = dst
    return src


def k1_shard_steps(f_in, f_a, f_b, tables: ShardTables, rows, use_les, bc_type,
                   obstacle=OBSTACLE_EQ, dev=False, prev=None):
    """n = len(rows) fast steps of a sharded chunk in one call of the shared
    library, on a mesh whose blocks live on the CUDA devices of this process
    (``ShardTables``): step i launches K1's ``_shard`` form on every block,
    on its device's current stream, with row i of the CPU table ``rows``
    [n, 14], reading f_in (step 0) or the previous step's output and writing
    f_a (even i) or f_b (odd i), the edge cells pushed into the
    neighbours' halos of the same buffer (no other launch; across cards
    each card's step after its neighbours' previous one). f_in, f_a, f_b
    are the [ry][rx] halo'd blocks of f (f_b may be f_in): f32, or with
    ``dev`` bf16 deviations (equilibrium and full-way bounce-back);
    ``prev`` the blocks' ``RingPrev`` where a side is a no-op, fresh (if so)
    for step 0 only. Every table is checked before the call. Returns the
    blocks holding f, halos refreshed; counted as n launches of
    ``k1_variant(obstacle, dev=dev, shard=True)`` a block."""
    if not f_in[0][0].is_cuda:
        return k1_shard_steps_plain(f_in, f_a, f_b, tables, rows, use_les, bc_type, obstacle,
                                    dev, prev)
    n, nb = int(rows.shape[0]), tables.n_blocks
    dtype = DEV_DTYPE if dev else torch.float32
    tables.needs(obstacle, bc_type, DEV_OBSTACLES if dev else tuple(range(4)))
    for name, blocks in (("f_in", f_in), ("f_a", f_a), ("f_b", f_b)):
        tables.check_f(name, blocks, dtype)
    for a, b, i in zip(_flat(f_a), _flat(f_b), _flat(f_in)):
        if a.data_ptr() in (b.data_ptr(), i.data_ptr()):
            raise ValueError("k1_shard_steps: f_a must differ from f_in and f_b on every block")
    _check_rows("k1_shard_steps", rows, n)
    rp, up, fresh = tables.prev_args(bc_type, prev)
    ta, tb, ti = _table(f_a), _table(f_b), _table(f_in)
    lt, tt, rt, bt = (int(t) for t in bc_type)
    failed = ctypes.c_int(-1)
    d, ords, streams = tables.launch_args()
    with _launch_device(d):
        rc = cuda_build.load("k1_shard_steps")(
            ctypes.addressof(ti), ctypes.addressof(ta), ctypes.addressof(tb),
            ctypes.addressof(tables.c_aux), _c_addr(tables.c_q), _c_addr(tables.c_prof),
            ctypes.addressof(tables.c_geoms), tables.grid[0], tables.grid[1], _ptr(rows), n,
            lt, tt, rt, bt, int(bool(use_les)), int(bool(dev)), obstacle,
            ctypes.addressof(ords), ctypes.addressof(streams), ctypes.addressof(failed),
            _c_addr(rp), _c_addr(up), fresh,
        )
    done = n if rc == 0 else max(failed.value, 0)
    LAUNCHES[k1_variant(obstacle, dev=bool(dev), shard=True)] += nb * done
    if rc != 0:
        raise _loop_failed("k1_shard_steps", rc, failed.value, n)
    return _ping_pong(f_in, f_a, f_b, n)


def k1_shard_full_plain(f_in, f_out, tables: ShardTables, scal, use_les, bc_type, rho, u,
                        f_post, obstacle=OBSTACLE_EQ, prev=None):
    """Plain version of ``k1_shard_full``: ``k1_blocks(plain=True)``'s full
    step, then ``halo_exchange_plain`` of f_out."""
    k1_blocks(f_in, f_out, tables, scal, use_les, bc_type, obstacle, rho=rho, u=u,
              f_post=f_post, plain=True, prev=prev)
    halo_exchange_plain(f_out, tables.geom.hl, tables.geom.wl)


def k1_shard_full(f_in, f_out, tables: ShardTables, scal, use_les, bc_type, rho, u, f_post,
                  obstacle=OBSTACLE_EQ, prev=None):
    """The closing full step of a sharded chunk in one call of the shared
    library: K1's full ``_shard`` form on every block (f32 f_in -> f_out,
    writing the blocks' rho, u and f_post), the edge cells of f_out pushed
    into the neighbours' halos, which the next chunk reads; ``scal`` the
    step's CPU scalar row, ``prev`` as for ``k1_shard_steps``. Counted as
    one launch of ``k1_variant(obstacle, full=True, shard=True)`` a
    block."""
    if not f_in[0][0].is_cuda:
        return k1_shard_full_plain(f_in, f_out, tables, scal, use_les, bc_type, rho, u, f_post,
                                   obstacle, prev)
    tables.needs(obstacle, bc_type)
    g = tables.geom
    for name, blocks in (("f_in", f_in), ("f_out", f_out), ("f_post", f_post)):
        tables.check_f(name, blocks, torch.float32)
    _check_blocks("rho", rho, tables.grid, g.plane, tables.devices, (torch.float32,))
    _check_blocks("u", u, tables.grid, (2,) + g.plane, tables.devices, (torch.float32,))
    for a, b in zip(_flat(f_in), _flat(f_out)):
        if a.data_ptr() == b.data_ptr():
            raise ValueError("k1_shard_full: pull streaming needs distinct in/out buffers")
    rp, up, fresh = tables.prev_args(bc_type, prev, rho, u)
    sc = _scal_c(scal)
    lt, tt, rt, bt = (int(t) for t in bc_type)
    tabs = [_table(x) for x in (f_in, f_out, rho, u, f_post)]
    d, ords, streams = tables.launch_args()
    with _launch_device(d):
        rc = cuda_build.load("k1_shard_full")(
            ctypes.addressof(tabs[0]), ctypes.addressof(tabs[1]),
            ctypes.addressof(tables.c_aux), _c_addr(tables.c_q), _c_addr(tables.c_prof),
            ctypes.addressof(tabs[2]), ctypes.addressof(tabs[3]), ctypes.addressof(tabs[4]),
            ctypes.addressof(sc), ctypes.addressof(tables.c_geoms), tables.grid[0],
            tables.grid[1], lt, tt, rt, bt, int(bool(use_les)), obstacle,
            ctypes.addressof(ords), ctypes.addressof(streams), _c_addr(rp), _c_addr(up), fresh,
        )
    if rc != 0:
        raise RuntimeError(f"k1_shard_full launch failed: CUDA error {rc}")
    LAUNCHES[k1_variant(obstacle, full=True, shard=True)] += tables.n_blocks


# ---------------------------------------------------------------------------
# K3: temporal blocking
# ---------------------------------------------------------------------------


def _k3_windows(H: int, W: int, S: int, th: int, tw: int, device):
    """K3's tiles as window coordinates: (gy [T, WH, WW], gx [T, WH, WW], the
    flat (tile, window row, window column) index of each grid cell's
    unshifted centre copy [H, W]). The last tile of each axis is shifted
    back to end on the grid's edge, as in the kernel."""
    nty, ntx = -(-H // th), -(-W // tw)
    wh, ww = th + 2 * S, tw + 2 * S
    ar = lambda n: torch.arange(n, device=device)  # noqa: E731
    y0 = torch.clamp(ar(nty) * th, max=max(H - th, 0)) - S
    x0 = torch.clamp(ar(ntx) * tw, max=max(W - tw, 0)) - S
    gy = (y0[:, None] + ar(wh))[:, None, :, None].expand(nty, ntx, wh, ww).reshape(-1, wh, ww)
    gx = (x0[:, None] + ar(ww))[None, :, None, :].expand(nty, ntx, wh, ww).reshape(-1, wh, ww)
    ty, tx = ar(H) // th, ar(W) // tw
    wy, wx = ar(H) - y0[ty], ar(W) - x0[tx]
    flat = ((ty[:, None] * ntx + tx[None, :]) * wh + wy[:, None]) * ww + wx[None, :]
    return gy, gx, flat


def _roll(a: torch.Tensor, dy: int, dx: int) -> torch.Tensor:
    """a[..., i - dy, j - dx] over the window's last two axes."""
    return torch.roll(a, (dy, dx), dims=(-2, -1))


def _check_k3_layout(bc_type) -> None:
    """K3 runs every side active, as the JAX ``_fused_kernel`` does; the
    chunk runner never fuses a layout with a no-op side (``fuse_refusal``)."""
    if noop_sides(bc_type):
        raise ValueError(f"K3: bc_type {tuple(bc_type)} has no-op sides "
                         f"{noop_sides(bc_type)}; the fused kernel runs every side active")


def k3_fused_plain(f_in, f_out, aux, scal_rows, bc_type, use_les, obstacle=OBSTACLE_EQ,
                   prof=None, tile=None):
    """Plain PyTorch version of K3, the windowed algorithm itself: every
    tile's window (its centre plus S halo cells a side, clipped to the grid)
    advances S sub-steps on its own, region R_s shrinking by one cell a side
    per sub-step, with the boundary ring applied inside each window in
    apply_bc order; then each cell's unshifted centre copy is stored. The
    windows run batched, [9, T, WH, WW]; cells outside R_s or the grid keep
    whatever they held and are never read into a stored value."""
    _check_obstacle(obstacle, None, f_in.shape[1:], f_in.device, FUSE_OBSTACLES)
    _check_k3_layout(bc_type)
    S = scal_rows.shape[0]
    th, tw = tile or k3_tile(S)
    H, W = f_in.shape[1:]
    dev = f_in.device
    gy, gx, flat = _k3_windows(H, W, S, th, tw, dev)
    wh, ww = gy.shape[1:]
    gyc, gxc = gy.clamp(0, H - 1), gx.clamp(0, W - 1)
    cur = f_in[:, gyc, gxc]
    solid, damp = unpack_aux(aux[gyc, gxc])
    ingrid = (gy >= 0) & (gy < H) & (gx >= 0) & (gx < W)
    inner_row = (gy >= 1) & (gy <= H - 2)
    side_l, side_r = inner_row & (gx == 0), inner_row & (gx == W - 1)
    row_b, row_t = gy == 0, gy == H - 1
    wi = torch.arange(wh, device=dev)[:, None]
    wj = torch.arange(ww, device=dev)[None, :]
    u_prof = None if prof is None else prof[gyc]
    w9 = torch.as_tensor(W_LAT, dtype=f_in.dtype, device=dev).reshape(9, 1, 1, 1)
    lt, tt, rt, bt = bc_type
    for step in range(S):
        sc = scal_rows[step]
        s = sc.to(device=dev, dtype=f_in.dtype)
        ramp = float(sc[_S_RAMP])
        bcv = s[6:].view(4, 2)
        region = ((wi >= step + 1) & (wi < wh - step - 1) & (wj >= step + 1)
                  & (wj < ww - step - 1) & ingrid)
        fs = torch.stack([_roll(cur[k], int(E_LAT[k, 1]), int(E_LAT[k, 0])) for k in range(9)])
        if obstacle == OBSTACLE_HALFWAY:
            fs = torch.stack([fs[0]] + [
                torch.where(_roll(solid, int(E_LAT[k, 1]), int(E_LAT[k, 0])),
                            cur[int(OPP_LAT[k])], fs[k])
                for k in range(1, 9)])
        fp, r, ux, uy = mrt_collide_arrays(fs, damp, s[0], s[1], s[2], use_les)
        if obstacle == OBSTACLE_BOUNCE:
            fp = full_way_bounce(fs, fp, solid)
        vals = [fp, r, ux, uy]
        # the side columns from the collide output of columns 1 / W-2
        vl = bc_left_values(*[_roll(v, 0, -1) for v in vals], ramp, lt, s[4], u_prof=u_prof)
        vr = bc_right_values(*[_roll(v, 0, 1) for v in vals], ramp, rt, s[5], bcv[2])
        for m, bv in ((side_l, vl), (side_r, vr)):
            vals = [torch.where(m, b, v) for b, v in zip(bv, vals)]
        # then the bottom/top rows, corners from the side BCs just merged
        vt = bc_horizontal_values(*[_roll(v, 1, 0) for v in vals], ramp, tt, bcv[1])
        vb = bc_horizontal_values(*[_roll(v, -1, 0) for v in vals], ramp, bt, bcv[3])
        for m, bv in ((row_t, vt), (row_b, vb)):
            vals = [torch.where(m, b, v) for b, v in zip(bv, vals)]
        f_new, rho = vals[0], vals[1]
        if obstacle != OBSTACLE_BOUNCE:
            f_new = torch.where(solid, w9 * rho, f_new)
        cur = torch.where(region, f_new, cur)
    f_out.copy_(cur.reshape(9, -1)[:, flat])


def k3_fused(f_in, f_out, aux, scal_rows, bc_type, use_les, obstacle=OBSTACLE_EQ, prof=None,
             tile=None):
    """K3 on ``f_in`` -> ``f_out`` (distinct [9, H, W] f32 buffers): S =
    len(scal_rows) lattice steps in one pass, ``scal_rows`` [S, 14] the CPU
    scalar rows of those steps. ``obstacle`` is an ``OBSTACLE_*`` scheme
    other than Bouzidi, ``prof`` [H] the inlet profile of left types 3/4,
    ``tile`` the (TH, TW) centre (``k3_tile(S)`` by default)."""
    S = int(scal_rows.shape[0])
    tile = tuple(tile or k3_tile(S))
    if not f_in.is_cuda:
        return k3_fused_plain(f_in, f_out, aux, scal_rows, bc_type, use_les, obstacle, prof,
                              tile)
    _, H, W = f_in.shape
    dev = f_in.device
    _check("f_in", f_in, (9, H, W), dev)
    _check("f_out", f_out, (9, H, W), dev)
    _check("aux", aux, (H, W), dev)
    _check_obstacle(obstacle, None, (H, W), dev, FUSE_OBSTACLES)
    _check_k3_layout(bc_type)
    if not 1 <= S <= FUSE_MAX_STEPS or tuple(scal_rows.shape) != (S, len(SCALAR_FIELDS)):
        raise ValueError(f"k3_fused: scalar rows {tuple(scal_rows.shape)}, need "
                         f"[S <= {FUSE_MAX_STEPS}, 14]")
    th, tw = tile
    if min(th, tw) < 2 or tw + 2 * S > 128:
        raise ValueError(f"k3_fused: tile {tile} at S = {S}: need TH, TW >= 2 and "
                         f"TW + 2 S <= 128")
    if f_in.data_ptr() == f_out.data_ptr():
        raise ValueError("k3_fused: needs distinct in/out buffers")
    prof_ptr = _prof_ptr(bc_type, prof, H, dev)
    rows = scal_rows.to(torch.float32).reshape(-1).tolist()
    sc = (ctypes.c_float * len(rows))(*rows)
    lt, tt, rt, bt = (int(t) for t in bc_type)
    rc = cuda_build.load("k3_fused")(
        _ptr(f_in), _ptr(f_out), _ptr(aux), prof_ptr, ctypes.addressof(sc), S, H, W, th, tw,
        lt, tt, rt, bt, int(bool(use_les)), obstacle, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"k3_fused launch failed: CUDA error {rc}")
    LAUNCHES[k3_variant(obstacle, lt)] += 1


def k3_passes_plain(f_in, f_a, f_b, aux, rows, S, bc_type, use_les, obstacle=OBSTACLE_EQ,
                    prof=None, tile=None):
    """Plain version of ``k3_passes``: pass i by ``k3_fused_plain`` with
    rows i S .. i S + S - 1 of ``rows``, reading f_in (pass 0) or the
    previous pass's output and writing f_a (even i) or f_b (odd i).
    Returns the buffer holding f."""
    src = f_in
    for i in range(rows.shape[0] // S):
        dst = f_b if i % 2 else f_a
        k3_fused_plain(src, dst, aux, rows[i * S:(i + 1) * S], bc_type, use_les, obstacle, prof,
                       tile)
        src = dst
    return src


def k3_passes(f_in, f_a, f_b, aux, rows, S, bc_type, use_les, obstacle=OBSTACLE_EQ, prof=None,
              tile=None):
    """len(rows) / S passes of K3 (S steps each) in one call of the shared
    library: pass i takes rows i S .. i S + S - 1 of the CPU table
    ``rows``, reads f_in (pass 0) or the previous pass's output and writes
    f_a (even i) or f_b (odd i); f_b may be f_in. f32 [9, H, W] buffers;
    ``tile`` as for ``k3_fused``. Returns the buffer holding f; counted as
    one launch of ``k3_variant`` a pass."""
    tile = tuple(tile or k3_tile(S))
    if not f_in.is_cuda:
        return k3_passes_plain(f_in, f_a, f_b, aux, rows, S, bc_type, use_les, obstacle, prof,
                               tile)
    _, H, W = f_in.shape
    d = f_in.device
    if not 1 <= S <= FUSE_MAX_STEPS or rows.shape[0] % S:
        raise ValueError(f"k3_passes: {rows.shape[0]} rows are not passes of S = {S} "
                         f"(1 <= S <= {FUSE_MAX_STEPS})")
    passes = int(rows.shape[0]) // S
    for name, t in (("f_in", f_in), ("f_a", f_a), ("f_b", f_b)):
        _check(name, t, (9, H, W), d)
    _check("aux", aux, (H, W), d)
    _check_obstacle(obstacle, None, (H, W), d, FUSE_OBSTACLES)
    _check_k3_layout(bc_type)
    if f_a.data_ptr() in (f_in.data_ptr(), f_b.data_ptr()):
        raise ValueError("k3_passes: f_a must differ from f_in and f_b")
    _check_rows("k3_passes", rows, passes * S)
    th, tw = tile
    prof_ptr = _prof_ptr(bc_type, prof, H, d)
    lt, tt, rt, bt = (int(t) for t in bc_type)
    failed = ctypes.c_int(-1)
    rc = cuda_build.load("k3_passes")(
        _ptr(f_in), _ptr(f_a), _ptr(f_b), _ptr(aux), prof_ptr, _ptr(rows), passes, S, H, W, th,
        tw, lt, tt, rt, bt, int(bool(use_les)), obstacle,
        torch.cuda.current_stream(d).cuda_stream, ctypes.addressof(failed),
    )
    LAUNCHES[k3_variant(obstacle, lt)] += passes if rc == 0 else max(failed.value, 0)
    if rc != 0:
        raise _loop_failed("k3_passes", rc, failed.value, passes)
    return _ping_pong(f_in, f_a, f_b, passes)


# ---------------------------------------------------------------------------
# Chunk runner
# ---------------------------------------------------------------------------


def run_chunk_cuda(state: LBMState, p: CaseParams, n_steps: int, store_dev: bool = False):
    """Advance ``n_steps`` through the kernels; same contract as
    ``solver.run_chunk``: ``(state, {"force": [2], "max_v": 0-d})``.

    Steps 1..n-1 run K1's fast variant, the last step its full variant.
    f_post keeps its ring and takes the last step's interior. The input
    state is not modified. ``store_dev`` runs steps 1..n-1 in 16-bit
    deviation storage when n > 1 and the obstacle scheme allows it (the JAX
    package's run_chunk_pallas engages it under the same conditions,
    ``dev_storage_refusal``; the engines add the grid's rules). While
    temporal blocking is requested (``_FUSE_STEPS`` = S > 1) and the case
    allows it, steps 1..n-1 run as ``divmod(n - 1, S)`` = (k, r): k passes
    of K3, then r single K1 steps, as the JAX package's run_chunk_pallas
    does. Where a side is a no-op, K1's ring threads read the state's rho
    and u there (``RingPrev``): its cells keep their values, as in the
    eager step.

    A chunk is one program, as run_chunk_pallas's jit over lax.scan is:
    its scalar rows are built once (``scalar_rows``, no device read), and
    it makes at most four calls of the shared libraries, each launching
    on the current stream with no sync: the K3 passes (``k3_passes``), the
    single K1 steps (``k1_steps``), the closing full step (``k1_step``)
    and the monitors (``case_monitors``: the case as a group of one, its
    links, scratch and tickets cut once a params object, ``case_links``).
    """
    return _run_chunk(state, p, n_steps, store_dev, plain=False)


def run_chunk_plain(state: LBMState, p: CaseParams, n_steps: int, store_dev: bool = False):
    """``run_chunk_cuda`` through the kernels' plain versions on any device:
    the plain version of the whole chunk runner."""
    return _run_chunk(state, p, n_steps, store_dev, plain=True)


def _run_chunk(state: LBMState, p: CaseParams, n_steps: int, store_dev: bool, plain: bool):
    reason = unsupported(p)
    if reason is not None:
        raise ValueError(f"run_chunk_cuda does not support this case: {reason}")
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if plain:
        k1, k1s, k3s = k1_step_plain, k1_steps_plain, k3_passes_plain
    else:
        k1, k1s, k3s = k1_step, k1_steps, k3_passes
    dev_store = bool(store_dev) and n_steps > 1 and dev_storage_refusal(p) is None
    plan = chunk_plan(n_steps, fuse_steps(p, n_steps))
    obst = obstacle_scheme(p)
    q = p.bouzidi_q if obst == OBSTACLE_BOUZIDI else None
    prof = p.inlet_profile if p.bc_type[0] in (BC_VEL_INLET, BC_VEL_INLET_NEBB) else None
    prev = RingPrev(state.rho, state.u) if noop_sides(p.bc_type) else None
    H, W = p.shape
    dev = state.f.device
    aux = pack_aux(p.damping, p.mask)
    rows = scalar_rows(p, state.step, n_steps)
    # quantize once per chunk; the fast steps ping-pong two buffers
    src = quantize(state.f) if dev_store else state.f
    bufs = (torch.empty_like(src), torch.empty_like(src))
    if plan.passes:
        src = k3s(src, bufs[0], bufs[1], aux, rows[plan.k3_rows], plan.fuse, p.bc_type,
                  p.use_les, obst, prof, k3_tile(plan.fuse))
    if plan.singles:
        first = plan.passes % 2
        src = k1s(src, bufs[first], bufs[1 - first], aux, rows[plan.k1_rows], p.use_les,
                  p.bc_type, obst, q, prof, dev_store, prev_at_step(prev, plan.passes))
    if dev_store:
        # the closing full step runs in exact f32
        src = dequantize(src)
        dst = torch.empty_like(src)
    else:
        dst = bufs[plan.parity]
    rho = torch.empty((H, W), dtype=state.f.dtype, device=dev)
    u = torch.empty((2, H, W), dtype=state.f.dtype, device=dev)
    f_post = state.f_post.clone()
    k1(src, dst, aux, rows[n_steps - 1], p.use_les, p.bc_type, rho, u, f_post, obstacle=obst,
       q=q, prof=prof, prev=prev_at_step(prev, n_steps - 1))
    new_state = LBMState(f=dst, f_post=f_post, rho=rho, u=u, step=state.step + n_steps)
    return new_state, (case_monitors_plain if plain else case_monitors)(f_post, u, case_links(p))


def run_chunk_stepwise(state: LBMState, p: CaseParams, n_steps: int, store_dev: bool = False):
    """``run_chunk_cuda`` issued one wrapper call a step (``k1_step``,
    ``k1_step_dev``, ``k3_fused``), each step's row from ``scalar_row``:
    the reference the chunk's library loops are held to, bitwise."""
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    dev_store = bool(store_dev) and n_steps > 1 and dev_storage_refusal(p) is None
    plan = chunk_plan(n_steps, fuse_steps(p, n_steps))
    obst = obstacle_scheme(p)
    q = p.bouzidi_q if obst == OBSTACLE_BOUZIDI else None
    prof = p.inlet_profile if p.bc_type[0] in (BC_VEL_INLET, BC_VEL_INLET_NEBB) else None
    prev = RingPrev(state.rho, state.u) if noop_sides(p.bc_type) else None
    aux = pack_aux(p.damping, p.mask)
    src = quantize(state.f) if dev_store else state.f
    step = state.step
    for _ in range(plan.passes):
        dst = torch.empty_like(src)
        rows = torch.stack([scalar_row(p, step + 1 + i) for i in range(plan.fuse)])
        k3_fused(src, dst, aux, rows, p.bc_type, p.use_les, obst, prof, k3_tile(plan.fuse))
        src, step = dst, step + plan.fuse
    for _ in range(plan.singles):
        dst = torch.empty_like(src)
        pv = prev_at_step(prev, step - state.step)
        step += 1
        if dev_store:
            k1_step_dev(src, dst, aux, scalar_row(p, step), p.use_les, p.bc_type, obst, prof,
                        prev=pv)
        else:
            k1_step(src, dst, aux, scalar_row(p, step), p.use_les, p.bc_type, obstacle=obst,
                    q=q, prof=prof, prev=pv)
        src = dst
    if dev_store:
        src = dequantize(src)
    dst = torch.empty_like(src)
    H, W = p.shape
    rho = torch.empty((H, W), dtype=src.dtype, device=src.device)
    u = torch.empty((2, H, W), dtype=src.dtype, device=src.device)
    f_post = state.f_post.clone()
    k1_step(src, dst, aux, scalar_row(p, step + 1), p.use_les, p.bc_type, rho, u, f_post,
            obstacle=obst, q=q, prof=prof, prev=prev_at_step(prev, n_steps - 1))
    new_state = LBMState(f=dst, f_post=f_post, rho=rho, u=u, step=state.step + n_steps)
    return new_state, case_monitors(f_post, u, case_links(p))


# ---------------------------------------------------------------------------
# A lockstep group's chunk: one program over the group's cases
# ---------------------------------------------------------------------------

# the monitor kernel's geometry (csrc/monitors.cu): threads a block, the
# link warps an item's force is summed by (the order ``monitor_sum_plain``
# repeats), the blocks an item's link warps take, and the blocks a SM its
# launch bounds hold, which its one wave is sized for
MON_THREADS = 256
MON_LINK_WARPS = 128
MON_LINK_LANES = MON_LINK_WARPS * 32
MON_LINK_BLOCKS = MON_LINK_WARPS * 32 // MON_THREADS
MON_BLOCKS_A_SM = 4
MON_MAX_TOTAL_ITEMS = 96
# a boundary link: (cell << LINK_CELL_SHIFT) | (cell - e_j in the grid) <<
# 4 | j
LINK_CELL_SHIFT = 5
_LINK_UP = 16


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


def monitor_blocks(cells: int, items: int, device: torch.device) -> int:
    """The monitor kernel's u blocks an item: what one wave over the card's
    SMs holds for the ``items`` beside their MON_LINK_BLOCKS link blocks,
    no more than an item's ``cells`` (read 4 a thread) fill, at least one.
    The force's order does not depend on it."""
    wave = _sm_count(device.index or 0) * MON_BLOCKS_A_SM // items - MON_LINK_BLOCKS
    return max(1, min(wave, -(-cells // (4 * MON_THREADS))))


def boundary_links(p: CaseParams) -> torch.Tensor:
    """Case ``p``'s boundary links (``mask_links`` of ``p.mask``): the same
    links for every obstacle scheme, force_on_obstacle's (solid s, fluid s
    + e_k) pairs being these with j = opp k."""
    return mask_links(p.mask)


def mask_links(mask: torch.Tensor) -> torch.Tensor:
    """The boundary links of a solid mask [H, W], the momentum-exchange
    force's terms, as a CPU int32 list: each fluid cell x (row major, x = y
    W + x') with a solid neighbour x + e_j in the grid, for j = 1 .. 8 in
    turn, packed as (x << 5) | (x - e_j in the grid) << 4 | j. Built on the
    host once a mask (a lockstep group's cases often share one)."""
    solid = (mask > 0.5).cpu().numpy()
    H, W = solid.shape
    if H * W >= 1 << (31 - LINK_CELL_SHIFT):
        raise ValueError(f"grid {H}x{W}: a boundary link's cell index needs "
                         f"H W < 2^{31 - LINK_CELL_SHIFT}")
    return _links_of(np.packbits(solid).tobytes(), H, W)


@functools.lru_cache(maxsize=16)
def _links_of(packed: bytes, H: int, W: int) -> torch.Tensor:
    solid = np.unpackbits(np.frombuffer(packed, np.uint8), count=H * W).reshape(H, W) > 0
    # from the solid cells s (row major): x = s - e_j is a link's fluid cell
    # where it lies in the grid and is fluid, in row-major order again
    sy, sx = np.nonzero(solid)
    out = []
    for j in range(1, 9):
        ex, ey = int(E_LAT[j, 0]), int(E_LAT[j, 1])
        ys, xs = sy - ey, sx - ex
        keep = (ys >= 0) & (ys < H) & (xs >= 0) & (xs < W)
        ys, xs = ys[keep], xs[keep]
        keep = ~solid[ys, xs]
        ys, xs = ys[keep], xs[keep]
        up = (ys - ey >= 0) & (ys - ey < H) & (xs - ex >= 0) & (xs - ex < W)
        cell = ys.astype(np.int64) * W + xs
        out.append((cell << LINK_CELL_SHIFT) | (up.astype(np.int64) << 4) | j)
    return torch.from_numpy(np.concatenate(out).astype(np.int32))


def _upload(host: torch.Tensor, device: torch.device) -> torch.Tensor:
    """``host`` on ``device``: from pinned memory without a sync on a card
    (a copy from pageable memory waits for the stream), as is on the CPU."""
    if device.type != "cuda":
        return host.to(device)
    return host.pin_memory().to(device, non_blocking=True)


class MonitorLinks:
    """The monitor kernel's inputs of I items that do not change between
    chunks, cut once (a group, a case, a mesh's blocks on one card): their
    link lists (``mask_links``, in each item's f_post layout) in CSR form
    on ``device`` (``links``, ``offsets``; the host lists ``links_host``),
    the kernel's f64 scratch [I, MON_LINK_WARPS, 2] and its int32 slots
    [3 I + 1] (max bits and tickets, zero between launches). A launch
    reuses them: the launches of one ``MonitorLinks`` follow each other on
    a stream."""

    def __init__(self, links_host, device):
        self.links_host = [x.to(torch.int32) for x in links_host]
        self.I = len(self.links_host)
        self.device = torch.device(device)
        counts = [0] + [int(x.numel()) for x in self.links_host]
        self.offsets_host = torch.tensor(np.cumsum(counts), dtype=torch.int32)
        # one entry more than the links, so an empty list still has a pointer
        self.links = torch.cat(self.links_host + [torch.zeros(1, dtype=torch.int32)]).to(
            self.device)
        self.offsets = self.offsets_host.to(self.device)
        self.partial = torch.zeros((self.I, MON_LINK_WARPS, 2), dtype=torch.float64,
                                   device=self.device)
        self.slots = torch.zeros(3 * self.I + 1, dtype=torch.int32, device=self.device)

    def item_links(self, c: int) -> torch.Tensor:
        """Item ``c``'s links on the device (a view)."""
        return self.links[int(self.offsets_host[c]):int(self.offsets_host[c + 1])]


class CaseLinks:
    """A case's monitor inputs, cut once: its scheme, its Bouzidi q planes
    and the ``MonitorLinks`` of one item, the links of ``p.mask`` or of
    ``mask`` (the DFG path's walls-excluded cylinder)."""

    def __init__(self, p: CaseParams, mask: Optional[torch.Tensor] = None):
        self.shape = tuple(p.shape)
        self.bouzidi = obstacle_scheme(p) == OBSTACLE_BOUZIDI
        self.q = p.bouzidi_q if self.bouzidi else None
        links = boundary_links(p) if mask is None else mask_links(mask)
        self.mon = MonitorLinks([links], p.mask.device)


_CASE_LINKS: Dict[int, CaseLinks] = {}


def case_links(p: CaseParams) -> CaseLinks:
    """``CaseLinks(p)``, cut once per params object (a new ``CaseParams``
    cuts again), as ``_host_scalars`` reads its row once."""
    key = id(p)
    hit = _CASE_LINKS.get(key)
    if hit is None:
        hit = _CASE_LINKS[key] = CaseLinks(p)
        weakref.finalize(p, _CASE_LINKS.pop, key, None)
    return hit


class GroupParams:
    """What a lockstep group's program takes of its cases, cut once a group
    (the JAX BatchEngine's stacked CaseParams): the cases' CaseParams (each
    case's host scalar rows, read once), their packed aux planes [B, H, W],
    Bouzidi q planes [B, 8, H, W] and inlet profiles [B, H] where the
    scheme and the layout read them, their boundary links and the monitor
    kernel's scratch (``MonitorLinks``), and the device tables a chunk
    reads: the alive cases' indices (``slots``) and the alive and
    past-the-warmup flags (``case_table``), rebuilt only when
    they change (a case never comes back to life), and the cases' scalar
    rows (``device_rows``), uploaded only when they change (past the warmup
    never). The cases share the grid, the BC layout, the LES flag, the
    obstacle scheme and the device; the kernels must cover them
    (``unsupported``)."""

    def __init__(self, params):
        params = list(params)
        if not params:
            raise ValueError("a group needs at least one case")
        p0 = params[0]
        for p in params:
            why = unsupported(p)
            if why is not None:
                raise ValueError(f"the group program does not cover {why}")
            if (p.shape != p0.shape or tuple(p.bc_type) != tuple(p0.bc_type)
                    or bool(p.use_les) != bool(p0.use_les)
                    or obstacle_scheme(p) != obstacle_scheme(p0)
                    or p.mask.device != p0.mask.device):
                raise ValueError("a group's cases must share the grid, bc_type, use_les, the "
                                 "obstacle scheme and the device")
        self.cases = params
        self.B = len(params)
        self.shape = tuple(p0.shape)
        self.bc_type = tuple(int(t) for t in p0.bc_type)
        self.use_les = bool(p0.use_les)
        self.obstacle = obstacle_scheme(p0)
        self.device = p0.mask.device
        self.aux = torch.stack([pack_aux(p.damping, p.mask) for p in params]).contiguous()
        self.q = (torch.stack([p.bouzidi_q for p in params]).contiguous()
                  if self.obstacle == OBSTACLE_BOUZIDI else None)
        vel = self.bc_type[0] in (BC_VEL_INLET, BC_VEL_INLET_NEBB)
        self.prof = torch.stack([p.inlet_profile for p in params]).contiguous() if vel else None
        self.warmup = [_host_scalars(p)[1] for p in params]
        self.mon = MonitorLinks([boundary_links(p) for p in params], self.device)
        self._slots = self._table = self._rows = None

    def rows(self, steps, n: int) -> torch.Tensor:
        """The cases' scalar rows of lattice steps step_c + 1 .. step_c + n,
        a contiguous CPU table [B, n, 14] (``scalar_rows`` a case)."""
        return torch.stack([scalar_rows(p, int(s), n) for p, s in zip(self.cases, steps)])

    def slots(self, alive):
        """(device int32 table of the alive cases' indices, their count)."""
        key = tuple(bool(a) for a in alive)
        if len(key) != self.B:
            raise ValueError(f"alive has {len(key)} entries, the group {self.B} cases")
        if self._slots is None or self._slots[0] != key:
            idx = torch.tensor([i for i, a in enumerate(key) if a] or [0], dtype=torch.int32)
            self._slots = (key, _upload(idx, self.device), sum(key))
        return self._slots[1], self._slots[2]

    def case_table(self, alive, later):
        """Device int32 [2 B]: the alive flags, then whether each case is past
        its warmup (``is_stable_device``'s velocity rule)."""
        key = tuple(bool(a) for a in alive) + tuple(bool(x) for x in later)
        if self._table is None or self._table[0] != key:
            self._table = (key, _upload(torch.tensor(key, dtype=torch.int32), self.device))
        return self._table[1]

    def device_rows(self, rows: torch.Tensor) -> torch.Tensor:
        """``rows`` [B, R, 14] on the device, uploaded when it differs from
        the last table."""
        _check_group_rows(rows, self.B)
        if (self._rows is None or self._rows[0].shape != rows.shape
                or not torch.equal(self._rows[0], rows)):
            self._rows = (rows.clone(), _upload(rows, self.device))
        return self._rows[1]

    def later(self, steps):
        """Whether each case at lattice step ``steps[c]`` is past its warmup."""
        return [int(s) > w for s, w in zip(steps, self.warmup)]


def _check_group_rows(rows: torch.Tensor, B: int) -> None:
    if rows.is_cuda or rows.dtype != torch.float32 or rows.dim() != 3 or rows.shape[0] != B \
            or rows.shape[2] != len(SCALAR_FIELDS) or not rows.is_contiguous():
        raise ValueError(f"need a contiguous f32 CPU table [{B}, R, 14] of scalar rows, got "
                         f"{tuple(rows.shape)} {rows.dtype} on {rows.device}")


def _case_prev(prev: Optional[RingPrev], c: int) -> Optional[RingPrev]:
    return None if prev is None else RingPrev(prev.rho[c], prev.u[c], prev.fresh)


def _alive_idx(alive):
    return [i for i, a in enumerate(alive) if a]


def _check_group(g: GroupParams, f_in, outs, dtype, prev, rho=None, u=None, f_post=None):
    """The group wrappers' checks: [B, 9, H, W] f buffers of ``dtype`` on
    the group's device, rho [B, H, W], u [B, 2, H, W], f_post [B, 9, H, W],
    and ``prev`` where a side is a no-op."""
    H, W = g.shape
    dev = g.device
    for name, t in (("f_in", f_in),) + tuple(outs):
        _check(name, t, (g.B, 9, H, W), dev, dtype)
    if rho is not None:
        _check("rho", rho, (g.B, H, W), dev)
        _check("u", u, (g.B, 2, H, W), dev)
        _check("f_post", f_post, (g.B, 9, H, W), dev)
    if _check_prev(g.bc_type, prev, rho, u):
        _check("prev.rho", prev.rho, (g.B, H, W), dev)
        _check("prev.u", prev.u, (g.B, 2, H, W), dev)
        return _ptr(prev.rho), _ptr(prev.u), int(bool(prev.fresh))
    return None, None, 0


def k1_group_steps_plain(f_in, f_a, f_b, g: GroupParams, rows, alive, n: int, dev=False,
                         prev=None):
    """Plain version of ``k1_group_steps``: ``k1_steps_plain`` on each alive
    case's slices, with its rows 0 .. n - 1. Returns the buffer holding f."""
    for c in _alive_idx(alive):
        k1_steps_plain(f_in[c], f_a[c], f_b[c], g.aux[c], rows[c, :n].contiguous(), g.use_les,
                       g.bc_type, g.obstacle, None if g.q is None else g.q[c],
                       None if g.prof is None else g.prof[c], dev, _case_prev(prev, c))
    return _ping_pong(f_in, f_a, f_b, n)


def k1_group_steps(f_in, f_a, f_b, g: GroupParams, rows, alive, n: int, dev=False, prev=None):
    """n fast K1 steps of a lockstep group in one call of the shared
    library, one launch a step over the alive cases (``alive``, host flags
    a case): step i takes column i of the host table ``rows`` [B, R, 14],
    reads f_in (step 0) or the previous step's output and writes f_a (even
    i) or f_b (odd i), each [B, 9, H, W]: f32, or with ``dev`` bf16
    deviations (equilibrium and full-way bounce-back); a dead case's slices
    are neither read nor written. ``prev`` the state's [B] rho and u where a
    side is a no-op, fresh (if so) for step 0. Returns the buffer holding f;
    counted as n launches of ``k1_variant(obstacle, dev=dev, group=True)``
    (none with no alive case), and n times the alive cases in
    ``CASE_STEPS``."""
    if not f_in.is_cuda:
        return k1_group_steps_plain(f_in, f_a, f_b, g, rows, alive, n, dev, prev)
    if dev:
        _check_obstacle(g.obstacle, None, g.shape, f_in.device, DEV_OBSTACLES)
    dtype = DEV_DTYPE if dev else torch.float32
    rp, up, fresh = _check_group(g, f_in, (("f_a", f_a), ("f_b", f_b)), dtype, prev)
    if f_a.data_ptr() in (f_b.data_ptr(), f_in.data_ptr()):
        raise ValueError("k1_group_steps: f_a must differ from f_in and f_b")
    if not 0 <= n <= rows.shape[1]:
        raise ValueError(f"k1_group_steps: {n} steps, the table holds {rows.shape[1]} rows")
    rows_d = g.device_rows(rows)
    slots, n_slots = g.slots(alive)
    H, W = g.shape
    lt, tt, rt, bt = g.bc_type
    failed = ctypes.c_int(-1)
    with _launch_device(f_in.device):
        rc = cuda_build.load("k1_group_steps")(
            _ptr(f_in), _ptr(f_a), _ptr(f_b), _ptr(g.aux),
            _ptr(g.q) if g.obstacle == OBSTACLE_BOUZIDI else None, _ptr(g.prof), _ptr(rows_d),
            n, rows.shape[1] * len(SCALAR_FIELDS), _ptr(slots), n_slots, H, W, lt, tt, rt, bt,
            int(g.use_les), int(bool(dev)), g.obstacle,
            torch.cuda.current_stream(f_in.device).cuda_stream, ctypes.addressof(failed), rp, up,
            fresh,
        )
    done = n if rc == 0 else max(failed.value, 0)
    name = k1_variant(g.obstacle, dev=bool(dev), group=True)
    if n_slots:
        LAUNCHES[name] += done
        CASE_STEPS[name] += done * n_slots
    if rc != 0:
        raise _loop_failed("k1_group_steps", rc, failed.value, n)
    return _ping_pong(f_in, f_a, f_b, n)


def k1_group_full_plain(f_in, f_out, g: GroupParams, rows, alive, rho, u, f_post, prev=None,
                        row: int = -1):
    """Plain version of ``k1_group_full``: ``k1_step_plain``'s full step on
    each alive case's slices with its row ``row``."""
    for c in _alive_idx(alive):
        k1_step_plain(f_in[c], f_out[c], g.aux[c], rows[c, row], g.use_les, g.bc_type, rho[c],
                      u[c], f_post[c], obstacle=g.obstacle,
                      q=None if g.q is None else g.q[c],
                      prof=None if g.prof is None else g.prof[c], prev=_case_prev(prev, c))


def k1_group_full(f_in, f_out, g: GroupParams, rows, alive, rho, u, f_post, prev=None,
                  row: int = -1):
    """The closing full step of a lockstep group's chunk, one launch over
    its alive cases: f32 f_in -> f_out [B, 9, H, W], writing their rho [B,
    H, W], u [B, 2, H, W] and f_post [B, 9, H, W] (the interior) slices,
    each case with column ``row`` of the host table ``rows`` [B, R, 14];
    ``prev`` as for ``k1_group_steps`` (not fresh on the buffers it writes).
    Counted as one launch of ``k1_variant(obstacle, full=True,
    group=True)`` (none with no alive case)."""
    if not f_in.is_cuda:
        return k1_group_full_plain(f_in, f_out, g, rows, alive, rho, u, f_post, prev, row)
    rp, up, fresh = _check_group(g, f_in, (("f_out", f_out),), torch.float32, prev, rho, u,
                                 f_post)
    if f_in.data_ptr() == f_out.data_ptr():
        raise ValueError("k1_group_full: pull streaming needs distinct in/out buffers")
    rows_d = g.device_rows(rows)
    R = rows.shape[1]
    row = row % R
    slots, n_slots = g.slots(alive)
    H, W = g.shape
    lt, tt, rt, bt = g.bc_type
    with _launch_device(f_in.device):
        rc = cuda_build.load("k1_group_full")(
            _ptr(f_in), _ptr(f_out), _ptr(g.aux),
            _ptr(g.q) if g.obstacle == OBSTACLE_BOUZIDI else None, _ptr(g.prof), _ptr(rho),
            _ptr(u), _ptr(f_post), _ptr(rows_d) + 4 * len(SCALAR_FIELDS) * row,
            R * len(SCALAR_FIELDS), _ptr(slots), n_slots, H, W, lt, tt, rt, bt, int(g.use_les),
            g.obstacle, torch.cuda.current_stream(f_in.device).cuda_stream, rp, up, fresh,
        )
    if rc != 0:
        raise RuntimeError(f"k1_group_full launch failed: CUDA error {rc}")
    name = k1_variant(g.obstacle, full=True, group=True)
    if n_slots:
        LAUNCHES[name] += 1
        CASE_STEPS[name] += n_slots


def _link_terms(f_post_c, q_c, links: torch.Tensor, pitch: int, bouzidi: bool):
    """(term f32, j) of each boundary link of one item, the monitor
    kernel's ``mon_term`` in the eager force's operation order; ``links``
    index the item's f_post planes [9, rows, pitch] (q's [8, rows, pitch])."""
    fp = f_post_c.reshape(9, -1)
    cell = (links >> LINK_CELL_SHIFT).long()
    j = (links & 15).long()
    fj = fp[j, cell]
    if not bouzidi:
        return 2.0 * fj, j
    ex = torch.as_tensor(E_LAT[:, 0], device=fp.device)[j]
    ey = torch.as_tensor(E_LAT[:, 1], device=fp.device)[j]
    up_ok = (links & _LINK_UP) != 0
    up_cell = torch.where(up_ok, cell - (ey * pitch + ex), cell)
    up = torch.where(up_ok, fp[j, up_cell], torch.zeros_like(fj))
    qv = q_c.reshape(8, -1)[j - 1, cell]
    fk = fp[torch.as_tensor(OPP_LAT, device=fp.device)[j], cell]
    two_q = 2.0 * qv
    lo = two_q * fj + (1.0 - two_q) * up
    hi = fj / two_q + (two_q - 1.0) / two_q * fk
    return fj + torch.where(qv < 0.5, lo, hi), j


def _tree(acc: torch.Tensor) -> torch.Tensor:
    """The kernel's warp tree over the last axis (32 lanes): lane i adds
    lane i + h, h = 16 .. 1; lane 0's sum."""
    h = 16
    while h:
        acc = acc[..., :h] + acc[..., h:2 * h]
        h //= 2
    return acc[..., 0]


def monitor_sum_plain(terms: torch.Tensor) -> torch.Tensor:
    """The monitor kernel's order over one item's link terms (f64 [L]) ->
    f64 0-d: lane g of MON_LINK_LANES adds terms g + k MON_LINK_LANES in k
    order from +0.0; each warp of 32 lanes adds them by ``_tree``; the
    warps' partials, lane i taking partials i, i + 32, ... in order from
    +0.0, by ``_tree`` again. No links: +0.0."""
    n = MON_LINK_LANES
    L = terms.numel()
    if L == 0:
        return torch.zeros((), dtype=torch.float64, device=terms.device)
    K = -(-L // n)
    padded = torch.zeros(K * n, dtype=torch.float64, device=terms.device)
    padded[:L] = terms
    padded = padded.view(K, n)
    acc = torch.zeros(n, dtype=torch.float64, device=terms.device)
    for k in range(K):
        acc = acc + padded[k]
    part = _tree(acc.view(MON_LINK_WARPS, 32)).view(MON_LINK_WARPS // 32, 32)
    lanes = torch.zeros(32, dtype=torch.float64, device=terms.device)
    for k in range(MON_LINK_WARPS // 32):
        lanes = lanes + part[k]
    return _tree(lanes)


def item_force_plain(f_post_c, q_c, links: torch.Tensor, pitch: int, bouzidi: bool):
    """One item's force as the kernel sums it: f64 [2] (Fx, Fy)."""
    term, j = _link_terms(f_post_c, q_c, links, pitch, bouzidi)
    t64 = term.double()
    e = torch.as_tensor(E_LAT, dtype=torch.float64, device=term.device)
    return torch.stack([monitor_sum_plain(t64 * e[j, 0]), monitor_sum_plain(t64 * e[j, 1])])


def speed_max_plain(u: torch.Tensor) -> torch.Tensor:
    """max |u| over the cells of u [2, ...] (``solver.max_velocity``; NaN
    kept), the kernel's max bit for bit."""
    return torch.sqrt(u[0] * u[0] + u[1] * u[1]).amax()


def monitor_item(f_post=None, q=None, u=None, pitch: int = 0, plane: int = 0,
                 region=None) -> list:
    """An item row of the monitor kernel (``MonItem``, 10 int64 words):
    f_post / q planes of ``plane`` floats whose rows are ``pitch`` apart,
    and u's region ``region`` = (u plane floats, rows, row stride, first
    column, columns) from ``u``'s first pointer. A missing tensor is 0."""
    uplane, urows, ustride, ucol0, ucols = region or (0, 0, 0, 0, 0)
    return [_ptr(f_post) or 0, _ptr(q) or 0, _ptr(u) or 0, plane, uplane, pitch, urows,
            ustride, ucol0, ucols]


def whole_item(f_post, q, u, H: int, W: int) -> list:
    """The item of a whole [H, W] grid: u read as one row of H W cells."""
    HW = H * W
    return monitor_item(f_post, q, u, W, HW, None if u is None else (HW, 1, HW, 0, HW))


def launch_monitors(ml: MonitorLinks, base: list, strides=(0, 0, 0), table=None,
                    bouzidi: bool = False, cells: int = 0, packed=None, alive_out=None,
                    case_table=None, total=None) -> torch.Tensor:
    """One launch of the monitor kernel over ``ml``'s items on the current
    stream: item c is ``table[c]`` (a device int64 [I, 10] of
    ``monitor_item`` rows) or, without one, ``base`` shifted by c times
    ``strides`` (f_post, q, u; in floats). Writes ``packed`` [4 I] and
    ``alive_out`` [I] where given (``case_table`` the group's [alive I |
    later I]) and ``total`` [3] (the items' sum in item order and their
    max); returns ``part`` f64 [I, 3] (each item's Fx, Fy and max_v).
    ``cells``: an item's u cells (the grid's size). Raises if the launch
    fails; no sync. Counted as one launch of ``monitor_variant`` and its
    I items in ``CASE_STEPS``."""
    I = ml.I
    if total is not None and I > MON_MAX_TOTAL_ITEMS:
        raise ValueError(f"a monitor total takes {MON_MAX_TOTAL_ITEMS} items, got {I}")
    part = torch.empty((I, 3), dtype=torch.float64, device=ml.device)
    host = (ctypes.c_longlong * 13)(*(list(base) + list(strides)))
    nb = monitor_blocks(cells, I, ml.device)
    with _launch_device(ml.device):
        rc = cuda_build.load("monitors")(
            host, _ptr(table), _ptr(ml.links), _ptr(ml.offsets), _ptr(case_table),
            _ptr(ml.partial), _ptr(ml.slots), _ptr(part), _ptr(packed), _ptr(alive_out),
            _ptr(total), I, nb, int(bool(bouzidi)),
            torch.cuda.current_stream(ml.device).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"monitor kernel launch failed: CUDA error {rc}")
    name = monitor_variant(OBSTACLE_BOUZIDI if bouzidi else OBSTACLE_EQ)
    LAUNCHES[name] += 1
    CASE_STEPS[name] += I
    return part


def group_monitors_plain(f_post, u, g: GroupParams, alive, later):
    """Plain version of ``group_monitors``, in the kernel's summation
    order, so bit for bit its output: (packed [Fx, Fy a case | max_v |
    stable] f32 [4 B], alive & stable bool [B])."""
    B = g.B
    H, W = g.shape
    dev = f_post.device
    bouzidi = g.obstacle == OBSTACLE_BOUZIDI
    force = torch.stack([
        item_force_plain(f_post[c], None if g.q is None else g.q[c],
                         g.mon.item_links(c).to(dev), W, bouzidi)
        for c in range(B)]).float()
    max_v = torch.sqrt(u[:, 0] * u[:, 0] + u[:, 1] * u[:, 1]).reshape(B, -1).amax(dim=1)
    # torch's max propagates NaN (amax does too); is_stable_device's rules
    later_t = torch.tensor([bool(x) for x in later], device=dev)
    f_ok = torch.isfinite(force).all(dim=1) & (force.abs() <= 1e6).all(dim=1)
    v_ok = torch.isfinite(max_v) & (~later_t | (max_v <= 0.25))
    stable = f_ok & v_ok
    packed = torch.cat([force.reshape(-1), max_v, stable.float()])
    return packed, stable & torch.tensor([bool(a) for a in alive], device=dev)


def group_monitors(f_post, u, g: GroupParams, alive, later):
    """The monitors of every case of a lockstep group in one launch
    (csrc/monitors.cu): its momentum-exchange force (the scheme's
    ``obstacle_force``, over its boundary links, summed in f64 in a fixed
    order), ``max_velocity`` (NaN kept) and ``is_stable_device`` (``later``:
    host flags, past the warmup), from f_post [B, 9, H, W] and u [B, 2, H,
    W]; a dead case's from the state it keeps. Returns (packed [Fx, Fy a
    case | max_v | stable] f32 [4 B], alive & stable bool [B]) on the
    device. Counted as one launch of ``monitor_variant(obstacle)``."""
    if not f_post.is_cuda:
        return group_monitors_plain(f_post, u, g, alive, later)
    H, W = g.shape
    _check("f_post", f_post, (g.B, 9, H, W), g.device)
    _check("u", u, (g.B, 2, H, W), g.device)
    table = g.case_table(alive, later)
    out = torch.empty(4 * g.B, dtype=torch.float32, device=g.device)
    alive_out = torch.empty(g.B, dtype=torch.bool, device=g.device)
    bouzidi = g.obstacle == OBSTACLE_BOUZIDI
    q = g.q if bouzidi else None
    plane = H * W
    launch_monitors(g.mon, whole_item(f_post, q, u, H, W), (9 * plane, 8 * plane, 2 * plane),
                    bouzidi=bouzidi, cells=plane, packed=out, alive_out=alive_out,
                    case_table=table)
    return out, alive_out


def case_monitors_plain(f_post, u, cl: CaseLinks):
    """Plain version of ``case_monitors``: {"force": [2], "max_v": 0-d} of
    f_post's dtype, the kernel's bits."""
    H, W = cl.shape
    force = item_force_plain(f_post, cl.q, cl.mon.item_links(0).to(f_post.device), W,
                             cl.bouzidi)
    return {"force": force.to(f_post.dtype), "max_v": speed_max_plain(u)}


def _case_launch(f_post, u, cl: CaseLinks) -> torch.Tensor:
    """The packed monitors [Fx, Fy, max_v, stable] of one case (a group of
    one) in one launch; without ``u`` the force alone (max_v 0)."""
    H, W = cl.shape
    dev = cl.mon.device
    _check("f_post", f_post, (9, H, W), dev)
    if u is not None:
        _check("u", u, (2, H, W), dev)
    if cl.bouzidi:
        _check("q", cl.q, (8, H, W), dev)
    packed = torch.empty(4, dtype=torch.float32, device=dev)
    alive_out = torch.empty(1, dtype=torch.bool, device=dev)
    launch_monitors(cl.mon, whole_item(f_post, cl.q, u, H, W), bouzidi=cl.bouzidi,
                    cells=0 if u is None else H * W, packed=packed, alive_out=alive_out)
    return packed


def case_monitors(f_post, u, cl: CaseLinks):
    """A serial chunk's monitors in one launch of the monitor kernel, its
    case a group of one: {"force": f32 [2] (the scheme's
    ``obstacle_force`` over ``cl``'s links, summed in f64 in the kernel's
    order), "max_v": f32 0-d (``max_velocity``, NaN kept)}, views of one
    device array, from f_post [9, H, W] and u [2, H, W]. Counted as one
    launch of ``monitor_variant``. CPU tensors take
    ``case_monitors_plain``."""
    if not f_post.is_cuda:
        return case_monitors_plain(f_post, u, cl)
    packed = _case_launch(f_post, u, cl)
    return {"force": packed[:2], "max_v": packed[2]}


def case_force_plain(f_post, cl: CaseLinks) -> torch.Tensor:
    """Plain version of ``case_force``."""
    H, W = cl.shape
    return item_force_plain(f_post, cl.q, cl.mon.item_links(0).to(f_post.device), W,
                            cl.bouzidi).to(f_post.dtype)


def case_force(f_post, cl: CaseLinks) -> torch.Tensor:
    """The force over ``cl``'s links alone (f32 [2] on the device) in one
    launch of the monitor kernel, no u read: the DFG path's cylinder-only
    force (``CaseLinks(p, mask=...)``, the eager ``obstacle_force(f_post,
    p, mask=...)``). CPU tensors take ``case_force_plain``."""
    if not f_post.is_cuda:
        return case_force_plain(f_post, cl)
    return _case_launch(f_post, None, cl)[:2]


def run_chunk_group_cuda(state_b: LBMState, p_b: GroupParams, alive, n_steps: int,
                         store_dev: bool = False):
    """Advance a lockstep group's alive cases ``n_steps`` through the kernels,
    as one program: the counterpart of the JAX ``run_chunk_batched`` /
    ``_chunk_sequential`` (lbm2d_tpu/parallel/batch.py:77-176). ``state_b``
    is the group's stacked state ([B, 9, H, W] f and f_post, [B, H, W] rho,
    [B, 2, H, W] u, a CPU int [B] step), ``p_b`` its ``GroupParams``,
    ``alive`` host flags a case. Returns ``(state_b, alive, packed)``: the
    state (f, f_post, rho and u updated in place, a dead case's bits and step
    untouched), alive & stable (bool [B] on the device), and the monitors
    packed as [Fx, Fy a case | max_v | stable] (f32 [4 B] on the device)
    for every case, a dead one's of the state it keeps.

    A chunk is at most three library calls and two torch ops whatever B
    is: the n - 1 fast steps (``k1_group_steps``, one K1 launch a step over
    the alive cases), the closing full step (``k1_group_full``), the
    monitors (``group_monitors``), and with ``store_dev`` (n > 1, the
    schemes it runs) a quantize before and a dequantize after the fast
    steps, once for the group. The scalar rows are one host table [B, n,
    14] uploaded only when it changes. Never fused: a group with temporal
    blocking requested runs its cases through ``run_chunk_cuda`` instead
    (parallel/batch.py)."""
    return _run_chunk_group(state_b, p_b, alive, n_steps, store_dev, plain=False)


def run_chunk_group_plain(state_b: LBMState, p_b: GroupParams, alive, n_steps: int,
                          store_dev: bool = False):
    """``run_chunk_group_cuda`` through the kernels' plain versions on any
    device: the plain version of the group program."""
    return _run_chunk_group(state_b, p_b, alive, n_steps, store_dev, plain=True)


def _run_chunk_group(state_b: LBMState, g: GroupParams, alive, n_steps: int, store_dev: bool,
                     plain: bool):
    if n_steps < 1:
        raise ValueError(f"n_steps must be >= 1, got {n_steps}")
    if plain:
        k1s, k1f, mon = k1_group_steps_plain, k1_group_full_plain, group_monitors_plain
    else:
        k1s, k1f, mon = k1_group_steps, k1_group_full, group_monitors
    alive = [bool(a) for a in alive]
    steps = [int(s) for s in state_b.step]
    dev_store = bool(store_dev) and n_steps > 1 and dev_storage_refusal(g.cases[0]) is None
    rows = g.rows(steps, n_steps)
    prev = RingPrev(state_b.rho, state_b.u) if noop_sides(g.bc_type) else None
    f = state_b.f
    if n_steps > 1:
        # quantize once per chunk; the fast steps ping-pong two buffers and
        # the full step writes the state's f in place, so a dead case's
        # slices are never written
        src = quantize(f) if dev_store else f
        src = k1s(src, torch.empty_like(src), torch.empty_like(src), g, rows, alive,
                  n_steps - 1, dev_store, prev)
        if dev_store:
            src = dequantize(src)
        dst = f
    else:
        src, dst = f, torch.empty_like(f)
        if prev is not None:  # the full step writes the rho and u it would read
            prev = RingPrev(prev.rho.clone(), prev.u.clone())
    k1f(src, dst, g, rows, alive, state_b.rho, state_b.u, state_b.f_post,
        prev_at_step(prev, n_steps - 1))
    if dst is not f:
        dead = [c for c, a in enumerate(alive) if not a]
        if dead:
            idx = torch.tensor(dead, device=f.device)
            dst.index_copy_(0, idx, f.index_select(0, idx))
    new_steps = [s + n_steps if a else s for s, a in zip(steps, alive)]
    packed, alive_out = mon(state_b.f_post, state_b.u, g, alive, g.later(new_steps))
    state = LBMState(f=dst, f_post=state_b.f_post, rho=state_b.rho, u=state_b.u,
                     step=torch.tensor(new_steps, dtype=torch.int32))
    return state, alive_out, packed
