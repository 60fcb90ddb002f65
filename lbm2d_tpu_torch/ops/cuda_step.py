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
Bouzidi bounce-back) picks a compiled variant.

With 16-bit deviation storage (``store_dev``, the JAX package's
``run_chunk_pallas(store_dev=True)``) a chunk's fast steps run
``k1_step_dev`` on bf16 buffers of f - w: the state is quantized once at
the start of the chunk and dequantized for the f32 full step that closes
it. Lossy by design (one bf16 rounding of each deviation per step),
opt-in, only for chunks of more than one step, and, as in the JAX package,
not for half-way or Bouzidi bounce-back (``dev_storage_refusal``).

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
block lies on the global edge; they count as the ``_shard`` variants.

Each wrapper launches its kernel for CUDA tensors (or raises) and takes its
plain PyTorch version (``k1_step_plain``, ``k1_step_dev_plain`` and
``k3_fused_plain``, each with the same arguments) only for CPU tensors.
``LAUNCHES`` counts kernel launches by variant (``k1_variant`` /
``k3_variant`` names), so a run can show that it went through the kernels.
The monitors are plain torch reductions, as the JAX package computes them
outside its kernels.
"""

from __future__ import annotations

import contextlib
import ctypes
import functools
from dataclasses import astuple, dataclass
from typing import Optional, Tuple

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
    max_velocity,
    mrt_collide_arrays,
    obstacle_force,
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
               shard: bool = False) -> str:
    """Launch-count name of a K1 variant: k1_step[_bounce|_halfway|_bouzidi]
    [_shard][_full|_dev]."""
    return ("k1_step" + _OBSTACLE_SUFFIX[obstacle] + ("_shard" if shard else "")
            + ("_full" if full else "_dev" if dev else ""))


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
)

# launches of each kernel variant, added to where the launch is made
LAUNCHES = {name: 0 for name in KERNEL_VARIANTS}


def reset_launch_counts() -> None:
    for k in LAUNCHES:
        LAUNCHES[k] = 0


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


def unsupported(p: CaseParams) -> Optional[str]:
    """Why the kernels cannot run case ``p``, or None when they can (a
    spatial mesh's own rule is ``parallel/topology.mesh_refusal``)."""
    lt, tt, rt, bt = p.bc_type
    if lt in (BC_VEL_INLET, BC_VEL_INLET_NEBB) and p.inlet_profile is None:
        return f"left bc_type {lt} without CaseParams.inlet_profile"
    sides_ok = (
        lt in (BC_INLET, BC_FREE_SLIP, BC_VEL_INLET, BC_VEL_INLET_NEBB)
        and rt in (BC_INLET, BC_OUTLET, BC_FREE_SLIP)
        and tt in (BC_INLET, BC_FREE_SLIP)
        and bt in (BC_INLET, BC_FREE_SLIP)
    )
    if not sides_ok:
        return f"bc_type {p.bc_type}: every side must be active (no port planned)"
    if p.bouzidi_obstacle and p.bouzidi_q is None:
        return "Bouzidi bounce-back without its q planes (CaseParams.bouzidi_q)"
    if p.dtype != torch.float32:
        return f"dtype {p.dtype}: the kernels are f32 only"
    h, w = p.shape
    if min(h, w) < 3:
        return f"grid {h}x{w} is smaller than 3x3"
    return None


def supports(p: CaseParams) -> bool:
    """True if K1 implements case ``p`` (the JAX ``pallas_step.supports``
    layouts): left BC in {0, 2, 3, 4} (3/4 with the inlet profile), right in
    {0, 1, 2}, top/bottom in {0, 2}, any obstacle scheme (Bouzidi with its q
    planes), f32, LES on or off."""
    return unsupported(p) is None


def dev_storage_refusal(p: CaseParams, sharded: bool = False) -> Optional[str]:
    """Why 16-bit deviation storage does not engage for case ``p``, or None.
    The JAX package's ``run_chunk_pallas`` rules: half-way and Bouzidi
    bounce-back read the cell's own previous populations on their links
    and run exact f32, and while temporal blocking is requested the state
    stays f32. The sharded runner (``sharded``) never fuses, so only the
    first rule holds there (``run_chunk_sharded_pallas``)."""
    if obstacle_scheme(p) not in DEV_OBSTACLES:
        return "half-way and Bouzidi bounce-back run exact f32 (the JAX run_chunk_pallas rule)"
    if fuse_requested() and not sharded:
        return (f"temporal blocking is requested (cuda_step._FUSE_STEPS = {_FUSE_STEPS}): "
                "the state stays f32 (the JAX run_chunk_pallas rule)")
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
    requested, or None: the JAX package's rule, Bouzidi bounce-back is
    never fused."""
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


def _host_scalars(p: CaseParams):
    """(scalar row without the ramp, warmup) on the host: one device read
    per chunk, none per step."""
    row = torch.cat(
        [
            torch.stack([p.tau0, p.cs_factor, p.s_ghost, p.tau0, p.rho_in, p.rho_out]),
            p.bc_value.reshape(-1),
        ]
    ).cpu()
    return row, float(p.warmup_steps)


def _with_ramp(row: torch.Tensor, warmup: float, step: int) -> torch.Tensor:
    row = row.clone()
    row[_S_RAMP] = warmup_ramp(step, warmup, row.dtype)
    return row


def scalar_row(p: CaseParams, step: int) -> torch.Tensor:
    """The scalar row of lattice step ``step`` as a CPU tensor [14] of the
    case dtype (counterpart of ``pallas_step._scalars``)."""
    row, warmup = _host_scalars(p)
    return _with_ramp(row, warmup, step)


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
    """The lattice weights as f32, shaped to broadcast over f's first axis."""
    w = torch.as_tensor(W_LAT, dtype=torch.float32, device=f.device)
    return w.reshape((9,) + (1,) * (f.dim() - 1))


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


def _ring_plain(f, aux, cell, box, scal, bc_type, rho, u, to_store, prof, bounce,
                g: BlockGeom):
    """The global ring cells that block ``g`` holds, of ``f`` (and of rho/u
    when given), in apply_bc order, from ``cell`` [12, ni, nj]: the collide
    output (f_post before the obstacle overwrite, rho, ux, uy) of the
    block's globally interior cells ``box`` = (i0, i1, j0, j1), the values
    the kernel's ring threads compute for a ring cell's inward neighbour.
    ``prof`` is the block's rows of the inlet profile and ``to_store`` maps
    the f32 ring values [9, n] to f's storage."""
    i0, i1, j0, j1 = box
    ctype = cell.dtype
    s = scal.to(device=f.device, dtype=ctype)
    ramp = float(scal[_S_RAMP])
    bcv = s[6:].view(4, 2)
    hl, wl, h = g.hl, g.wl, g.halo
    lt, tt, rt, bt = bc_type
    # the side columns on the block's inner rows i0..i1, from global column
    # 1 / Wg-2 (the first / last column of the box on such a block)
    left, right = g.x_off == 0, g.x_off + wl == g.Wg
    vl = vr = None
    if left:
        vl = bc_left_values(cell[:9, :, 0], cell[9, :, 0], cell[10, :, 0], cell[11, :, 0],
                            ramp, lt, s[4], u_prof=None if prof is None else prof[i0:i1 + 1])
    if right:
        vr = bc_right_values(cell[:9, :, -1], cell[9, :, -1], cell[10, :, -1], cell[11, :, -1],
                             ramp, rt, s[5], bcv[2])
    writes = []
    if left:
        writes.append(((slice(i0 + h, i1 + h + 1), h), vl))
    if right:
        writes.append(((slice(i0 + h, i1 + h + 1), wl - 1 + h), vr))
    # rows from global row 1 / Hg-2 (the first / last row of the box), the
    # corner-adjacent neighbours taken from the side BCs
    for side, t, r_box, y, y_nb, on in ((1, tt, -1, hl - 1, hl - 2, g.y_off + hl == g.Hg),
                                        (3, bt, 0, 0, 1, g.y_off == 0)):
        if not on:
            continue
        nb = torch.zeros((12, wl), dtype=ctype, device=f.device)
        nb[:, j0:j1 + 1] = cell[:, r_box]
        for x, vals in ((0, vl), (wl - 1, vr)):
            if vals is not None:
                nb[:9, x] = vals[0][:, y_nb - i0]
                nb[9, x] = vals[1][y_nb - i0]
                nb[10, x] = vals[2][y_nb - i0]
                nb[11, x] = vals[3][y_nb - i0]
        vals = bc_horizontal_values(nb[:9], nb[9], nb[10], nb[11], ramp, t, bcv[side])
        writes.append(((y + h, slice(h, wl + h)), vals))
    w9 = torch.as_tensor(W_LAT, dtype=ctype, device=f.device).reshape(9, 1)
    solid, _ = unpack_aux(aux)
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


def _k1_plain(f_in, f_out, aux, scal, use_les, bc_type, rho, u, f_post, obstacle, q, prof,
              g: BlockGeom, to_store):
    """K1's plain version on block ``g``: the interior update, then the ring
    from the interior's collide output; ``to_store`` maps f32 populations to
    f_out's storage."""
    if obstacle == OBSTACLE_BOUZIDI and q is None:
        raise ValueError("Bouzidi bounce-back needs the q planes")
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
    _ring_plain(f_out, aux, cell, box, scal, bc_type, rho, u, to_store, prof,
                obstacle == OBSTACLE_BOUNCE, g)


def k1_step_plain(f_in, f_out, aux, scal, use_les, bc_type, rho=None, u=None, f_post=None,
                  obstacle=OBSTACLE_EQ, q=None, prof=None, geom=None):
    """Plain PyTorch version of K1 on block ``geom`` (the whole grid by
    default), writing the same cells of the same buffers: the cells
    interior in the global grid of f_out (and of rho/u/f_post when given),
    then the global ring cells the block holds (f_out, and rho/u when
    given) from the interior's collide output, the values the kernel's
    ring threads compute for themselves. Every read goes through the
    block's own cells and halo; the link predicate of half-way and Bouzidi
    bounce-back is the solid flag of ``aux`` at the pull source, as in the
    kernel."""
    _k1_plain(f_in, f_out, aux, scal, use_les, bc_type, rho, u, f_post, obstacle, q, prof,
              _geom(geom, f_in), lambda v: v)


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
            obstacle=OBSTACLE_EQ, q=None, prof=None, geom=None):
    """K1 on ``f_in`` -> ``f_out``: one lattice step, one launch. Distinct
    [9, H, W] buffers, or with ``geom`` the [9, hl + 2, pitch] blocks of one
    shard of a spatial mesh, halos filled, of which the cells interior in
    the global grid are updated and the global ring cells held are written
    from ``bc_type`` (left, top, right, bottom). The full variant runs when
    ``rho``, ``u`` [2, ...] and ``f_post`` [9, ...] are given; aux, q and
    those share f's geometry. ``scal`` is the CPU scalar row of this step;
    ``obstacle`` an ``OBSTACLE_*`` scheme, Bouzidi with ``q`` [8, ...];
    ``prof`` [hl] the block's rows of the inlet profile of left types 3/4.
    Counted as ``k1_variant(obstacle, full, shard=geom.halo > 0)``."""
    if not f_in.is_cuda:
        return k1_step_plain(f_in, f_out, aux, scal, use_les, bc_type, rho, u, f_post,
                             obstacle, q, prof, geom)
    g = _geom(geom, f_in)
    full = rho is not None
    dev = f_in.device
    _check_k1(f_in, f_out, aux, g, torch.float32, obstacle, q, rho, u, f_post)
    prof_ptr = _prof_ptr(bc_type, prof, g.hl, dev)
    sc = _scal_c(scal)
    q_ptr = _ptr(q) if obstacle == OBSTACLE_BOUZIDI else None
    lt, tt, rt, bt = (int(t) for t in bc_type)
    with _launch_device(dev):
        rc = cuda_build.load("k1_step")(
            _ptr(f_in), _ptr(f_out), _ptr(aux), q_ptr, prof_ptr, _ptr(rho), _ptr(u),
            _ptr(f_post), ctypes.addressof(sc), ctypes.addressof(g.c_row), lt, tt, rt, bt,
            int(bool(use_les)), int(full), obstacle, torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"k1_step launch failed: CUDA error {rc}")
    LAUNCHES[k1_variant(obstacle, full, shard=g.halo > 0)] += 1


def k1_step_dev_plain(f_in, f_out, aux, scal, use_les, bc_type, obstacle=OBSTACLE_EQ,
                      prof=None, geom=None):
    """Plain PyTorch version of K1's deviation-storage fast step: dequantize
    f_in, step in f32 as ``k1_step_plain``, ring included, and quantize each
    written cell of f_out."""
    g = _geom(geom, f_in)
    _check_obstacle(obstacle, None, g.plane, f_in.device, DEV_OBSTACLES)
    _k1_plain(dequantize(f_in), f_out, aux, scal, use_les, bc_type, None, None, None,
              obstacle, None, prof, g, quantize)


def k1_step_dev(f_in, f_out, aux, scal, use_les, bc_type, obstacle=OBSTACLE_EQ, prof=None,
                geom=None):
    """K1's fast step on bf16 deviation buffers ``f_in`` -> ``f_out``
    ([9, H, W], distinct, or one shard's blocks of ``geom``, halos
    included), ring included. Equilibrium and full-way bounce-back only."""
    if not f_in.is_cuda:
        return k1_step_dev_plain(f_in, f_out, aux, scal, use_les, bc_type, obstacle, prof,
                                 geom)
    g = _geom(geom, f_in)
    dev = f_in.device
    _check_k1(f_in, f_out, aux, g, DEV_DTYPE, obstacle, None, None, None, None,
              DEV_OBSTACLES)
    prof_ptr = _prof_ptr(bc_type, prof, g.hl, dev)
    sc = _scal_c(scal)
    lt, tt, rt, bt = (int(t) for t in bc_type)
    with _launch_device(dev):
        rc = cuda_build.load("k1_step_dev")(
            _ptr(f_in), _ptr(f_out), _ptr(aux), prof_ptr, ctypes.addressof(sc),
            ctypes.addressof(g.c_row), lt, tt, rt, bt, int(bool(use_les)), obstacle,
            torch.cuda.current_stream(dev).cuda_stream,
        )
    if rc != 0:
        raise RuntimeError(f"k1_step_dev launch failed: CUDA error {rc}")
    LAUNCHES[k1_variant(obstacle, dev=True, shard=g.halo > 0)] += 1


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


# ---------------------------------------------------------------------------
# Chunk runner
# ---------------------------------------------------------------------------


def run_chunk_cuda(state: LBMState, p: CaseParams, n_steps: int, store_dev: bool = False):
    """Advance ``n_steps`` through K1, one launch a step; same contract as
    ``solver.run_chunk``: ``(state, {"force": [2], "max_v": 0-d})``.

    Steps 1..n-1 run K1's fast variant, the last step its full variant.
    f_post keeps its ring and takes the last step's interior. The input
    state is not modified. ``store_dev`` runs steps 1..n-1 in 16-bit
    deviation storage when n > 1 and the obstacle scheme allows it (the JAX
    package's run_chunk_pallas engages it under the same conditions).
    While temporal blocking is requested (``_FUSE_STEPS`` = S > 1) and the
    case allows it, steps 1..n-1 run as ``divmod(n - 1, S)`` = (k, r): k
    passes of K3, then r single K1 steps, as the JAX package's
    run_chunk_pallas does.
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
        k1, k1d, k3 = k1_step_plain, k1_step_dev_plain, k3_fused_plain
    else:
        k1, k1d, k3 = k1_step, k1_step_dev, k3_fused
    dev_store = bool(store_dev) and n_steps > 1 and dev_storage_refusal(p) is None
    fuse = fuse_steps(p, n_steps)
    obst = obstacle_scheme(p)
    q = p.bouzidi_q if obst == OBSTACLE_BOUZIDI else None
    prof = p.inlet_profile if p.bc_type[0] in (BC_VEL_INLET, BC_VEL_INLET_NEBB) else None
    H, W = p.shape
    dev = state.f.device
    aux = pack_aux(p.damping, p.mask)
    row, warmup = _host_scalars(p)
    # quantize once per chunk; the fast steps ping-pong two buffers
    src = quantize(state.f) if dev_store else state.f
    bufs = (torch.empty_like(src), torch.empty_like(src))

    def other(t):
        return bufs[1] if t is bufs[0] else bufs[0]

    step = state.step
    n_single = n_steps - 1
    if fuse:
        passes, n_single = divmod(n_steps - 1, fuse)
        tile = k3_tile(fuse)
        for _ in range(passes):
            rows = torch.stack([_with_ramp(row, warmup, step + 1 + i) for i in range(fuse)])
            dst = other(src)
            k3(src, dst, aux, rows, p.bc_type, p.use_les, obst, prof, tile)
            src = dst
            step += fuse
    for _ in range(n_single):
        step += 1
        scal = _with_ramp(row, warmup, step)
        dst = other(src)
        if dev_store:
            k1d(src, dst, aux, scal, p.use_les, p.bc_type, obst, prof)
        else:
            k1(src, dst, aux, scal, p.use_les, p.bc_type, obstacle=obst, q=q, prof=prof)
        src = dst
    if dev_store:
        # the closing full step runs in exact f32
        src = dequantize(src)
        dst = torch.empty_like(src)
    else:
        dst = other(src)
    scal = _with_ramp(row, warmup, step + 1)
    rho = torch.empty((H, W), dtype=state.f.dtype, device=dev)
    u = torch.empty((2, H, W), dtype=state.f.dtype, device=dev)
    f_post = state.f_post.clone()
    k1(src, dst, aux, scal, p.use_les, p.bc_type, rho, u, f_post, obstacle=obst, q=q,
       prof=prof)
    new_state = LBMState(f=dst, f_post=f_post, rho=rho, u=u, step=state.step + n_steps)
    monitors = {
        "force": obstacle_force(new_state.f_post, p),
        "max_v": max_velocity(new_state.u),
    }
    return new_state, monitors
