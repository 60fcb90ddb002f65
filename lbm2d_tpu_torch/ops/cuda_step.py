"""Chunk runner on the hand-written CUDA kernels (counterpart of
``lbm2d_tpu/ops/pallas_step.py``).

Each step is two launches on the current stream:

* K1 ``k1_step`` (csrc/k1_step.cu, replaces ``_step_kernel``): stream,
  collide and write the interior of the next f buffer, plus the edge
  export K2 reads; its full variant, on a chunk's last step, also writes
  rho, u and f_post. The obstacle scheme (``OBSTACLE_*``: equilibrium,
  full-way, half-way or Bouzidi bounce-back) picks a compiled variant.
* K2 ``k2_edge_bc`` (csrc/k2_edge_bc.cu, replaces ``_edge_bc_kernel``):
  rebuild the boundary ring in ``apply_bc`` order, the profiled velocity
  inlets (left types 3/4) from the case's ``inlet_profile``.

With 16-bit deviation storage (``store_dev``, the JAX package's
``run_chunk_pallas(store_dev=True)``) a chunk's fast steps run
``k1_step_dev`` + ``k2_edge_bc_dev`` on bf16 buffers of f - w: the state
is quantized once at the start of the chunk and dequantized for the f32
full step that closes it. Lossy by design (one bf16 rounding of each
deviation per step), opt-in, only for chunks of more than one step, and,
as in the JAX package, not for half-way or Bouzidi bounce-back
(``dev_storage_refusal``).

Each wrapper launches its kernel for CUDA tensors (or raises) and takes its
plain PyTorch version (``k1_step_plain`` / ``k2_edge_bc_plain`` and the
``_dev`` pair) only for CPU tensors. ``LAUNCHES`` counts kernel launches by
variant (``k1_variant`` / ``k2_variant`` names), so a run can show that
it went through the kernels. The monitors
are plain torch reductions, as the JAX package computes them outside its
kernels.
"""

from __future__ import annotations

import ctypes
from typing import Optional

import torch

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
    link_bounce,
    max_velocity,
    mrt_collide_arrays,
    obstacle_force,
    pull_stream,
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

EDGE_C = 12  # f_post[0..8], rho, ux, uy per exported strip cell

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


def k1_variant(obstacle: int, full: bool = False, dev: bool = False) -> str:
    """Launch-count name of a K1 variant: k1_step[_bounce|_halfway|_bouzidi]
    [_full|_dev]."""
    return "k1_step" + _OBSTACLE_SUFFIX[obstacle] + ("_full" if full else "_dev" if dev else "")


def k2_variant(left_type: int, dev: bool = False) -> str:
    """Launch-count name of a K2 variant: k2_edge_bc[_vel][_dev], ``_vel``
    for the profiled velocity inlets (left types 3/4)."""
    vel = left_type in (BC_VEL_INLET, BC_VEL_INLET_NEBB)
    return "k2_edge_bc" + ("_vel" if vel else "") + ("_dev" if dev else "")


KERNEL_VARIANTS = (
    [k1_variant(o, full) for o in range(4) for full in (False, True)]
    + [k1_variant(o, dev=True) for o in DEV_OBSTACLES]
    + [k2_variant(t, dev) for t in (BC_INLET, BC_VEL_INLET) for dev in (False, True)]
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


def unsupported(p: CaseParams) -> Optional[str]:
    """Why the kernels cannot run case ``p``, or None when they can."""
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
    """True if K1 + K2 implement case ``p`` (the JAX ``pallas_step.supports``
    layouts): left BC in {0, 2, 3, 4} (3/4 with the inlet profile), right in
    {0, 1, 2}, top/bottom in {0, 2}, any obstacle scheme (Bouzidi with its q
    planes), f32, LES on or off."""
    return unsupported(p) is None


def dev_storage_refusal(p: CaseParams) -> Optional[str]:
    """Why 16-bit deviation storage does not engage for case ``p``, or None.
    The JAX package's ``run_chunk_pallas`` rule: half-way and Bouzidi
    bounce-back read the cell's own previous populations on their links
    and run exact f32."""
    if obstacle_scheme(p) not in DEV_OBSTACLES:
        return "half-way and Bouzidi bounce-back run exact f32 (the JAX run_chunk_pallas rule)"
    return None


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


def edge_views(edge: torch.Tensor, H: int, W: int):
    """(cols [2, 12, H], rows [2, 12, W]) views of the edge export buffer:
    side 0/1 = column 1 / W-2 and row 1 / H-2."""
    cols = edge[: 2 * EDGE_C * H].view(2, EDGE_C, H)
    rows = edge[2 * EDGE_C * H :].view(2, EDGE_C, W)
    return cols, rows


def new_edge_buffer(H: int, W: int, dtype=torch.float32, device="cpu") -> torch.Tensor:
    return torch.zeros(2 * EDGE_C * (H + W), dtype=dtype, device=device)


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
# K1: interior step
# ---------------------------------------------------------------------------


def k1_step_plain(f_in, f_out, aux, edge, scal, use_les, rho=None, u=None, f_post=None,
                  obstacle=OBSTACLE_EQ, q=None):
    """Plain PyTorch version of K1, writing the same cells of the same
    buffers: the interior of f_out (and of rho/u/f_post when given) and the
    edge export. The link predicate of half-way and Bouzidi bounce-back is
    the solid flag of ``aux`` at the pull source, as in the kernel."""
    if obstacle == OBSTACLE_BOUZIDI and q is None:
        raise ValueError("Bouzidi bounce-back needs the q planes")
    H, W = f_in.shape[1:]
    s = scal.to(device=f_in.device, dtype=f_in.dtype)
    solid, damp = unpack_aux(aux)
    fs = pull_stream(f_in)
    if obstacle in (OBSTACLE_HALFWAY, OBSTACLE_BOUZIDI):
        fs = link_bounce(f_in, fs, solid, q if obstacle == OBSTACLE_BOUZIDI else None)
    fp, r, ux, uy = mrt_collide_arrays(fs, damp, s[0], s[1], s[2], use_les)
    if obstacle == OBSTACLE_BOUNCE:
        fp = full_way_bounce(fs, fp, solid)
        f_store = fp
    else:
        w9 = torch.as_tensor(W_LAT, dtype=f_in.dtype, device=f_in.device).reshape(9, 1, 1)
        f_store = torch.where(solid[None], w9 * r[None], fp)
    f_out[:, 1:-1, 1:-1] = f_store[:, 1:-1, 1:-1]
    cols, rows = edge_views(edge, H, W)
    for side, x in ((0, 1), (1, W - 2)):
        cols[side, :9, 1:-1] = fp[:, 1:-1, x]
        cols[side, 9:, 1:-1] = torch.stack([r, ux, uy])[:, 1:-1, x]
    for side, y in ((0, 1), (1, H - 2)):
        rows[side, :9, 1:-1] = fp[:, y, 1:-1]
        rows[side, 9:, 1:-1] = torch.stack([r, ux, uy])[:, y, 1:-1]
    if rho is not None:
        zero = torch.zeros_like(ux)
        rho[1:-1, 1:-1] = r[1:-1, 1:-1]
        u[0, 1:-1, 1:-1] = torch.where(solid, zero, ux)[1:-1, 1:-1]
        u[1, 1:-1, 1:-1] = torch.where(solid, zero, uy)[1:-1, 1:-1]
        f_post[:, 1:-1, 1:-1] = fp[:, 1:-1, 1:-1]


def _check_obstacle(obstacle: int, q, shape, device, allowed=tuple(range(4))) -> None:
    if obstacle not in allowed:
        raise ValueError(f"obstacle scheme {obstacle!r} not in {allowed}")
    if obstacle == OBSTACLE_BOUZIDI:
        if q is None:
            raise ValueError("Bouzidi bounce-back needs the q planes")
        _check("q", q, (8,) + tuple(shape), device)


def k1_step(f_in, f_out, aux, edge, scal, use_les, rho=None, u=None, f_post=None,
            obstacle=OBSTACLE_EQ, q=None):
    """K1 on ``f_in`` -> ``f_out`` (distinct [9, H, W] buffers). The full
    variant runs when ``rho`` [H, W], ``u`` [2, H, W] and ``f_post``
    [9, H, W] are given. ``scal`` is the CPU scalar row of this step;
    ``obstacle`` an ``OBSTACLE_*`` scheme, Bouzidi with ``q`` [8, H, W]."""
    if not f_in.is_cuda:
        return k1_step_plain(f_in, f_out, aux, edge, scal, use_les, rho, u, f_post,
                             obstacle, q)
    full = rho is not None
    _, H, W = f_in.shape
    dev = f_in.device
    _check("f_in", f_in, (9, H, W), dev)
    _check("f_out", f_out, (9, H, W), dev)
    _check("aux", aux, (H, W), dev)
    _check("edge", edge, (2 * EDGE_C * (H + W),), dev)
    _check_obstacle(obstacle, q, (H, W), dev)
    if full:
        _check("rho", rho, (H, W), dev)
        _check("u", u, (2, H, W), dev)
        _check("f_post", f_post, (9, H, W), dev)
    if f_in.data_ptr() == f_out.data_ptr():
        raise ValueError("k1_step: pull streaming needs distinct in/out buffers")
    sc = _scal_c(scal)
    q_ptr = _ptr(q) if obstacle == OBSTACLE_BOUZIDI else None
    rc = cuda_build.load("k1_step")(
        _ptr(f_in), _ptr(f_out), _ptr(aux), q_ptr, _ptr(edge), _ptr(rho), _ptr(u),
        _ptr(f_post), ctypes.addressof(sc), H, W, int(bool(use_les)), int(full), obstacle,
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"k1_step launch failed: CUDA error {rc}")
    LAUNCHES[k1_variant(obstacle, full)] += 1


def k1_step_dev_plain(f_in, f_out, aux, edge, scal, use_les, obstacle=OBSTACLE_EQ):
    """Plain PyTorch version of K1's deviation-storage fast step: dequantize
    f_in, step in f32 as ``k1_step_plain``, quantize the interior of f_out.
    The edge export stays f32."""
    _check_obstacle(obstacle, None, f_in.shape[1:], f_in.device, DEV_OBSTACLES)
    f32_out = torch.empty(f_in.shape, dtype=torch.float32, device=f_in.device)
    k1_step_plain(dequantize(f_in), f32_out, aux, edge, scal, use_les, obstacle=obstacle)
    f_out[:, 1:-1, 1:-1] = quantize(f32_out[:, 1:-1, 1:-1])


def k1_step_dev(f_in, f_out, aux, edge, scal, use_les, obstacle=OBSTACLE_EQ):
    """K1's fast step on bf16 deviation buffers ``f_in`` -> ``f_out``
    ([9, H, W], distinct); ``edge`` is the f32 export K2 reads. Equilibrium
    and full-way bounce-back only."""
    if not f_in.is_cuda:
        return k1_step_dev_plain(f_in, f_out, aux, edge, scal, use_les, obstacle)
    _, H, W = f_in.shape
    dev = f_in.device
    _check("f_in", f_in, (9, H, W), dev, DEV_DTYPE)
    _check("f_out", f_out, (9, H, W), dev, DEV_DTYPE)
    _check("aux", aux, (H, W), dev)
    _check("edge", edge, (2 * EDGE_C * (H + W),), dev)
    _check_obstacle(obstacle, None, (H, W), dev, DEV_OBSTACLES)
    if f_in.data_ptr() == f_out.data_ptr():
        raise ValueError("k1_step_dev: pull streaming needs distinct in/out buffers")
    sc = _scal_c(scal)
    rc = cuda_build.load("k1_step_dev")(
        _ptr(f_in), _ptr(f_out), _ptr(aux), _ptr(edge), ctypes.addressof(sc), H, W,
        int(bool(use_les)), obstacle, torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"k1_step_dev launch failed: CUDA error {rc}")
    LAUNCHES[k1_variant(obstacle, dev=True)] += 1


# ---------------------------------------------------------------------------
# K2: boundary ring
# ---------------------------------------------------------------------------


def _k2_ring_plain(f, aux, edge, scal, bc_type, rho, u, to_store, prof, bounce):
    """The ring of ``f`` (and of rho/u when given) from the edge export, in
    apply_bc order; ``to_store`` maps the f32 ring values [9, n] to f's
    storage."""
    H, W = f.shape[1:]
    ctype = torch.float32 if f.dtype == DEV_DTYPE else f.dtype
    s = scal.to(device=f.device, dtype=ctype)
    ramp = float(scal[_S_RAMP])
    bcv = s[6:].view(4, 2)
    cols, rows = edge_views(edge, H, W)
    lt, tt, rt, bt = bc_type
    vl = bc_left_values(
        cols[0, :9, 1:-1], cols[0, 9, 1:-1], cols[0, 10, 1:-1], cols[0, 11, 1:-1],
        ramp, lt, s[4], u_prof=None if prof is None else prof[1:-1],
    )
    vr = bc_right_values(
        cols[1, :9, 1:-1], cols[1, 9, 1:-1], cols[1, 10, 1:-1], cols[1, 11, 1:-1],
        ramp, rt, s[5], bcv[2],
    )
    # rows, with the corner-adjacent neighbours taken from the side BCs
    ring = {}
    for side, t, r_side, i_nb in ((1, tt, 1, -1), (3, bt, 0, 0)):
        nb = rows[r_side].clone()
        for x, vals in ((0, vl), (W - 1, vr)):
            nb[:9, x] = vals[0][:, i_nb]
            nb[9, x] = vals[1][i_nb]
            nb[10, x] = vals[2][i_nb]
            nb[11, x] = vals[3][i_nb]
        ring[side] = bc_horizontal_values(nb[:9], nb[9], nb[10], nb[11], ramp, t, bcv[side])
    w9 = torch.as_tensor(W_LAT, dtype=ctype, device=f.device).reshape(9, 1)
    solid, _ = unpack_aux(aux)
    for idx, (fb, rho_b, ux_b, uy_b) in (
        ((slice(1, -1), 0), vl), ((slice(1, -1), W - 1), vr),
        ((H - 1, slice(None)), ring[1]), ((0, slice(None)), ring[3]),
    ):
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


def k2_edge_bc_plain(f, aux, edge, scal, bc_type, rho=None, u=None, prof=None, bounce=False):
    """Plain PyTorch version of K2: the ring of ``f`` (and of rho/u when
    given) from the edge export, in apply_bc order."""
    _k2_ring_plain(f, aux, edge, scal, bc_type, rho, u, lambda v: v, prof, bounce)


def k2_edge_bc_dev_plain(f, aux, edge, scal, bc_type, prof=None, bounce=False):
    """Plain PyTorch version of K2 on a bf16 deviation buffer: the same f32
    ring, quantized into ``f``."""
    _k2_ring_plain(f, aux, edge, scal, bc_type, None, None, quantize, prof, bounce)


def _k2_prof(bc_type, prof, H: int, dev):
    """The inlet profile's pointer for left types 3/4 (checked), else None."""
    if int(bc_type[0]) not in (BC_VEL_INLET, BC_VEL_INLET_NEBB):
        return None
    if prof is None:
        raise ValueError(f"left bc_type {bc_type[0]} needs the inlet profile")
    _check("prof", prof, (H,), dev)
    return _ptr(prof)


def k2_edge_bc(f, aux, edge, scal, bc_type, rho=None, u=None, prof=None, bounce=False):
    """K2 on ``f`` [9, H, W] in place; with ``rho``/``u`` (the full
    variant) also their ring. ``prof`` [H] is the inlet profile of left
    types 3/4; ``bounce`` (full-way bounce-back) skips the f overwrite of
    solid ring cells."""
    if not f.is_cuda:
        return k2_edge_bc_plain(f, aux, edge, scal, bc_type, rho, u, prof, bounce)
    full = rho is not None
    _, H, W = f.shape
    dev = f.device
    _check("f", f, (9, H, W), dev)
    _check("aux", aux, (H, W), dev)
    _check("edge", edge, (2 * EDGE_C * (H + W),), dev)
    if full:
        _check("rho", rho, (H, W), dev)
        _check("u", u, (2, H, W), dev)
    prof_ptr = _k2_prof(bc_type, prof, H, dev)
    sc = _scal_c(scal)
    lt, tt, rt, bt = (int(t) for t in bc_type)
    rc = cuda_build.load("k2_edge_bc")(
        _ptr(f), _ptr(aux), _ptr(edge), prof_ptr, _ptr(rho), _ptr(u), ctypes.addressof(sc),
        H, W, lt, tt, rt, bt, int(bool(bounce)), int(full),
        torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"k2_edge_bc launch failed: CUDA error {rc}")
    LAUNCHES[k2_variant(lt)] += 1


def k2_edge_bc_dev(f, aux, edge, scal, bc_type, prof=None, bounce=False):
    """K2 on the bf16 deviation buffer ``f`` [9, H, W] in place."""
    if not f.is_cuda:
        return k2_edge_bc_dev_plain(f, aux, edge, scal, bc_type, prof, bounce)
    _, H, W = f.shape
    dev = f.device
    _check("f", f, (9, H, W), dev, DEV_DTYPE)
    _check("aux", aux, (H, W), dev)
    _check("edge", edge, (2 * EDGE_C * (H + W),), dev)
    prof_ptr = _k2_prof(bc_type, prof, H, dev)
    sc = _scal_c(scal)
    lt, tt, rt, bt = (int(t) for t in bc_type)
    rc = cuda_build.load("k2_edge_bc_dev")(
        _ptr(f), _ptr(aux), _ptr(edge), prof_ptr, ctypes.addressof(sc), H, W, lt, tt, rt, bt,
        int(bool(bounce)), torch.cuda.current_stream(dev).cuda_stream,
    )
    if rc != 0:
        raise RuntimeError(f"k2_edge_bc_dev launch failed: CUDA error {rc}")
    LAUNCHES[k2_variant(lt, dev=True)] += 1


# ---------------------------------------------------------------------------
# Chunk runner
# ---------------------------------------------------------------------------


def run_chunk_cuda(state: LBMState, p: CaseParams, n_steps: int, store_dev: bool = False):
    """Advance ``n_steps`` through K1 + K2; same contract as
    ``solver.run_chunk``: ``(state, {"force": [2], "max_v": 0-d})``.

    Steps 1..n-1 run K1 then K2; the last step runs K1's full variant then
    K2. f_post keeps its ring and takes the last step's interior. The input
    state is not modified. ``store_dev`` runs steps 1..n-1 in 16-bit
    deviation storage when n > 1 and the obstacle scheme allows it (the JAX
    package's run_chunk_pallas engages it under the same conditions).
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
        k1, k2, k1d, k2d = k1_step_plain, k2_edge_bc_plain, k1_step_dev_plain, k2_edge_bc_dev_plain
    else:
        k1, k2, k1d, k2d = k1_step, k2_edge_bc, k1_step_dev, k2_edge_bc_dev
    dev_store = bool(store_dev) and n_steps > 1 and dev_storage_refusal(p) is None
    obst = obstacle_scheme(p)
    q = p.bouzidi_q if obst == OBSTACLE_BOUZIDI else None
    prof = p.inlet_profile if p.bc_type[0] in (BC_VEL_INLET, BC_VEL_INLET_NEBB) else None
    bounce = obst == OBSTACLE_BOUNCE
    H, W = p.shape
    dev = state.f.device
    aux = pack_aux(p.damping, p.mask)
    edge = new_edge_buffer(H, W, state.f.dtype, dev)
    row, warmup = _host_scalars(p)
    # quantize once per chunk; the fast steps ping-pong two buffers
    src = quantize(state.f) if dev_store else state.f
    bufs = (torch.empty_like(src), torch.empty_like(src))
    for i in range(n_steps - 1):
        scal = _with_ramp(row, warmup, state.step + i + 1)
        dst = bufs[i % 2]
        if dev_store:
            k1d(src, dst, aux, edge, scal, p.use_les, obst)
            k2d(dst, aux, edge, scal, p.bc_type, prof, bounce)
        else:
            k1(src, dst, aux, edge, scal, p.use_les, obstacle=obst, q=q)
            k2(dst, aux, edge, scal, p.bc_type, prof=prof, bounce=bounce)
        src = dst
    if dev_store:
        # the closing full step runs in exact f32
        src = dequantize(src)
        dst = torch.empty_like(src)
    else:
        dst = bufs[(n_steps - 1) % 2]
    scal = _with_ramp(row, warmup, state.step + n_steps)
    rho = torch.empty((H, W), dtype=state.f.dtype, device=dev)
    u = torch.empty((2, H, W), dtype=state.f.dtype, device=dev)
    f_post = state.f_post.clone()
    k1(src, dst, aux, edge, scal, p.use_les, rho, u, f_post, obstacle=obst, q=q)
    k2(dst, aux, edge, scal, p.bc_type, rho, u, prof=prof, bounce=bounce)
    new_state = LBMState(f=dst, f_post=f_post, rho=rho, u=u, step=state.step + n_steps)
    monitors = {
        "force": obstacle_force(new_state.f_post, p),
        "max_v": max_velocity(new_state.u),
    }
    return new_state, monitors
