"""D2Q9 MRT-LES lattice-Boltzmann solver core, eager PyTorch reference step.

Counterpart of ``lbm2d_tpu/core/solver.py``. One lattice update is
``step(state, params) -> state``: pull streaming, MRT-LES collision with the
sponge, the obstacle rule, then the boundary conditions in the reference's
order (left/right edges, then top/bottom rows including corners, then the
obstacle equilibrium overwrite ``f <- w rho`` on solid cells).

This module is the plain version every CUDA kernel of ``ops/cuda_step.py``
is held against, and the path the engine runs on the CPU. Every expression
keeps the JAX package's evaluation order, so f64 runs agree to ~1e-15 and
data-dependent branches (the outlet backflow guard, the ``rho > 0`` guard)
take the same side in f32.

State layout: channel-major ``[9, H, W]`` (y, x). ``f_post`` mirrors the
reference's ``f_new`` buffer: its 1-cell ring stays at the initial
equilibrium and it is the field the moment export and the force read.
``LBMState.step`` is a host integer: the warmup ramp is computed from it on
the host, so no step needs a device read.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import Optional, Tuple

import numpy as np
import torch

from .lattice import (
    E,
    OPP,
    W,
    PI_REF,
    f_eq,
    f_eq_unit,
    f_eq_unit_x,
    f_eq_unit_y,
    moments_from_f,
)
from .sponge import sponge_damping_field

# BC side indices (reference apply_bc order of the config list).
SIDE_LEFT, SIDE_TOP, SIDE_RIGHT, SIDE_BOTTOM = 0, 1, 2, 3

# BC type codes (master_config.yaml): 0 = inlet (Zou-He pressure on the left
# edge, velocity inlet elsewhere), 1 = Zou-He pressure outlet (right edge
# only), 2 = free-slip, 3 = profiled equilibrium velocity inlet (left edge),
# 4 = profiled NEBB velocity inlet (left edge).
BC_INLET, BC_OUTLET, BC_FREE_SLIP, BC_VEL_INLET = 0, 1, 2, 3
BC_VEL_INLET_NEBB = 4


@dataclass
class CaseParams:
    """Per-case parameters: tensors on the case device plus static fields."""

    mask: torch.Tensor  # [H, W], 1 = solid
    damping: torch.Tensor  # [H, W] sponge tau addition
    tau0: torch.Tensor  # 0-d, 3 nu + 0.5
    cs_factor: torch.Tensor  # 0-d, 18 * Cs^2
    s_ghost: torch.Tensor  # 0-d ghost-moment relaxation rate
    rho_in: torch.Tensor  # 0-d
    rho_out: torch.Tensor  # 0-d
    warmup_steps: torch.Tensor  # 0-d ramp denominator
    bc_value: torch.Tensor  # [4, 2] velocity-inlet values
    inlet_profile: Optional[torch.Tensor] = None  # [H] for BC types 3/4
    use_les: bool = True
    bc_type: Tuple[int, int, int, int] = (
        BC_INLET, BC_FREE_SLIP, BC_OUTLET, BC_FREE_SLIP,
    )
    bounce_obstacle: bool = False
    halfway_obstacle: bool = False
    bouzidi_obstacle: bool = False

    @property
    def shape(self):
        return tuple(self.mask.shape)

    @property
    def dtype(self):
        return self.mask.dtype


@dataclass
class LBMState:
    f: torch.Tensor  # [9, H, W] post-BC distributions (reference f_old)
    f_post: torch.Tensor  # [9, H, W] post-collision (reference f_new)
    rho: torch.Tensor  # [H, W]
    u: torch.Tensor  # [2, H, W] (ux, uy)
    step: int  # equals the reference frame_count


def make_params(
    config: dict,
    mask: Optional[np.ndarray] = None,
    dtype=torch.float32,
    device="cpu",
) -> CaseParams:
    """Build CaseParams from a per-case config dict (reference YAML schema).

    ``mask`` is [H, W] (y, x) with 1 = solid.
    """
    sim = config["simulation"]
    ny, nx = int(sim["ny"]), int(sim["nx"])
    zones = config["domain_zones"]
    damping = sponge_damping_field(
        nx,
        ny,
        zones["sponge_in"],
        zones["sponge_out"],
        zones["sponge_top"],
        zones["sponge_bot"],
        zones["sponge_strength"],
        dtype=np.float64,
    )
    if mask is None:
        mask = np.zeros((ny, nx), np.float32)
    else:
        mask = np.asarray(mask, np.float32)
        if mask.shape != (ny, nx):
            raise ValueError(f"mask shape {mask.shape} != (ny={ny}, nx={nx})")
    bc = config["boundary_condition"]
    bc_types = [int(t) for t in bc["type"]]
    for side in (1, 3):  # top, bottom
        if bc_types[side] == 1:
            raise ValueError(
                "boundary_condition.type=1 (pressure outlet) on top/bottom is "
                "not supported (reference applies it only at two corner cells; "
                "use 2 = free-slip or 0 = velocity inlet)"
            )
    for side in (1, 2, 3):
        if bc_types[side] in (BC_VEL_INLET, BC_VEL_INLET_NEBB):
            raise ValueError(
                "boundary_condition.type=3/4 (profiled velocity inlet) is "
                "only supported on the left edge"
            )

    def t(x):
        return torch.as_tensor(np.array(x), dtype=dtype, device=device)

    inlet_profile = None
    if bc_types[SIDE_LEFT] in (BC_VEL_INLET, BC_VEL_INLET_NEBB):
        u_max = float(np.asarray(bc["value"], np.float32)[SIDE_LEFT][0])
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype.type
        inlet_profile = t(parabolic_profile(ny, u_max, np_dtype))
    obstacle = str(bc.get("obstacle", "equilibrium"))
    if obstacle not in (
        "equilibrium", "bounce_back", "bounce_back_halfway",
        "bounce_back_bouzidi",
    ):
        raise ValueError(f"unknown boundary_condition.obstacle {obstacle!r}")
    if obstacle == "bounce_back_bouzidi":
        raise NotImplementedError(
            "obstacle 'bounce_back_bouzidi' is not ported yet "
            "(ROADMAP.md, Bouzidi interpolated bounce-back)"
        )
    c_smag = float(sim["smagorinsky_constant"])
    return CaseParams(
        mask=t(mask),
        damping=t(damping),
        tau0=t(3.0 * float(sim["nu"]) + 0.5),
        cs_factor=t(18.0 * c_smag * c_smag),
        s_ghost=t(float(sim["ghost_moments_s"])),
        rho_in=t(float(sim["rho_in"])),
        rho_out=t(float(sim["rho_out"])),
        warmup_steps=t(float(sim["warmup_steps"])),
        bc_value=t(np.asarray(bc["value"], np.float32)),
        inlet_profile=inlet_profile,
        use_les=c_smag > 0.001,
        bc_type=tuple(bc_types),
        bounce_obstacle=obstacle == "bounce_back",
        halfway_obstacle=obstacle == "bounce_back_halfway",
    )


def parabolic_profile(ny: int, u_max: float, dtype=np.float64) -> np.ndarray:
    """Parabolic inlet profile over rows 0..ny-1: 4 u y (h - y) / h^2."""
    y = np.arange(ny, dtype=dtype)
    h = dtype(ny - 1)
    return (4.0 * dtype(u_max) * y * (h - y) / (h * h)).astype(dtype)


def init_state(ny: int, nx: int, dtype=torch.float32, device="cpu") -> LBMState:
    """rho = 1, u = 0, f = f_post = equilibrium."""
    rho = torch.ones((ny, nx), dtype=dtype, device=device)
    u = torch.zeros((2, ny, nx), dtype=dtype, device=device)
    f = f_eq(rho, u[0], u[1])
    return LBMState(f=f, f_post=f.clone(), rho=rho, u=u, step=0)


# ---------------------------------------------------------------------------
# Collision + streaming (interior physics)
# ---------------------------------------------------------------------------


def pull_stream(f: torch.Tensor) -> torch.Tensor:
    """Pull streaming via circular shifts: f_k(y, x) <- f_k(y - ey, x - ex).

    Wrap-around values land only on the boundary ring, which the caller
    discards.
    """
    return torch.stack(
        [
            torch.roll(f[k], (int(E[k, 1]), int(E[k, 0])), dims=(0, 1))
            for k in range(9)
        ]
    )


def mrt_collide_arrays(fs, damping, tau0, cs_factor, s_ghost, use_les: bool):
    """MRT-LES collision of a post-streaming field fs [9, ...].

    Returns (f_post, rho, ux, uy). f_post = fs - M^-1 S (m - m_eq) with the
    forward moments butterfly-factored; the operation order is the JAX
    package's and the CUDA kernel's (csrc/lbm_common.cuh).
    """
    f0, f1, f2, f3, f4, f5, f6, f7, f8 = (fs[k] for k in range(9))

    s13 = f1 + f3
    s24 = f2 + f4
    d13 = f1 - f3
    d24 = f2 - f4
    s56 = f5 + f6
    s78 = f7 + f8
    d56 = f5 - f6
    d78 = f7 - f8
    s1324 = s13 + s24
    s5678 = s56 + s78
    rho = f0 + s1324 + s5678  # m0
    m1 = 2.0 * s5678 - s1324 - 4.0 * f0  # energy e
    m2 = 4.0 * f0 - 2.0 * s1324 + s5678  # epsilon
    a_d = d56 - d78
    b_s = s56 - s78
    m3 = d13 + a_d  # jx
    m4 = a_d - 2.0 * d13  # qx
    m5 = d24 + b_s  # jy
    m6 = b_s - 2.0 * d24  # qy
    m7 = s13 - s24  # pxx
    m8 = d56 + d78  # pxy

    # multiply by the guarded reciprocal; never divide by rho
    pos = rho > 0
    inv_rho = torch.where(
        pos, 1.0 / torch.where(pos, rho, torch.ones_like(rho)),
        torch.zeros_like(rho),
    )
    ux = m3 * inv_rho
    uy = m5 * inv_rho

    uxx = ux * ux
    uyy = uy * uy
    u2 = uxx + uyy
    rux = rho * ux
    ruy = rho * uy
    d1 = m1 - rho * (-2.0 + 3.0 * u2)
    d2 = m2 - rho * (1.0 - 3.0 * u2)
    d4 = m4 + rux  # meq4 = -rho ux
    d6 = m6 + ruy  # meq6 = -rho uy
    d7 = m7 - rho * (uxx - uyy)
    d8 = m8 - rux * uy

    if use_les:
        neq_norm = torch.sqrt(2.0 * d7 * d7 + 2.0 * d8 * d8)
        term = tau0 * tau0 + cs_factor * neq_norm * inv_rho
        tau_eff = tau0 + 0.5 * (torch.sqrt(term) - tau0)
    else:
        tau_eff = tau0.expand(rho.shape)
    tau_eff = tau_eff + damping
    s_eff = 1.0 / tau_eff

    sd1 = s_ghost * d1
    sd2 = s_ghost * d2
    sd4 = s_ghost * d4
    sd6 = s_ghost * d6
    sd7 = s_eff * d7
    sd8 = s_eff * d8

    t0 = (sd2 - sd1) * (4.0 / 36.0)
    ta = -(sd1 + 2.0 * sd2) * (1.0 / 36.0)
    td = (2.0 * sd1 + sd2) * (1.0 / 36.0)
    u4 = sd4 * (6.0 / 36.0)
    u6 = sd6 * (6.0 / 36.0)
    u7 = sd7 * (9.0 / 36.0)
    u8 = sd8 * (9.0 / 36.0)
    v4 = sd4 * (3.0 / 36.0)
    v6 = sd6 * (3.0 / 36.0)

    f_post = torch.stack(
        [
            f0 - t0,
            f1 - (ta - u4 + u7),
            f2 - (ta - u6 - u7),
            f3 - (ta + u4 + u7),
            f4 - (ta + u6 - u7),
            f5 - (td + v4 + v6 + u8),
            f6 - (td - v4 + v6 - u8),
            f7 - (td - v4 - v6 + u8),
            f8 - (td + v4 - v6 - u8),
        ]
    )
    return f_post, rho, ux, uy


def shift2d(a: torch.Tensor, dy: int, dx: int, fill=0.0) -> torch.Tensor:
    """result[y, x] = a[y+dy, x+dx], out-of-bounds -> fill. dy,dx in {-1,0,1}."""
    h, w = a.shape[-2], a.shape[-1]
    out = torch.full_like(a, fill)
    ys_out = slice(max(0, -dy), h - max(0, dy))
    xs_out = slice(max(0, -dx), w - max(0, dx))
    ys_in = slice(max(0, dy), h - max(0, -dy))
    xs_in = slice(max(0, dx), w - max(0, -dx))
    out[..., ys_out, xs_out] = a[..., ys_in, xs_in]
    return out


def collide_stream_full(f: torch.Tensor, p: CaseParams):
    """Fused pull-stream + MRT-LES collision over the full grid."""
    fs = pull_stream(f)
    if p.halfway_obstacle:
        # a pull whose source cell is solid returns this cell's own opposite
        # population from the previous post-collision field
        solid = p.mask > 0.5
        planes = [fs[0]]
        for k in range(1, 9):
            ex, ey = int(E[k, 0]), int(E[k, 1])
            nb_solid = shift2d(solid, -ey, -ex, False)
            planes.append(torch.where(nb_solid, f[int(OPP[k])], fs[k]))
        fs = torch.stack(planes)
    f_post, rho, ux, uy = mrt_collide_arrays(
        fs, p.damping, p.tau0, p.cs_factor, p.s_ghost, p.use_les
    )
    if p.bounce_obstacle:
        # full-way bounce-back replaces collision on solid cells
        solid = p.mask > 0.5
        f_bb = torch.stack([fs[int(OPP[k])] for k in range(9)])
        f_post = torch.where(solid[None], f_bb, f_post)
    return f_post, rho, ux, uy


# ---------------------------------------------------------------------------
# Boundary conditions
# ---------------------------------------------------------------------------


def bc_left_values(fn, rho_nb, uxn, uyn, ramp, t, rho_in, u_prof=None):
    """West-edge BC values from the neighbor strip; None if no-op.

    ``fn`` [9, N] and the macros [N] are the neighbor column's collide
    output; ``ramp`` is a Python float, ``rho_in`` a 0-d tensor.
    Returns (fb [9, N], rho_b, ux_b, uy_b).
    """
    if t == BC_VEL_INLET:
        # prescribed-velocity equilibrium inlet: rho = 1, f = f_eq(1, u)
        ux = u_prof * ramp
        uy = torch.zeros_like(ux)
        rho_b = torch.ones_like(rho_nb)
        fb = f_eq_unit_x(ux)
        return fb, rho_b, ux, uy
    if t == BC_VEL_INLET_NEBB:
        ux = u_prof * ramp
        uy = torch.zeros_like(ux)
        fb = rho_nb * (f_eq_unit_x(ux) - f_eq_unit(uxn, uyn)) + fn
        return fb, rho_nb, ux, uy
    if t == BC_INLET:
        # Zou-He pressure inlet with the warmup-ramped target density
        rho_c = 1.0 + (rho_in - 1.0) * ramp
        rho_b = rho_c * torch.ones_like(rho_nb)
        ux = 1.0 - (fn[0] + fn[2] + fn[4] + 2.0 * (fn[3] + fn[6] + fn[7])) / rho_c
        uy = torch.zeros_like(ux)
        feq = rho_c * f_eq_unit_x(ux)
        f1 = fn[3] + (2.0 / 3.0) * rho_c * ux
        f5 = fn[7] - 0.5 * (fn[2] - fn[4]) + (1.0 / 6.0) * rho_c * ux
        f8 = fn[6] + 0.5 * (fn[2] - fn[4]) + (1.0 / 6.0) * rho_c * ux
        fb = torch.stack(
            [feq[0], f1, feq[2], feq[3], feq[4], f5, feq[6], feq[7], f8]
        )
        return fb, rho_b, ux, uy
    if t == BC_FREE_SLIP:
        ux = torch.zeros_like(uxn)
        uy = uyn
        fb = rho_nb * (f_eq_unit_y(uyn) - f_eq_unit(uxn, uyn)) + fn
        return fb, rho_nb, ux, uy
    return None  # type 1 on the left edge is a no-op


def bc_right_values(fn, rho_nb, uxn, uyn, ramp, t, rho_out, bc_val):
    """East-edge BC values from the neighbor strip; None if no-op.

    ``bc_val`` is the side's [2] velocity value (type-0 branch).
    """
    if t == BC_OUTLET:
        # Zou-He pressure outlet with the zero-gradient backflow guard
        rho_o = rho_out
        ux = -1.0 + (fn[0] + fn[2] + fn[4] + 2.0 * (fn[1] + fn[5] + fn[8])) / rho_o
        backflow = ux < 0.0
        rho_b = rho_o * torch.ones_like(rho_nb)
        feq = rho_o * f_eq_unit_x(ux)
        f3 = fn[1] - (2.0 / 3.0) * rho_o * ux
        f6 = fn[8] - 0.5 * (fn[2] - fn[4]) - (1.0 / 6.0) * rho_o * ux
        f7 = fn[5] + 0.5 * (fn[2] - fn[4]) - (1.0 / 6.0) * rho_o * ux
        fz = torch.stack(
            [feq[0], feq[1], feq[2], f3, feq[4], feq[5], f6, f7, feq[8]]
        )
        fbf = (rho_o - rho_nb) * f_eq_unit(uxn, uyn) + fn
        fb = torch.where(backflow[None], fbf, fz)
        ux_b = torch.where(backflow, uxn, ux)
        uy_b = torch.where(backflow, uyn, torch.zeros_like(uyn))
        return fb, rho_b, ux_b, uy_b
    if t == BC_INLET:
        # non-west inlet: prescribed-velocity NEBB
        v = bc_val * ramp
        ux_b = v[0] * torch.ones_like(uxn)
        uy_b = v[1] * torch.ones_like(uyn)
        fb = rho_nb * (f_eq_unit(ux_b, uy_b) - f_eq_unit(uxn, uyn)) + fn
        return fb, rho_nb, ux_b, uy_b
    if t == BC_FREE_SLIP:
        ux_b = torch.zeros_like(uxn)
        uy_b = uyn
        fb = rho_nb * (f_eq_unit_y(uyn) - f_eq_unit(uxn, uyn)) + fn
        return fb, rho_nb, ux_b, uy_b
    return None


def bc_horizontal_values(fn, rho_nb, uxn, uyn, ramp, t, bc_val):
    """Top/bottom-row BC values; None if no-op (types 0 and 2 act)."""
    if t == BC_FREE_SLIP:
        ux_b = uxn
        uy_b = torch.zeros_like(uyn)
        g_b = f_eq_unit_x(uxn)
    elif t == BC_INLET:
        v = bc_val * ramp
        ux_b = v[0] * torch.ones_like(uxn)
        uy_b = v[1] * torch.ones_like(uyn)
        g_b = f_eq_unit(ux_b, uy_b)
    else:
        return None
    fb = rho_nb * (g_b - f_eq_unit(uxn, uyn)) + fn
    return fb, rho_nb, ux_b, uy_b


def warmup_ramp(step: int, warmup_steps: float, dtype) -> float:
    """1 - cos(0.5 PI_REF min(1, step / warmup)) in ``dtype``, on the host.

    Both the eager step and the CUDA runner take the ramp from here, so the
    two paths see the same bits without a device read.
    """
    progress = torch.minimum(
        torch.ones((), dtype=dtype),
        torch.tensor(step, dtype=dtype) / torch.tensor(warmup_steps, dtype=dtype),
    )
    ramp = 1.0 - torch.cos(torch.tensor(0.5 * PI_REF, dtype=dtype) * progress)
    return float(ramp)


def _set_col(f, rho, u, x, vals):
    fb, rho_b, ux_b, uy_b = vals
    f[:, 1:-1, x] = fb
    rho[1:-1, x] = rho_b
    u[0, 1:-1, x] = ux_b
    u[1, 1:-1, x] = uy_b


def apply_bc(f, rho, u, step: int, p: CaseParams):
    """Full BC pass in the reference's sequential order, in place.

    Left/right columns on the inner rows, then the top and bottom rows
    including the corners (which read what the side BCs just wrote), then
    the obstacle overwrite on solid cells.
    """
    ramp = warmup_ramp(step, float(p.warmup_steps), f.dtype)
    prof = None if p.inlet_profile is None else p.inlet_profile[1:-1]
    vals = bc_left_values(
        f[:, 1:-1, 1], rho[1:-1, 1], u[0, 1:-1, 1], u[1, 1:-1, 1], ramp,
        p.bc_type[SIDE_LEFT], p.rho_in, u_prof=prof,
    )
    if vals is not None:
        _set_col(f, rho, u, 0, vals)
    vals = bc_right_values(
        f[:, 1:-1, -2], rho[1:-1, -2], u[0, 1:-1, -2], u[1, 1:-1, -2], ramp,
        p.bc_type[SIDE_RIGHT], p.rho_out, p.bc_value[SIDE_RIGHT],
    )
    if vals is not None:
        _set_col(f, rho, u, -1, vals)
    for side, row, nbr in ((SIDE_TOP, -1, -2), (SIDE_BOTTOM, 0, 1)):
        vals = bc_horizontal_values(
            f[:, nbr, :], rho[nbr, :], u[0, nbr, :], u[1, nbr, :], ramp,
            p.bc_type[side], p.bc_value[side],
        )
        if vals is not None:
            fb, rho_b, ux_b, uy_b = vals
            f[:, row, :] = fb
            rho[row, :] = rho_b
            u[0, row, :] = ux_b
            u[1, row, :] = uy_b
    # obstacle: u <- 0 on solids; f <- f_eq(rho, 0) = w rho unless full-way
    # bounce-back already replaced f inside the collision
    solid = p.mask > 0.5
    if not p.bounce_obstacle:
        w9 = torch.as_tensor(W, dtype=f.dtype, device=f.device).reshape(9, 1, 1)
        f = torch.where(solid[None], w9 * rho[None], f)
    u = torch.where(solid[None], torch.zeros_like(u), u)
    return f, rho, u


# ---------------------------------------------------------------------------
# Full step + chunked advance
# ---------------------------------------------------------------------------


def step(state: LBMState, p: CaseParams) -> LBMState:
    """One lattice update (collide+stream, macro, BC)."""
    f_c, rho_c, ux_c, uy_c = collide_stream_full(state.f, p)
    inner = (slice(1, -1), slice(1, -1))
    f_post = state.f_post.clone()
    f_post[(slice(None),) + inner] = f_c[(slice(None),) + inner]
    f = state.f.clone()
    f[(slice(None),) + inner] = f_c[(slice(None),) + inner]
    rho = state.rho.clone()
    rho[inner] = rho_c[inner]
    u = state.u.clone()
    u[(0,) + inner] = ux_c[inner]
    u[(1,) + inner] = uy_c[inner]
    new_step = state.step + 1
    f, rho, u = apply_bc(f, rho, u, new_step, p)
    return LBMState(f=f, f_post=f_post, rho=rho, u=u, step=new_step)


def neighbor_solid_bits(mask: torch.Tensor) -> torch.Tensor:
    """int32 [H, W]: bit k set iff the pull source (y - ey_k, x - ex_k) is
    solid."""
    solid = mask > 0.5
    bits = torch.zeros(mask.shape, dtype=torch.int32, device=mask.device)
    for k in range(1, 9):
        ex, ey = int(E[k, 0]), int(E[k, 1])
        bits = bits | (shift2d(solid, -ey, -ex, False).to(torch.int32) << k)
    return bits


def force_on_obstacle(f_post: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Momentum-exchange force on all solid cells -> [2] (fx, fy).

    For each solid cell and direction k with an in-bounds fluid neighbor at
    +e_k: force += 2 * f_post[OPP[k]](neighbor) * (-e_k).
    """
    solid = mask > 0.5
    fluid = (~solid).to(f_post.dtype)
    zero = torch.zeros((), dtype=f_post.dtype, device=f_post.device)
    fx = zero
    fy = zero
    for k in range(1, 9):
        ex, ey = int(E[k, 0]), int(E[k, 1])
        nb_fluid = shift2d(fluid, ey, ex, 0.0)
        nb_f = shift2d(f_post[int(OPP[k])], ey, ex, 0.0)
        s = torch.where(solid, 2.0 * nb_f * nb_fluid, zero).sum()
        fx = fx + s * (-ex)
        fy = fy + s * (-ey)
    return torch.stack([fx, fy])


def force_on_obstacle_halfway(f_post: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
    """Momentum-exchange force for half-way bounce-back -> [2] (fx, fy)."""
    solid = mask > 0.5
    zero = torch.zeros((), dtype=f_post.dtype, device=f_post.device)
    fx = zero
    fy = zero
    for k in range(1, 9):
        ex, ey = int(E[k, 0]), int(E[k, 1])
        nb_solid = shift2d(solid, ey, ex, False)
        s = torch.where((~solid) & nb_solid, 2.0 * f_post[k], zero).sum()
        fx = fx + s * ex
        fy = fy + s * ey
    return torch.stack([fx, fy])


def obstacle_force(
    f_post: torch.Tensor, p: CaseParams, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Momentum-exchange force with the scheme matching the obstacle mode."""
    m = p.mask if mask is None else mask
    if p.halfway_obstacle:
        return force_on_obstacle_halfway(f_post, m)
    return force_on_obstacle(f_post, m)


def max_velocity(u: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(u[0] * u[0] + u[1] * u[1]).max()


def run_chunk(state: LBMState, p: CaseParams, n_steps: int):
    """Advance n_steps; return (state, {"force": [2], "max_v": 0-d}).

    The monitors come from the final step's f_post / u, as the reference
    loop reads them once per chunk.
    """
    for _ in range(n_steps):
        state = step(state, p)
    monitors = {
        "force": obstacle_force(state.f_post, p),
        "max_v": max_velocity(state.u),
    }
    return state, monitors


def moments_output(state: LBMState) -> torch.Tensor:
    """[9, H, W] MRT moments of f_post, for dataset export."""
    return moments_from_f(state.f_post)
