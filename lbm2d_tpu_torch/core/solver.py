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
    # [8, H, W] Bouzidi wall fractions: plane j-1 holds q_j(c) in (0, 1] for
    # fluid cells whose +e_j neighbour is solid, 0.5 elsewhere
    bouzidi_q: Optional[torch.Tensor] = None
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
    bouzidi_q = None
    if obstacle == "bounce_back_bouzidi":
        # obstacle_geometry gives the analytic surface; without one the q
        # planes derive from the mask's own signed-distance field
        np_dtype = torch.empty((), dtype=dtype).numpy().dtype.type
        bouzidi_q = t(
            bouzidi_q_planes(np.asarray(mask), bc.get("obstacle_geometry"), np_dtype)
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
        bouzidi_obstacle=obstacle == "bounce_back_bouzidi",
        bouzidi_q=bouzidi_q,
    )


def parabolic_profile(ny: int, u_max: float, dtype=np.float64) -> np.ndarray:
    """Parabolic inlet profile over rows 0..ny-1: 4 u y (h - y) / h^2."""
    y = np.arange(ny, dtype=dtype)
    h = dtype(ny - 1)
    return (4.0 * dtype(u_max) * y * (h - y) / (h * h)).astype(dtype)


# ---------------------------------------------------------------------------
# Bouzidi wall fractions (numpy, once per case)
# ---------------------------------------------------------------------------


def _link_t_cylinder(geom: dict, dx, dy, ex: int, ey: int) -> np.ndarray:
    """Smallest t in (0, 1] where cell-center + t e hits the circle; inf
    where the link misses it.  dx/dy are cell-center offsets from (cx, cy)."""
    r = float(geom["r"])
    cc = dx * dx + dy * dy - r * r
    a = float(ex * ex + ey * ey)
    b = 2.0 * (dx * ex + dy * ey)
    disc = b * b - 4.0 * a * cc
    sq = np.sqrt(np.maximum(disc, 0.0))
    t1 = (-b - sq) / (2.0 * a)
    t2 = (-b + sq) / (2.0 * a)
    in1 = (disc >= 0.0) & (t1 > 0.0) & (t1 <= 1.0)
    in2 = (disc >= 0.0) & (t2 > 0.0) & (t2 <= 1.0)
    return np.where(in1, t1, np.where(in2, t2, np.inf))


def _link_t_polygon(verts: np.ndarray, xx, yy, ex: int, ey: int) -> np.ndarray:
    """Smallest t in (0, 1] where cell-center + t e crosses any polygon
    edge; inf where the link misses the polygon.  Solves
    c + t d = p + s (pn - p) per edge via 2D cross products."""
    t_min = np.full(xx.shape, np.inf)
    verts = np.asarray(verts, np.float64)
    n = len(verts)
    for i in range(n):
        px, py = verts[i]
        qx, qy = verts[(i + 1) % n]
        egx, egy = qx - px, qy - py
        denom = ex * egy - ey * egx  # cross(d, edge)
        if abs(denom) < 1e-12:
            continue  # link parallel to this edge; neighbors cover corners
        rx = px - xx
        ry = py - yy
        t = (rx * egy - ry * egx) / denom  # cross(p-c, e) / cross(d, e)
        s = (rx * ey - ry * ex) / denom  # cross(p-c, d) / cross(d, e)
        hit = (t > 0.0) & (t <= 1.0) & (s >= 0.0) & (s <= 1.0)
        t_min = np.where(hit & (t < t_min), t, t_min)
    return t_min


def _link_t_sdf(phi: np.ndarray, xx, yy, ex: int, ey: int,
                samples: int = 32) -> np.ndarray:
    """First zero crossing of a bilinearly-interpolated signed-distance
    field along each link (mask-derived geometry: composite shapes with no
    analytic description).  phi > 0 in fluid, < 0 in solid; flat walls
    reduce to q = 1/2 (half-way)."""
    from scipy.ndimage import map_coordinates

    h, w = phi.shape
    ts = np.linspace(0.0, 1.0, samples + 1)
    prev_phi = phi.copy()
    t_hit = np.full(phi.shape, np.inf)
    for i in range(1, samples + 1):
        t = ts[i]
        cy = np.clip(yy + t * ey, 0, h - 1)
        cx = np.clip(xx + t * ex, 0, w - 1)
        cur = map_coordinates(phi, [cy, cx], order=1, mode="nearest")
        # first crossing only: cells whose t_hit is already set keep it
        crossing = (prev_phi > 0.0) & (cur <= 0.0) & np.isinf(t_hit)
        denom = prev_phi - cur
        frac = np.where(denom > 1e-12, prev_phi / np.maximum(denom, 1e-12), 0.0)
        t_cross = ts[i - 1] + frac * (ts[i] - ts[i - 1])
        t_hit = np.where(crossing, t_cross, t_hit)
        prev_phi = cur
    return t_hit


def signed_distance(mask: np.ndarray) -> np.ndarray:
    """Pseudo signed distance whose zero level approximates the surface the
    binary mask was rasterized from: > 0 in fluid, < 0 in solid
    (phi = 1/2 - box3(mask), a 3x3 volume-fraction smoothing). Near-boundary
    accuracy only, which is all the q-plane crossing search samples."""
    from scipy.ndimage import uniform_filter

    solid = np.asarray(mask) > 0.5
    if not solid.any():
        return np.full(solid.shape, np.inf)
    return 0.5 - uniform_filter(solid.astype(np.float64), 3, mode="nearest")


def _geom_link_t(geom: dict, mask: np.ndarray, xx, yy, ex: int, ey: int,
                 _phi_cache: dict = None) -> np.ndarray:
    shape = str(geom.get("shape", "cylinder"))
    if shape == "cylinder":
        return _link_t_cylinder(
            geom, xx - float(geom["cx"]), yy - float(geom["cy"]), ex, ey
        )
    if shape == "polygon":
        return _link_t_polygon(np.asarray(geom["vertices"]), xx, yy, ex, ey)
    if shape == "rect":
        from ..tools.shapes import rect_points_f

        verts = rect_points_f(
            float(geom["cx"]), float(geom["cy"]), float(geom["w"]),
            float(geom["h"]), float(geom.get("angle_deg", 0.0)),
        )
        return _link_t_polygon(verts, xx, yy, ex, ey)
    if shape == "triangle":
        from ..tools.shapes import triangle_points_f

        verts = triangle_points_f(
            float(geom["cx"]), float(geom["cy"]), float(geom["size"]),
            float(geom.get("angle_deg", 0.0)),
            geom.get("orientation", "vertex_left"),
        )
        return _link_t_polygon(verts, xx, yy, ex, ey)
    if shape == "union":
        t = np.full(xx.shape, np.inf)
        for part in geom["parts"]:
            t = np.minimum(
                t, _geom_link_t(part, mask, xx, yy, ex, ey, _phi_cache)
            )
        return t
    if shape == "sdf":
        if _phi_cache is not None and "phi" in _phi_cache:
            phi = _phi_cache["phi"]
        else:
            phi = signed_distance(mask)
            if _phi_cache is not None:
                _phi_cache["phi"] = phi
        return _link_t_sdf(phi, xx, yy, ex, ey)
    raise ValueError(f"unsupported obstacle_geometry {geom!r}")


def bouzidi_q_planes(
    mask: np.ndarray, geom: Optional[dict] = None, dtype=np.float32
) -> np.ndarray:
    """[8, H, W] sub-grid wall fractions for Bouzidi interpolated bounce-back.

    Plane j-1 (j = 1..8) holds, for every fluid cell c whose +e_j neighbor
    is solid, the smallest t in (0, 1] with c + t e_j on the wall surface.
    Where the fraction is undefined (no root, or a q < 1/2 link whose
    interpolation cell c - e_j is solid) it falls back to q = 1/2, where the
    scheme is exactly half-way bounce-back.

    ``geom`` (lattice cell-center coordinates) is the analytic surface:
    ``{"shape": "cylinder", "cx", "cy", "r"}``, ``"rect"`` (cx, cy, w, h,
    angle_deg), ``"triangle"`` (cx, cy, size, angle_deg, orientation),
    ``"polygon"`` (vertices), ``"union"`` (parts; q = min over parts), or
    ``"sdf"`` / None: the zero level of the mask's own signed distance.
    """
    if geom is None:
        geom = {"shape": "sdf"}
    solid = np.asarray(mask) > 0.5
    h, w = solid.shape
    yy, xx = np.mgrid[0:h, 0:w]
    xx = xx.astype(np.float64)
    yy = yy.astype(np.float64)

    def shifted_solid(ddy, ddx):
        """solid[y + ddy, x + ddx], out-of-bounds -> True (treat the domain
        edge like a wall so no formula reaches past it)."""
        out = np.ones_like(solid)
        ys = slice(max(0, -ddy), min(h, h - ddy))
        xs = slice(max(0, -ddx), min(w, w - ddx))
        out[ys, xs] = solid[
            max(0, ddy) : max(0, ddy) + (ys.stop - ys.start),
            max(0, ddx) : max(0, ddx) + (xs.stop - xs.start),
        ]
        return out

    phi_cache: dict = {}
    q = np.full((8, h, w), 0.5, np.float64)
    for j in range(1, 9):
        ex, ey = int(E[j, 0]), int(E[j, 1])
        link = (~solid) & shifted_solid(ey, ex)  # fluid c, solid c + e_j
        t = _geom_link_t(geom, mask, xx, yy, ex, ey, phi_cache)
        t = np.where(np.isfinite(t), t, 0.5)  # no root -> half-way fallback
        # the q < 1/2 two-point formula interpolates with cell c - e_j;
        # if that cell is solid the link degrades to half-way
        behind_solid = shifted_solid(-ey, -ex)
        t = np.where((t < 0.5) & behind_solid, 0.5, t)
        q[j - 1] = np.where(link, t, 0.5)
    return q.astype(dtype)


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


def link_bounce(f: torch.Tensor, fs: torch.Tensor, solid: torch.Tensor,
                q: Optional[torch.Tensor] = None) -> torch.Tensor:
    """``fs`` with the links whose pull source c - e_k is solid replaced:
    half-way bounce-back (``q`` None) returns this cell's own f_opp(c) from
    the previous field ``f``; Bouzidi interpolated bounce-back (``q`` the
    [8, H, W] wall fractions) puts the wall at fraction q along the link
    j = opp(k):
      q < 1/2:  f_k <- 2q f_j(c) + (1 - 2q) f_j(c + e_k)
      q >= 1/2: f_k <- f_j(c)/(2q) + (2q - 1)/(2q) f_k(c)
    q = 1/2 gives f_j(c) exactly, the half-way value. Applied on every cell,
    solid ones included (their f is overwritten afterwards)."""
    return link_bounce_at(
        lambda k, dy, dx: shift2d(f[k], dy, dx, 0.0) if dy or dx else f[k],
        lambda dy, dx: shift2d(solid, dy, dx, False), fs, q,
    )


def link_bounce_at(f_at, solid_at, fs: torch.Tensor, q: Optional[torch.Tensor] = None):
    """``link_bounce`` with the neighbourhood read through accessors, for a
    block that holds its neighbours' cells in a halo: ``f_at(k, dy, dx)`` is
    f_k of the previous field at c + (dy, dx) and ``solid_at(dy, dx)`` the
    solid flag there, each shaped like ``fs[0]``."""
    planes = [fs[0]]
    for k in range(1, 9):
        ex, ey = int(E[k, 0]), int(E[k, 1])
        j = int(OPP[k])
        nb_solid = solid_at(-ey, -ex)
        if q is None:
            planes.append(torch.where(nb_solid, f_at(j, 0, 0), fs[k]))
            continue
        qj = q[j - 1]
        f_j = f_at(j, 0, 0)
        f_j_up = f_at(j, ey, ex)  # f_j at c + e_k = c - e_j
        lo = 2.0 * qj * f_j + (1.0 - 2.0 * qj) * f_j_up
        hi = f_j / (2.0 * qj) + (2.0 * qj - 1.0) / (2.0 * qj) * f_at(k, 0, 0)
        planes.append(torch.where(nb_solid, torch.where(qj < 0.5, lo, hi), fs[k]))
    return torch.stack(planes)


def full_way_bounce(fs: torch.Tensor, f_post: torch.Tensor, solid: torch.Tensor):
    """Full-way bounce-back: on solid cells the streamed populations leave
    reversed, in place of the collision output."""
    f_bb = torch.stack([fs[int(OPP[k])] for k in range(9)])
    return torch.where(solid[None], f_bb, f_post)


def collide_stream_full(f: torch.Tensor, p: CaseParams):
    """Fused pull-stream + MRT-LES collision over the full grid, with the
    obstacle scheme's link substitution or full-way bounce."""
    fs = pull_stream(f)
    solid = p.mask > 0.5
    if p.halfway_obstacle:
        fs = link_bounce(f, fs, solid)
    if p.bouzidi_obstacle:
        fs = link_bounce(f, fs, solid, p.bouzidi_q)
    f_post, rho, ux, uy = mrt_collide_arrays(
        fs, p.damping, p.tau0, p.cs_factor, p.s_ghost, p.use_les
    )
    if p.bounce_obstacle:
        f_post = full_way_bounce(fs, f_post, solid)
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


def force_on_obstacle_bouzidi(
    f_post: torch.Tensor, mask: torch.Tensor, q_planes: torch.Tensor
) -> torch.Tensor:
    """Momentum-exchange force for Bouzidi bounce-back -> [2] (fx, fy).

    Per boundary link (fluid c, solid c + e_j) the wall absorbs f_j(c) and
    emits the interpolated return f_ret (the streaming step's formulas), so
    the link carries (f_j + f_ret) e_j; at q = 1/2 this is the half-way 2 f_j.
    """
    solid = mask > 0.5
    zero = torch.zeros((), dtype=f_post.dtype, device=f_post.device)
    fx = zero
    fy = zero
    for j in range(1, 9):
        ex, ey = int(E[j, 0]), int(E[j, 1])
        k = int(OPP[j])
        nb_solid = shift2d(solid, ey, ex, False)
        q = q_planes[j - 1]
        f_j = f_post[j]
        f_j_up = shift2d(f_post[j], -ey, -ex, 0.0)  # f_j at c - e_j
        lo = 2.0 * q * f_j + (1.0 - 2.0 * q) * f_j_up
        hi = f_j / (2.0 * q) + (2.0 * q - 1.0) / (2.0 * q) * f_post[k]
        f_ret = torch.where(q < 0.5, lo, hi)
        s = torch.where((~solid) & nb_solid, f_j + f_ret, zero).sum()
        fx = fx + s * ex
        fy = fy + s * ey
    return torch.stack([fx, fy])


def obstacle_force(
    f_post: torch.Tensor, p: CaseParams, mask: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Momentum-exchange force with the scheme matching the obstacle mode.

    ``mask`` overrides ``p.mask`` (the DFG validation measures the cylinder
    alone)."""
    m = p.mask if mask is None else mask
    if p.bouzidi_obstacle:
        return force_on_obstacle_bouzidi(f_post, m, p.bouzidi_q)
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
