"""D2Q9 MRT-LES lattice Boltzmann, written plainly.

One lattice update, as the configuration defines it:

1. pull streaming, ``fs_k(x) = f_k(x - e_k)``, with Bouzidi interpolated
   bounce-back substituted on the links whose pull source is solid where the
   obstacle rule says so;
2. the Lallemand-Luo MRT collision in moment space, ``f* = fs - M^-1 S (m -
   m_eq)``, the stress moments relaxed at ``1 / tau_eff`` (Smagorinsky LES
   plus the sponge's damping) and the ghost moments at ``s_ghost``;
3. the interior takes the collision output; the boundary ring keeps the
   previous values until the edge rules overwrite them: left and right
   columns on the inner rows, then the top and bottom rows with their
   corners, all read from the neighbouring column or row of the new field;
4. solid cells take the rest equilibrium ``w rho`` and zero velocity.

``f_post`` is the collision output of the interior, its ring left at the
first state's, as the dataset's moments and the momentum-exchange force
read it. The inlet ramps in over ``warmup_steps`` as ``1 - cos(pi/2
min(1, step / warmup))`` with the configuration's truncated pi, 3.14159265.

Every function takes and returns plain tensors; ``dtype`` is float64 unless
a caller asks for another (the lower-precision controls do).
"""

from __future__ import annotations

import dataclasses
from typing import Dict, Optional

import numpy as np
import torch

# velocity set k: 0 rest, 1 E, 2 N, 3 W, 4 S, 5 NE, 6 NW, 7 SW, 8 SE
EX = (0, 1, 0, -1, 0, 1, -1, -1, 1)
EY = (0, 0, 1, 0, -1, 1, 1, -1, -1)
OPP = (0, 3, 4, 1, 2, 7, 8, 5, 6)
WEIGHTS = (4 / 9,) + (1 / 9,) * 4 + (1 / 36,) * 4
PI_TRUNC = 3.14159265

# Lallemand & Luo (2000): rows rho, e, eps, jx, qx, jy, qy, pxx, pxy
M_ROWS = np.array([
    [1, 1, 1, 1, 1, 1, 1, 1, 1],
    [-4, -1, -1, -1, -1, 2, 2, 2, 2],
    [4, -2, -2, -2, -2, 1, 1, 1, 1],
    [0, 1, 0, -1, 0, 1, -1, -1, 1],
    [0, -2, 0, 2, 0, 1, -1, -1, 1],
    [0, 0, 1, 0, -1, 1, 1, -1, -1],
    [0, 0, -2, 0, 2, 1, 1, -1, -1],
    [0, 1, -1, 1, -1, 0, 0, 0, 0],
    [0, 0, 0, 0, 0, 1, -1, 1, -1],
], dtype=np.float64)
M_INV = np.linalg.inv(M_ROWS)

# edge rule codes of boundary_condition.type, sides [left, top, right, bottom]
INLET, OUTLET, FREE_SLIP, VEL_EQ, VEL_NEBB = 0, 1, 2, 3, 4


@dataclasses.dataclass
class Case:
    """What one case's step needs, worked out from its configuration."""

    solid: torch.Tensor          # bool [H, W]
    damping: torch.Tensor        # [H, W]
    tau0: float
    cs_factor: float             # 18 C_s^2
    s_ghost: float
    rho_in: float
    rho_out: float
    warmup: float
    bc_type: tuple
    bc_value: np.ndarray         # [4, 2], on the host
    use_les: bool
    profile: Optional[torch.Tensor] = None   # [H] left-edge velocity profile
    bouzidi_q: Optional[torch.Tensor] = None  # [9, H, W], plane j the wall fraction


def sponge(nx: int, ny: int, zones: dict) -> np.ndarray:
    """Quadratic tau damping near the edges: strength * max(cx^2, cy^2); the
    outlet side wins over the inlet side, the bottom over the top."""
    w_in, w_out, w_top, w_bot = (max(1, int(zones[k])) for k in
                                 ("sponge_in", "sponge_out", "sponge_top", "sponge_bot"))
    s = float(zones["sponge_strength"])
    x = np.arange(nx, dtype=np.float64)
    y = np.arange(ny, dtype=np.float64)
    dx = np.zeros(nx)
    dx[x < w_in] = s * ((w_in - x[x < w_in]) / w_in) ** 2
    dx[x > nx - w_out] = s * ((x[x > nx - w_out] - (nx - w_out)) / w_out) ** 2
    dy = np.zeros(ny)
    dy[y > ny - w_top] = s * ((y[y > ny - w_top] - (ny - w_top)) / w_top) ** 2
    dy[y < w_bot] = s * ((w_bot - y[y < w_bot]) / w_bot) ** 2
    return np.maximum(dx[None, :], dy[:, None])


def parabola(ny: int, u_max: float) -> np.ndarray:
    """4 u_max y (h - y) / h^2 over rows 0..ny-1, h = ny - 1."""
    y = np.arange(ny, dtype=np.float64)
    h = ny - 1.0
    return 4.0 * u_max * y * (h - y) / (h * h)


def cylinder_fractions(solid: np.ndarray, cx: float, cy: float, r: float) -> np.ndarray:
    """[9, H, W] Bouzidi wall fractions of a circle: for a fluid cell c whose
    neighbour c + e_j is solid (beyond the grid counts as solid), the
    smallest t in (0, 1] with c + t e_j on the circle; 1/2 where there is
    none, and where t < 1/2 needs c - e_j and that cell is solid. 1/2
    elsewhere."""
    h, w = solid.shape
    padded = np.pad(solid, 1, constant_values=True)
    q = np.full((9, h, w), 0.5)
    yy, xx = np.mgrid[0:h, 0:w].astype(np.float64)
    for j in range(1, 9):
        ex, ey = EX[j], EY[j]
        ahead = padded[1 + ey:1 + ey + h, 1 + ex:1 + ex + w]
        behind = padded[1 - ey:1 - ey + h, 1 - ex:1 - ex + w]
        link = ~solid & ahead
        dx, dy = xx[link] - cx, yy[link] - cy
        a = float(ex * ex + ey * ey)
        b = 2.0 * (dx * ex + dy * ey)
        c = dx * dx + dy * dy - r * r
        disc = b * b - 4.0 * a * c
        root = np.sqrt(np.maximum(disc, 0.0))
        t1, t2 = (-b - root) / (2 * a), (-b + root) / (2 * a)
        ok1 = (disc >= 0) & (t1 > 0) & (t1 <= 1)
        ok2 = (disc >= 0) & (t2 > 0) & (t2 <= 1)
        t = np.where(ok1, t1, np.where(ok2, t2, 0.5))
        t = np.where((t < 0.5) & behind[link], 0.5, t)
        q[j][link] = t
    return q


def make_case(config: dict, mask: np.ndarray, device="cpu", dtype=torch.float64) -> Case:
    """A case from its configuration dict and its [H, W] mask (1 = solid)."""
    sim, zones, bc = config["simulation"], config["domain_zones"], config["boundary_condition"]
    ny, nx = int(sim["ny"]), int(sim["nx"])
    solid_np = np.asarray(mask) > 0.5
    if solid_np.shape != (ny, nx):
        raise ValueError(f"mask {solid_np.shape} does not fit the grid ({ny}, {nx})")
    types = tuple(int(t) for t in bc["type"])
    values = np.asarray(bc["value"], np.float64)
    t = lambda a: torch.as_tensor(np.asarray(a), dtype=dtype, device=device)  # noqa: E731
    profile = None
    if types[0] in (VEL_EQ, VEL_NEBB):
        # the configuration's velocity is float32; the profile is of that value
        profile = t(parabola(ny, float(np.float32(values[0][0]))))
    bouzidi = None
    obstacle = bc.get("obstacle", "equilibrium")
    if obstacle == "bounce_back_bouzidi":
        geom = bc["obstacle_geometry"]
        if geom.get("shape") != "cylinder":
            raise ValueError("the reference's Bouzidi fractions know the cylinder only")
        bouzidi = t(cylinder_fractions(solid_np, float(geom["cx"]), float(geom["cy"]),
                                       float(geom["r"])))
    elif obstacle != "equilibrium":
        raise ValueError(f"obstacle rule {obstacle!r} is not in the reference")
    cs = float(sim["smagorinsky_constant"])
    return Case(
        solid=torch.as_tensor(solid_np, device=device),
        damping=t(sponge(nx, ny, zones)),
        tau0=3.0 * float(sim["nu"]) + 0.5, cs_factor=18.0 * cs * cs,
        s_ghost=float(sim["ghost_moments_s"]), rho_in=float(sim["rho_in"]),
        rho_out=float(sim["rho_out"]), warmup=float(sim["warmup_steps"]),
        bc_type=types, bc_value=values, use_les=cs > 0.001,
        profile=profile, bouzidi_q=bouzidi)


_WEIGHTS_ON = {}


def weights(device, dtype=torch.float64) -> torch.Tensor:
    """[9, 1, 1] w_k on ``device``, made once a device and type: a copy
    from the host on every step would wait for the device each time."""
    key = (torch.device(device), dtype)
    if key not in _WEIGHTS_ON:
        _WEIGHTS_ON[key] = torch.tensor(WEIGHTS, dtype=dtype, device=device).reshape(9, 1, 1)
    return _WEIGHTS_ON[key]


def equilibrium(rho, ux, uy):
    """[9, ...] w_k rho (1 + 3 e.u + 4.5 (e.u)^2 - 1.5 u.u)."""
    usq = ux * ux + uy * uy
    out = []
    for k in range(9):
        eu = EX[k] * ux + EY[k] * uy
        out.append(WEIGHTS[k] * rho * (1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * usq))
    return torch.stack(out)


def rest_state(ny: int, nx: int, device="cpu", dtype=torch.float64) -> Dict[str, torch.Tensor]:
    """rho = 1, u = 0, f = f_post = w."""
    f = weights(device, dtype).expand(9, ny, nx).clone()
    return {"f": f, "f_post": f.clone(), "rho": torch.ones(ny, nx, dtype=dtype, device=device),
            "u": torch.zeros(2, ny, nx, dtype=dtype, device=device)}


def ramp(step: int, warmup: float) -> float:
    return 1.0 - float(np.cos(0.5 * PI_TRUNC * min(1.0, step / warmup)))


def stream(f: torch.Tensor) -> torch.Tensor:
    """fs_k(y, x) = f_k(y - ey, x - ex); what wraps round lands on the ring."""
    return torch.stack([torch.roll(f[k], (EY[k], EX[k]), dims=(0, 1)) for k in range(9)])


def at(a: torch.Tensor, dy: int, dx: int, fill) -> torch.Tensor:
    """a[..., y + dy, x + dx], ``fill`` beyond the grid."""
    h, w = a.shape[-2:]
    out = torch.full_like(a, fill)
    out[..., max(0, -dy):h - max(0, dy), max(0, -dx):w - max(0, dx)] = \
        a[..., max(0, dy):h - max(0, -dy), max(0, dx):w - max(0, -dx)]
    return out


def bouzidi_links(f: torch.Tensor, fs: torch.Tensor, case: Case) -> torch.Tensor:
    """fs with each population k whose source c - e_k is solid replaced by
    the interpolated return of j = opp(k) off a wall at fraction q_j(c):
    q < 1/2: 2q f_j(c) + (1 - 2q) f_j(c - e_j); q >= 1/2: f_j(c) / (2q) +
    (2q - 1) / (2q) f_k(c)."""
    out = fs.clone()
    for k in range(1, 9):
        j = OPP[k]
        src_solid = at(case.solid, -EY[k], -EX[k], False)
        q = case.bouzidi_q[j]
        lo = 2 * q * f[j] + (1 - 2 * q) * at(f[j], -EY[j], -EX[j], 0.0)
        hi = f[j] / (2 * q) + (2 * q - 1) / (2 * q) * f[k]
        out[k] = torch.where(src_solid, torch.where(q < 0.5, lo, hi), fs[k])
    return out


def _mm(mat: np.ndarray, planes: torch.Tensor) -> torch.Tensor:
    """[9, 9] x [9, H, W] -> [9, H, W] in ``planes``' dtype, never in TF32."""
    m = torch.as_tensor(mat, dtype=planes.dtype, device=planes.device)
    tf32 = torch.backends.cuda.matmul.allow_tf32
    torch.backends.cuda.matmul.allow_tf32 = False
    try:
        return torch.einsum("ij,jhw->ihw", m, planes)
    finally:
        torch.backends.cuda.matmul.allow_tf32 = tf32


def collide(fs: torch.Tensor, case: Case):
    """MRT-LES collision of a streamed field: (f*, rho, ux, uy)."""
    m = _mm(M_ROWS, fs)
    rho = m[0].clone()
    inv = torch.where(rho > 0, 1.0 / torch.where(rho > 0, rho, torch.ones_like(rho)),
                      torch.zeros_like(rho))
    ux, uy = m[3] * inv, m[5] * inv
    u2 = ux * ux + uy * uy
    d = m
    d[1] -= rho * (-2 + 3 * u2)
    d[2] -= rho * (1 - 3 * u2)
    d[4] += rho * ux
    d[6] += rho * uy
    d[7] -= rho * (ux * ux - uy * uy)
    d[8] -= rho * ux * uy
    tau = torch.full_like(rho, case.tau0)
    if case.use_les:
        neq = torch.sqrt(2 * d[7] * d[7] + 2 * d[8] * d[8])
        tau = case.tau0 + 0.5 * (torch.sqrt(case.tau0 ** 2 + case.cs_factor * neq * inv)
                                 - case.tau0)
    s_eff = 1.0 / (tau + case.damping)
    # rho, jx and jy are conserved; the ghost moments relax at s_ghost, the
    # stresses at 1 / tau_eff
    d[0] = 0
    d[3] = 0
    d[5] = 0
    d[1:3] *= case.s_ghost
    d[4] *= case.s_ghost
    d[6] *= case.s_ghost
    d[7:9] *= s_eff
    return fs - _mm(M_INV, d), rho, ux, uy


def _unit(ux, uy):
    return equilibrium(torch.ones_like(ux), ux, uy)


def edges(f, rho, u, step: int, case: Case) -> None:
    """The edge rules, in place: left and right columns on the inner rows
    from columns 1 and W-2, then the top and bottom rows, corners included,
    from rows H-2 and 1 as the columns left them."""
    r = ramp(step, case.warmup)
    t_left, t_top, t_right, t_bottom = case.bc_type
    inner = slice(1, -1)

    def put_col(x, fb, rb, uxb, uyb):
        f[:, inner, x], rho[inner, x], u[0, inner, x], u[1, inner, x] = fb, rb, uxb, uyb

    fn, rn, uxn, uyn = f[:, inner, 1], rho[inner, 1], u[0, inner, 1], u[1, inner, 1]
    if t_left == INLET:
        # Zou-He pressure inlet at the ramped density, from column 1
        rc = 1.0 + (case.rho_in - 1.0) * r
        ux = 1.0 - (fn[0] + fn[2] + fn[4] + 2 * (fn[3] + fn[6] + fn[7])) / rc
        fb = rc * _unit(ux, torch.zeros_like(ux))
        fb[1] = fn[3] + (2 / 3) * rc * ux
        fb[5] = fn[7] - 0.5 * (fn[2] - fn[4]) + rc * ux / 6
        fb[8] = fn[6] + 0.5 * (fn[2] - fn[4]) + rc * ux / 6
        put_col(0, fb, rc, ux, torch.zeros_like(ux))
    elif t_left in (VEL_EQ, VEL_NEBB):
        ux = case.profile[inner] * r
        zero = torch.zeros_like(ux)
        if t_left == VEL_EQ:
            put_col(0, _unit(ux, zero), torch.ones_like(ux), ux, zero)
        else:
            put_col(0, rn * (_unit(ux, zero) - _unit(uxn, uyn)) + fn, rn, ux, zero)
    elif t_left == FREE_SLIP:
        zero = torch.zeros_like(uxn)
        put_col(0, rn * (_unit(zero, uyn) - _unit(uxn, uyn)) + fn, rn, zero, uyn)

    fn, rn, uxn, uyn = f[:, inner, -2], rho[inner, -2], u[0, inner, -2], u[1, inner, -2]
    if t_right == OUTLET:
        # Zou-He pressure outlet; where the flow would come back in, the
        # neighbour's state at the outlet density instead
        ro = case.rho_out
        ux = -1.0 + (fn[0] + fn[2] + fn[4] + 2 * (fn[1] + fn[5] + fn[8])) / ro
        fz = ro * _unit(ux, torch.zeros_like(ux))
        fz[3] = fn[1] - (2 / 3) * ro * ux
        fz[6] = fn[8] - 0.5 * (fn[2] - fn[4]) - ro * ux / 6
        fz[7] = fn[5] + 0.5 * (fn[2] - fn[4]) - ro * ux / 6
        back = ux < 0
        fb = torch.where(back, (ro - rn) * _unit(uxn, uyn) + fn, fz)
        put_col(-1, fb, torch.full_like(rn, ro), torch.where(back, uxn, ux),
                torch.where(back, uyn, torch.zeros_like(uyn)))
    elif t_right == INLET:
        v = case.bc_value[2] * r
        uxb, uyb = torch.full_like(uxn, float(v[0])), torch.full_like(uyn, float(v[1]))
        put_col(-1, rn * (_unit(uxb, uyb) - _unit(uxn, uyn)) + fn, rn, uxb, uyb)
    elif t_right == FREE_SLIP:
        zero = torch.zeros_like(uxn)
        put_col(-1, rn * (_unit(zero, uyn) - _unit(uxn, uyn)) + fn, rn, zero, uyn)

    for side, row, nbr in ((t_top, -1, -2), (t_bottom, 0, 1)):
        fn, rn, uxn, uyn = f[:, nbr, :], rho[nbr, :], u[0, nbr, :], u[1, nbr, :]
        if side == FREE_SLIP:
            uxb, uyb = uxn, torch.zeros_like(uyn)
        elif side == INLET:
            v = case.bc_value[1 if row == -1 else 3] * r
            uxb, uyb = torch.full_like(uxn, float(v[0])), torch.full_like(uyn, float(v[1]))
        else:
            continue
        fb = rn * (_unit(uxb, uyb) - _unit(uxn, uyn)) + fn
        f[:, row, :], rho[row, :], u[0, row, :], u[1, row, :] = fb, rn.clone(), uxb, uyb


def _keep_ring(a: torch.Tensor, b: torch.Tensor) -> None:
    """a's boundary ring (first and last row and column) from b, in place."""
    a[..., 0, :], a[..., -1, :] = b[..., 0, :], b[..., -1, :]
    a[..., :, 0], a[..., :, -1] = b[..., :, 0], b[..., :, -1]


def step(state: Dict[str, torch.Tensor], step_no: int, case: Case) -> Dict[str, torch.Tensor]:
    """Lattice update number ``step_no`` (the first is 1) of ``state``."""
    f = state["f"]
    fs = stream(f)
    if case.bouzidi_q is not None:
        fs = bouzidi_links(f, fs, case)
    new_f, rho, ux, uy = collide(fs, case)
    del fs
    _keep_ring(new_f, f)
    f_post = new_f.clone()
    _keep_ring(f_post, state["f_post"])
    u = torch.stack([ux, uy])
    _keep_ring(rho, state["rho"])
    _keep_ring(u, state["u"])
    edges(new_f, rho, u, step_no, case)
    new_f = torch.where(case.solid, weights(f.device, f.dtype) * rho, new_f)
    u = torch.where(case.solid, torch.zeros_like(u), u)
    return {"f": new_f, "f_post": f_post, "rho": rho, "u": u}


def chunk(state: Dict[str, torch.Tensor], step0: int, n: int, case: Case,
          store=None) -> Dict[str, torch.Tensor]:
    """Steps step0 + 1 .. step0 + n. ``store`` (a dtype) rounds the
    deviation f - w to it after each of the first n - 1 steps, as a state
    kept in that storage between steps would be: the lower-precision
    control of a program that stores its state so."""
    w = weights(state["f"].device, state["f"].dtype)
    for i in range(n):
        state = step(state, step0 + i + 1, case)
        if store is not None and i < n - 1:
            state["f"] = (state["f"] - w).to(store).to(w.dtype) + w
    return state


def force_equilibrium(f_post: torch.Tensor, solid: torch.Tensor) -> torch.Tensor:
    """Momentum exchange on the solid cells: for each solid c and k with a
    fluid neighbour c + e_k on the grid, 2 f_opp(k)(c + e_k) (-e_k)."""
    fluid = (~solid).to(f_post.dtype)
    fx = f_post.new_zeros(())
    fy = f_post.new_zeros(())
    for k in range(1, 9):
        s = (solid * 2 * at(f_post[OPP[k]], EY[k], EX[k], 0.0) *
             at(fluid, EY[k], EX[k], 0.0)).sum()
        fx, fy = fx - EX[k] * s, fy - EY[k] * s
    return torch.stack([fx, fy])


def force_bouzidi(f_post: torch.Tensor, solid: torch.Tensor, q: torch.Tensor) -> torch.Tensor:
    """Momentum exchange across each Bouzidi link (fluid c, solid c + e_j on
    the grid): (f_j(c) + its interpolated return) e_j."""
    fx = f_post.new_zeros(())
    fy = f_post.new_zeros(())
    for j in range(1, 9):
        k = OPP[j]
        link = ~solid & at(solid, EY[j], EX[j], False)
        qj = q[j]
        lo = 2 * qj * f_post[j] + (1 - 2 * qj) * at(f_post[j], -EY[j], -EX[j], 0.0)
        hi = f_post[j] / (2 * qj) + (2 * qj - 1) / (2 * qj) * f_post[k]
        s = torch.where(link, f_post[j] + torch.where(qj < 0.5, lo, hi), 0.0).sum()
        fx, fy = fx + EX[j] * s, fy + EY[j] * s
    return torch.stack([fx, fy])


def max_speed(u: torch.Tensor) -> torch.Tensor:
    return torch.sqrt(u[0] * u[0] + u[1] * u[1]).max()


def moments(f_post: torch.Tensor) -> torch.Tensor:
    """[9, H, W] MRT moments M f."""
    return _mm(M_ROWS, f_post)


def stable(force, max_v, step_no: int, warmup: float, v_limit=0.25, f_limit=1e6) -> bool:
    """The run's breaker: finite force within 1e6, finite speed, and after
    the warm-up a speed of at most 0.25."""
    force = [float(x) for x in force]
    v = float(max_v)
    if not all(np.isfinite(force)) or max(abs(x) for x in force) > f_limit:
        return False
    if not np.isfinite(v):
        return False
    return not (step_no > warmup and v > v_limit)
