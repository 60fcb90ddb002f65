"""D2Q9 lattice constants and equilibrium functions (PyTorch).

Counterpart of ``lbm2d_tpu/core/lattice.py``: the Lallemand-Luo 9x9 moment
matrix, the D2Q9 velocity set and weights, the velocity-space equilibrium
``f_eq`` and the moment-space equilibrium ``m_eq``. Fields are channel-major
``[9, H, W]`` indexed ``[k, y, x]``.

Every function keeps the reference's evaluation order term by term, so an
f32 run rounds exactly like the JAX package and like the CUDA kernels in
``csrc/`` (built with ``-fmad=false``). The moment transforms are integer
add/subtract combinations, never a matmul: a reduced-precision product would
cost ~1e-3 on rho and flip the Zou-He pressure physics.

Moment ordering (Lallemand & Luo 2000):
    0 rho, 1 e, 2 eps, 3 jx, 4 qx, 5 jy, 6 qy, 7 pxx, 8 pxy
"""

from __future__ import annotations

import numpy as np
import torch

# Discrete velocity set e_k = (ex, ey). Index k: 0 rest, 1 E, 2 N, 3 W, 4 S,
# 5 NE, 6 NW, 7 SW, 8 SE.
E = np.array(
    [
        [0, 0],
        [1, 0],
        [0, 1],
        [-1, 0],
        [0, -1],
        [1, 1],
        [-1, 1],
        [-1, -1],
        [1, -1],
    ],
    dtype=np.int32,
)

# Opposite-direction index: OPP[k] is the k' with e_{k'} = -e_k.
OPP = np.array([0, 3, 4, 1, 2, 7, 8, 5, 6], dtype=np.int32)

# Quadrature weights, kept in f64 and cast at each use: an f32-rounded 1/36
# stored once flips the Zou-He backflow branch (docs/DESIGN.md section 2).
W = np.array(
    [4.0 / 9.0] + [1.0 / 9.0] * 4 + [1.0 / 36.0] * 4,
    dtype=np.float64,
)

# Lallemand-Luo moment transform, rows (rho, e, eps, jx, qx, jy, qy, pxx,
# pxy) in terms of f_0..f_8.
M = np.array(
    [
        [1, 1, 1, 1, 1, 1, 1, 1, 1],
        [-4, -1, -1, -1, -1, 2, 2, 2, 2],
        [4, -2, -2, -2, -2, 1, 1, 1, 1],
        [0, 1, 0, -1, 0, 1, -1, -1, 1],
        [0, -2, 0, 2, 0, 1, -1, -1, 1],
        [0, 0, 1, 0, -1, 1, 1, -1, -1],
        [0, 0, -2, 0, 2, 1, 1, -1, -1],
        [0, 1, -1, 1, -1, 0, 0, 0, 0],
        [0, 0, 0, 0, 0, 1, -1, 1, -1],
    ],
    dtype=np.float64,
)

M_INV = np.linalg.inv(M)

# The reference ramps the inlet with this truncated literal for pi; the same
# constant keeps warmup ramps equal in f32.
PI_REF = 3.14159265

# 36 * M_INV has exact small-integer entries.
M_INV_X36 = np.round(M_INV * 36.0).astype(np.int64)
assert np.abs(M_INV_X36 / 36.0 - M_INV).max() < 1e-12


def _inner(ex: int, ey: int, ux, uy, usq):
    """((1 + 3 e.u) + 4.5 (e.u)^2) - 1.5 u.u, in the reference's order."""
    if ex == 0 and ey == 0:
        return 1.0 - 1.5 * usq
    if ey == 0:
        eu = float(ex) * ux
    elif ex == 0:
        eu = float(ey) * uy
    else:
        eu = float(ex) * ux + float(ey) * uy
    return 1.0 + 3.0 * eu + 4.5 * eu * eu - 1.5 * usq


def f_eq(rho, ux, uy):
    """Velocity-space equilibrium, [9, *S] for fields of shape S.

    f_eq_k = w_k * rho * (1 + 3 e.u + 4.5 (e.u)^2 - 1.5 u.u)
    """
    usq = ux * ux + uy * uy
    return torch.stack(
        [
            float(W[k]) * rho * _inner(int(E[k, 0]), int(E[k, 1]), ux, uy, usq)
            for k in range(9)
        ]
    )


def f_eq_unit(ux, uy):
    """f_eq / rho: the equilibrium's velocity factor g_k(u), [9, *S]."""
    usq = ux * ux + uy * uy
    return torch.stack(
        [
            float(W[k]) * _inner(int(E[k, 0]), int(E[k, 1]), ux, uy, usq)
            for k in range(9)
        ]
    )


def _three_inner(v):
    """Inner values for e = 0, +1, -1 along one axis (the other u is 0)."""
    usq = v * v
    inner0 = 1.0 - 1.5 * usq
    innp = 1.0 + 3.0 * v + 4.5 * v * v - 1.5 * usq
    neg = -v
    innm = 1.0 + 3.0 * neg + 4.5 * neg * neg - 1.5 * usq
    return {0: inner0, 1: innp, -1: innm}


def f_eq_unit_x(ux):
    """g_k(ux, 0): three distinct inner values, equal to f_eq_unit(ux, 0)."""
    by_ex = _three_inner(ux)
    return torch.stack([float(W[k]) * by_ex[int(E[k, 0])] for k in range(9)])


def f_eq_unit_y(uy):
    """g_k(0, uy): three distinct inner values along e_y."""
    by_ey = _three_inner(uy)
    return torch.stack([float(W[k]) * by_ey[int(E[k, 1])] for k in range(9)])


def m_eq(rho, ux, uy):
    """Moment-space equilibrium, [9, *S]."""
    u2 = ux * ux + uy * uy
    return torch.stack(
        [
            rho,
            rho * (-2.0 + 3.0 * u2),
            rho * (1.0 - 3.0 * u2),
            rho * ux,
            -rho * ux,
            rho * uy,
            -rho * uy,
            rho * (ux * ux - uy * uy),
            rho * ux * uy,
        ]
    )


def _int_combo(coeffs_int: np.ndarray, rows, scale: float = 1.0):
    """Apply an integer-coefficient 9x9 matrix to 9 planes by adds only."""
    outs = []
    for r in range(9):
        acc = None
        for c in range(9):
            k = int(coeffs_int[r, c])
            if k == 0:
                continue
            term = rows[c] if k == 1 else (-rows[c] if k == -1 else k * rows[c])
            acc = term if acc is None else acc + term
        if acc is None:
            acc = torch.zeros_like(rows[0])
        if scale != 1.0:
            acc = acc * torch.tensor(scale, dtype=acc.dtype, device=acc.device)
        outs.append(acc)
    return torch.stack(outs)


def moments_from_f(f):
    """Project f [9, ...] to MRT moment space [9, ...] (m = M f), exactly."""
    return _int_combo(M.astype(np.int64), [f[k] for k in range(9)])


def f_from_moments(m_star):
    """Inverse transform f = (1/36) * (36 M^-1) m."""
    return _int_combo(M_INV_X36, [m_star[k] for k in range(9)], scale=1.0 / 36.0)
