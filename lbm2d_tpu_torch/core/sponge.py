"""Omni-directional sponge-layer damping profile.

The reference adds a quadratic tau damping near every domain edge inside the
collision kernel (LBM2D_MRT_LES.py:353-380). The profile depends only on the
cell coordinate and the static sponge config, so in the TPU build it is
precomputed once as a ``[H, W]`` field and added to tau_eff inside the fused
step -- no per-cell branching at runtime.

Semantics replicated exactly:
  * each width is clamped to >= 1 (LBM2D_MRT_LES.py:90-93),
  * x damping: outlet side (x > nx - w_out) wins over inlet side (x < w_in),
  * y damping: bottom (y < w_bot) wins over top (y > ny - w_top),
  * total damping = strength * max(coord_x^2, coord_y^2).
"""

from __future__ import annotations

import numpy as np


def sponge_damping_field(
    nx: int,
    ny: int,
    sponge_in: int,
    sponge_out: int,
    sponge_top: int,
    sponge_bot: int,
    strength: float,
    dtype=np.float32,
) -> np.ndarray:
    """Return damping [ny, nx] to be added to tau_eff, indexed [y, x]."""
    w_in = max(1, int(sponge_in))
    w_out = max(1, int(sponge_out))
    w_top = max(1, int(sponge_top))
    w_bot = max(1, int(sponge_bot))

    x = np.arange(nx, dtype=np.float64)
    y = np.arange(ny, dtype=np.float64)

    coord_out = (x - (nx - w_out)) / w_out
    coord_in = (w_in - x) / w_in
    dx = np.where(
        x > (nx - w_out),
        strength * coord_out * coord_out,
        np.where(x < w_in, strength * coord_in * coord_in, 0.0),
    )

    coord_bot = (w_bot - y) / w_bot
    coord_top = (y - (ny - w_top)) / w_top
    dy = np.where(
        y < w_bot,
        strength * coord_bot * coord_bot,
        np.where(y > (ny - w_top), strength * coord_top * coord_top, 0.0),
    )

    damping = np.maximum(dx[None, :], dy[:, None])
    return damping.astype(dtype)
