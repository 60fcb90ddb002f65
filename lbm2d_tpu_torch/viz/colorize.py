"""Field-to-RGB colorization (reference visualization/color_utils.py parity).

Velocity magnitude -> plasma; vorticity -> custom 5-stop
yellow-orange-black-green-cyan diverging map; pressure -> RdBu_r;
obstacles painted grey (0.5).

The colours come from the 256-entry LUTs shipped in
``data/render_luts.npz`` (``ops/render.render_luts``), with each map's
under, over and bad colours, so nothing here imports matplotlib. The
lookup repeats matplotlib's rule for a float input (``Normalize`` then
``Colormap.__call__``): normalise in float64, scale by N, send N to N - 1,
truncate; values below 0 or at N and above take the under and over
colours, NaN (the masked cells) the bad colour. The result is bitwise the
matplotlib one (``tests/test_torch_colorize.py``).
"""

from __future__ import annotations

from typing import Optional

import numpy as np

_VORTICITY_STOPS = [
    (1, 1, 0),
    (0.953, 0.490, 0.016),
    (0, 0, 0),
    (0.176, 0.976, 0.529),
    (0, 1, 1),
]


def vorticity_cmap():
    """The vorticity map as a matplotlib colormap. Only
    ``ops/render.build_render_luts`` calls it, to sample the shipped LUT."""
    from matplotlib.colors import LinearSegmentedColormap

    cmap = LinearSegmentedColormap.from_list("vorticity_cmap", _VORTICITY_STOPS)
    cmap.set_bad(color="grey")
    return cmap


def apply_colormap(
    data: np.ndarray,
    cmap: str,
    vmin: float,
    vmax: float,
    mask: Optional[np.ndarray] = None,
    obstacle_color: float = 0.5,
) -> np.ndarray:
    """[H, W] scalars -> [H, W, 3] float32 through the shipped LUT named
    ``cmap`` ("plasma", "vorticity" or "RdBu_r")."""
    from ..ops.render import colormap_lut

    lut, under, over, bad = colormap_lut(cmap)
    n = lut.shape[0]
    vmin, vmax = float(vmin), float(vmax)
    x = np.array(data, np.float64)
    if mask is not None:
        x[mask > 0] = np.nan
    if vmin == vmax:
        x.fill(0.0)
    elif vmin > vmax:
        raise ValueError("minvalue must be less than or equal to maxvalue")
    else:
        x -= vmin
        x /= vmax - vmin
    x *= n
    x[x == n] = n - 1
    is_under, is_over, is_bad = x < 0, x >= n, np.isnan(x)
    with np.errstate(invalid="ignore"):
        idx = x.astype(int)
    np.clip(idx, 0, n - 1, out=idx)
    rgb = lut[idx]
    rgb[is_under] = under
    rgb[is_over] = over
    rgb[is_bad] = bad
    if mask is not None:
        rgb[mask == 1] = obstacle_color
    return rgb


def colorize_velocity(
    vel_mag: np.ndarray,
    u_norm_max: float,
    mask: Optional[np.ndarray] = None,
    cmap_name: str = "plasma",
) -> np.ndarray:
    return apply_colormap(vel_mag, cmap_name, 0.0, u_norm_max, mask)


def colorize_vorticity(
    vorticity: np.ndarray,
    vorticity_range: float,
    mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    return apply_colormap(vorticity, "vorticity", -vorticity_range, vorticity_range, mask)


def colorize_pressure(
    pressure: np.ndarray,
    p_min: float,
    p_max: float,
    mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    return apply_colormap(pressure, "RdBu_r", p_min, p_max, mask)
