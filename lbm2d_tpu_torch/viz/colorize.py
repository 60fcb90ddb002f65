"""Field-to-RGB colorization (reference visualization/color_utils.py parity).

Velocity magnitude -> plasma; vorticity -> custom 5-stop
yellow-orange-black-green-cyan diverging map; obstacles painted grey (0.5).
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
    from matplotlib.colors import LinearSegmentedColormap

    cmap = LinearSegmentedColormap.from_list("vorticity_cmap", _VORTICITY_STOPS)
    cmap.set_bad(color="grey")
    return cmap


def apply_colormap(
    data: np.ndarray,
    cmap,
    vmin: float,
    vmax: float,
    mask: Optional[np.ndarray] = None,
    obstacle_color: float = 0.5,
) -> np.ndarray:
    from matplotlib import cm
    from matplotlib.colors import Normalize

    mapper = cm.ScalarMappable(norm=Normalize(vmin=vmin, vmax=vmax), cmap=cmap)
    plot = np.array(data, np.float64)
    if mask is not None:
        plot[mask > 0] = np.nan
    rgb = mapper.to_rgba(plot)[:, :, :3]
    if mask is not None:
        rgb[mask == 1] = obstacle_color
    return rgb.astype(np.float32)


def colorize_velocity(
    vel_mag: np.ndarray,
    u_norm_max: float,
    mask: Optional[np.ndarray] = None,
    cmap_name: str = "plasma",
) -> np.ndarray:
    from matplotlib import colormaps

    return apply_colormap(vel_mag, colormaps[cmap_name], 0.0, u_norm_max, mask)


def colorize_vorticity(
    vorticity: np.ndarray,
    vorticity_range: float,
    mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    return apply_colormap(
        vorticity, vorticity_cmap(), -vorticity_range, vorticity_range, mask
    )


def colorize_pressure(
    pressure: np.ndarray,
    p_min: float,
    p_max: float,
    mask: Optional[np.ndarray] = None,
) -> np.ndarray:
    from matplotlib import colormaps

    return apply_colormap(pressure, colormaps["RdBu_r"], p_min, p_max, mask)
