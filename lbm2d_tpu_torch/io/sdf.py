"""Signed distance field for static_mask channel 1.

SDF = EDT(fluid side) - EDT(solid side): positive in fluid, negative inside
solids (reference io/lbm_writer.py:92-99). Uses scipy's exact euclidean
distance transform with a pure-numpy Felzenszwalb fallback.
"""

from __future__ import annotations

import numpy as np

try:
    from scipy.ndimage import distance_transform_edt as _edt

    _HAS_SCIPY = True
except Exception:  # pragma: no cover
    _HAS_SCIPY = False


def _edt_1d(f: np.ndarray) -> np.ndarray:
    """Felzenszwalb & Huttenlocher 1-D squared distance transform."""
    n = f.shape[0]
    d = np.empty(n)
    v = np.zeros(n, dtype=int)
    z = np.empty(n + 1)
    k = 0
    z[0], z[1] = -np.inf, np.inf
    for q in range(1, n):
        s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2 * q - 2 * v[k])
        while s <= z[k]:
            k -= 1
            s = ((f[q] + q * q) - (f[v[k]] + v[k] * v[k])) / (2 * q - 2 * v[k])
        k += 1
        v[k] = q
        z[k], z[k + 1] = s, np.inf
    k = 0
    for q in range(n):
        while z[k + 1] < q:
            k += 1
        d[q] = (q - v[k]) ** 2 + f[v[k]]
    return d


def _edt_numpy(binary: np.ndarray) -> np.ndarray:
    """Exact EDT: distance of each zero... matching scipy semantics, where the
    input's nonzero cells get the distance to the nearest zero cell."""
    big = 1e18
    f = np.where(binary != 0, big, 0.0).astype(np.float64)
    # pass along columns then rows
    g = np.apply_along_axis(_edt_1d, 0, f)
    d2 = np.apply_along_axis(_edt_1d, 1, g)
    return np.sqrt(np.minimum(d2, big))


def edt(binary: np.ndarray) -> np.ndarray:
    """Distance from each nonzero cell to the nearest zero cell."""
    if _HAS_SCIPY:
        return _edt(binary)
    return _edt_numpy(np.asarray(binary))


def signed_distance_field(mask: np.ndarray) -> np.ndarray:
    """mask: 1 = solid. Positive in fluid, negative in solid."""
    mask = np.asarray(mask)
    dist_fluid = edt(1 - mask)  # fluid cells: distance to solid
    dist_solid = edt(mask)  # solid cells: distance to fluid
    return (dist_fluid - dist_solid).astype(np.float64)
