"""Physics analysis helpers: Re, characteristic length, CTU time scale,
DFG drag/lift coefficients and Karman-street sine fit.

Counterpart of ``lbm2d_tpu/utils/physics.py`` (numpy and scipy only, kept
as the port's own copy). Parity targets: reference utils/physics_utils.py
(calculate_characteristic_length:24, calculate_simulation_time_scale:44,
compute_coefficients:112, fit_sine_wave:128).
"""

from __future__ import annotations

from typing import Any, Dict, Optional, Tuple

import numpy as np


def reynolds_number(u_char: float, l_char: float, nu: float) -> float:
    return (u_char * l_char) / nu if nu > 0 else float("inf")


def characteristic_length_projection(mask_yx: np.ndarray) -> int:
    """Legacy L_char: count of y rows touched by any solid cell.

    ``mask_yx`` is [ny, nx]; the reference computes the same quantity on its
    [nx, ny] layout by reducing over x (physics_utils.py:24-43).
    """
    y_occupied = np.any(mask_yx, axis=1)
    return max(1, int(np.sum(y_occupied)))


def simulation_time_scale(config: Dict[str, Any]) -> float:
    """steps per convective time unit: L_char / U_lb (bc value[0][0])."""
    l_char = config["simulation"].get("characteristic_length", 0)
    u_lb = config["boundary_condition"]["value"][0][0]
    if not u_lb or not l_char:
        return 0.0
    return l_char / u_lb


def compute_coefficients(
    fx_arr: np.ndarray, fy_arr: np.ndarray, u_max: float, d: float, rho: float = 1.0
) -> Tuple[np.ndarray, np.ndarray, float]:
    """DFG benchmark Cd/Cl: denominator 0.5 rho U_mean^2 D, U_mean = 2/3 U_max."""
    u_mean = (2.0 / 3.0) * u_max
    denom = 0.5 * rho * u_mean * u_mean * d
    return np.asarray(fx_arr) / denom, np.asarray(fy_arr) / denom, u_mean


def fit_sine_wave(
    t: np.ndarray, signal: np.ndarray
) -> Tuple[Optional[np.ndarray], Optional[np.ndarray]]:
    """Fit y = A sin(w t + phi) + c; frequency seeded from the FFT peak.

    Returns (fitted_curve, [A, omega, phi, offset]) or (None, None).
    """
    from scipy.optimize import curve_fit

    def sine(tt, a, w, phi, c):
        return a * np.sin(w * tt + phi) + c

    signal = np.asarray(signal, float)
    t = np.asarray(t, float)
    guess_amp = (signal.max() - signal.min()) / 2
    guess_off = signal.mean()
    fft_vals = np.fft.rfft(signal - guess_off)
    fft_freqs = np.fft.rfftfreq(len(signal))
    w0 = 2 * np.pi * fft_freqs[int(np.argmax(np.abs(fft_vals)))]
    try:
        popt, _ = curve_fit(sine, t, signal, p0=[guess_amp, w0, 0, guess_off], maxfev=10000)
        return sine(t, *popt), np.asarray(popt)
    except Exception:
        return None, None


def strouhal_number(omega: float, d: float, u: float, dt: float = 1.0) -> float:
    """St = f D / U with f = omega / 2pi (per-step angular frequency)."""
    f = omega / (2.0 * np.pi) / dt
    return f * d / u if u > 0 else 0.0


def parabolic_inlet_velocity(j, u_max: float, ny: int):
    """DFG parabolic inlet profile: 4 u_max y (h - y) / h^2, h = ny - 1
    (reference LBM2D_MRT_LES.py:580-586)."""
    y = np.asarray(j, float)
    h = float(ny - 1)
    return 4.0 * u_max * y * (h - y) / (h * h)


def latin_hypercube(n_samples: int, bounds, rng=None) -> np.ndarray:
    """Mixed Latin-hypercube sampler (reference notebooks/LHS_sampling.ipynb
    role): one stratified uniform sample per dimension interval, shuffled.

    ``bounds``: sequence of (lo, hi) per dimension. Returns [n, d].
    """
    rng = rng or np.random.default_rng()
    bounds = np.asarray(bounds, float)
    d = bounds.shape[0]
    u = (rng.random((n_samples, d)) + np.arange(n_samples)[:, None]) / n_samples
    for k in range(d):
        rng.shuffle(u[:, k])
    return bounds[:, 0] + u * (bounds[:, 1] - bounds[:, 0])
