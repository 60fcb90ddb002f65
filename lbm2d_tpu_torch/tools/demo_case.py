"""The square demo case of the JAX package's entry module
(``__graft_entry__._demo_config`` and ``_cylinder_mask``), kept here so the
port's tools build it without importing the JAX package: a pressure-driven
channel ``[0, 2, 1, 2]`` with sponges on every side and a cylinder of
radius ny/16 at (ny/2, nx/4). The roofline tool runs it at 4096 x 4096,
the bench (``tools/bench.py``) at 1024 x 1024; ``entry`` is the entry
module's ``entry``.
"""

from __future__ import annotations

import numpy as np


def demo_config(nx: int, ny: int, nu: float = 0.02, warmup: int = 512) -> dict:
    return {
        "simulation": {
            "nx": nx, "ny": ny, "name": "graft", "nu": nu,
            "ghost_moments_s": 1.2, "characteristic_length": max(8, ny // 8),
            "rho_in": 1.015, "rho_out": 1.0, "smagorinsky_constant": 0.1,
            "warmup_steps": warmup,
        },
        "boundary_condition": {
            "type": [0, 2, 1, 2],
            "value": [[0.05, 0.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0]],
        },
        "domain_zones": {
            "sponge_in": max(1, nx // 16), "sponge_out": max(1, nx // 8),
            "sponge_top": max(1, ny // 16), "sponge_bot": max(1, ny // 16),
            "sponge_strength": 3.0,
        },
    }


def cylinder_mask(ny: int, nx: int) -> np.ndarray:
    y, x = np.mgrid[0:ny, 0:nx]
    cy, cx, r = ny // 2, nx // 4, max(4, ny // 16)
    return ((x - cx) ** 2 + (y - cy) ** 2 <= r * r).astype(np.float32)


def entry(device="cuda"):
    """(fn, (state, p)): ``fn(state, p)`` is one 8-step chunk of the eager
    step (``solver.run_chunk``) on the 1024^2 demo case at its defaults, as
    the entry module's ``entry()`` returns the jnp ``run_chunk``."""
    from ..core.engine import resolve_device
    from ..core.solver import init_state, make_params, run_chunk

    device = resolve_device(device)
    nx = ny = 1024
    p = make_params(demo_config(nx, ny), cylinder_mask(ny, nx), device=device)
    state = init_state(ny, nx, device=device)

    def fn(state, p):
        return run_chunk(state, p, n_steps=8)

    return fn, (state, p)
