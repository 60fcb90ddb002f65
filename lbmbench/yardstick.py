"""The benchmark's yardstick: the chip's peaks and the bytes the lattice
work needs, counted from the configuration's shapes and storage.

A lattice update reads each population once and writes it once, and reads
the packed sponge and solid flag (4 B a cell): 76 B a cell in float32, 40 B
with 16-bit deviation storage. The step that closes a chunk also writes
rho, u and the post-collision field: 124 B a cell, 88 B where the
populations it reads and writes are 16-bit deviations. A Bouzidi link reads its
wall fraction: 4 B more. The monitors read u (8 B a cell) and each boundary
link's populations: 8 B a link, 20 B under Bouzidi. These are the bytes
each piece of work needs at the least, whatever implements it.
"""

from __future__ import annotations

import numpy as np

# published peaks (SXM part, dense rates): HBM bytes/s and float32 FLOP/s
PEAKS = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12, "fp32_flops_per_s": 67e12},
}

STEP_F32 = 76
STEP_DEV = 40
STEP_FULL = 124
STEP_FULL_DEV = 88
BOUZIDI_LINK = 4
MONITOR_CELL = 8
MONITOR_LINK = 8
MONITOR_LINK_BOUZIDI = 20

_EX = (0, 1, 0, -1, 0, 1, -1, -1, 1)
_EY = (0, 0, 1, 0, -1, 1, 1, -1, -1)


def _shifted(solid: np.ndarray, dy: int, dx: int, fill: bool) -> np.ndarray:
    """solid[y + dy, x + dx], ``fill`` beyond the grid."""
    p = np.pad(solid, 1, constant_values=fill)
    h, w = solid.shape
    return p[1 + dy:1 + dy + h, 1 + dx:1 + dx + w]


def solid_links(mask: np.ndarray) -> int:
    """Links (solid c, fluid c + e_k on the grid) of the momentum exchange
    over solid cells."""
    solid = np.asarray(mask) > 0.5
    return int(sum((solid & ~_shifted(solid, _EY[k], _EX[k], True)).sum() for k in range(1, 9)))


def fluid_links(mask: np.ndarray) -> int:
    """Links (fluid c, solid c + e_j on the grid): Bouzidi's links."""
    solid = np.asarray(mask) > 0.5
    return int(sum((~solid & _shifted(solid, _EY[k], _EX[k], False)).sum() for k in range(1, 9)))


def step_bytes(cells: int, dev: bool = False, bouzidi_links: int = 0) -> int:
    """One fast lattice update of a case."""
    return cells * (STEP_DEV if dev else STEP_F32) + BOUZIDI_LINK * bouzidi_links


def full_step_bytes(cells: int, bouzidi_links: int = 0, dev: bool = False) -> int:
    """The step that closes a chunk."""
    return cells * (STEP_FULL_DEV if dev else STEP_FULL) + BOUZIDI_LINK * bouzidi_links


def monitor_bytes(cells: int, links: int, bouzidi: bool = False) -> int:
    """The chunk's monitors: u, and every link's populations."""
    return cells * MONITOR_CELL + links * (MONITOR_LINK_BOUZIDI if bouzidi else MONITOR_LINK)


def chunk_bytes(cells: int, n_steps: int, links: int, dev: bool = False,
                bouzidi: bool = False, force_links: int = 0) -> int:
    """One case's chunk of ``n_steps``: n - 1 fast steps, the full step,
    the monitors and, where the run measures a second body's force
    (``force_links`` > 0), that force's links."""
    bl = links if bouzidi else 0
    out = (n_steps - 1) * step_bytes(cells, dev, bl) + full_step_bytes(cells, bl, dev)
    out += monitor_bytes(cells, links, bouzidi)
    if force_links:
        out += force_links * (MONITOR_LINK_BOUZIDI if bouzidi else MONITOR_LINK)
    return out


def bound_seconds(nbytes: float, device_kind: str):
    """The least time the chip takes to move ``nbytes``; None for a chip
    whose peak the table does not hold."""
    peak = PEAKS.get(device_kind)
    return None if peak is None else nbytes / peak["hbm_bytes_per_s"]
