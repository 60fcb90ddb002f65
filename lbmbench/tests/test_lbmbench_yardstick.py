"""The yardstick's bytes against the port's kernel table (PERF.md §6):
K1 76 B a cell, the full step 124, deviation storage 40 (its full step 88), +4 B a Bouzidi
link; the monitors 8 B a cell and 8 (Bouzidi 20) B a link."""

import numpy as np

from lbmbench import yardstick as y


def test_bytes_a_cell():
    assert y.step_bytes(1) == 76
    assert y.step_bytes(1, dev=True) == 40
    assert y.full_step_bytes(1) == 124
    # the closing step's f read and written as 2-byte deviations
    assert y.full_step_bytes(1, dev=True) == 124 - 2 * 9 * 2
    assert y.step_bytes(10, bouzidi_links=3) == 760 + 12
    assert y.full_step_bytes(10, bouzidi_links=3) == 1240 + 12
    assert y.monitor_bytes(10, 3) == 80 + 24
    assert y.monitor_bytes(10, 3, bouzidi=True) == 80 + 60


def test_chunk_bytes():
    cells, n, links = 1000, 262, 50
    assert y.chunk_bytes(cells, n, links, dev=True) == 261 * 40 * cells + 88 * cells + \
        8 * cells + 8 * links
    assert y.chunk_bytes(cells, 500, links, bouzidi=True, force_links=links) == \
        499 * (76 * cells + 4 * links) + 124 * cells + 4 * links + 8 * cells + 20 * links \
        + 20 * links


def test_links_of_a_block():
    mask = np.zeros((6, 6))
    mask[2:4, 2:4] = 1
    # each of 4 solid cells: of its 8 neighbours, those outside the block
    assert y.solid_links(mask) == 4 * 5
    # fluid cells whose neighbour is solid: 12 around the block with 1-3 links each
    assert y.fluid_links(mask) == 20


def test_bound_needs_a_known_peak():
    assert y.bound_seconds(3.35e12, "NVIDIA H100 80GB HBM3") == 1.0
    assert y.bound_seconds(1e9, "some other card") is None
