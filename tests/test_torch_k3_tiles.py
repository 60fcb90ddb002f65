"""K3's tile and schedule (csrc/k3_fused.cu) on the CPU, where the kernel
cannot run: the shared-memory and register budget its default tile
assumes, its plain version's independence of the tile, and a model of the
kernel's sweep that checks every read of a level's row finds that row
finished and not yet overwritten in its ring slot.

The kernel's ring sizes and prefetch distance are read from the source, so
the model follows the kernel when they change.
"""

import os
import re

import numpy as np
import pytest
import torch

from lbm2d_tpu_torch.core import solver as ts
from lbm2d_tpu_torch.core.lattice import f_eq
from lbm2d_tpu_torch.ops import cuda_build
from lbm2d_tpu_torch.ops import cuda_step as cs
import torch_threads  # noqa: F401  (the test processes' torch thread budget)


def kernel_constants():
    with open(os.path.join(cuda_build.CSRC, "k3_fused.cu")) as fh:
        src = fh.read()
    return {k: int(v) for k, v in re.findall(r"#define (K3_\w+) (\d+)", src)}


K = kernel_constants()


@pytest.mark.parametrize("S", range(1, cs.FUSE_MAX_STEPS + 1))
def test_default_tile_fits_the_budget(S):
    th, tw = cs.k3_tile(S)
    ww = cs.k3_window_w(S, tw)
    assert th >= 2 and tw % 8 == 0 and tw + 2 * S <= ww
    smem = cs.k3_smem_bytes(S, tw)
    assert smem == 4 * ww * (9 * (K["K3_RING0"] + K["K3_RING"] * (S - 1)) + K["K3_RING_AUX"])
    assert smem <= cs.K3_SMEM_LIMIT
    n = cs.k3_blocks_per_sm(S, tw)
    assert n >= 1
    assert n * (smem + 1024) <= cs.SM_SMEM
    # the launch bounds: WW x 8 threads and 128 / WW blocks in 65,536
    # registers
    assert n * ww * S * cs.K3_MAX_REGISTERS <= 65536
    assert 65536 // (ww * K["K3_MAX_STEPS"] * (128 // ww)) == cs.K3_MAX_REGISTERS
    if S <= 4:  # one block's loads and barriers overlap another's arithmetic
        assert n >= 2


def make_case(h, w, bc_type=(0, 2, 1, 2)):
    cfg = {
        "simulation": {
            "nx": w, "ny": h, "nu": 0.02, "ghost_moments_s": 1.2, "rho_in": 1.02,
            "rho_out": 1.0, "warmup_steps": 12, "smagorinsky_constant": 0.1,
        },
        "domain_zones": {"sponge_in": 4, "sponge_out": 6, "sponge_top": 3, "sponge_bot": 3,
                         "sponge_strength": 3.0},
        "boundary_condition": {"type": list(bc_type),
                               "value": [[0.05, 0.0], [0.02, 0.01], [0.03, -0.01], [0.01, 0.02]],
                               "obstacle": "equilibrium"},
    }
    mask = np.zeros((h, w), np.float32)
    mask[h // 2 - 4:h // 2 + 4, w // 3:w // 3 + 8] = 1.0
    mask[1, w - 30] = mask[h - 2, 9] = mask[0, 5] = 1.0
    p = ts.make_params(cfg, mask)
    rng = np.random.default_rng(4)
    rho = torch.tensor(1.0 + 0.01 * rng.standard_normal((h, w)), dtype=torch.float32)
    u = torch.tensor(0.03 * rng.standard_normal((2, h, w)), dtype=torch.float32)
    return p, f_eq(rho, u[0], u[1])


@pytest.mark.parametrize("S", [4, 8])
def test_plain_version_does_not_depend_on_the_tile(S):
    """The first design's (32, 64) tile, the default tile and S single K1 steps give
    the same f, bitwise (64 x 128: the default tile's last column of tiles
    is shifted, and its one row of tiles is taller than the grid)."""
    p, f0 = make_case(64, 128)
    aux = cs.pack_aux(p.damping, p.mask)
    rows = torch.stack([cs.scalar_row(p, 1 + i) for i in range(S)])
    outs = []
    for tile in [(32, 64), cs.k3_tile(S)]:
        out = torch.full_like(f0, float("nan"))
        cs.k3_fused_plain(f0, out, aux, rows, p.bc_type, p.use_les, tile=tile)
        outs.append(out)
    f = f0
    for i in range(S):
        nxt = torch.empty_like(f)
        cs.k1_step_plain(f, nxt, aux, rows[i], p.use_les, p.bc_type)
        f = nxt
    assert torch.equal(outs[0], outs[1])
    assert torch.equal(outs[1], f)


def sweep_events(S, th, H, y0):
    """The kernel's schedule for the tile whose shifted centre starts on
    row ``y0``: {iteration: [(kind, level, window row)]}. Kinds: "issue"
    and "done" (level 0's rows and aux's, issued by cp.async at iteration
    r - AHEAD and complete at the end of iteration r), "write" (a level's
    row) and "read". Every collide reads aux's rows beside the f rows it
    reads."""
    ahead, nrows, wy0 = K["K3_AHEAD"], th + 2 * S, y0 - S
    ev = {}

    def add(t, *e):
        ev.setdefault(t, []).append(e)

    for wr in range(nrows):
        if 0 <= wy0 + wr < H:
            for lv in (0, "aux"):
                add(max(wr - ahead, -1), "issue", lv, wr)
                add(wr, "done", lv, wr)
    for t in range(th + 3 * S):
        for s in range(1, S + 1):
            wr = t - 2 * s
            gy = wy0 + wr
            if not (s <= wr < nrows - s and 0 <= gy < H):
                continue
            if 1 <= gy <= H - 2:  # interior or a side column: the 3 rows around it
                reads = [wr - 1, wr, wr + 1]
            elif gy == H - 1:  # the top row recomputes row H - 2
                reads = [wr - 2, wr - 1, wr]
            else:  # the bottom row waits for row 1's turn
                continue
            if gy == 1 and wr - 1 >= s:  # ... here: row 0 from rows 0 .. 2
                add(t, "write", s, wr - 1)
            add(t, "write", s, wr)
            for r in reads:
                add(t, "read", s - 1, r)
                add(t, "read", "aux", r)
    return ev


@pytest.mark.parametrize("S", [1, 2, 4, 8])
@pytest.mark.parametrize("th, H, y0", [(96, 96, 0), (96, 200, 40), (5, 40, 35), (2, 3, 0)],
                         ids=["one-tile", "inner", "last-shifted", "tiny"])
def test_sweep_reads_finished_rows_only(S, th, H, y0):
    ev = sweep_events(S, th, H, y0)
    slots = {}  # (level, slot) -> [(row, first iteration, last iteration of the write)]
    sizes = {0: K["K3_RING0"], "aux": K["K3_RING_AUX"]}
    ring = lambda lv: sizes.get(lv, K["K3_RING"])  # noqa: E731
    issued = {}
    for t in sorted(ev):
        for kind, lv, r in ev[t]:
            if kind == "issue":
                issued[lv, r] = t
            elif kind == "done":
                slots.setdefault((lv, r % ring(lv)), []).append((r, issued[lv, r], t))
            elif kind == "write":
                slots.setdefault((lv, r % ring(lv)), []).append((r, t, t))
    for t in sorted(ev):
        for kind, lv, r in ev[t]:
            if kind != "read":
                continue
            assert 0 <= y0 - S + r < H, (t, lv, r)
            hist = slots.get((lv, r % ring(lv)), [])
            mine = [w for w in hist if w[0] == r]
            assert mine and mine[0][2] < t, f"t {t}: level {lv} row {r} not finished"
            # no other row lands in the slot between this row's write and the read
            for row, first, last in hist:
                if row != r:
                    assert last < mine[0][1] or first > t, (
                        f"t {t}: level {lv} row {r} overwritten by row {row} ({first}..{last})")


@pytest.mark.parametrize("S", [1, 4, 8])
@pytest.mark.parametrize("W, tw", [(2432, 112), (881, 112), (36, 16), (130, None), (47, 7)],
                         ids=["production", "dfg", "small", "widest", "odd"])
def test_windows_cover_what_each_level_reads(S, W, tw):
    """Each tile's window columns (64 or 128) hold every level-0 column its levels
    read, its rows start aligned wherever the tile allows it, and the
    unshifted shares store each column once. ``None`` is the widest tile
    the launch takes, TW + 2 S = 128, whose windows cannot be aligned."""
    tw = tw or 128 - 2 * S
    ww = cs.k3_window_w(S, tw)
    nt = -(-W // tw)
    stored = np.zeros(W, int)
    for tx in range(nt):
        xn = tx * tw
        xc = min(xn, max(W - tw, 0))
        x0 = cs.k3_window_x0(xc, S, tw, W)
        need_lo, need_hi = max(xc - S, 0), min(xc + tw + S, W)  # level 0, read by level 1
        assert x0 <= need_lo and need_hi <= x0 + ww
        if tw % 8 == 0 and xc == xn and tw + 2 * 8 <= ww:
            assert x0 % 8 == 0
        stored[xn:min(xn + tw, W)] += 1
    assert (stored == 1).all()


def test_timing_probes_are_off_in_the_kernel_source():
    """K3's timing probes (tools/kernel_ab.py --k3-breakdown) are compiled in
    only by -DK3_PROBE; the source every launch builds leaves them out."""
    assert K["K3_PROBE"] == 0
    assert "-DK3_PROBE" not in " ".join(cuda_build.NVCC_FLAGS)


def test_build_log_outlives_the_building_process(tmp_path, monkeypatch):
    """A library built by an earlier process brings its ptxas report back
    into BUILD_LOG (chip_smoke.py prints registers and spills from it), and
    a present build starts no nvcc."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", str(tmp_path))
    monkeypatch.setattr(cuda_build, "BUILD_LOG", {})
    for name in cuda_build.SOURCES:
        out = cuda_build._lib_path(name)
        open(out, "wb").close()
        with open(out + ".log", "w") as fh:
            fh.write(f"ptxas info    : Used 40 registers ({name})")
    monkeypatch.setattr(cuda_build.subprocess, "Popen", None)
    paths = cuda_build.build_all()
    assert set(paths) == set(cuda_build.SOURCES)
    assert cuda_build.BUILD_LOG == {
        n: f"ptxas info    : Used 40 registers ({n})" for n in cuda_build.SOURCES}


def test_kernel_ab_parses_tiles_and_needs_a_card(capsys):
    """The A/B tool (tools/kernel_ab.py) reads "S:THxTW" and, without a
    CUDA device, exits non-zero before building anything."""
    from lbm2d_tpu_torch.tools import kernel_ab

    assert kernel_ab.parse_tile("4:24x112") == (4, (24, 112))
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tool would time on it")
    assert kernel_ab.main(["--k3-tiles", "4:24x112"]) == 1
    assert "no CUDA device" in capsys.readouterr().err
