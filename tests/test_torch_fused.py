"""Temporal blocking (K3) in the port, on the CPU through K3's plain version
(the windowed algorithm the kernel runs), against the port's unfused chunk
runner and against the JAX package's fused Pallas path in interpret mode.

Geometry (a): 34 x 50 with 8 x 16 tiles and S = 3, so the last tile of
each axis is shifted back onto the grid's edge, the top row and the right
column lie in two windows each (both must apply their BC), and 14 steps
leave one split K1 + K2 step before the closing full step. Limits: the
fused chunk equals the unfused one and the eager step bitwise (the same f32
operations in the same order).

(b): the JAX package's ``run_chunk_pallas`` with ``_FUSE_STEPS`` and
``_FUSE_BH`` set, in interpret mode, as ``tests/test_pallas.py`` runs it
(40 x 128, 16-row bands), against the port's fused chunk: f, rho, u within
1e-6 absolute, the limit of ``test_torch_dfg_pallas.py`` (a few f32 ulps of
O(1) values).
"""

import logging

import numpy as np
import pytest
import torch

from lbm2d_tpu.core import solver as js
from lbm2d_tpu.ops import pallas_step as ps
from lbm2d_tpu_torch.core import solver as ts
from lbm2d_tpu_torch.core.engine import LBMEngine
from lbm2d_tpu_torch.core.lattice import f_eq
from lbm2d_tpu_torch.ops import cuda_step as cs

H, W = 34, 50
TILE = (8, 16)
JAX_TOL = 1e-6


def make_config(h, w, bc_type=(0, 2, 1, 2), obstacle="equilibrium", cs_=0.1):
    return {
        "simulation": {
            "nx": w, "ny": h, "nu": 0.02, "ghost_moments_s": 1.2, "rho_in": 1.02,
            "rho_out": 1.0, "warmup_steps": 12, "smagorinsky_constant": cs_,
            "characteristic_length": 6,
        },
        "domain_zones": {
            "sponge_in": 4, "sponge_out": 6, "sponge_top": 3, "sponge_bot": 3,
            "sponge_strength": 3.0,
        },
        "boundary_condition": {
            "type": list(bc_type),
            "value": [[0.05, 0.0], [0.02, 0.01], [0.03, -0.01], [0.01, 0.02]],
            "obstacle": obstacle,
        },
    }


def make_mask(h, w):
    """A block, and solids on the strips the BCs read and on the ring."""
    m = np.zeros((h, w), np.float32)
    m[h // 2 - 3:h // 2 + 3, w // 3:w // 3 + 6] = 1.0
    m[3:6, 1] = 1.0
    m[h - 12, w - 2] = 1.0
    m[1, w // 2] = 1.0
    m[h - 2, 5] = 1.0
    m[0, w - 20] = 1.0
    m[8, 0] = 1.0
    m[h - 1, 0] = 1.0
    m[h - 1, w - 1] = 1.0
    return m


def seeded_state(h, w, seed=0):
    rng = np.random.default_rng(seed)
    rho = torch.tensor(1.0 + 0.01 * rng.standard_normal((h, w)), dtype=torch.float32)
    u = torch.tensor(0.03 * rng.standard_normal((2, h, w)), dtype=torch.float32)
    f = f_eq(rho, u[0], u[1])
    return ts.LBMState(f=f, f_post=f.clone(), rho=rho, u=u, step=0)


@pytest.fixture
def fused(monkeypatch):
    """Request temporal blocking; returns the list of K3 plain calls (S)."""
    calls = []
    real = cs.k3_fused_plain

    def counting(f_in, f_out, aux, scal_rows, *a, **kw):
        calls.append(int(scal_rows.shape[0]))
        return real(f_in, f_out, aux, scal_rows, *a, **kw)

    monkeypatch.setattr(cs, "k3_fused_plain", counting)

    def request(S, tile=TILE):
        monkeypatch.setattr(cs, "_FUSE_STEPS", S)
        monkeypatch.setattr(cs, "k3_tile", lambda S_: tile)
        return calls

    return request


def test_tile_geometry_overlaps_the_ring():
    S = 3
    gy, gx, flat = cs._k3_windows(H, W, S, *TILE, "cpu")
    nty, ntx = -(-H // TILE[0]), -(-W // TILE[1])
    assert gy.shape == (nty * ntx, TILE[0] + 2 * S, TILE[1] + 2 * S)
    # the top row and the right column each lie in two windows
    assert int(((gy == H - 1).any(-1).any(-1)).sum()) == 2 * ntx
    assert int(((gx == W - 1).any(-1).any(-1)).sum()) == 2 * nty
    # the last tiles are shifted back to end on the grid's edge
    assert int(gy.max()) == H - 1 + S and int(gx.max()) == W - 1 + S
    # each grid cell is stored from exactly one window cell, inside the grid
    assert flat.unique().numel() == H * W
    assert torch.equal(gy.reshape(-1)[flat], torch.arange(H)[:, None].expand(H, W))
    assert torch.equal(gx.reshape(-1)[flat], torch.arange(W)[None, :].expand(H, W))


CASES = [
    ((0, 2, 1, 2), "equilibrium", 0.1),
    ((0, 2, 1, 2), "equilibrium", 0.0),
    ((0, 0, 0, 0), "equilibrium", 0.1),
    ((2, 0, 2, 2), "bounce_back", 0.1),
    ((3, 0, 1, 0), "bounce_back", 0.1),
    ((3, 0, 1, 0), "bounce_back_halfway", 0.1),
    ((4, 2, 1, 2), "bounce_back_halfway", 0.1),
    ((4, 2, 1, 2), "equilibrium", 0.1),
]
CASE_IDS = [f"{''.join(map(str, b))}-{o}-les{c}" for b, o, c in CASES]


@pytest.mark.parametrize("bc_type, obstacle, cs_", CASES, ids=CASE_IDS)
def test_fused_chunk_equals_unfused(bc_type, obstacle, cs_, fused):
    p = ts.make_params(make_config(H, W, bc_type, obstacle, cs_), make_mask(H, W))
    s0 = seeded_state(H, W)
    ref, mref = cs.run_chunk_plain(s0, p, 14)
    eager, _ = ts.run_chunk(s0, p, 14)
    calls = fused(3)
    got, mgot = cs.run_chunk_plain(s0, p, 14)
    assert calls == [3] * 4  # divmod(13, 3): 4 passes, then 1 split step
    for k in ("f", "f_post", "rho", "u"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k
        assert torch.equal(getattr(got, k), getattr(eager, k)), k
    assert torch.equal(mgot["force"], mref["force"]) and got.step == 14
    # the wrapper on CPU tensors takes the same plain path and counts nothing
    before = dict(cs.LAUNCHES)
    again, _ = cs.run_chunk_cuda(s0, p, 14)
    assert torch.equal(again.f, ref.f) and cs.LAUNCHES == before


@pytest.mark.parametrize("S, tile, n_steps", [(2, (8, 16), 9), (8, (64, 64), 17), (4, (5, 7), 6)],
                         ids=["S2", "S8-one-tile", "S4-odd-tile"])
def test_fused_chunk_other_geometries(S, tile, n_steps, fused):
    p = ts.make_params(make_config(H, W, (3, 0, 1, 0), "bounce_back_halfway"), make_mask(H, W))
    s0 = seeded_state(H, W, seed=1)
    ref, _ = cs.run_chunk_plain(s0, p, n_steps)
    calls = fused(S, tile)
    got, _ = cs.run_chunk_plain(s0, p, n_steps)
    assert calls == [S] * ((n_steps - 1) // S)
    for k in ("f", "f_post", "rho", "u"):
        assert torch.equal(getattr(got, k), getattr(ref, k)), k


def test_one_k3_pass_equals_split_steps():
    p = ts.make_params(make_config(H, W), make_mask(H, W))
    s0 = seeded_state(H, W, seed=2)
    aux = cs.pack_aux(p.damping, p.mask)
    rows = torch.stack([cs.scalar_row(p, 1 + i) for i in range(4)])
    out = torch.full_like(s0.f, float("nan"))
    cs.k3_fused(s0.f, out, aux, rows, p.bc_type, p.use_les, tile=TILE)
    f = s0.f
    for i in range(4):
        nxt = torch.empty_like(f)
        cs.k1_step(f, nxt, aux, rows[i], p.use_les, p.bc_type)
        f = nxt
    assert torch.equal(out, f)


def test_fuse_rules_and_engine_logs(caplog, monkeypatch):
    cfg_b = make_config(H, W, (4, 2, 1, 2), "bounce_back_bouzidi")
    cfg_e = make_config(H, W)
    cfg_e["simulation"]["f16_state"] = True
    p_b = ts.make_params(cfg_b, make_mask(H, W))
    assert cs.fuse_refusal(p_b) and "Bouzidi" in cs.fuse_refusal(p_b)
    assert cs.fuse_steps(p_b, 10) == 0
    # not requested: no fusion, store_dev as before
    assert cs.fuse_steps(ts.make_params(cfg_e, make_mask(H, W)), 10) == 0
    with caplog.at_level(logging.WARNING, logger="lbm2d_tpu_torch.core.engine"):
        assert LBMEngine(cfg_e, make_mask(H, W), device="cpu").store_dev
    assert not caplog.records
    monkeypatch.setattr(cs, "_FUSE_STEPS", 12)
    p_e = ts.make_params(cfg_e, make_mask(H, W))
    assert cs.fuse_steps(p_e, 10) == cs.FUSE_MAX_STEPS and cs.fuse_steps(p_e, 1) == 0
    assert cs.fuse_refusal(p_e) is None
    assert "temporal blocking" in cs.dev_storage_refusal(p_e)
    with caplog.at_level(logging.WARNING, logger="lbm2d_tpu_torch.core.engine"):
        eng_e = LBMEngine(cfg_e, make_mask(H, W), device="cpu")
        eng_b = LBMEngine(cfg_b, make_mask(H, W), device="cpu")
    msgs = [r.getMessage() for r in caplog.records]
    assert len(msgs) == 2, msgs
    assert "16-bit deviation storage" in msgs[0] and "temporal blocking" in msgs[0]
    assert "temporal blocking" in msgs[1] and "Bouzidi" in msgs[1]
    assert not eng_e.store_dev and eng_e._runner is cs.run_chunk_plain
    # Bouzidi runs unfused, on the eager step as any CPU case
    assert eng_b._runner is ts.run_chunk
    # the store_dev request is off in the chunk runner too: exact f32
    monkeypatch.setattr(cs, "k3_tile", lambda S: TILE)
    s0 = seeded_state(H, W)
    a, _ = cs.run_chunk_plain(s0, p_e, 9, store_dev=True)
    b, _ = ts.run_chunk(s0, p_e, 9)
    assert torch.equal(a.f, b.f)


def test_engine_runs_fused_on_cpu(fused):
    cfg = make_config(H, W)
    calls = fused(4)
    eng = LBMEngine(cfg, make_mask(H, W), device="cpu")
    eng.run_step(10)
    assert calls == [4, 4]
    ref = LBMEngine(cfg, make_mask(H, W), device="cpu")
    cs._FUSE_STEPS = None
    ref.run_step(10)
    assert torch.equal(eng.state.f, ref.state.f)


# -- against the JAX package's fused Pallas path ----------------------------

JH, JW = 40, 128


def jax_case(bc_type, obstacle):
    cfg = make_config(JH, JW, bc_type, obstacle)
    mask = np.zeros((JH, JW), np.float32)
    if bc_type[0] == 3:  # walls, as in tests/test_pallas.py's DFG-mode case
        cfg["boundary_condition"]["value"] = [[0.08, 0.0]] + [[0.0, 0.0]] * 3
        mask[0, :] = 1.0
        mask[-1, :] = 1.0
    mask[16:24, 30:38] = 1.0
    return cfg, mask


@pytest.mark.parametrize("bc_type, obstacle, S, n_steps", [
    ((0, 2, 1, 2), "equilibrium", 3, 11),
    ((3, 0, 1, 0), "bounce_back", 2, 9),
    ((3, 0, 1, 0), "bounce_back_halfway", 2, 9),
], ids=["0212-equilibrium", "3010-bounce_back", "3010-bounce_back_halfway"])
def test_fused_chunk_matches_jax_fused_pallas(bc_type, obstacle, S, n_steps, fused, monkeypatch):
    cfg, mask = jax_case(bc_type, obstacle)
    pt = ts.make_params(cfg, mask)
    pj = js.make_params(cfg, mask)
    s0 = seeded_state(JH, JW, seed=3)
    f = s0.f.numpy()
    sj0 = js.LBMState(f=f, f_post=f, rho=s0.rho.numpy(), u=s0.u.numpy(), step=np.int32(0))
    jax_fused = []
    real = ps._pallas_fused_steps

    def counting(*a, **kw):
        jax_fused.append(kw.get("S", a[4] if len(a) > 4 else None))
        return real(*a, **kw)

    monkeypatch.setattr(ps, "_pallas_fused_steps", counting)
    monkeypatch.setattr(ps, "_FUSE_STEPS", S)
    monkeypatch.setattr(ps, "_FUSE_BH", 16)
    sj, _ = ps.run_chunk_pallas(sj0, pj, n_steps=n_steps, interpret=True)
    assert jax_fused, "the JAX chunk did not take the fused path"
    calls = fused(S, (8, 32))
    st, _ = cs.run_chunk_plain(s0, pt, n_steps)
    assert calls == [S] * ((n_steps - 1) // S)
    for k in ("f", "rho", "u"):
        diff = float(np.abs(getattr(st, k).numpy() - np.asarray(getattr(sj, k))).max())
        assert diff <= JAX_TOL, (k, diff)
