"""The DFG-2D validation path of the port against the JAX package, on the
CPU, for each of the six obstacle x inlet pairs of
``analysis/dfg_validation`` (full-way, half-way or Bouzidi bounce-back on
the cylinder; the equilibrium (type 3) or NEBB (type 4) parabolic inlet).

The case is ``dfg_case(ny=48, nx_cap=128)`` (cylinder D = 11 at (23, 23),
walls as no-slip velocity BCs) with the warmup cut to 10 steps, started
from a seeded developed-looking state. Limits:

- eager step, f64, 12 steps: within 1e-12 of the jnp ``run_chunk``;
- ``run_chunk_cuda`` on CPU tensors (the kernels' plain versions): equal to
  the eager ``run_chunk`` in f32, bitwise;
- a tiny ``run_validation`` (ny 45, nx_cap 120, the inlet ramp cut to 300
  steps, 400 steps in chunks of 20): the force series the breaker sees
  within 5e-6 absolute of the JAX engine's, f32 on both sides. Read: at
  most 1.37e-6 over the six pairs, against forces up to 0.16, on a CPU:
  the two sum O(0.1) link terms in different orders, one f32 ulp of their
  partial sums.

The Pallas-kernel comparisons are in ``test_torch_dfg_pallas.py``.
"""

import copy
import json
import logging

import jax
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lbm2d_tpu.analysis import dfg_validation as jdfg  # noqa: E402
from lbm2d_tpu.core import solver as js  # noqa: E402
from lbm2d_tpu.core import stability as jstab  # noqa: E402
from lbm2d_tpu_torch.analysis import dfg_validation as tdfg  # noqa: E402
from lbm2d_tpu_torch.core import solver as ts  # noqa: E402
from lbm2d_tpu_torch.core import stability as tstab  # noqa: E402
from lbm2d_tpu_torch.core.engine import LBMEngine  # noqa: E402
from lbm2d_tpu_torch.ops import cuda_step as cs  # noqa: E402
from torch_monitor_checks import assert_runner_monitors  # noqa: E402

OBSTACLES = ("bounce_back", "bounce_back_halfway", "bounce_back_bouzidi")
INLETS = ("equilibrium", "nebb")
PAIRS = [(o, i) for o in OBSTACLES for i in INLETS]
PAIR_IDS = [f"{o}-{i}" for o, i in PAIRS]
NY, NX_CAP = 48, 128
STEPS = 12
SERIES_TOL = 5e-6


def small_case(obstacle, inlet):
    cfg, mask, _ = tdfg.dfg_case(ny=NY, obstacle=obstacle, inlet=inlet, nx_cap=NX_CAP)
    cfg["simulation"]["warmup_steps"] = 10
    return cfg, mask


def seeded_fields(shape, seed=0):
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.01 * rng.standard_normal(shape)
    u = 0.03 * rng.standard_normal((2,) + shape)
    return rho, u


def torch_state(rho, u, dtype):
    rho_t = torch.tensor(rho, dtype=dtype)
    u_t = torch.tensor(u, dtype=dtype)
    f = ts.f_eq(rho_t, u_t[0], u_t[1])
    return ts.LBMState(f=f, f_post=f.clone(), rho=rho_t, u=u_t, step=0)


@pytest.mark.parametrize("obstacle, inlet", PAIRS, ids=PAIR_IDS)
def test_dfg_case_matches_jax(obstacle, inlet):
    for kw in (dict(ny=NY, nx_cap=NX_CAP), dict(ny=165)):
        cj, mj, dj = jdfg.dfg_case(obstacle=obstacle, inlet=inlet, **kw)
        ct, mt, dt = tdfg.dfg_case(obstacle=obstacle, inlet=inlet, **kw)
        assert ct == cj and dt == dj
        np.testing.assert_array_equal(mt, mj)
    assert ct["simulation"]["nx"] == 881 and dt == 40  # the full DFG grid


@pytest.mark.parametrize("obstacle, inlet", PAIRS, ids=PAIR_IDS)
def test_eager_step_matches_jax_f64(obstacle, inlet):
    cfg, mask = small_case(obstacle, inlet)
    pj = js.make_params(cfg, mask, dtype=jnp.float64)
    pt = ts.make_params(copy.deepcopy(cfg), mask, dtype=torch.float64)
    if obstacle == "bounce_back_bouzidi":
        np.testing.assert_array_equal(pt.bouzidi_q.numpy(), np.asarray(pj.bouzidi_q))
    np.testing.assert_array_equal(pt.inlet_profile.numpy(), np.asarray(pj.inlet_profile))
    rho, u = seeded_fields(pt.shape)
    st = torch_state(rho, u, torch.float64)
    f = st.f.numpy()
    sj = js.LBMState(f=jnp.asarray(f), f_post=jnp.asarray(f), rho=jnp.asarray(rho),
                     u=jnp.asarray(u), step=jnp.asarray(0, jnp.int32))
    sj, mj = js.run_chunk(sj, pj, STEPS)
    st, mt = ts.run_chunk(st, pt, STEPS)
    for k in ("f", "f_post", "rho", "u"):
        np.testing.assert_allclose(getattr(st, k).numpy(), np.asarray(getattr(sj, k)),
                                   rtol=0, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(mt["force"].numpy(), np.asarray(mj["force"]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(mt["max_v"]), float(mj["max_v"]), rtol=0, atol=1e-12)


@pytest.mark.parametrize("obstacle, inlet", PAIRS, ids=PAIR_IDS)
def test_chunk_runner_equals_eager_f32(obstacle, inlet):
    cfg, mask = small_case(obstacle, inlet)
    p = ts.make_params(cfg, mask)
    assert cs.supports(p)
    s0 = torch_state(*seeded_fields(p.shape), torch.float32)
    before = dict(cs.LAUNCHES)
    a, ma = cs.run_chunk_cuda(s0, p, 7)
    a, ma = cs.run_chunk_cuda(a, p, 5)  # the second chunk starts inside the warmup
    b, mb = ts.run_chunk(s0, p, 12)
    for k in ("f", "f_post", "rho", "u"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert_runner_monitors(ma, a, p, mb)
    assert cs.LAUNCHES == before  # CPU tensors never count as launches
    c, _ = cs.run_chunk_plain(s0, p, 12)
    assert torch.equal(c.f, b.f)


@pytest.mark.parametrize("obstacle", OBSTACLES)
def test_engine_store_dev_follows_jax_rule(obstacle, caplog):
    cfg, mask = small_case(obstacle, "nebb")
    cfg["simulation"]["f16_state"] = True
    with caplog.at_level(logging.WARNING, logger="lbm2d_tpu_torch.core.engine"):
        eng = LBMEngine(cfg, mask, device="cpu")
    refused = cs.dev_storage_refusal(eng.params)
    if obstacle == "bounce_back":
        # full-way bounce runs deviation storage, as run_chunk_pallas does
        assert eng.store_dev and refused is None and not caplog.records
    else:
        assert not eng.store_dev and "exact f32" in refused
        assert len(caplog.records) == 1 and "not engaged" in caplog.records[0].getMessage()
    # the chunk runner applies the same rule on its own
    p = eng.params
    s0 = torch_state(*seeded_fields(p.shape), torch.float32)
    dev, _ = cs.run_chunk_cuda(s0, p, 6, store_dev=True)
    exact, _ = cs.run_chunk_cuda(s0, p, 6)
    diff = float((dev.f - exact.f).abs().max())
    assert (diff > 0) == (obstacle == "bounce_back"), diff


def _short_warmup(monkeypatch, module):
    """The module's dfg_case with the inlet ramp cut from 8000 to 300 steps,
    so a few hundred steps develop a real flow."""
    real = module.dfg_case

    def dfg_case(*a, **kw):
        cfg, mask, d = real(*a, **kw)
        cfg["simulation"]["warmup_steps"] = 300
        return cfg, mask, d

    monkeypatch.setattr(module, "dfg_case", dfg_case)


def _capture_series(monkeypatch, module):
    forces = []
    real = module.check_stability

    def recording(f, max_v, step, **kw):
        forces.append((step, float(f[0]), float(f[1]), float(max_v)))
        return real(f, max_v, step, **kw)

    monkeypatch.setattr(module, "check_stability", recording)
    return forces


@pytest.mark.parametrize("obstacle, inlet", PAIRS, ids=PAIR_IDS)
def test_tiny_validation_matches_jax(obstacle, inlet, monkeypatch):
    kw = dict(mode="dfg", re=100.0, u_target=0.1, ny=45, nx_cap=120, steps=400, chunk=20,
              obstacle=obstacle, inlet=inlet, progress=False)
    _short_warmup(monkeypatch, jdfg)
    _short_warmup(monkeypatch, tdfg)
    fj = _capture_series(monkeypatch, jstab)
    rj = jdfg.run_validation(**kw)
    ft = _capture_series(monkeypatch, tstab)
    rt = tdfg.run_validation(device="cpu", **kw)
    assert len(ft) == len(fj) == 20
    a, b = np.asarray(ft), np.asarray(fj)
    np.testing.assert_array_equal(a[:, 0], b[:, 0])
    np.testing.assert_allclose(a[:, 1:], b[:, 1:], rtol=0, atol=SERIES_TOL)
    assert np.abs(b[:, 1]).max() > 100 * SERIES_TOL  # a real drag to compare
    assert rt.keys() == rj.keys()
    for k in ("steps", "ny", "diameter_px", "obstacle", "inlet", "mode"):
        assert rt[k] == rj[k], k
    np.testing.assert_allclose(rt["u_inlet_measured"], rj["u_inlet_measured"], rtol=0,
                               atol=SERIES_TOL)


def test_validation_cli_device(monkeypatch, capsys):
    args = ["dfg_validation", "--mode", "dfg", "--obstacle", "bounce_back_bouzidi",
            "--inlet", "nebb", "--ny", "24", "--nx_cap", "60", "--steps", "200",
            "--chunk", "10"]
    if not torch.cuda.is_available():
        # the entry point defaults to the card
        monkeypatch.setattr("sys.argv", args)
        with pytest.raises(RuntimeError, match="no CUDA device"):
            tdfg.main()
    monkeypatch.setattr("sys.argv", args + ["--device", "cpu"])
    tdfg.main()
    out = capsys.readouterr().out
    res = json.loads(out[out.index("{"):])
    assert res["obstacle"] == "bounce_back_bouzidi" and res["inlet"] == "nebb"
    assert res["steps"] == 200 and np.isfinite(res["cd_mean"])


def test_physics_utils_match_jax():
    from lbm2d_tpu.utils import physics as jp
    from lbm2d_tpu_torch.utils import physics as tp

    rng = np.random.default_rng(4)
    t = np.arange(200, dtype=float)  # samples, as the FFT seed of the fit counts them
    lift = 0.3 * np.sin(2 * np.pi * t / 85.0 + 0.4) + 0.01 * rng.standard_normal(200)
    drag = 1.2 + 0.02 * rng.standard_normal(200)
    for a, b in zip(tp.compute_coefficients(drag, lift, 0.1, 40),
                    jp.compute_coefficients(drag, lift, 0.1, 40)):
        np.testing.assert_array_equal(a, b)
    (ct, pt_), (cj, pj) = tp.fit_sine_wave(t, lift), jp.fit_sine_wave(t, lift)
    np.testing.assert_array_equal(ct, cj)
    np.testing.assert_array_equal(pt_, pj)
    assert abs(2 * np.pi / pt_[1] - 85.0) < 1.0  # the fit found the period
    assert tp.strouhal_number(pt_[1] / 20.0, 40, 0.0667) == jp.strouhal_number(
        pj[1] / 20.0, 40, 0.0667)
    mask = np.zeros((30, 50))
    mask[10:17, 20:24] = 1
    assert tp.characteristic_length_projection(mask) == jp.characteristic_length_projection(mask) == 7
    np.testing.assert_array_equal(tp.parabolic_inlet_velocity(np.arange(11), 0.1, 11),
                                  jp.parabolic_inlet_velocity(np.arange(11), 0.1, 11))
    bounds = [(0.0, 1.0), (10.0, 20.0)]
    np.testing.assert_array_equal(
        tp.latin_hypercube(8, bounds, np.random.default_rng(1)),
        jp.latin_hypercube(8, bounds, np.random.default_rng(1)))
