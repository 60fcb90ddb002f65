"""The port's BatchEngine (parallel/batch.py) against the JAX package's
(tests/test_parallel.py's batch cases), on the CPU.

On the CPU the JAX engine advances its cases through the vmap lockstep of
the jnp step, and the port through the eager step per case; both freeze a
diverged case in place. In f32 the two steps agree to a few ulps, hence
f within 1e-6, forces (sums over the obstacle) within 1e-4 and moments
within 1e-5, the JAX package's own tolerances for its two batch runners.
With 16-bit deviation storage the JAX reference is its sequential Pallas
runner in interpret mode, held to the 5e-4 deviation-storage budget.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm2d_tpu.parallel.batch import BatchEngine as JaxBatchEngine
from lbm2d_tpu.parallel.batch import init_batch_state as jax_init_batch_state
from lbm2d_tpu_torch.core import solver as ts
from lbm2d_tpu_torch.parallel.batch import BatchEngine, init_batch_state, stack_params
from test_parallel import block_mask, grid_config
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

BUDGET = 5e-4  # the JAX package's store_dev budget


def _diverging_pair(nx=64, ny=32):
    good = grid_config(nx, ny, rho_in=1.02)
    bad = grid_config(nx, ny, rho_in=1.02)
    bad["simulation"]["nu"] = -0.16  # tau < 0.5: unconditionally unstable
    bad["simulation"]["warmup_steps"] = 1
    return [good, bad], [block_mask(ny, nx), block_mask(ny, nx)]


def test_batch_matches_jax_with_a_diverging_case():
    cfgs, masks = _diverging_pair()
    ref = JaxBatchEngine(cfgs, masks, runner="vmap")
    eng = BatchEngine(cfgs, masks, device="cpu")
    for _ in range(6):
        mr = ref.run_step(10)
        mt = eng.run_step(10)
    assert (eng.alive_mask == ref.alive_mask).all()
    assert eng.alive_mask[0] and not eng.alive_mask[1]
    np.testing.assert_array_equal(mt["stable"], mr["stable"])
    np.testing.assert_allclose(
        eng.state.f[0].numpy(), np.asarray(ref.state.f[0]), rtol=0, atol=1e-6
    )
    np.testing.assert_allclose(mt["force"], np.asarray(mr["force"]), atol=1e-4)
    np.testing.assert_allclose(eng.get_moments()[0], ref.get_moments()[0], atol=1e-5)
    assert eng.state.step.tolist() == np.asarray(ref.state.step).tolist()


def test_batch_equals_per_case_runs():
    nx, ny = 48, 24
    cfgs = [grid_config(nx, ny, rho_in=1.01), grid_config(nx, ny, rho_in=1.03)]
    masks = [block_mask(ny, nx), np.zeros((ny, nx), np.float32)]
    eng = BatchEngine(cfgs, masks, device="cpu")
    eng.run_step(15)
    for i, (cfg, mask) in enumerate(zip(cfgs, masks)):
        st, _ = ts.run_chunk(ts.init_state(ny, nx), ts.make_params(cfg, mask), 15)
        assert torch.equal(eng.state.f[i], st.f), i
    assert eng.alive_mask.all()


def test_store_dev_batch_matches_jax_pallas():
    # 65536 cells: below them the lockstep engine runs exact f32, as the
    # JAX auto runner does (its vmap jnp chunk); the JAX "pallas" runner
    # engages deviation storage at any size
    nx, ny = 1024, 64
    cfgs = [grid_config(nx, ny, rho_in=1.02), grid_config(nx, ny, rho_in=1.03)]
    masks = [block_mask(ny, nx), block_mask(ny, nx)]
    ref = JaxBatchEngine(cfgs, masks, runner="pallas", store_dev=True)
    eng = BatchEngine(cfgs, masks, store_dev=True, device="cpu")
    exact = BatchEngine(cfgs, masks, device="cpu")
    assert eng._store_dev and not exact._store_dev
    for _ in range(2):
        ref.run_step(8)
        eng.run_step(8)
        exact.run_step(8)
    f_dev = eng.state.f.numpy()
    np.testing.assert_allclose(f_dev, np.asarray(ref.state.f), rtol=0, atol=BUDGET)
    diff = np.abs(f_dev - exact.state.f.numpy()).max()
    assert 0 < diff <= BUDGET, diff
    assert (eng.alive_mask == ref.alive_mask).all()


def test_store_dev_from_the_config_key():
    nx, ny = 1024, 64  # the lockstep engine's smallest grid for it: 65536 cells
    cfg = grid_config(nx, ny)
    cfg["simulation"]["f16_state"] = True
    assert BatchEngine([cfg], [block_mask(ny, nx)], device="cpu")._store_dev
    assert not BatchEngine([cfg], [block_mask(ny, nx)], store_dev=False, device="cpu")._store_dev


def test_dead_case_stays_frozen_across_chunks():
    nx, ny = 48, 24
    cfgs = [grid_config(nx, ny, rho_in=1.01 + 0.01 * i) for i in range(3)]
    masks = [block_mask(ny, nx)] * 3
    ref = BatchEngine(cfgs, masks, device="cpu")
    eng = BatchEngine(cfgs, masks, device="cpu")
    ref.run_step(10)
    eng.run_step(10)
    frozen = eng.state
    eng.set_state(frozen, np.array([True, False, True]))
    for _ in range(2):
        ref.run_step(10)
        mon = eng.run_step(10, sync=False)
        mon = eng.sync_monitors(mon)
    after = eng.state
    for b in (0, 2):  # alive: equal to the never-killed engine
        assert torch.equal(after.f[b], ref.state.f[b])
    assert torch.equal(after.f[1], frozen.f[1]) and torch.equal(after.u[1], frozen.u[1])
    assert after.step.tolist() == [30, 10, 30]
    assert mon["force"].shape == (3, 2) and mon["max_v"].shape == (3,)
    assert eng.alive_mask.tolist() == [True, False, True]
    # all dead: run_step leaves the state as it is
    eng.set_state(after, np.zeros(3, bool))
    eng.run_step(10)
    assert torch.equal(eng.state.f, after.f)


def test_set_state_round_trip():
    nx, ny = 48, 24
    cfgs = [grid_config(nx, ny, rho_in=1.01), grid_config(nx, ny, rho_in=1.03)]
    masks = [block_mask(ny, nx)] * 2
    a = BatchEngine(cfgs, masks, device="cpu")
    a.run_step(10)
    # through numpy, as the group checkpoint stores it
    st = a.state
    saved = ts.LBMState(
        f=torch.from_numpy(st.f.numpy()), f_post=torch.from_numpy(st.f_post.numpy()),
        rho=torch.from_numpy(st.rho.numpy()), u=torch.from_numpy(st.u.numpy()),
        step=torch.from_numpy(st.step.numpy()),
    )
    b = BatchEngine(cfgs, masks, device="cpu")
    b.set_state(saved, a.alive_mask)
    for k in ("f", "f_post", "rho", "u", "step"):
        assert torch.equal(getattr(b.state, k), getattr(st, k)), k
    a.run_step(10)
    b.run_step(10)
    assert torch.equal(a.state.f, b.state.f)


def test_stacked_params_and_rest_state_match_jax_layout():
    nx, ny = 48, 24
    cfgs = [grid_config(nx, ny, rho_in=1.01), grid_config(nx, ny, rho_in=1.03)]
    p = stack_params([ts.make_params(c, block_mask(ny, nx)) for c in cfgs])
    assert tuple(p.mask.shape) == (2, ny, nx) and tuple(p.rho_in.shape) == (2,)
    np.testing.assert_allclose(p.rho_in.numpy(), [1.01, 1.03], rtol=1e-6)
    st = init_batch_state(2, ny, nx)
    ref = jax_init_batch_state(2, ny, nx, jnp.float32)
    for k in ("f", "f_post", "rho", "u"):
        np.testing.assert_array_equal(getattr(st, k).numpy(), np.asarray(getattr(ref, k)))
    mixed = grid_config(nx, ny)
    mixed["boundary_condition"]["type"] = [0, 0, 1, 0]
    with pytest.raises(ValueError, match="bc_type"):
        stack_params([ts.make_params(cfgs[0]), ts.make_params(mixed)])
