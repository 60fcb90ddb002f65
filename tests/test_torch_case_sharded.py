"""The case-sharded lockstep runner (``BatchEngine(runner="sharded")``) on
the CPU: bitwise against ``runner="auto"`` on the same configs, padding
included (B = 3 on 2 devices, B = 5 on 4), with a case that dies mid-run;
and against the JAX package's ``BatchEngine(runner="vmap")`` within the
port's f32 bar (f 1e-6 abs; forces, sums over the obstacle, 1e-4)."""

import numpy as np
import pytest
import torch

from lbm2d_tpu.parallel.batch import BatchEngine as JaxBatchEngine
from lbm2d_tpu_torch.parallel.batch import BatchEngine, case_mesh
from test_parallel import block_mask, grid_config

NX, NY = 48, 24
CHUNKS, STEPS = 5, 10


def _configs(b):
    """b cases of one shape; case 1 diverges in the third chunk."""
    cfgs, masks = [], []
    for i in range(b):
        cfg = grid_config(NX, NY, rho_in=1.01 + 0.005 * i)
        cfg["simulation"]["nu"] = 0.02 + 0.01 * i
        if i == 1:
            cfg["simulation"]["nu"] = -0.05  # tau < 0.5
            cfg["simulation"]["warmup_steps"] = 1
        cfgs.append(cfg)
        masks.append(block_mask(NY, NX))
    return cfgs, masks


def _run(eng):
    mons = [eng.run_step(STEPS) for _ in range(CHUNKS)]
    return mons, eng.state, eng.alive_mask


@pytest.mark.parametrize("store_dev", [False, True], ids=["f32", "store_dev"])
@pytest.mark.parametrize("b,d", [(3, 2), (5, 4)])
def test_sharded_equals_auto_bitwise(b, d, store_dev):
    cfgs, masks = _configs(b)
    auto = BatchEngine(cfgs, masks, device="cpu", store_dev=store_dev)
    sh = BatchEngine(cfgs, masks, device="cpu", store_dev=store_dev, runner="sharded",
                     n_devices=d)
    assert len(sh.mesh) == min(d, b)
    assert sh._shard_pad == (-b) % min(d, b)
    ma, sa, aa = _run(auto)
    ms, ss, as_ = _run(sh)
    assert not aa[1] and aa[0] and aa[2:].all()  # case 1 died mid-run
    np.testing.assert_array_equal(as_, aa)
    for x, y in zip(ms, ma):
        for k in ("force", "max_v", "stable"):
            assert x[k].shape[0] == b  # the pad's outputs are discarded
            np.testing.assert_array_equal(x[k], y[k])
    for k in ("f", "f_post", "rho", "u", "step"):
        assert torch.equal(getattr(ss, k), getattr(sa, k)), k
    np.testing.assert_array_equal(sh.get_moments(), auto.get_moments())
    assert torch.equal(sh.get_velocity_device(), auto.get_velocity_device())


def test_sharded_matches_jax_vmap():
    cfgs, masks = _configs(3)
    ref = JaxBatchEngine(cfgs, masks, runner="vmap")
    sh = BatchEngine(cfgs, masks, device="cpu", runner="sharded", n_devices=2)
    for _ in range(CHUNKS):
        mr = ref.run_step(STEPS)
        ms = sh.run_step(STEPS)
    np.testing.assert_array_equal(sh.alive_mask, np.asarray(ref.alive_mask))
    np.testing.assert_array_equal(ms["stable"], np.asarray(mr["stable"]))
    for i in (0, 2):  # the live cases
        np.testing.assert_allclose(sh.state.f[i].numpy(), np.asarray(ref.state.f[i]),
                                   rtol=0, atol=1e-6)
        np.testing.assert_allclose(ms["force"][i], np.asarray(mr["force"])[i], atol=1e-4)
    assert sh.state.step.tolist() == np.asarray(ref.state.step).tolist()


def test_sharded_set_state_round_trip():
    cfgs, masks = _configs(3)
    a = BatchEngine(cfgs, masks, device="cpu", runner="sharded", n_devices=2)
    a.run_step(STEPS)
    b = BatchEngine(cfgs, masks, device="cpu", runner="sharded", n_devices=2)
    b.set_state(a.state, a.alive_mask)
    a.run_step(STEPS)
    b.run_step(STEPS)
    assert torch.equal(a.state.f, b.state.f)


def test_case_mesh_and_refusals():
    assert case_mesh(3, "cpu") == [torch.device("cpu")] * 3
    assert case_mesh(devices=["cpu", "cpu"]) == [torch.device("cpu")] * 2
    with pytest.raises(ValueError):
        case_mesh(3, devices=["cpu"])
    cfgs, masks = _configs(2)
    with pytest.raises(ValueError, match="runner"):
        BatchEngine(cfgs, masks, device="cpu", runner="vmap")
    with pytest.raises(ValueError, match="sharded"):
        BatchEngine(cfgs, masks, device="cpu", n_devices=2)
    # a case mesh is never wider than the batch
    assert len(BatchEngine(cfgs, masks, device="cpu", runner="sharded", n_devices=4).mesh) == 2
