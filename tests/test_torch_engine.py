"""Port LBMEngine vs the JAX package's LBMEngine on the CPU: monitors,
moments and fields after the same chunks, and checkpoints that resume in
the other package."""

import jax
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lbm2d_tpu.core.engine import LBMEngine as JaxEngine  # noqa: E402
from lbm2d_tpu_torch.core.convert import params_from_numpy, state_from_numpy  # noqa: E402
from lbm2d_tpu_torch.core.engine import LBMEngine  # noqa: E402

H, W = 32, 64
ATOL = 1e-12  # f64, values O(1)


def make_config(nx=W):
    return {
        "simulation": {
            "nx": nx, "ny": H, "name": "eng", "nu": 0.03, "ghost_moments_s": 1.2,
            "characteristic_length": 8, "rho_in": 1.01, "rho_out": 1.0,
            "smagorinsky_constant": 0.1, "warmup_steps": 20,
        },
        "domain_zones": {
            "sponge_in": 4, "sponge_out": 8, "sponge_top": 3, "sponge_bot": 3,
            "sponge_strength": 3.0,
        },
        "boundary_condition": {
            "type": [0, 2, 1, 2],
            "value": [[0.05, 0.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0]],
        },
    }


def make_mask(nx=W):
    mask = np.zeros((H, nx), np.float32)
    yy, xx = np.mgrid[0:H, 0:nx]
    mask[(yy - 15.5) ** 2 + (xx - 20) ** 2 < 25] = 1.0
    return mask


def engines():
    je = JaxEngine(make_config(), make_mask(), dtype=jnp.float64)
    te = LBMEngine(make_config(), make_mask(), dtype=torch.float64, device="cpu")
    return je, te


def assert_engines_agree(je, te):
    assert te.step_count == je.step_count
    np.testing.assert_allclose(te.get_force(), je.get_force(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(te.get_max_velocity(), je.get_max_velocity(), rtol=0, atol=ATOL)
    np.testing.assert_allclose(te.get_moments(), je.get_moments(), rtol=0, atol=ATOL)
    (ut, mt), (uj, mj) = te.get_physical_fields(), je.get_physical_fields()
    np.testing.assert_allclose(ut, uj, rtol=0, atol=ATOL)
    np.testing.assert_array_equal(mt, mj)


def test_engine_matches_jax_engine():
    je, te = engines()
    assert te.Re == pytest.approx(je.Re) and te.tau0 == je.tau0
    # monitors before any chunk are computed from the initial state
    assert_engines_agree(je, te)
    for n in (10, 15, 5):
        je.run_step(n)
        te.run_step(n)
        assert_engines_agree(je, te)
    assert te.get_moments().shape == (9, H, W)
    assert te.get_moments_device().dtype == torch.float64


@pytest.mark.parametrize("direction", ["jax_to_torch", "torch_to_jax"])
def test_checkpoint_resumes_in_the_other_package(tmp_path, direction):
    je, te = engines()
    path = str(tmp_path / "case.ckpt.npz")
    if direction == "jax_to_torch":
        je.run_step(12)
        je.save_checkpoint(path)
        te.load_checkpoint(path)
    else:
        te.run_step(12)
        te.save_checkpoint(path)
        je.load_checkpoint(path)
    ref = JaxEngine(make_config(), make_mask(), dtype=jnp.float64)
    ref.run_step(12)
    assert te.step_count == je.step_count == 12
    je.run_step(8)
    te.run_step(8)
    ref.run_step(8)
    assert_engines_agree(je, te)
    assert_engines_agree(ref, te)
    with np.load(path) as z:
        assert sorted(z.files) == ["f", "f_post", "rho", "step", "u"]
        assert z["step"].dtype == np.int32 and z["f"].shape == (9, H, W)


def test_convert_builds_params_from_jax_leaves():
    je, te = engines()
    p = je.params
    leaves = {k: np.asarray(getattr(p, k)) for k in (
        "mask", "damping", "tau0", "cs_factor", "s_ghost", "rho_in", "rho_out",
        "warmup_steps", "bc_value")}
    leaves.update(use_les=p.use_les, bc_type=p.bc_type, bounce_obstacle=p.bounce_obstacle,
                  halfway_obstacle=p.halfway_obstacle)
    pt = params_from_numpy(leaves, dtype=torch.float64)
    for k in leaves:
        a, b = getattr(pt, k), getattr(te.params, k)
        if isinstance(a, torch.Tensor):
            assert torch.equal(a, b), k
        else:
            assert a == b, k
    s = state_from_numpy({k: np.asarray(getattr(je.state, k))
                          for k in ("f", "f_post", "rho", "u", "step")}, dtype=torch.float64)
    assert s.step == 0 and torch.equal(s.f, te.state.f)


def test_engine_f32_default_matches_jax_engine():
    je = JaxEngine(make_config(), make_mask())
    te = LBMEngine(make_config(), make_mask(), device="cpu")
    je.run_step(20)
    te.run_step(20)
    mj = je.get_moments()
    assert te.get_moments().dtype == np.float32
    assert np.abs(te.get_moments() - mj).max() <= 1e-5 * np.abs(mj).max()
    # the force is a small difference of O(0.1) link sums over the obstacle:
    # the f32 summation order alone moves it by ~3e-7 absolute
    np.testing.assert_allclose(te.get_force(), je.get_force(), rtol=0, atol=1e-5)


def test_engine_device_and_unported_options():
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            LBMEngine(make_config(), make_mask())  # default device is cuda
    # 16-bit deviation storage engages (on the CPU through the kernels'
    # plain versions) on a grid of the JAX split-BC geometry (W % 128 == 0):
    # a chunk differs from the exact f32 one, within the quantization budget
    dev = LBMEngine(make_config(128), make_mask(128), device="cpu", store_dev=True)
    exact = LBMEngine(make_config(128), make_mask(128), device="cpu")
    assert dev.store_dev and not exact.store_dev
    dev.run_step(12)
    exact.run_step(12)
    diff = np.abs(dev.get_moments() - exact.get_moments()).max()
    assert 0 < diff <= 5e-4
    ref = LBMEngine(make_config(), make_mask(), device="cpu")
    ref.run_step(12)
    # a spatial mesh runs the case on its blocks, bitwise the one-block run
    sharded = LBMEngine(make_config(), make_mask(), device="cpu", spatial_mesh="2x1")
    assert sharded.mesh.grid == (2, 1)
    sharded.run_step(12)
    np.testing.assert_array_equal(sharded.get_moments(), ref.get_moments())
