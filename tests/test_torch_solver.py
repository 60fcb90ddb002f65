"""Port eager step vs the JAX package's jnp ``run_chunk``, fed the same
seeded numpy state, over 40 steps.

f64: within 1e-12 absolute (values are O(1); both sides round the same
operations in the same order, so the gap is reduction order, ~1e-16).
f32: f, f_post, rho and the force within 1e-5 relative to their largest
value; u within 1e-5 of the lattice speed (c = 1). On the pressure-boundary
columns u is 1 - sum(f) / rho, so one f32 ulp of the O(1) sum is an absolute
1.2e-7 in u whatever the flow speed: measured 2.4e-7 after 40 steps, 1.1e-5
of max |u| there.
"""

import copy

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lbm2d_tpu.core import solver as js  # noqa: E402
from lbm2d_tpu.core.stability import is_stable_device as jax_is_stable  # noqa: E402
from lbm2d_tpu.ops.pallas_step import _scalars  # noqa: E402
from lbm2d_tpu_torch.core import solver as ts  # noqa: E402
from lbm2d_tpu_torch.core.stability import is_stable_device  # noqa: E402
from lbm2d_tpu_torch.ops.cuda_step import scalar_row  # noqa: E402

H, W = 24, 40
STEPS = 40


def make_config(bc_type=(0, 2, 1, 2), obstacle="equilibrium", cs=0.1):
    return {
        "simulation": {
            "nx": W, "ny": H, "nu": 0.02, "ghost_moments_s": 1.2,
            "rho_in": 1.02, "rho_out": 1.0, "warmup_steps": 15,
            "smagorinsky_constant": cs,
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


def make_mask(edge_solids=False):
    mask = np.zeros((H, W), np.float32)
    mask[9:15, 12:18] = 1.0
    if edge_solids:
        # solids on the strips the BCs read (column 1 / W-2, row 1 / H-2)
        # and on the ring itself
        mask[4:7, 1] = 1.0
        mask[17, W - 2] = 1.0
        mask[1, 25] = 1.0
        mask[H - 2, 6] = 1.0
        mask[0, 30] = 1.0
        mask[11, 0] = 1.0
    return mask


def seeded_state(seed, jdtype, tdtype):
    """The same developed-looking state for both packages: f = f_eq of
    seeded noise on rho and u."""
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.01 * rng.standard_normal((H, W))
    u = 0.03 * rng.standard_normal((2, H, W))
    f = np.asarray(
        js.f_eq(jnp.asarray(rho, jdtype), jnp.asarray(u[0], jdtype), jnp.asarray(u[1], jdtype))
    )
    sj = js.LBMState(
        f=jnp.asarray(f), f_post=jnp.asarray(f), rho=jnp.asarray(rho, jdtype),
        u=jnp.asarray(u, jdtype), step=jnp.asarray(0, jnp.int32),
    )
    st = ts.LBMState(
        f=torch.tensor(f), f_post=torch.tensor(f), rho=torch.tensor(rho, dtype=tdtype),
        u=torch.tensor(u, dtype=tdtype), step=0,
    )
    return sj, st


CASES = {
    "production_0212": dict(),
    "all_inlet": dict(bc_type=(0, 0, 0, 0)),
    "slip_inlet_mix": dict(bc_type=(2, 0, 2, 2)),
    "left_noop_outlet": dict(bc_type=(1, 2, 1, 0)),
    "vel_inlet_3": dict(bc_type=(3, 2, 1, 2)),
    "vel_inlet_nebb_4": dict(bc_type=(4, 2, 1, 2)),
    "no_les": dict(cs=0.0),
    "full_way_bounce": dict(obstacle="bounce_back"),
    "half_way_bounce": dict(obstacle="bounce_back_halfway"),
    "solid_on_edge_strips": dict(edge_solids=True),
}


def run_both(case, jdtype, tdtype, seed=0):
    kw = dict(case)
    edge = kw.pop("edge_solids", False)
    cfg = make_config(**kw)
    mask = make_mask(edge)
    pj = js.make_params(cfg, mask, dtype=jdtype)
    pt = ts.make_params(copy.deepcopy(cfg), mask, dtype=tdtype)
    sj, st = seeded_state(seed, jdtype, tdtype)
    sj, mj = js.run_chunk(sj, pj, STEPS)
    st, mt = ts.run_chunk(st, pt, STEPS)
    return sj, mj, st, mt


@pytest.mark.parametrize("name", list(CASES))
def test_eager_step_matches_jax_f64(name):
    sj, mj, st, mt = run_both(CASES[name], jnp.float64, torch.float64)
    assert st.step == int(sj.step) == STEPS
    for k in ("f", "f_post", "rho", "u"):
        np.testing.assert_allclose(getattr(st, k).numpy(), np.asarray(getattr(sj, k)),
                                   rtol=0, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(mt["force"].numpy(), np.asarray(mj["force"]), rtol=0, atol=1e-12)
    np.testing.assert_allclose(float(mt["max_v"]), float(mj["max_v"]), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["production_0212", "solid_on_edge_strips"])
def test_eager_step_matches_jax_f32(name):
    sj, mj, st, mt = run_both(CASES[name], jnp.float32, torch.float32)
    for k in ("f", "f_post", "rho", "u"):
        a, b = getattr(st, k).numpy(), np.asarray(getattr(sj, k))
        scale = 1.0 if k == "u" else np.abs(b).max()
        assert np.abs(a - b).max() <= 1e-5 * scale, k
    fj = np.asarray(mj["force"])
    assert np.abs(mt["force"].numpy() - fj).max() <= 1e-5 * np.abs(fj).max()


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_scalar_row_matches_jax(dtype):
    cfg = make_config()
    pj = js.make_params(cfg, make_mask(), dtype=getattr(jnp, dtype))
    pt = ts.make_params(cfg, make_mask(), dtype=getattr(torch, dtype))
    for step in (0, 1, 7, 15, 16, 1000):
        a = np.asarray(_scalars(pj, jnp.asarray(step, jnp.int32), getattr(jnp, dtype)))[0]
        b = scalar_row(pt, step).numpy()
        assert b.dtype == np.dtype(dtype)
        np.testing.assert_allclose(b, a, rtol=4 * np.finfo(dtype).eps, atol=0)


def test_neighbor_solid_bits_match_jax():
    mask = make_mask(edge_solids=True)
    a = np.asarray(js.neighbor_solid_bits(jnp.asarray(mask)))
    b = ts.neighbor_solid_bits(torch.tensor(mask)).numpy()
    np.testing.assert_array_equal(b, a)


@pytest.mark.parametrize(
    "force, max_v, step",
    [
        ((0.1, -0.2), 0.05, 10),
        ((np.nan, 0.0), 0.05, 10),
        ((2e6, 0.0), 0.05, 10),
        ((0.1, 0.0), 0.3, 10),  # fast but still in warmup
        ((0.1, 0.0), 0.3, 50),
        ((0.1, 0.0), np.inf, 10),
    ],
)
def test_is_stable_device_matches_jax(force, max_v, step):
    a = bool(jax_is_stable(jnp.asarray(force), jnp.asarray(max_v), jnp.asarray(step), 20))
    b = is_stable_device(torch.tensor(force), torch.tensor(max_v), step, 20)
    assert b.dtype == torch.bool and bool(b) == a
