"""Bouzidi interpolated bounce-back in the port against the JAX package.

The q planes are numpy code copied from the JAX package and must be equal
bitwise for every geometry of its menu (cylinder, rect, triangle, polygon,
union, and the mask's own signed distance). The eager step and the
Bouzidi force run in f64 within 1e-12 of the jnp versions (both round the
same operations in the same order; the gap is summation order). With every
q = 1/2 the scheme is half-way bounce-back, bitwise.
"""

import copy

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lbm2d_tpu.core import solver as js  # noqa: E402
from lbm2d_tpu.tools.shapes import add_circle, add_rotated_rect, add_triangle  # noqa: E402
from lbm2d_tpu_torch.core import solver as ts  # noqa: E402
from lbm2d_tpu_torch.core.convert import params_from_numpy  # noqa: E402

NY, NX = 30, 44
CYL = {"shape": "cylinder", "cx": 12.3, "cy": 14.6, "r": 5.2}
RECT = {"shape": "rect", "cx": 28.6, "cy": 15.1, "w": 8.0, "h": 6.0, "angle_deg": 33.0}
TRI = {"shape": "triangle", "cx": 30.3, "cy": 14.8, "size": 7.0, "angle_deg": 12.0,
       "orientation": "vertex_left"}
POLY = {"shape": "polygon", "vertices": [[20.2, 8.1], [31.7, 10.4], [27.9, 21.6], [18.4, 17.3]]}


def raster(geom):
    mask = np.zeros((NY, NX), np.uint8)
    shape = geom["shape"]
    if shape == "cylinder":
        add_circle(mask, geom["cx"], geom["cy"], geom["r"])
    elif shape == "rect":
        add_rotated_rect(mask, geom["cx"], geom["cy"], geom["w"], geom["h"], geom["angle_deg"])
    elif shape == "triangle":
        add_triangle(mask, geom["cx"], geom["cy"], geom["size"], geom["angle_deg"],
                     geom["orientation"])
    elif shape == "polygon":
        import cv2

        cv2.fillPoly(mask, [np.round(np.asarray(geom["vertices"])).astype(np.int32)], 1)
    elif shape == "union":
        for part in geom["parts"]:
            mask |= raster(part)
    return mask


GEOMS = {
    "cylinder": (CYL, raster(CYL)),
    "rect": (RECT, raster(RECT)),
    "triangle": (TRI, raster(TRI)),
    "polygon": (POLY, raster(POLY)),
    "union": ({"shape": "union", "parts": [CYL, RECT]}, raster(CYL) | raster(RECT)),
    "sdf": (None, raster(CYL) | raster(TRI)),
}


@pytest.mark.parametrize("name", list(GEOMS))
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_q_planes_equal_jax_bitwise(name, dtype):
    geom, mask = GEOMS[name]
    mask = mask.astype(np.float32)
    a = ts.bouzidi_q_planes(mask, copy.deepcopy(geom), dtype)
    b = js.bouzidi_q_planes(mask, copy.deepcopy(geom), dtype)
    assert a.dtype == b.dtype == dtype
    np.testing.assert_array_equal(a, b)
    assert (a != 0.5).sum() >= 10  # real sub-grid fractions, not just the fallback


def config(obstacle="bounce_back_bouzidi", geom=CYL, bc_type=(4, 0, 1, 0)):
    cfg = {
        "simulation": {
            "nx": NX, "ny": NY, "nu": 0.04, "ghost_moments_s": 1.2, "rho_in": 1.0,
            "rho_out": 1.0, "smagorinsky_constant": 0.0, "warmup_steps": 8,
        },
        "boundary_condition": {
            "type": list(bc_type),
            "value": [[0.08, 0.0], [0.0, 0.0], [0.0, 0.0], [0.0, 0.0]],
            "obstacle": obstacle,
        },
        "domain_zones": {
            "sponge_in": 1, "sponge_out": 1, "sponge_top": 1, "sponge_bot": 1,
            "sponge_strength": 0.0,
        },
    }
    if obstacle == "bounce_back_bouzidi" and geom is not None:
        cfg["boundary_condition"]["obstacle_geometry"] = copy.deepcopy(geom)
    return cfg


def seeded_f(seed, shape=(9, NY, NX)):
    return np.random.default_rng(seed).uniform(0.01, 0.2, size=shape)


@pytest.mark.parametrize("name", ["cylinder", "union", "sdf"])
def test_eager_bouzidi_step_matches_jax_f64(name):
    geom, mask = GEOMS[name]
    mask = mask.astype(np.float32)
    cfg = config(geom=geom)
    pj = js.make_params(cfg, mask, dtype=jnp.float64)
    pt = ts.make_params(copy.deepcopy(cfg), mask, dtype=torch.float64)
    assert pt.bouzidi_obstacle and not (pt.halfway_obstacle or pt.bounce_obstacle)
    np.testing.assert_array_equal(pt.bouzidi_q.numpy(), np.asarray(pj.bouzidi_q))
    rng = np.random.default_rng(1)
    rho = 1.0 + 0.01 * rng.standard_normal((NY, NX))
    u = 0.03 * rng.standard_normal((2, NY, NX))
    f = np.asarray(js.f_eq(jnp.asarray(rho), jnp.asarray(u[0]), jnp.asarray(u[1])))
    sj = js.LBMState(f=jnp.asarray(f), f_post=jnp.asarray(f), rho=jnp.asarray(rho),
                     u=jnp.asarray(u), step=jnp.asarray(0, jnp.int32))
    st = ts.LBMState(f=torch.tensor(f), f_post=torch.tensor(f), rho=torch.tensor(rho),
                     u=torch.tensor(u), step=0)
    sj, mj = js.run_chunk(sj, pj, 12)
    st, mt = ts.run_chunk(st, pt, 12)
    for k in ("f", "f_post", "rho", "u"):
        np.testing.assert_allclose(getattr(st, k).numpy(), np.asarray(getattr(sj, k)),
                                   rtol=0, atol=1e-12, err_msg=k)
    np.testing.assert_allclose(mt["force"].numpy(), np.asarray(mj["force"]), rtol=0, atol=1e-12)


def test_bouzidi_collide_stream_matches_jax_on_random_f():
    mask = GEOMS["cylinder"][1].astype(np.float32)
    cfg = config()
    pj = js.make_params(cfg, mask, dtype=jnp.float64)
    pt = ts.make_params(copy.deepcopy(cfg), mask, dtype=torch.float64)
    f = seeded_f(7)
    a = ts.collide_stream_full(torch.tensor(f), pt)
    b = js.collide_stream_full(jnp.asarray(f), pj)
    for x, y in zip(a, b):
        np.testing.assert_allclose(x.numpy(), np.asarray(y), rtol=0, atol=1e-12)


@pytest.mark.parametrize("name", ["cylinder", "rect", "sdf"])
def test_bouzidi_force_matches_jax(name):
    geom, mask = GEOMS[name]
    mask = mask.astype(np.float64)
    q = js.bouzidi_q_planes(mask, copy.deepcopy(geom), np.float64)
    f_post = seeded_f(3)
    got = ts.force_on_obstacle_bouzidi(torch.tensor(f_post), torch.tensor(mask), torch.tensor(q))
    want = js.force_on_obstacle_bouzidi(jnp.asarray(f_post), jnp.asarray(mask), jnp.asarray(q))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=0, atol=1e-12)
    assert np.abs(np.asarray(want)).max() > 1e-3  # an unbalanced field: a real force
    # obstacle_force dispatches on the scheme
    pt = ts.make_params(config(geom=geom), mask.astype(np.float32), dtype=torch.float64)
    torch.testing.assert_close(ts.obstacle_force(torch.tensor(f_post), pt),
                               ts.force_on_obstacle_bouzidi(torch.tensor(f_post), pt.mask,
                                                            pt.bouzidi_q), rtol=0, atol=0)


def test_q_half_reduces_to_halfway_bitwise():
    mask = GEOMS["cylinder"][1].astype(np.float32)
    p_h = ts.make_params(config(obstacle="bounce_back_halfway"), mask)
    p_b = ts.make_params(config(), mask)
    p_b.bouzidi_q = torch.full_like(p_b.bouzidi_q, 0.5)
    s_h = ts.init_state(NY, NX)
    s_b = ts.init_state(NY, NX)
    for _ in range(12):
        s_h = ts.step(s_h, p_h)
        s_b = ts.step(s_b, p_b)
    assert torch.equal(s_h.f, s_b.f) and torch.equal(s_h.u, s_b.u)
    assert torch.equal(ts.obstacle_force(s_h.f_post, p_h), ts.obstacle_force(s_b.f_post, p_b))
    assert s_h.u[0].abs().max() > 0.01  # the inlet has driven a flow


def test_convert_carries_bouzidi_q_and_inlet_profile():
    mask = GEOMS["cylinder"][1].astype(np.float32)
    pj = js.make_params(config(), mask)
    leaves = {k: np.asarray(getattr(pj, k)) for k in (
        "mask", "damping", "tau0", "cs_factor", "s_ghost", "rho_in", "rho_out",
        "warmup_steps", "bc_value", "inlet_profile", "bouzidi_q")}
    leaves.update(use_les=pj.use_les, bc_type=pj.bc_type, bounce_obstacle=pj.bounce_obstacle,
                  halfway_obstacle=pj.halfway_obstacle, bouzidi_obstacle=pj.bouzidi_obstacle)
    pt = params_from_numpy(leaves)
    ref = ts.make_params(config(), mask)
    assert pt.bouzidi_obstacle and pt.bc_type == (4, 0, 1, 0)
    for k in ("bouzidi_q", "inlet_profile", "mask", "damping", "bc_value"):
        assert torch.equal(getattr(pt, k), getattr(ref, k)), k
    # a case without the optional leaves leaves them unset
    del leaves["bouzidi_q"], leaves["inlet_profile"]
    leaves.update(bouzidi_obstacle=False, bc_type=(0, 2, 1, 2))
    bare = params_from_numpy(leaves)
    assert bare.bouzidi_q is None and bare.inlet_profile is None
