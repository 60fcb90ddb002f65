"""Port lattice functions vs the JAX package, in f64 on seeded fields."""

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lbm2d_tpu.core import lattice as jl  # noqa: E402
from lbm2d_tpu_torch.core import lattice as tl  # noqa: E402

TOL = 1e-14  # both sides round the same f64 operations in the same order


def _fields(seed=0, shape=(12, 20)):
    rng = np.random.default_rng(seed)
    rho = 1.0 + 0.05 * rng.standard_normal(shape)
    ux = 0.1 * rng.standard_normal(shape)
    uy = 0.1 * rng.standard_normal(shape)
    return rho, ux, uy


def _close(a, b):
    np.testing.assert_allclose(np.asarray(a), b.numpy(), rtol=0, atol=TOL)


def test_constants_match():
    for name in ("E", "OPP", "W", "M", "M_INV", "M_INV_X36"):
        np.testing.assert_array_equal(getattr(jl, name), getattr(tl, name))
    assert jl.PI_REF == tl.PI_REF
    assert tl.W.dtype == np.float64


@pytest.mark.parametrize("fn", ["f_eq", "m_eq"])
def test_equilibria(fn):
    rho, ux, uy = _fields(1)
    a = getattr(jl, fn)(jnp.asarray(rho), jnp.asarray(ux), jnp.asarray(uy))
    b = getattr(tl, fn)(torch.tensor(rho), torch.tensor(ux), torch.tensor(uy))
    _close(a, b)


def test_unit_equilibria():
    _, ux, uy = _fields(2)
    _close(jl.f_eq_unit(jnp.asarray(ux), jnp.asarray(uy)),
           tl.f_eq_unit(torch.tensor(ux), torch.tensor(uy)))
    _close(jl.f_eq_unit_x(jnp.asarray(ux)), tl.f_eq_unit_x(torch.tensor(ux)))
    _close(jl.f_eq_unit_y(jnp.asarray(uy)), tl.f_eq_unit_y(torch.tensor(uy)))
    # the axis specialisations are bitwise the general form with the other u 0
    z = torch.zeros_like(torch.tensor(ux))
    assert torch.equal(tl.f_eq_unit_x(torch.tensor(ux)), tl.f_eq_unit(torch.tensor(ux), z))


def test_moment_transforms():
    rng = np.random.default_rng(3)
    f = rng.random((9, 10, 14))
    m_j = jl.moments_from_f(jnp.asarray(f))
    m_t = tl.moments_from_f(torch.tensor(f))
    _close(m_j, m_t)
    np.testing.assert_allclose(m_t.numpy(), np.einsum("ij,jyx->iyx", tl.M, f), atol=1e-13)
    _close(jl.f_from_moments(m_j), tl.f_from_moments(m_t))
    np.testing.assert_allclose(tl.f_from_moments(m_t).numpy(), f, atol=1e-14)
