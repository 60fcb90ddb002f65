"""16-bit deviation storage (``store_dev``, ``--f16_state``) in the port
against the JAX package, on the CPU.

The port's ``run_chunk_cuda(..., store_dev=True)`` runs the kernels' plain
versions on CPU tensors (``k1_step_dev_plain``, the ring included):
f kept as bf16 f - w between the fast steps, arithmetic in f32, the chunk
closed by the exact f32 full step. The JAX reference is
``run_chunk_pallas(interpret=True, split_bc=True, store_dev=True)``, set up
as tests/test_pallas.py's budget test. Both are lossy by design. Against
the exact f32 chunk the contract is the JAX package's own budget: within
5e-4 absolute, and different (the path engaged). Against each other they
are held tighter, to limits set from their readings on the CPU (f, rho, u
at most 1.53e-5 apart, max_v 9.5e-7; PERF.md). The two differ by design in
one place: the JAX edge kernel dequantizes the stored neighbour strip, the
port's K1 writes the ring from the f32 collide output its ring threads
compute, so the ring differs by one bf16 rounding of that strip.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from lbm2d_tpu.core import solver as js
from lbm2d_tpu.ops.pallas_step import run_chunk_pallas
from lbm2d_tpu_torch.core import solver as ts
from lbm2d_tpu_torch.core.engine import LBMEngine
from lbm2d_tpu_torch.ops import cuda_step as cs
from test_pallas import block_mask, cfg_grid
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

NX, NY = 128, 64
STEPS = 12
BUDGET = 5e-4  # the JAX package's store_dev budget (tests/test_pallas.py)
# the port against the JAX deviation-storage chunk: about 3x and 5x the
# largest differences read over the four cases below
VS_JAX = 5e-5
VS_JAX_MAX_V = 5e-6


def _config(bc_type, les):
    cfg = cfg_grid(NX, NY)
    cfg["boundary_condition"]["type"] = list(bc_type)
    cfg["simulation"]["smagorinsky_constant"] = 0.1 if les else 0.0
    return cfg


def _max_abs(a, b):
    return max(
        float(np.abs(np.asarray(getattr(a, k)) - np.asarray(getattr(b, k))).max())
        for k in ("f", "rho", "u")
    )


def _torch_state_np(st):
    return ts.LBMState(f=st.f.numpy(), f_post=st.f_post.numpy(), rho=st.rho.numpy(),
                       u=st.u.numpy(), step=st.step)


@pytest.mark.parametrize("les", [True, False], ids=["les", "no_les"])
@pytest.mark.parametrize("bc_type", [(0, 2, 1, 2), (0, 0, 1, 0)], ids=["0212", "0010"])
def test_store_dev_chunk_matches_jax_and_exact(bc_type, les):
    cfg = _config(bc_type, les)
    mask = block_mask(NY, NX)
    pj = js.make_params(cfg, mask)
    jax_dev, jax_mon = run_chunk_pallas(
        js.init_state(NY, NX), pj, n_steps=STEPS, interpret=True,
        split_bc=True, store_dev=True,
    )
    pt = ts.make_params(cfg, mask)
    dev, mon = cs.run_chunk_cuda(ts.init_state(NY, NX), pt, STEPS, store_dev=True)
    exact, _ = ts.run_chunk(ts.init_state(NY, NX), pt, STEPS)
    dev_np, exact_np = _torch_state_np(dev), _torch_state_np(exact)
    assert dev.step == int(jax_dev.step) == STEPS

    # against the JAX package's deviation-storage chunk
    assert _max_abs(dev_np, jax_dev) <= VS_JAX
    np.testing.assert_allclose(float(mon["max_v"]), float(jax_mon["max_v"]), rtol=0,
                               atol=VS_JAX_MAX_V)
    # against the port's exact chunk: engaged, and within the budget
    diff = _max_abs(dev_np, exact_np)
    assert 0 < diff <= BUDGET, diff


def test_quantize_equals_jax_cast_bitwise():
    rng = np.random.default_rng(0)
    rho = 1.0 + 0.05 * rng.standard_normal((NY, NX))
    u = 0.1 * rng.standard_normal((2, NY, NX))
    f = np.asarray(js.init_state(NY, NX).f)  # equilibrium at rest, then perturb
    f = (f * rho[None] + 0.01 * u[0][None] * rng.standard_normal((9, NY, NX))).astype(np.float32)
    w = np.asarray(js.W, np.float32).reshape(9, 1, 1)
    ref = np.asarray((jnp.asarray(f) - w).astype(jnp.bfloat16).astype(jnp.float32))
    q = cs.quantize(torch.from_numpy(f))
    assert q.dtype == torch.bfloat16
    np.testing.assert_array_equal(q.float().numpy(), ref)
    # and dequantize adds the weight back in f32, as the JAX chunk does
    back = np.asarray(jnp.asarray(ref) + w)
    np.testing.assert_array_equal(cs.dequantize(q).numpy(), back)


def test_single_step_chunk_stays_exact():
    # as in the JAX package, deviation storage engages only for n > 1
    pt = ts.make_params(_config((0, 2, 1, 2), True), block_mask(NY, NX))
    a, _ = cs.run_chunk_cuda(ts.init_state(NY, NX), pt, 1, store_dev=True)
    b, _ = ts.run_chunk(ts.init_state(NY, NX), pt, 1)
    for k in ("f", "f_post", "rho", "u"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k


def test_engine_engages_store_dev_on_cpu():
    cfg = _config((0, 2, 1, 2), True)
    cfg["simulation"]["characteristic_length"] = 8
    mask = block_mask(NY, NX)
    by_arg = LBMEngine(cfg, mask, device="cpu", store_dev=True)
    cfg_key = dict(cfg, simulation=dict(cfg["simulation"], f16_state=True))
    by_key = LBMEngine(cfg_key, mask, device="cpu")
    exact = LBMEngine(cfg, mask, device="cpu")
    assert by_arg.store_dev and by_key.store_dev and not exact.store_dev
    for e in (by_arg, by_key, exact):
        e.run_step(STEPS)
    assert torch.equal(by_arg.state.f, by_key.state.f)
    diff = float((by_arg.state.f - exact.state.f).abs().max())
    assert 0 < diff <= BUDGET


def test_dev_plain_versions_write_interior_then_ring():
    pt = ts.make_params(_config((0, 2, 1, 2), True), block_mask(NY, NX))
    aux = cs.pack_aux(pt.damping, pt.mask)
    scal = cs.scalar_row(pt, 1)
    f = ts.init_state(NY, NX).f
    # one call writes bf16 deviations of the interior, then of the ring from
    # the f32 collide output: each cell the f32 step's, quantized once
    fq = cs.quantize(f)
    out = torch.full_like(fq, float("nan"))
    cs.k1_step_dev(fq, out, aux, scal, pt.use_les, pt.bc_type)
    assert out.dtype == torch.bfloat16
    ref = torch.full_like(f, float("nan"))
    cs.k1_step(cs.dequantize(fq), ref, aux, scal, pt.use_les, pt.bc_type)
    assert torch.equal(out, cs.quantize(ref))
    assert out[:, 0].abs().sum() > 0


@pytest.mark.cuda
def test_dev_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    dev = torch.device("cuda")
    pt = ts.make_params(_config((0, 2, 1, 2), True), block_mask(NY, NX), device=dev)
    state, _ = ts.run_chunk(ts.init_state(NY, NX, device=dev), pt, 5)
    aux = cs.pack_aux(pt.damping, pt.mask)
    scal = cs.scalar_row(pt, state.step + 1)
    fq = cs.quantize(state.f)
    outs = []
    for k1 in (cs.k1_step_dev, cs.k1_step_dev_plain):
        out = torch.full_like(fq, float("nan"))
        k1(fq, out, aux, scal, pt.use_les, pt.bc_type)
        outs.append(out)
    torch.cuda.synchronize()
    assert torch.equal(outs[0], outs[1])
    a, _ = cs.run_chunk_cuda(state, pt, 9, store_dev=True)
    b, _ = cs.run_chunk_plain(state, pt, 9, store_dev=True)
    for k in ("f", "f_post", "rho", "u"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
