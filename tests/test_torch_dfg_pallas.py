"""The port's DFG-path kernels (through their plain versions on the CPU)
against the JAX package's Pallas kernels, run as its own tests run them:
``run_chunk_pallas(interpret=True, split_bc=True)``, the split-BC path
whose two kernels K1 and K2 replace.

Same case as ``test_torch_dfg.py``: ``dfg_case(ny=48, nx_cap=128)`` with a
10-step warmup, from a seeded developed-looking state, 12 steps, f32.
Limits, each set from a reading on the CPU:

- ``run_chunk_plain`` against the Pallas chunk: f, rho, u within 1e-6
  absolute. Read on a CPU: 3.6e-7 in every pair, a few f32 ulps of O(1)
  values.
- 16-bit deviation storage under full-way bounce, from rest with the
  30-step ramp of ``test_torch_store_dev.py``'s budget test: the port's
  ``run_chunk_cuda(store_dev=True)`` within that file's 5e-5 of the JAX
  ``run_chunk_pallas(store_dev=True)``. Read on a CPU: 7.6e-6 with the
  equilibrium inlet, 4.6e-5 with NEBB. The two K2s differ
  by design in one bf16 rounding of the neighbour strip
  (``test_torch_store_dev.py``), and the NEBB inlet copies that strip's
  non-equilibrium part into the ring one to one. Under an impulsive 10-step
  ramp the same pair reads 4.7e-4 apart, each within the 5e-4 budget of
  its exact chunk (2.8e-4 and 3.2e-4): the loss scales with the flow's
  gradients at the inlet.
- Half-way and Bouzidi with ``store_dev``: both packages run exact f32,
  so each equals its own f32 chunk bitwise.
"""

import numpy as np
import pytest
import torch

from lbm2d_tpu.core import solver as js
from lbm2d_tpu.ops.pallas_step import run_chunk_pallas
from lbm2d_tpu_torch.core import solver as ts
from lbm2d_tpu_torch.ops import cuda_step as cs
from test_torch_dfg import PAIR_IDS, PAIRS, STEPS, seeded_fields, small_case, torch_state
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

F32_TOL = 1e-6
VS_JAX_DEV = 5e-5


def jax_state(st):
    f = st.f.numpy()
    return js.LBMState(f=f, f_post=f, rho=st.rho.numpy(), u=st.u.numpy(),
                       step=np.int32(st.step))


def max_abs(a, b):
    return max(float(np.abs(np.asarray(getattr(a, k)) - np.asarray(getattr(b, k))).max())
               for k in ("f", "rho", "u"))


@pytest.mark.parametrize("obstacle, inlet", PAIRS, ids=PAIR_IDS)
def test_plain_chunk_matches_pallas(obstacle, inlet):
    cfg, mask = small_case(obstacle, inlet)
    pt = ts.make_params(cfg, mask)
    pj = js.make_params(cfg, mask)
    s0 = torch_state(*seeded_fields(pt.shape), torch.float32)
    sj, mj = run_chunk_pallas(jax_state(s0), pj, n_steps=STEPS, interpret=True, split_bc=True)
    st, mt = cs.run_chunk_plain(s0, pt, STEPS)
    assert max_abs(st, sj) <= F32_TOL
    # force: a sum of O(0.1) link terms (read 4.8e-7)
    np.testing.assert_allclose(mt["force"].numpy(), np.asarray(mj["force"]), rtol=0, atol=2e-6)
    if obstacle != "bounce_back":
        # the JAX rule: store_dev does not engage, the chunk is exact f32
        sd, _ = run_chunk_pallas(jax_state(s0), pj, n_steps=STEPS, interpret=True,
                                 split_bc=True, store_dev=True)
        for k in ("f", "rho", "u"):
            np.testing.assert_array_equal(np.asarray(getattr(sd, k)), np.asarray(getattr(sj, k)))
        td, _ = cs.run_chunk_cuda(s0, pt, STEPS, store_dev=True)
        for k in ("f", "rho", "u"):
            assert torch.equal(getattr(td, k), getattr(st, k)), k


@pytest.mark.parametrize("inlet", ["equilibrium", "nebb"])
def test_store_dev_bounce_matches_pallas(inlet):
    cfg, mask = small_case("bounce_back", inlet)
    cfg["simulation"]["warmup_steps"] = 30  # the ramp of the store_dev budget test
    pt = ts.make_params(cfg, mask)
    pj = js.make_params(cfg, mask)
    s0 = ts.init_state(*pt.shape)
    sj, _ = run_chunk_pallas(jax_state(s0), pj, n_steps=STEPS, interpret=True,
                             split_bc=True, store_dev=True)
    sd, _ = cs.run_chunk_cuda(s0, pt, STEPS, store_dev=True)
    exact, _ = cs.run_chunk_cuda(s0, pt, STEPS)
    assert max_abs(sd, sj) <= VS_JAX_DEV
    assert 0 < max_abs(sd, exact) <= 5e-4  # engaged, within the JAX budget
