"""A chunk issued as one program: the scalar-row table, the chunk plan and
the library step loops, checked through their plain versions on the CPU.

``run_chunk_cuda`` builds a chunk's scalar rows once (``scalar_rows``) and
issues its fast steps through ``k3_passes`` and ``k1_steps``, which on the
card are single calls of the shared libraries' loops; on CPU tensors they
run their plain versions, whose Python loops hold the rows, the step
numbering and the ping-pong parity that the C loops reproduce. Each check
here is against the per-step form (``scalar_row``, ``run_chunk_stepwise``)
or the eager step, bitwise, or against the JAX package on the same
inputs with the tolerance stated.
"""

import gc

import jax
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lbm2d_tpu.core import solver as js  # noqa: E402
from lbm2d_tpu.ops.pallas_step import _scalars  # noqa: E402
from lbm2d_tpu_torch.core import solver as ts  # noqa: E402
from lbm2d_tpu_torch.core.lattice import f_eq  # noqa: E402
from lbm2d_tpu_torch.ops import cuda_step as cs  # noqa: E402
from torch_monitor_checks import assert_runner_monitors  # noqa: E402

H, W = 20, 36
WARMUP = 12


def make_config(bc_type=(0, 2, 1, 2), obstacle="equilibrium", warmup=WARMUP, nu=0.02):
    return {
        "simulation": {
            "nx": W, "ny": H, "nu": nu, "ghost_moments_s": 1.2,
            "rho_in": 1.02, "rho_out": 1.0, "warmup_steps": warmup,
            "smagorinsky_constant": 0.1,
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


def make_mask():
    mask = np.zeros((H, W), np.float32)
    mask[7:12, 10:15] = 1.0
    mask[3:6, 1] = 1.0  # column 1: read by the left BC
    mask[1, 20] = 1.0  # row 1: read by the bottom BC
    return mask


def seeded_state(seed=0, step=0):
    rng = np.random.default_rng(seed)
    rho = torch.tensor(1.0 + 0.01 * rng.standard_normal((H, W)), dtype=torch.float32)
    u = torch.tensor(0.03 * rng.standard_normal((2, H, W)), dtype=torch.float32)
    f = f_eq(rho, u[0], u[1])
    return ts.LBMState(f=f, f_post=f.clone(), rho=rho, u=u, step=step)


def assert_bitwise(a, b):
    for k in ("f", "f_post", "rho", "u"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert a.step == b.step


# (first step - 1, steps): before the warmup, straddling it, starting at
# it, after it
CHUNKS = [(0, 5), (8, 10), (WARMUP - 1, 6), (40, 7)]


@pytest.mark.parametrize("dtype", [torch.float32, torch.float64], ids=["f32", "f64"])
@pytest.mark.parametrize("warmup", [WARMUP, 12.5, 0], ids=["w12", "w12.5", "w0"])
@pytest.mark.parametrize("step0, n", CHUNKS, ids=["before", "straddling", "at", "after"])
def test_scalar_rows_equal_per_step_rows(dtype, warmup, step0, n):
    p = ts.make_params(make_config(warmup=warmup), make_mask(), dtype=dtype)
    rows = cs.scalar_rows(p, step0, n)
    assert rows.dtype == dtype and rows.is_contiguous() and tuple(rows.shape) == (n, 14)
    want = torch.stack([cs.scalar_row(p, step0 + 1 + i) for i in range(n)])
    assert torch.equal(rows, want)
    # K3's [S, 14] rows are slices of the same table
    plan = cs.chunk_plan(n, 4)
    for i in range(plan.passes):
        got = rows[plan.k3_rows][i * 4:(i + 1) * 4]
        assert torch.equal(got, torch.stack([cs.scalar_row(p, step0 + 1 + i * 4 + j)
                                             for j in range(4)]))


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_scalar_rows_match_jax(dtype):
    """The table against the JAX package's per-step SMEM row ``_scalars``
    over a chunk that straddles the warmup: within 4 ulp (the two cos
    implementations may round apart; the port's own rows are bitwise)."""
    cfg = make_config()
    pj = js.make_params(cfg, make_mask(), dtype=getattr(jnp, dtype))
    pt = ts.make_params(cfg, make_mask(), dtype=getattr(torch, dtype))
    rows = cs.scalar_rows(pt, 5, 12).numpy()
    want = np.stack([np.asarray(_scalars(pj, jnp.asarray(6 + i, jnp.int32),
                                         getattr(jnp, dtype)))[0] for i in range(12)])
    np.testing.assert_allclose(rows, want, rtol=4 * np.finfo(dtype).eps, atol=0)


def test_host_row_read_once_per_params(monkeypatch):
    reads = []
    real = cs._read_host_row

    def counting(p):
        reads.append(id(p))
        return real(p)

    monkeypatch.setattr(cs, "_read_host_row", counting)
    p = ts.make_params(make_config(), make_mask())
    s, _ = cs.run_chunk_cuda(seeded_state(), p, 5)
    s, _ = cs.run_chunk_cuda(s, p, 5)
    cs.scalar_row(p, 3)
    assert reads == [id(p)]
    # a new params object reads again, and its own values
    p2 = ts.make_params(make_config(nu=0.05), make_mask())
    cs.run_chunk_cuda(seeded_state(), p2, 3)
    assert reads == [id(p), id(p2)]
    assert cs.scalar_rows(p2, 0, 1)[0, 0] == p2.tau0 != p.tau0
    assert cs.scalar_rows(p, 0, 1)[0, 0] == p.tau0
    # the entry leaves with its object, so a later object at the same
    # address cannot find it
    key = id(p2)
    del p2
    gc.collect()
    assert key not in cs._HOST_ROWS


# n in {1, 2, S, S + 1, 262} at S in {0, 4, 8} (S = 0: unfused)
PLANS = [(S, n) for S in (0, 4, 8) for n in sorted({1, 2, S, S + 1, 262} - {0})]


@pytest.mark.parametrize("S, n", PLANS, ids=[f"S{S}-n{n}" for S, n in PLANS])
def test_chunk_plan(S, n):
    plan = cs.chunk_plan(n, S)
    want = divmod(n - 1, S) if S else (0, n - 1)
    assert (plan.passes, plan.singles) == want
    # the rows cover steps 1 .. n - 1 once, K3's first, whole passes only
    assert plan.k3_rows == slice(0, plan.passes * S)
    assert plan.k1_rows == slice(plan.passes * S, n - 1)
    assert plan.k1_rows.stop - plan.k1_rows.start == plan.singles
    # the parity, from the per-step runner's rule: each launch writes the
    # buffer its source is not, the first buffer 0
    src, bufs = "state", ("buf0", "buf1")
    for _ in range(plan.passes + plan.singles):
        src = bufs[1] if src == bufs[0] else bufs[0]
    closing = bufs[1] if src == bufs[0] else bufs[0]
    assert closing == bufs[plan.parity]
    if n == 262:  # 261 fast steps: 261 K1, 65 K3 + 1 K1, 32 K3 + 5 K1
        assert plan.parity == {0: 1, 4: 0, 8: 1}[S]


@pytest.mark.parametrize("fuse", [None, 3, 4], ids=["unfused", "S3", "S4"])
@pytest.mark.parametrize("store_dev", [False, True], ids=["f32", "dev"])
@pytest.mark.parametrize("n", [1, 2, 5, 9, 13])
def test_chunk_loop_equals_stepwise(fuse, store_dev, n, monkeypatch):
    """The chunk through the loop entries (their plain versions here) is
    the per-step wrapper loop, bitwise, from a state that straddles the
    warmup."""
    monkeypatch.setattr(cs, "_FUSE_STEPS", fuse)
    p = ts.make_params(make_config(), make_mask())
    s0 = seeded_state(1, step=WARMUP - 4)
    a, ma = cs.run_chunk_cuda(s0, p, n, store_dev=store_dev)
    b, mb = cs.run_chunk_stepwise(s0, p, n, store_dev=store_dev)
    assert_bitwise(a, b)
    assert torch.equal(ma["force"], mb["force"]) and torch.equal(ma["max_v"], mb["max_v"])


@pytest.mark.parametrize("bc_type, obstacle", [((0, 2, 1, 2), "equilibrium"),
                                               ((4, 2, 1, 2), "bounce_back_bouzidi"),
                                               ((3, 0, 1, 0), "bounce_back_halfway")],
                         ids=["0212-eq", "4212-bouzidi", "3010-halfway"])
def test_plain_runner_equals_eager(bc_type, obstacle):
    """``run_chunk_plain`` fed by the table, chunks straddling the warmup,
    against the eager step, bitwise."""
    p = ts.make_params(make_config(bc_type, obstacle), make_mask())
    s0 = seeded_state(2)
    a, _ = cs.run_chunk_plain(s0, p, 9)
    a, ma = cs.run_chunk_plain(a, p, 8)
    b, mb = ts.run_chunk(s0, p, 17)
    assert_bitwise(a, b)
    assert_runner_monitors(ma, a, p, mb)


def test_chunk_runner_matches_jax():
    """The chunk runner (loop entries' plain versions) against the JAX
    package's jnp ``run_chunk`` on the same seeded f32 state, a chunk
    straddling the warmup: f within 1e-5 relative (test_torch_solver's f32
    tolerance; the two round the same operations in another order)."""
    cfg = make_config()
    pt = ts.make_params(cfg, make_mask())
    pj = js.make_params(cfg, make_mask(), dtype=jnp.float32)
    s0 = seeded_state(3)
    sj = js.LBMState(f=jnp.asarray(s0.f.numpy()), f_post=jnp.asarray(s0.f_post.numpy()),
                     rho=jnp.asarray(s0.rho.numpy()), u=jnp.asarray(s0.u.numpy()),
                     step=jnp.asarray(0, jnp.int32))
    a, _ = cs.run_chunk_cuda(s0, pt, 16)
    b, _ = js.run_chunk(sj, pj, 16)
    for k in ("f", "rho"):
        x, y = getattr(a, k).numpy(), np.asarray(getattr(b, k))
        assert np.abs(x - y).max() <= 1e-5 * np.abs(y).max(), k


def test_loop_entries_return_the_buffer_holding_f():
    p = ts.make_params(make_config(), make_mask())
    s0 = seeded_state(4)
    aux = cs.pack_aux(p.damping, p.mask)
    rows = cs.scalar_rows(p, 0, 3)
    fa, fb = torch.empty_like(s0.f), torch.empty_like(s0.f)
    out = cs.k1_steps(s0.f, fa, fb, aux, rows, p.use_les, p.bc_type)
    assert out is fa
    ref = s0.f
    for i in range(3):
        nxt = torch.empty_like(ref)
        cs.k1_step(ref, nxt, aux, cs.scalar_row(p, i + 1), p.use_les, p.bc_type)
        ref = nxt
    assert torch.equal(out, ref)
    # f_b may be f_in: only step 0 reads it
    f_in = s0.f.clone()
    out = cs.k1_steps(f_in, torch.empty_like(f_in), f_in, aux, rows[:2], p.use_les, p.bc_type)
    assert out is f_in
    rows4 = cs.scalar_rows(p, 0, 8)
    fa, fb = torch.empty_like(s0.f), torch.empty_like(s0.f)
    out = cs.k3_passes(s0.f, fa, fb, aux, rows4, 4, p.bc_type, p.use_les, tile=(6, 8))
    assert out is fb


def test_loop_table_checks():
    with pytest.raises(ValueError, match="table"):
        cs._check_rows("k1_steps", torch.zeros(3, 14, dtype=torch.float64), 3)
    with pytest.raises(ValueError, match="table"):
        cs._check_rows("k1_steps", torch.zeros(3, 13), 3)
    with pytest.raises(ValueError, match="table"):
        cs._check_rows("k1_steps", torch.zeros(14, 3).t(), 3)
    cs._check_rows("k1_steps", torch.zeros(3, 14), 3)
    err = cs._loop_failed("k1_steps", 700, 41, 99)
    assert isinstance(err, RuntimeError) and "launch 41 of 99" in str(err)
    assert "refused" in str(cs._loop_failed("k3_passes", 1, -1, 5))
