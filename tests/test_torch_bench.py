"""The port's headline bench (``lbm2d_tpu_torch/tools/bench.py``) and its
``entry()`` (``tools/demo_case.py``) against the repository's root
``bench.py`` and ``__graft_entry__.entry()``, on the CPU.

The bench's line is held to ``bench.py``'s metric string and baseline
(read from its source), its state after the timed chunks to the JAX
package's jnp ``run_chunk`` over the same steps (f32: within 1e-6 of max
|f|; the JAX Pallas path's chunks read 3.6e-7 against it), and its guard
to its 1e-5 tolerance from both sides. The timing itself is a device
number and runs on the card only (``chip_smoke.py`` phase 11).
"""

import ast
import contextlib
import dataclasses
import io
import json
import os

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import __graft_entry__
from __graft_entry__ import _cylinder_mask, _demo_config
from lbm2d_tpu.core import solver as js
from lbm2d_tpu_torch.tools import bench, demo_case

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# a tiny bench: 32^2, 1 warm-up chunk and 2 windows of 2 chunks of 10 steps
N, CHUNK, WARM, WINDOWS, N_CHUNKS = 32, 10, 1, 2, 2
STEPS = CHUNK * (WARM + WINDOWS * N_CHUNKS)


def rel(a, b) -> float:
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.abs(a - b).max() / np.abs(b).max())


@pytest.fixture(scope="module")
def tiny():
    """(stdout, BenchResult) of the tiny bench on the CPU."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = bench.run(n=N, chunk=CHUNK, warm_chunks=WARM, windows=WINDOWS, n_chunks=N_CHUNKS,
                        device="cpu")
    return out.getvalue(), res


def bench_py_constants():
    """(metric string, vs_baseline divisor) of the root bench.py."""
    with open(os.path.join(REPO, "bench.py")) as fh:
        tree = ast.parse(fh.read())
    metric = divisor = None
    for node in ast.walk(tree):
        if isinstance(node, ast.Dict):
            keys = [k.value for k in node.keys if isinstance(k, ast.Constant)]
            if "metric" in keys:
                metric = node.values[keys.index("metric")].value
                vs = node.values[keys.index("vs_baseline")]  # round(mlups / D, 4)
                divisor = vs.args[0].right.value
    return metric, divisor


def test_metric_and_baseline_are_bench_py_s():
    metric, divisor = bench_py_constants()
    assert metric == bench.METRIC
    assert divisor == bench.BASELINE_MLUPS == 10000.0


def test_run_prints_one_json_line(tiny):
    out, res = tiny
    lines = out.splitlines()
    assert len(lines) == 1
    line = json.loads(lines[0])
    assert line == res.line
    assert list(line) == ["metric", "value", "unit", "vs_baseline"]
    assert line["metric"] == bench_py_constants()[0] and line["unit"] == "MLUPS"
    assert line["value"] > 0 and line["vs_baseline"] == pytest.approx(line["value"] / 1e4,
                                                                      abs=1e-4)
    assert res.guard_rel == 0.0  # on the CPU the chunk runner is the eager step, bitwise


def test_state_after_the_chunks_matches_jax(tiny):
    _, res = tiny
    assert res.state.step == STEPS
    p = js.make_params(_demo_config(N, N, nu=0.01, warmup=2000), _cylinder_mask(N, N),
                       dtype=jnp.float32)
    state = js.init_state(N, N, jnp.float32)
    for _ in range(STEPS // CHUNK):
        state, mon = js.run_chunk(state, p, n_steps=CHUNK)
    assert res.state.f.dtype == torch.float32
    assert rel(res.state.f.numpy(), state.f) < 1e-6
    # u from rest is O(1e-5) here: held absolutely, in lattice units (c = 1)
    np.testing.assert_allclose(res.state.u.numpy(), np.asarray(state.u), rtol=0, atol=1e-6)


@pytest.mark.parametrize("scale,raises", [(2e-5, True), (2e-6, False)],
                         ids=["past-tolerance", "inside-tolerance"])
def test_guard_holds_its_tolerance(monkeypatch, scale, raises):
    real = bench.run_chunk_cuda

    def perturbed(state, p, n, **kw):
        s, mon = real(state, p, n, **kw)
        return dataclasses.replace(s, f=s.f * (1 + scale)), mon

    monkeypatch.setattr(bench, "run_chunk_cuda", perturbed)
    p, _ = bench.bench_case(N, "cpu")
    if raises:
        with pytest.raises(RuntimeError, match="mismatch"):
            bench.guard(p)
        with pytest.raises(RuntimeError, match="mismatch"):
            bench.run(n=N, chunk=CHUNK, warm_chunks=1, windows=1, n_chunks=1, device="cpu")
    else:
        assert scale / 2 < bench.guard(p) < bench.GUARD_TOL


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.run(n=N, chunk=CHUNK, warm_chunks=WARM, windows=1, n_chunks=1)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        bench.main([])
    with pytest.raises(RuntimeError, match="no CUDA device"):
        demo_case.entry()


def test_entry_is_the_entry_module_s():
    fn_j, (state_j, p_j) = __graft_entry__.entry()
    fn, (state, p) = demo_case.entry(device="cpu")
    assert p.shape == state.f.shape[1:] == (1024, 1024)
    for name in ("mask", "damping", "tau0", "cs_factor", "s_ghost", "rho_in", "rho_out",
                 "warmup_steps", "bc_value"):
        np.testing.assert_array_equal(getattr(p, name).numpy(), np.asarray(getattr(p_j, name)),
                                      err_msg=name)
    assert (p.bc_type, p.use_les) == (tuple(p_j.bc_type), p_j.use_les)
    assert p.inlet_profile is p_j.inlet_profile is None
    np.testing.assert_array_equal(state.f.numpy(), np.asarray(state_j.f))
    s8, _ = fn(state, p)
    s8_j, _ = fn_j(state_j, p_j)
    assert s8.step == int(s8_j.step) == 8
    assert rel(s8.f.numpy(), s8_j.f) < 1e-6
