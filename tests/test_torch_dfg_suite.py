"""The port's DFG-2D matrix (``lbm2d_tpu_torch/tools/dfg_suite.py``)
against the repository's ``tools_dfg_suite.sh`` and its results file, on
the CPU: the 12 rows parsed from the shell script, the output file's
life cycle (started fresh, a row appended as it ends, each
row ``run_validation``'s dict plus ``card`` and ``wall_s``), and the
H100's committed results file against the JAX test's ranges and the TPU
rows.
"""

import json
import math
import os
import re

import pytest
import torch

from lbm2d_tpu_torch.analysis.dfg_validation import run_validation
from lbm2d_tpu_torch.tools import dfg_suite
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TPU_FILE = os.path.join(REPO, "docs", "benchmarks", "dfg2d_results.json")
H100_FILE = os.path.join(REPO, "docs", "benchmarks", "dfg2d_results_h100.json")
# a tiny row: a truncated channel at ny 45, 20 samples of 10 steps (enough
# for every key: the FFT Strouhal needs 16)
TINY = dict(obstacle="bounce_back", inlet="nebb", ny=45, nx_cap=120, u_target=0.1, chunk=10)
TINY_STEPS = 200


def shell_matrix():
    """(obstacle, inlet, ny, u, steps) of every run in tools_dfg_suite.sh."""
    rows = []
    obstacles = ()
    with open(os.path.join(REPO, "tools_dfg_suite.sh")) as fh:
        for line in fh:
            m = re.match(r"for OBS in (.+); do", line.strip())
            if m:
                obstacles, block = m.group(1).split(), []
                continue
            m = re.search(r"dfg_validation --mode dfg --ny (\d+) --u ([\d.]+) --steps (\d+) "
                          r"--obstacle \$OBS(?: --inlet (\w+))? --out", line)
            if m:
                block.append((int(m.group(1)), float(m.group(2)), int(m.group(3)),
                              m.group(4) or "equilibrium"))
            if line.strip() == "done":
                rows += [(o, inlet, ny, u, steps) for o in obstacles
                         for ny, u, steps, inlet in block]
    return rows


def tpu_keys():
    with open(TPU_FILE) as fh:
        rows = json.load(fh)
    keys = {frozenset(r) for r in rows}
    assert len(keys) == 1
    return set(next(iter(keys)))


def test_matrix_is_the_shell_script_s():
    port = [(r["obstacle"], r["inlet"], r["ny"], r["u_target"], r["steps"])
            for r in dfg_suite.MATRIX]
    assert len(port) == 12
    assert port == shell_matrix()


def test_run_suite_writes_fresh_rows_as_they_end(tmp_path, monkeypatch):
    out = tmp_path / "nested" / "results.json"
    out.parent.mkdir()
    out.write_text(json.dumps([{"stale": 1}]))
    got = dfg_suite.run_suite(str(out), steps=TINY_STEPS, device="cpu", rows=[TINY])
    rows = json.loads(out.read_text())
    assert rows == got and len(rows) == 1
    row = rows[0]
    assert set(row) == tpu_keys() | {"card", "wall_s"}
    assert row["card"] == "cpu" and row["wall_s"] > 0
    assert (row["obstacle"], row["inlet"], row["ny"], row["steps"]) == (
        TINY["obstacle"], TINY["inlet"], TINY["ny"], TINY_STEPS)
    ref = run_validation(mode="dfg", re=100.0, device="cpu", progress=False,
                         **dict(TINY, steps=TINY_STEPS))
    assert {k: v for k, v in row.items() if k not in ("card", "wall_s")} == ref

    # the matrix's rows appended as they end: a run cut in its third row
    # keeps the first two, and nothing of the last run's file
    calls = []

    def cut(**kw):
        calls.append(kw)
        if len(calls) == 3:
            raise KeyboardInterrupt
        return {k: kw[k] for k in ("obstacle", "inlet", "ny", "steps")}

    monkeypatch.setattr(dfg_suite, "run_validation", cut)
    with pytest.raises(KeyboardInterrupt):
        dfg_suite.run_suite(str(out), device="cpu")
    kept = json.loads(out.read_text())
    assert [{k: r[k] for k in ("obstacle", "inlet", "ny", "steps")} for r in kept] == [
        {k: m[k] for k in ("obstacle", "inlet", "ny", "steps")} for m in dfg_suite.MATRIX[:2]]
    assert all(r["card"] == "cpu" for r in kept)
    assert calls[0] == dict(dfg_suite.MATRIX[0], mode="dfg", re=100.0,
                            device=torch.device("cpu"), progress=False)


def test_cuda_device_raises_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a CUDA device is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        dfg_suite.run_suite(str(tmp_path / "r.json"), steps=TINY_STEPS, rows=[TINY])
    assert not (tmp_path / "r.json").exists()


def test_h100_results_file():
    """The full matrix as run on the H100: 12 rows in the script's order,
    each inside the JAX test's ranges; the ny-165 rows within 1e-3 of the
    TPU rows' Cd, in the same FFT bin of St and within 1e-3 of their Re."""
    with open(H100_FILE) as fh:
        rows = json.load(fh)
    with open(TPU_FILE) as fh:
        tpu = json.load(fh)
    assert [(r["obstacle"], r["inlet"], r["ny"], r["steps"]) for r in rows] == [
        (m["obstacle"], m["inlet"], m["ny"], m["steps"]) for m in dfg_suite.MATRIX]
    for row, ref in zip(rows, tpu):
        name = f"{row['obstacle']}/{row['inlet']}/{row['ny']}"
        assert set(row) == tpu_keys() | {"card", "wall_s"}, name
        assert "H100" in row["card"], name
        assert all(math.isfinite(v) for v in row.values() if isinstance(v, float)), name
        assert dfg_suite.gate(row) == [], name
        assert dfg_suite.recorded_row(row, tpu) is ref
        if row["ny"] == 165:
            assert abs(row["cd_mean"] - ref["cd_mean"]) <= 1e-3, name
            assert abs(row["strouhal"] - ref["strouhal"]) < 1e-9, name
            assert abs(row["re_measured"] - ref["re_measured"]) <= 1e-3, name
