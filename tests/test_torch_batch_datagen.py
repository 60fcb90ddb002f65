"""The port's lockstep batch path (``batch_run --lockstep`` ->
pipeline/batch_datagen.py) against the JAX package's, on the CPU, on
tests/test_batch_datagen.py's projects (its options against the port's own
runs: tests/test_torch_lockstep_options.py).

Datasets are compared as tests/test_torch_pipeline.py compares the serial
path: same names and shapes, values within 1e-5 of each dataset's largest
value (1e-4 for ``sum_vor``, a sum of finite differences that cancels two
digits). On the CPU the JAX lockstep engine ignores ``f16_state`` (its vmap
runner has no deviation storage) while the port runs its plain
deviation-storage split, so with the production flags the two differ by
the storage loss and one f16 rounding: see ``_close_production``.
"""

import json
import os

import h5py
import numpy as np
import pytest
import yaml

from lbm2d_tpu.pipeline.batch_datagen import group_configs as jax_group_configs
from lbm2d_tpu.pipeline.batch_run import run_batch as jax_run_batch
from lbm2d_tpu_torch.pipeline import batch_datagen
from lbm2d_tpu_torch.pipeline.batch_datagen import group_configs, run_batched
from lbm2d_tpu_torch.pipeline.batch_run import run_batch
from test_batch_datagen import _fake_group_runner, make_two_case_project
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

CASES = ("mask_00_Nu0-0500", "mask_00_Nu0-0300")
RTOL = 1e-5
RTOL_DERIVED = {"sum_vor": 1e-4}


def _video_on(root, name):
    cfg_dir = os.path.join(root, "SimCases", name, "configs")
    for fname in os.listdir(cfg_dir):
        path = os.path.join(cfg_dir, fname)
        with open(path) as fh:
            cfg = yaml.safe_load(fh)
        cfg["outputs"]["video"]["enable"] = True
        with open(path, "w") as fh:
            yaml.safe_dump(cfg, fh, sort_keys=False)


def _out(root, name, *parts):
    return os.path.join(root, "outputs", name, *parts)


def _h5(root, name, case):
    with h5py.File(_out(root, name, "raw", f"{case}.h5"), "r") as f:
        return {k: f[k][()] for k in f}, dict(f.attrs)


def _close(a, b, what, rtol=RTOL):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    scale = max(float(np.abs(b).max()), np.finfo(np.float32).tiny)
    assert np.abs(a - b).max() <= RTOL_DERIVED.get(what, rtol) * scale, what


def _close_production(a, b):
    """The port's production-flag frames ``a`` [T, 9, H, W] against the JAX
    lockstep run's ``b``: within one f16 rounding of each other (1e-3
    relative) plus the deviation-storage loss, read on the CPU at most
    9.2e-5 absolute (jx) and 4.9e-2 of a channel's largest value (qy;
    PERF.md). The absolute term is 2e-4, or a tenth of the channel's
    largest value where that is smaller, so a zeroed or wrong channel
    fails however small its values."""
    scale = np.abs(b).max(axis=(0, 2, 3), keepdims=True)
    atol = np.minimum(2e-4, 0.1 * scale)
    excess = np.abs(a - b) - (1e-3 * np.abs(b) + atol)
    assert excess.max() <= 0, np.unravel_index(excess.argmax(), excess.shape)


def _statuses(root, name):
    with open(_out(root, name, "plots", "sim_results.json")) as fh:
        return {e["config_filename"]: e["status"] for e in json.load(fh)}


def _fake(**kw):
    """The JAX test's stub group runner, taking the port's extra keywords."""
    fake = _fake_group_runner(**kw)

    def run(members, project_paths, output_dirs, progress, device_resize, **kwargs):
        kwargs.pop("device", None)
        return fake(members, project_paths, output_dirs, progress, device_resize, **kwargs)

    return run


@pytest.fixture(scope="module")
def lockstep_roots(tmp_path_factory):
    """One two-case project with video, run by both packages' lockstep."""
    roots = {}
    for tag, run in (("jax", jax_run_batch), ("torch", run_batch)):
        root = str(tmp_path_factory.mktemp(tag))
        make_two_case_project(root)
        _video_on(root, "LockProj")
        kw = {"device": "cpu"} if tag == "torch" else {}
        stats = run("LockProj", root=root, progress=False, lockstep=True, max_batch=8, **kw)
        assert stats["success"] == 2, (tag, stats)
        roots[tag] = root
    return roots


def test_lockstep_statuses_match_jax(lockstep_roots):
    st = _statuses(lockstep_roots["torch"], "LockProj")
    assert st == _statuses(lockstep_roots["jax"], "LockProj")
    assert sorted(st.values()) == ["Success", "Success"]


@pytest.mark.parametrize("case", CASES)
def test_lockstep_hdf5_matches_jax(lockstep_roots, case):
    dt, at = _h5(lockstep_roots["torch"], "LockProj", case)
    dj, aj = _h5(lockstep_roots["jax"], "LockProj", case)
    assert sorted(dt) == sorted(dj)
    for k in dj:
        _close(dt[k], dj[k], k)
    assert dt["turbulence"].shape[0] == 5 and np.isfinite(dt["turbulence"]).all()
    assert sorted(at) == sorted(aj)
    for k in ("stats_min", "stats_max", "stats_mean"):
        _close(at[k], aj[k], k)


def test_lockstep_summary_and_video_match_jax(lockstep_roots):
    def entries(root):
        with open(_out(root, "LockProj", "plots", "sim_results.json")) as fh:
            return {e["config_filename"]: e for e in json.load(fh)}

    et, ej = entries(lockstep_roots["torch"]), entries(lockstep_roots["jax"])
    for fname in ej:
        assert sorted(et[fname]) == sorted(ej[fname])
        so_t = et[fname]["parameters"]["simulation_outputs"]
        so_j = ej[fname]["parameters"]["simulation_outputs"]
        assert so_t["tensor_shapes"] == so_j["tensor_shapes"]
        assert so_t["total_steps_executed"] == so_j["total_steps_executed"]
        assert sorted(et[fname]["run_summary"]["transfer"]) == sorted(
            ej[fname]["run_summary"]["transfer"])
    for case in CASES:
        assert os.path.getsize(_out(lockstep_roots["torch"], "LockProj", "vis", f"{case}.mp4")) > 0
    assert os.path.exists(_out(lockstep_roots["torch"], "LockProj", "plots",
                               "all_cases_vectors.npz"))


def test_production_flags_match_jax(tmp_path):
    flags = dict(lockstep=True, device_resize=True, max_batch=5, f16_state=True,
                 f16_transfer=True, yuv_video=True, f16_retry=True, progress=False)
    roots = {}
    for tag, run in (("jax", jax_run_batch), ("torch", run_batch)):
        root = str(tmp_path / tag)
        os.makedirs(root)
        make_two_case_project(root, name="PF")
        _video_on(root, "PF")
        kw = {"device": "cpu"} if tag == "torch" else {}
        assert run("PF", root=root, **flags, **kw)["success"] == 2
        roots[tag] = root
    assert _statuses(roots["torch"], "PF") == _statuses(roots["jax"], "PF")
    for case in CASES:
        dt, _ = _h5(roots["torch"], "PF", case)
        dj, _ = _h5(roots["jax"], "PF", case)
        assert dt["turbulence"].dtype == np.float32
        assert dt["turbulence"].shape == dj["turbulence"].shape
        _close_production(dt["turbulence"], dj["turbulence"])
        assert os.path.getsize(_out(roots["torch"], "PF", "vis", f"{case}.mp4")) > 0


def test_group_configs_matches_jax(tmp_path):
    root = str(tmp_path)
    names = make_two_case_project(root)
    cfg_dir = os.path.join(root, "SimCases", "LockProj", "configs")
    for max_batch in (16, 1):
        ours = [[f for f, _ in g] for g in group_configs(names, cfg_dir, max_batch)]
        ref = [[f for f, _ in g] for g in jax_group_configs(names, cfg_dir, max_batch)]
        assert ours == ref
    assert len(group_configs(names, cfg_dir, 1)) == 2


def test_batch_run_lockstep_delegation_and_checks(tmp_path):
    root = str(tmp_path)
    names = make_two_case_project(root, name="LK")
    stats = run_batch("LK", root=root, progress=False, lockstep=True, max_batch=8,
                      device="cpu")
    assert stats["success"] == 2, stats
    assert all(_statuses(root, "LK")[n] == "Success" for n in names)
    assert os.path.exists(_out(root, "LK", "plots", "all_cases_vectors.npz"))
    stats2 = run_batch("LK", root=root, progress=False, lockstep=True, device="cpu")
    assert stats2["success"] == 0 and stats2["skipped"] == 2
    with pytest.raises(ValueError, match="f16_retry"):
        run_batch("LK", root=root, f16_retry=True, device="cpu")
    with pytest.raises(ValueError, match="f16_retry"):
        run_batch("LK", root=root, lockstep=True, f16_retry=True, device="cpu")
    with pytest.raises(ValueError, match="coordinate"):
        run_batched("LK", root=root, reclaim_stale_s=60.0, device="cpu")
    with pytest.raises(ValueError, match="coordinate"):
        run_batch("LK", root=root, lockstep=True, reclaim_stale_s=60.0, device="cpu")
    # multi-worker mode on a finished project: nothing left to claim
    stats3 = run_batched("LK", root=root, coordinate=True, device="cpu", progress=False)
    assert stats3["success"] == 0 and stats3["skipped"] == 2


def test_lockstep_max_success_stops_group_launches(tmp_path):
    root = str(tmp_path)
    names = make_two_case_project(root, name="MS")
    kw = dict(root=root, progress=False, lockstep=True, max_batch=1, device="cpu")
    assert run_batch("MS", max_success=1, **kw)["success"] == 1
    assert sorted(_statuses(root, "MS")[n] for n in names) == ["Pending", "Success"]
    assert run_batch("MS", max_success=1, **kw)["success"] == 0
    assert run_batch("MS", max_success=2, **kw)["success"] == 1
    assert all(_statuses(root, "MS")[n] == "Success" for n in names)


def test_f16_retry_recovers_quantization_failure(tmp_path, monkeypatch):
    root = str(tmp_path)
    names = make_two_case_project(root)
    calls = []
    monkeypatch.setattr(batch_datagen, "run_lockstep_group",
                        _fake(fail_f16={names[0]}, calls=calls))
    stats = run_batched("LockProj", max_batch=8, root=root, progress=False,
                        f16_state=True, f16_retry=True, device="cpu")
    assert stats["success"] == 2 and stats["failed"] == 0, stats
    assert stats["f16_retried"] == 1 and stats["f16_recovered"] == 1
    assert calls == [(True, sorted(names)), (False, [names[0]])]
    with open(_out(root, "LockProj", "plots", "sim_results.json")) as fh:
        entries = {e["config_filename"]: e for e in json.load(fh)}
    assert entries[names[0]]["status"] == entries[names[1]]["status"] == "Success"
    assert "reason" not in entries[names[0]]


def test_f16_retry_crash_safe_between_passes(tmp_path, monkeypatch):
    root = str(tmp_path)
    names = make_two_case_project(root)
    base = _fake(fail_f16={names[0]})

    def crashing(members, *args, **kwargs):
        if not kwargs.get("f16_state", False):
            raise KeyboardInterrupt  # crash as the retry pass starts
        return base(members, *args, **kwargs)

    monkeypatch.setattr(batch_datagen, "run_lockstep_group", crashing)
    with pytest.raises(KeyboardInterrupt):
        run_batched("LockProj", max_batch=8, root=root, progress=False,
                    f16_state=True, f16_retry=True, device="cpu")
    st = _statuses(root, "LockProj")
    assert st[names[0]] in ("RetryPending", "Running") and st[names[1]] == "Success"
    monkeypatch.setattr(batch_datagen, "run_lockstep_group", _fake())
    stats = run_batched("LockProj", max_batch=8, root=root, progress=False,
                        f16_state=True, f16_retry=True, device="cpu")
    assert stats["success"] == 1 and stats["skipped"] == 1, stats
    assert _statuses(root, "LockProj")[names[0]] == "Success"

    # a crash before the retry pass regroups: the failure stays RetryPending
    root2 = str(tmp_path / "pre")
    names2 = make_two_case_project(root2)
    monkeypatch.setattr(batch_datagen, "run_lockstep_group", _fake(fail_f16={names2[0]}))
    real_group_configs = batch_datagen.group_configs
    n_calls = {"n": 0}

    def crashing_group_configs(*args, **kwargs):
        n_calls["n"] += 1
        if n_calls["n"] == 2:  # the retry pass's regrouping
            raise KeyboardInterrupt
        return real_group_configs(*args, **kwargs)

    monkeypatch.setattr(batch_datagen, "group_configs", crashing_group_configs)
    with pytest.raises(KeyboardInterrupt):
        run_batched("LockProj", max_batch=8, root=root2, progress=False,
                    f16_state=True, f16_retry=True, device="cpu")
    assert _statuses(root2, "LockProj")[names2[0]] == "RetryPending"


def test_f16_retry_keeps_physical_failures_failed(tmp_path, monkeypatch):
    root = str(tmp_path)
    names = make_two_case_project(root)
    monkeypatch.setattr(batch_datagen, "run_lockstep_group", _fake(fail_always={names[1]}))
    stats = run_batched("LockProj", max_batch=8, root=root, progress=False,
                        f16_state=True, f16_retry=True, device="cpu")
    assert stats["success"] == 1 and stats["failed"] == 1, stats
    assert stats["f16_retried"] == 1 and stats["f16_recovered"] == 0
    with open(_out(root, "LockProj", "plots", "sim_results.json")) as fh:
        entries = {e["config_filename"]: e for e in json.load(fh)}
    assert entries[names[1]]["status"] == "Failed" and entries[names[1]]["reason"] == "physical"
    # without the flag, no retry happens: single f16 pass, case Failed
    root2 = str(tmp_path / "noflag")
    names2 = make_two_case_project(root2)
    monkeypatch.setattr(batch_datagen, "run_lockstep_group", _fake(fail_f16={names2[1]}))
    stats2 = run_batched("LockProj", max_batch=8, root=root2, progress=False,
                         f16_state=True, device="cpu")
    assert stats2["failed"] == 1 and "f16_retried" not in stats2
