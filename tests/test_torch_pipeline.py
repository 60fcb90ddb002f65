"""The port's serial batch pipeline vs the JAX package's, on the same
project (tests/test_pipeline_e2e.make_project), both on the CPU.

Both write HDF5 / mp4 / sim_results.json / summary / NPZ artifacts; the
datasets must have the same names, shapes, dtypes and attrs, with values
within 1e-5 relative to each dataset's largest value (the f32 step agrees
to a few ulps, and the dataset resize and statistics are the same host
code). The one exception is ``sum_vor``, a sum of finite differences of
u = j / rho: the differences cancel about two digits of the moments'
agreement (3.5e-7 on ``turbulence``), measured 2.7e-5, held to 1e-4.
"""

import json
import os

import h5py
import numpy as np
import pytest

from lbm2d_tpu.pipeline.batch_run import run_batch as jax_run_batch
from lbm2d_tpu_torch.pipeline.batch_run import run_batch
from test_pipeline_e2e import make_project

CASE = "mask_00_Nu0-0500"
RTOL = 1e-5
RTOL_DERIVED = {"sum_vor": 1e-4}


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    root_j = str(tmp_path_factory.mktemp("jax"))
    root_t = str(tmp_path_factory.mktemp("torch"))
    make_project(root_j)
    make_project(root_t)
    assert jax_run_batch("TestProj", root=root_j, progress=False)["success"] == 1
    assert run_batch("TestProj", root=root_t, progress=False, device="cpu")["success"] == 1
    return root_j, root_t


def _h5(root):
    return os.path.join(root, "outputs", "TestProj", "raw", f"{CASE}.h5")


def _plots(root, name):
    return os.path.join(root, "outputs", "TestProj", "plots", name)


def _close(a, b, what):
    a, b = np.asarray(a), np.asarray(b)
    assert a.shape == b.shape and a.dtype == b.dtype, what
    if a.dtype.kind in "fc":
        scale = max(float(np.abs(b).max()), np.finfo(np.float32).tiny)
        assert np.abs(a - b).max() <= RTOL_DERIVED.get(what, RTOL) * scale, what
    else:
        np.testing.assert_array_equal(a, b, err_msg=what)


def test_hdf5_artifacts_match(roots):
    root_j, root_t = roots
    with h5py.File(_h5(root_j), "r") as fj, h5py.File(_h5(root_t), "r") as ft:
        assert sorted(fj.keys()) == sorted(ft.keys())
        for name in fj:
            _close(ft[name][()], fj[name][()], name)
            assert dict(ft[name].attrs) == dict(fj[name].attrs), name
        assert sorted(fj.attrs) == sorted(ft.attrs)
        for name in fj.attrs:
            a, b = ft.attrs[name], fj.attrs[name]
            if isinstance(b, np.ndarray) and b.dtype.kind == "f":
                _close(a, b, name)
            elif name == "config_json":
                # the same case config; only the project root differs
                assert a.replace(root_t, root_j) == b
            else:
                assert a == b, name
        assert ft["turbulence"].shape[0] == 5


def test_results_summary_and_npz_match(roots):
    root_j, root_t = roots
    with open(_plots(root_j, "sim_results.json")) as fh:
        rj = json.load(fh)
    with open(_plots(root_t, "sim_results.json")) as fh:
        rt = json.load(fh)
    assert [(e["config_filename"], e["status"]) for e in rt] == [
        (e["config_filename"], e["status"]) for e in rj
    ] == [("mask_00_cfg_Nu0-0500.yaml", "Success")]
    assert rt[0]["parameters"]["simulation_outputs"] == rj[0]["parameters"]["simulation_outputs"]
    assert sorted(rt[0]) == sorted(rj[0])
    with open(_plots(root_j, "all_cases_summary.json")) as fh:
        sj = json.load(fh)
    with open(_plots(root_t, "all_cases_summary.json")) as fh:
        st = json.load(fh)
    assert [e["status"] for e in st] == [e["status"] for e in sj]

    def keys(d, prefix=""):
        out = set()
        for k, v in d.items():
            out.add(prefix + k)
            if isinstance(v, dict):
                out |= keys(v, prefix + k + ".")
        return out

    assert keys(st[0]) == keys(sj[0])
    nj = np.load(_plots(root_j, "all_cases_vectors.npz"), allow_pickle=True)
    nt = np.load(_plots(root_t, "all_cases_vectors.npz"), allow_pickle=True)
    assert sorted(nt.files) == sorted(nj.files)
    assert list(nt["feature_names"]) == list(nj["feature_names"])
    assert list(nt["statuses"]) == list(nj["statuses"])
    assert nt["vectors"].shape == nj["vectors"].shape
    vis = os.path.join(root_t, "outputs", "TestProj", "vis", f"{CASE}.mp4")
    assert os.path.exists(vis)


def test_resume_skips_finished_cases(roots):
    _, root_t = roots
    r = run_batch("TestProj", root=root_t, progress=False, device="cpu")
    assert r == {"success": 0, "skipped": 1, "failed": 0}
