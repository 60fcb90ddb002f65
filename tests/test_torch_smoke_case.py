"""The production-shaped smoke case and its sibling project
(``lbm2d_tpu_torch/tools/smoke_case.py``), which ``chip_smoke.py`` and the
trace tool drive on the card, and the in-memory ``h5py.File`` stand-in they
write through where h5py is missing: here it must hold what a real HDF5
file holds."""

import os

import cv2
import h5py
import numpy as np
import yaml

from lbm2d_tpu_torch.io import h5_writer
from lbm2d_tpu_torch.tools import smoke_case


def test_smoke_case_is_the_production_grid():
    config, mask = smoke_case.load_smoke_case()
    sim = config["simulation"]
    assert mask.shape == (sim["ny"], sim["nx"]) == (1152, 2432)
    assert mask.dtype == np.float32 and set(np.unique(mask)) == {0.0, 1.0}
    assert 0 < mask.mean() < 0.5


def test_sibling_project_varies_only_nu(tmp_path):
    config, mask = smoke_case.load_smoke_case()
    names = smoke_case.write_sibling_project(str(tmp_path), config, mask)
    base = tmp_path / "SimCases" / "Smoke4"
    cfgs = []
    for fname, case in names:
        with open(base / "configs" / fname) as fh:
            cfgs.append(yaml.safe_load(fh))
        assert cfgs[-1]["simulation"]["name"] == case
        assert cfgs[-1]["outputs"]["video"]["enable"]
    assert tuple(c["simulation"]["nu"] for c in cfgs) == smoke_case.SIBLING_NUS
    for c in cfgs:
        c["simulation"].pop("nu"), c["simulation"].pop("name"), c["outputs"].pop("video")
        assert c == cfgs[0]
    png = cv2.imread(cfgs[0]["mask"]["path"], cv2.IMREAD_GRAYSCALE)
    np.testing.assert_array_equal(png == 0, mask > 0.5)


def _write_case(path, config, mask, frames):
    w = h5_writer.LBMCaseWriter(path, config, config["simulation"]["nx"],
                                config["simulation"]["ny"], mask_yx=mask)
    for fr in frames:
        w.append(fr, pre_resized=True)
    w.close()
    return w


def test_memory_h5_holds_what_h5py_writes(tmp_path, monkeypatch):
    config, mask = smoke_case.load_smoke_case()
    rng = np.random.default_rng(0)
    real = str(tmp_path / "real.h5")
    probe = h5_writer.LBMCaseWriter(str(tmp_path / "probe.h5"), config, 2432, 1152)
    shape = (9, probe.target_h, probe.target_w)
    probe.close()
    frames = [rng.standard_normal(shape).astype(np.float32) for _ in range(3)]
    _write_case(real, config, mask, frames)

    monkeypatch.setattr(h5_writer, "h5py", h5_writer.h5py)
    monkeypatch.setattr(h5_writer, "_HAS_H5PY", False)
    assert smoke_case.use_memory_h5()
    mem = str(tmp_path / "mem.h5")
    _write_case(mem, config, mask, frames)
    assert not os.path.exists(mem)

    held = smoke_case.MemH5File.FILES.pop(mem)
    np.testing.assert_array_equal(smoke_case.read_turbulence(real), np.stack(frames))
    with h5py.File(real, "r") as f:
        assert sorted(held.datasets) == sorted(f)
        for k in f:
            np.testing.assert_array_equal(held.datasets[k].a, f[k][()], err_msg=k)
        for k in ("stats_min", "stats_max", "stats_mean"):
            np.testing.assert_array_equal(held.attrs[k], f.attrs[k])
