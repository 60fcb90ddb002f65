"""The production-shaped smoke case and its sibling project
(``lbm2d_tpu_torch/tools/smoke_case.py``), which ``chip_smoke.py`` and the
trace tool drive on the card, and the in-memory ``h5py.File`` stand-in they
write through where h5py is missing: here it must hold what a real HDF5
file holds."""

import json
import os

import cv2
import h5py
import numpy as np
import pytest
import yaml

from lbm2d_tpu_torch.io import h5_writer
from lbm2d_tpu_torch.tools import smoke_case
import torch_threads  # noqa: F401  (the test processes' torch thread budget)


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

    _use_memory_h5(monkeypatch)
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



def _use_memory_h5(monkeypatch):
    """Put the writer and the readers on the stand-in, as where h5py is
    missing; monkeypatch restores them."""
    from lbm2d_tpu_torch.analysis import h5_inspect, io_bench
    from lbm2d_tpu_torch.post import h5_to_zarr

    monkeypatch.setattr(h5_writer, "h5py", h5_writer.h5py)
    monkeypatch.setattr(h5_writer, "_HAS_H5PY", False)
    for reader in (h5_to_zarr, h5_inspect, io_bench):
        monkeypatch.setattr(reader, "_h5py", reader._h5py)
    monkeypatch.setattr(smoke_case.MemH5File, "FILES", {})
    assert smoke_case.use_memory_h5()
    assert h5_to_zarr._h5py() is h5_inspect._h5py() is io_bench._h5py() is smoke_case.MemH5


def test_memory_h5_reads_back_as_h5py_does(tmp_path, monkeypatch, capsys):
    """h5_to_zarr and h5_inspect read a file written through the stand-in
    as they read the same file written by h5py: the same Zarr tree byte for
    byte, the same printed tree."""
    from lbm2d_tpu_torch.analysis import h5_inspect
    from lbm2d_tpu_torch.post import h5_to_zarr
    from test_torch_tools import assert_same_tree

    config, mask = smoke_case.load_smoke_case()
    rng = np.random.default_rng(1)
    frames = [rng.normal(1.0, 0.05, (9, 256, 554)).astype(np.float32) for _ in range(3)]
    summary = str(tmp_path / "summary.json")
    with open(summary, "w") as fh:
        json.dump([{"case_name": "case", "status": "Success",
                    "run_summary": {"h5_file": "case.h5"}}], fh)
    trees = {}
    for tag in ("real", "mem"):
        if tag == "mem":
            _use_memory_h5(monkeypatch)
        (tmp_path / tag).mkdir()
        _write_case(str(tmp_path / tag / "case.h5"), config, mask, frames)
        assert (tmp_path / tag / "case.h5").exists() == (tag == "real")
        stats = h5_to_zarr.run(summary, str(tmp_path / tag), str(tmp_path / f"zarr_{tag}"))
        assert stats["cases"] == ["case"]
        h5_inspect.print_structure(str(tmp_path / tag / "case.h5"))
        trees[tag] = capsys.readouterr().out.replace(str(tmp_path / tag), "<dir>")
    assert_same_tree(str(tmp_path / "zarr_real"), str(tmp_path / "zarr_mem"))
    assert trees["real"] == trees["mem"]
    assert "turbulence: (3, 9, 256, 554) float32 [lzf]" in trees["mem"]


def test_memory_h5_grows_by_doubling():
    """Appending a frame grows the stand-in's buffer by doubling, so the
    frames it holds are copied O(log n) times, not on every append; the
    dataset still reads back every frame, and shrinking clears the tail."""
    d = smoke_case.MemDataset(shape=(0, 2, 3), dtype=np.float32)
    bufs, frames = [], []
    for i in range(9):
        n = d.shape[0]
        d.resize(n + 1, axis=0)
        frames.append(np.full((2, 3), i, np.float32))
        d[n] = frames[-1]
        bufs.append(d._buf)
    assert d.shape == (9, 2, 3) and d.dtype == np.float32
    np.testing.assert_array_equal(d.a, np.stack(frames))
    np.testing.assert_array_equal(d[3:5], np.stack(frames[3:5]))
    assert len({id(b) for b in bufs}) == 5  # buffers of 1, 2, 4, 8 and 16 frames
    assert d._buf.shape[0] == 16
    d.resize(4)
    assert d.shape == (4, 2, 3) and not d._buf[4:].any()
    with pytest.raises(ValueError):
        d.resize(3, axis=1)


def test_memory_h5_read_mode(tmp_path, monkeypatch):
    _use_memory_h5(monkeypatch)
    path = str(tmp_path / "x.h5")
    with pytest.raises(FileNotFoundError):
        smoke_case.MemH5File(path, "r")
    f = smoke_case.MemH5File(path, "w")
    f.create_dataset("a", data=np.arange(6, dtype=np.float32).reshape(2, 3), compression="lzf")
    f.attrs["k"] = 1
    with smoke_case.MemH5File(path, "r") as g:
        assert g is f and "a" in g and g.keys() == ["a"]
        assert g["a"].dtype == np.float32 and g["a"].compression == "lzf"
        np.testing.assert_array_equal(g["a"][1:], [[3, 4, 5]])
        seen = []
        g.visititems(lambda name, obj: seen.append((name, obj.shape)))
        assert seen == [("a", (2, 3))]
    # "w" again starts an empty file
    assert smoke_case.MemH5File(path, "w").keys() == []
