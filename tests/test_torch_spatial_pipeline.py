"""Spatial sharding as a production entry of the port, on the CPU
(counterpart of ``tests/test_spatial_pipeline.py``): ``LBMEngine`` resolves
a sharded chunk runner from ``spatial_mesh``, and ``batch_run
--spatial_mesh`` writes the serial run's artifacts byte for byte."""

import copy
import json
import logging
import os
import sys

import h5py
import numpy as np
import pytest
import torch
import yaml

from lbm2d_tpu_torch.core.engine import LBMEngine, parse_spatial_mesh
from lbm2d_tpu_torch.ops import cuda_step as cs
from lbm2d_tpu_torch.pipeline import batch_run
from lbm2d_tpu_torch.utils.masks import create_mask
from test_pipeline_e2e import make_project
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

CFG = "mask_00_cfg_Nu0-0500.yaml"
CASE = "mask_00_Nu0-0500"


def project_case(root):
    make_project(root)
    base = os.path.join(root, "SimCases", "TestProj")
    with open(os.path.join(base, "configs", CFG)) as fh:
        cfg = yaml.safe_load(fh)
    mask_path = os.path.join(base, "masks", os.path.basename(cfg["mask"]["path"]))
    return cfg, create_mask(cfg, mask_path).astype(np.float32)


def test_parse_spatial_mesh(monkeypatch):
    assert parse_spatial_mesh(None) is None
    assert parse_spatial_mesh("") is None
    assert parse_spatial_mesh("2x4") == (2, 4)
    assert parse_spatial_mesh("1X8") == (1, 8)
    assert parse_spatial_mesh([4, 2]) == (4, 2)
    assert parse_spatial_mesh(8) == (2, 4)  # most-square factorization
    assert parse_spatial_mesh("auto", "cpu") == (1, 1)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    assert parse_spatial_mesh("auto", "cuda") == (2, 2)
    with pytest.raises(ValueError):
        parse_spatial_mesh("2x4x1")


def test_engine_spatial_matches_serial(tmp_path):
    cfg, mask = project_case(str(tmp_path))
    serial = LBMEngine(cfg, mask_yx=mask, device="cpu")
    sharded = LBMEngine(cfg, mask_yx=mask, device="cpu", spatial_mesh="2x4")
    assert sharded.mesh.grid == (2, 4)
    assert {d.type for row in sharded.mesh.devices for d in row} == {"cpu"}
    for _ in range(3):
        serial.run_step(10)
        sharded.run_step(10)
    assert serial.step_count == sharded.step_count == 30
    for k in ("f", "rho", "u"):
        assert torch.equal(getattr(serial.state, k), getattr(sharded.state, k)), k
    np.testing.assert_allclose(serial.get_force(), sharded.get_force(), rtol=0, atol=1e-5)
    assert serial.get_max_velocity() == sharded.get_max_velocity()
    np.testing.assert_array_equal(serial.get_moments(), sharded.get_moments())


def test_engine_spatial_store_dev_and_checkpoint(tmp_path):
    cfg, mask = project_case(str(tmp_path))
    # 16-bit deviation storage on a mesh runs the sharded kernels' plain
    # versions on the CPU, equal to the single-device plain split; the
    # project's case widened to 256 x 32, whose 2x2 blocks (16x128) have the
    # JAX sharded split-BC geometry, where the engines engage it
    wide = copy.deepcopy(cfg)
    wide["simulation"].update(nx=256, ny=32)
    wide_mask = np.zeros((32, 256), np.float32)
    wide_mask[:, 80:176] = mask[16:48]
    serial = LBMEngine(wide, mask_yx=wide_mask, device="cpu", store_dev=True)
    sharded = LBMEngine(wide, mask_yx=wide_mask, device="cpu", store_dev=True,
                        spatial_mesh=(2, 2))
    assert serial.store_dev and sharded.store_dev
    serial.run_step(12)
    sharded.run_step(12)
    assert torch.equal(serial.state.f, sharded.state.f)
    # checkpoints are gathered: a 2x4 run resumes on 1x1 and stays exact
    a = LBMEngine(cfg, mask_yx=mask, device="cpu", spatial_mesh="2x4")
    a.run_step(20)
    ckpt = str(tmp_path / "case.ckpt.npz")
    a.save_checkpoint(ckpt)
    a.run_step(10)
    b = LBMEngine(cfg, mask_yx=mask, device="cpu", spatial_mesh="1x1")
    b.load_checkpoint(ckpt)
    assert b.step_count == 20
    b.run_step(10)
    assert torch.equal(a.state.f, b.state.f)


def test_engine_spatial_config_key_and_fuse_log(tmp_path, monkeypatch, caplog):
    cfg, mask = project_case(str(tmp_path))
    cfg["simulation"]["spatial_mesh"] = "4x2"
    monkeypatch.setattr(cs, "_FUSE_STEPS", 4)
    with caplog.at_level(logging.WARNING, logger="lbm2d_tpu_torch.core.engine"):
        e = LBMEngine(cfg, mask_yx=mask, device="cpu")
    assert e.mesh.grid == (4, 2)
    assert "never fuses" in caplog.text
    ref = LBMEngine(cfg, mask_yx=mask, device="cpu", spatial_mesh="")  # the argument wins
    assert ref.mesh is None
    e.run_step(8)
    ref.run_step(8)
    assert torch.equal(e.state.f, ref.state.f)


def test_engine_spatial_mesh_errors(tmp_path, monkeypatch):
    cfg, mask = project_case(str(tmp_path))
    with pytest.raises(ValueError, match="not divisible"):
        LBMEngine(cfg, mask_yx=mask, device="cpu", spatial_mesh="1x5")  # nx=96 % 5 != 0
    with pytest.raises(ValueError, match="smaller than 3x3"):
        LBMEngine(cfg, mask_yx=mask, device="cpu", spatial_mesh="32x1")  # 2-row blocks
    # on the card the blocks go on distinct CUDA devices: too few raises
    # before anything touches a device
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 1)
    with pytest.raises(ValueError, match="needs 4 devices, found 1"):
        LBMEngine(cfg, mask_yx=mask, device="cuda", spatial_mesh="2x2")


def test_batch_run_rejects_lockstep_plus_spatial(tmp_path):
    with pytest.raises(ValueError, match="spatial_mesh"):
        batch_run.run_batch("X", root=str(tmp_path), lockstep=True, spatial_mesh="2x4",
                            device="cpu")
    with pytest.raises(ValueError, match="lockstep"):
        batch_run.run_batch("X", root=str(tmp_path), runner="sharded", device="cpu")


def _h5_tree(path):
    """{dataset name: bytes, '@'+attr: value} snapshot of an HDF5 file."""
    out = {}
    with h5py.File(path, "r") as f:
        def visit(name, obj):
            if isinstance(obj, h5py.Dataset):
                out[name] = np.asarray(obj[...]).tobytes()
                for k, v in obj.attrs.items():
                    out[f"{name}@{k}"] = v.tobytes() if isinstance(v, np.ndarray) else v
        f.visititems(visit)
        for k, v in f.attrs.items():
            out[f"@{k}"] = v.tobytes() if isinstance(v, np.ndarray) else v
    return out


def test_batch_run_spatial_artifact_parity(tmp_path, monkeypatch):
    # the serial run through run_batch, the sharded one through the CLI
    roots = {t: str(tmp_path / t) for t in ("serial", "sharded")}
    for root in roots.values():
        os.makedirs(root)
        make_project(root)
    stats = batch_run.run_batch("TestProj", root=roots["serial"], progress=False, device="cpu")
    assert stats == {"success": 1, "skipped": 0, "failed": 0}
    monkeypatch.setattr(sys, "argv", ["batch_run", "--project_name", "TestProj", "--root",
                                      roots["sharded"], "--spatial_mesh", "2x2",
                                      "--device", "cpu"])
    batch_run.main()
    out = {t: os.path.join(r, "outputs", "TestProj") for t, r in roots.items()}

    h5s = {t: _h5_tree(os.path.join(p, "raw", f"{CASE}.h5")) for t, p in out.items()}
    assert set(h5s["serial"]) == set(h5s["sharded"])
    for k in h5s["serial"]:
        a, b = h5s["serial"][k], h5s["sharded"][k]
        if k == "@config_json":
            # the same case up to the project root of the mask path
            a, b = json.loads(a), json.loads(b)
            a["mask"].pop("path"), b["mask"].pop("path")
        assert a == b, f"h5 mismatch at {k}"
    for name in ("sim_results.json", "all_cases_summary.json"):
        entries = {}
        for t, p in out.items():
            with open(os.path.join(p, "plots", name)) as fh:
                entries[t] = json.load(fh)
            for e in entries[t]:
                e.pop("wall_time_s", None)
        assert entries["serial"] == entries["sharded"], name
        assert [e["status"] for e in entries["serial"]] == ["Success"]
    vecs = {t: np.load(os.path.join(p, "plots", "all_cases_vectors.npz"), allow_pickle=True)
            for t, p in out.items()}
    assert sorted(vecs["serial"].files) == sorted(vecs["sharded"].files)
    for k in vecs["serial"].files:
        a, b = vecs["serial"][k], vecs["sharded"][k]
        if a.dtype == object:  # case names and statuses
            assert a.tolist() == b.tolist(), k
        else:
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), k
    for p in out.values():
        mp4 = os.path.join(p, "vis", f"{CASE}.mp4")
        assert os.path.exists(mp4) and os.path.getsize(mp4) > 0
