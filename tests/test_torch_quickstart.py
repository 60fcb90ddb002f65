"""The README quickstart through the port on the CPU, against the JAX
package's run of the same steps (chip_smoke.py phase 10 drives it on the
card at the production width):

1. gen_masks -c master.yaml -n 1 --mode hybrid --seed 7
2. config_batch_gen -c master.yaml
3. batch_run --lockstep with the production flags (the port: --device cpu),
   the generated configs cut in depth as the smoke case is
4. h5_to_zarr on the project's summary

on a small master config (a 128x56 grid). Steps 1, 2 and 4 (on the same
HDF5 files) must write byte-equal files; step 3's frames must agree within
the production-lockstep tolerance (one f16 rounding, 1e-3 relative, plus
the deviation-storage loss: tests/test_torch_batch_datagen.py
``_close_production``). Also: the production master config regenerates
the smoke case (mask bit for bit, configs outside the depth keys).
"""

import json
import os
import sys

import numpy as np
import pytest
import yaml

from lbm2d_tpu.pipeline.batch_run import run_batch as j_run_batch
from lbm2d_tpu.post import h5_to_zarr as j_h5_to_zarr
from lbm2d_tpu.tools import config_batch_gen as j_cbg
from lbm2d_tpu.tools import gen_masks as j_gen_masks
from lbm2d_tpu_torch.pipeline.batch_run import run_batch
from lbm2d_tpu_torch.post import h5_to_zarr, zarrlite
from lbm2d_tpu_torch.tools import config_batch_gen, gen_masks, smoke_case
from lbm2d_tpu_torch.utils.masks import load_grayscale
from test_torch_batch_datagen import _close_production
from test_torch_tools import assert_same_tree, tree_bytes
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PROJECT = "QS"
NUS = (0.05, 0.03)
DEPTH = dict(warmup=20, chunk=10, max_steps=60, interval=20, video=True)


def small_master():
    with open(os.path.join(REPO, "master_config.yaml")) as fh:
        master = yaml.safe_load(fh)
    master["settings"].update(project_name=PROJECT, blockage_buffer=8)
    master["physics_control"]["nu_lb_list"] = list(NUS)
    mg = master["map_generator"]
    mg["domain"] = {"width": 80, "height": 32}
    mg["padding"] = {"left": 16, "right": 24, "top": 12, "bot": 12}  # grows to 128x56
    mg["validation"]["boundary_buffer"] = 4
    mg["step_urban"].update(rect_size={"w": [4, 10], "h": [4, 10]}, min_distance=[2, 4],
                            rect_count=[2, 4], max_attempts=60)
    master["template"]["outputs"]["dataset"]["save_resolution_height"] = 16
    return master


def _jax_main(monkeypatch, main, argv):
    monkeypatch.setattr(sys, "argv", ["prog"] + argv)
    main()


@pytest.fixture(scope="module")
def roots(tmp_path_factory):
    """Steps 1-3 by each package in its own directory."""
    mp = pytest.MonkeyPatch()
    out = {}
    try:
        for tag in ("jax", "torch"):
            root = str(tmp_path_factory.mktemp(tag))
            mp.chdir(root)
            with open("master.yaml", "w") as fh:
                yaml.safe_dump(small_master(), fh)
            step1 = ["-c", "master.yaml", "-n", "1", "--mode", "hybrid", "--seed", "7"]
            step2 = ["-c", "master.yaml"]
            if tag == "jax":
                _jax_main(mp, j_gen_masks.main, step1)
                _jax_main(mp, j_cbg.main, step2)
            else:
                gen_masks.main(step1)
                config_batch_gen.main(step2)
            base = os.path.join(root, "SimCases", PROJECT)
            generated = tree_bytes(base)
            smoke_case.cut_depth(os.path.join(base, "configs"), **DEPTH)
            run = j_run_batch if tag == "jax" else run_batch
            kw = {"device": "cpu"} if tag == "torch" else {}
            stats = run(PROJECT, root=root, progress=False, **smoke_case.PRODUCTION_FLAGS, **kw)
            out[tag] = (root, generated, stats)
    finally:
        mp.undo()
    return out


def _out(root, *parts):
    return os.path.join(root, "outputs", PROJECT, *parts)


def _statuses(root):
    with open(_out(root, "plots", "sim_results.json")) as fh:
        return {e["config_filename"]: e["status"] for e in json.load(fh)}


def test_steps_1_2_write_the_jax_files(roots):
    gen_j, gen_t = roots["jax"][1], roots["torch"][1]
    assert sorted(gen_t) == sorted(gen_j)
    assert [k for k in gen_t if gen_t[k] != gen_j[k]] == []
    meta = json.loads(gen_t[os.path.join("masks", "metadata.json")])
    assert (meta[0]["domain_W_total"], meta[0]["domain_H_total"]) == (128, 56)
    cfgs = sorted(k for k in gen_t if k.startswith("configs"))
    assert len(cfgs) == len(NUS)
    assert [yaml.safe_load(gen_t[c])["simulation"]["nu"] for c in cfgs] == sorted(NUS)
    cm = json.loads(gen_t["config_meta.json"])
    assert [c["status"] for c in cm] == ["Pending"] * len(NUS)


def test_step_3_frames_match_jax(roots):
    (root_j, _, stats_j), (root_t, _, stats_t) = roots["jax"], roots["torch"]
    assert stats_t == stats_j == {"success": len(NUS), "skipped": 0, "failed": 0}
    assert _statuses(root_t) == _statuses(root_j)
    cases = sorted(f[:-3] for f in os.listdir(_out(root_t, "raw")) if f.endswith(".h5"))
    assert len(cases) == len(NUS)
    for case in cases:
        ft = smoke_case.read_turbulence(_out(root_t, "raw", f"{case}.h5"))
        fj = smoke_case.read_turbulence(_out(root_j, "raw", f"{case}.h5"))
        assert ft.shape == fj.shape and ft.shape[:2] == (3, 9)
        assert np.isfinite(ft).all() and ft[:, 3].mean() > 0
        _close_production(ft, fj)
        assert os.path.getsize(_out(root_t, "vis", f"{case}.mp4")) > 0


def test_step_4_writes_the_jax_zarr_tree(roots, tmp_path, monkeypatch):
    root_t = roots["torch"][0]
    summary = _out(root_t, "plots", "all_cases_summary.json")
    raw = _out(root_t, "raw")
    stats = h5_to_zarr.run(summary, raw, str(tmp_path / "torch"))
    assert stats == j_h5_to_zarr.run(summary, raw, str(tmp_path / "jax"))
    assert len(stats["cases"]) == len(NUS)
    assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))
    for case in stats["cases"]:
        frames = smoke_case.read_turbulence(os.path.join(raw, f"{case}.h5"))
        m = np.asarray(stats["mean"]).reshape(1, 9, 1, 1).astype(np.float32)
        s = np.asarray(stats["std"]).reshape(1, 9, 1, 1).astype(np.float32)
        got = zarrlite.read_region(str(tmp_path / "torch" / f"{case}.zarr" / "turbulence"),
                                   tuple(slice(0, n) for n in frames.shape))
        np.testing.assert_array_equal(got, ((frames - m) / s).astype(np.float16))
    # the CLI's project form writes the same tree under outputs/<p>/zarr
    monkeypatch.chdir(root_t)
    h5_to_zarr.main(["--project_name", PROJECT])
    assert_same_tree(str(tmp_path / "jax"), _out(root_t, "zarr"))


def test_production_master_regenerates_the_smoke_case(tmp_path, monkeypatch):
    """README steps 1 and 2 on master_config.yaml: the smoke case's mask bit
    for bit, and its config outside the depth keys."""
    monkeypatch.chdir(tmp_path)
    gen_masks.main(["-c", os.path.join(REPO, "master_config.yaml"), "-n", "1", "--mode",
                    "hybrid", "--seed", "7"])
    config_batch_gen.main(["-c", os.path.join(REPO, "master_config.yaml")])
    base = tmp_path / "SimCases" / "Urban-1"
    ref, mask = smoke_case.load_smoke_case()
    png = load_grayscale(str(base / "masks" / "L114_0000.png"))
    np.testing.assert_array_equal(png < 127, mask > 0.5)
    meta = json.loads((base / "masks" / "metadata.json").read_text())[0]
    assert [meta[k] for k in ("domain_W_total", "domain_H_total", "pad_left", "pad_right",
                              "pad_top", "pad_bot")] == [2432, 1152, 256, 640, 192, 192]
    cfgs = sorted(os.listdir(base / "configs"))
    nus = [yaml.safe_load((base / "configs" / c).read_text())["simulation"]["nu"]
           for c in cfgs]
    assert sorted(nus) == [0.007, 0.01, 0.02, 0.03, 0.05]
    cfg = yaml.safe_load((base / "configs" / "L114_0000_cfg_Nu0-0200.yaml").read_text())
    diff = smoke_case.config_diff(cfg, ref)
    assert diff <= smoke_case.QUICKSTART_FREE_KEYS, diff - smoke_case.QUICKSTART_FREE_KEYS
    cm = json.loads((base / "config_meta.json").read_text())
    assert [c["status"] for c in cm] == ["Pending"] * 5
