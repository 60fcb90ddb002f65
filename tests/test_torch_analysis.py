"""The port's analysis tools (``lbm2d_tpu_torch/analysis``: h5_inspect,
io_bench, video_stats) against the JAX package's on the CPU, on the same
files: the same printed tree and PNGs, the same random crops from the same
seed, the same video statistics PNGs. h5py, matplotlib and cv2 are
imported at first use, so each module imports without them and a call that
needs one names it."""

import json
import os
import random
import subprocess
import sys

import h5py
import numpy as np
import pytest

from lbm2d_tpu.analysis import h5_inspect as j_h5_inspect
from lbm2d_tpu.analysis import io_bench as j_io_bench
from lbm2d_tpu.analysis import video_stats as j_video_stats
from lbm2d_tpu.post import zarrlite as j_zarrlite
from lbm2d_tpu_torch.analysis import h5_inspect, io_bench, video_stats
from lbm2d_tpu_torch.post import zarrlite
from test_analysis import _write_tiny_mp4
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _case_h5(path):
    rng = np.random.default_rng(4)
    with h5py.File(path, "w") as f:
        f.create_dataset("turbulence", data=rng.normal(0, 1, (3, 9, 16, 24)).astype(np.float32),
                         compression="lzf")
        f.create_dataset("static_mask", data=np.zeros((2, 16, 24), np.float32))
        f.create_dataset("sum_vor", data=np.ones((16, 24), np.float32))
        f.create_dataset("mean_vel_field", data=np.zeros((9, 16, 24), np.float32))
        f.attrs["config_json"] = json.dumps(
            {"simulation": {"name": "t", "nu": 0.02, "nx": 24, "ny": 16}})
        f.attrs["stats_min"] = np.linspace(-1, 1, 9).astype(np.float32)
    return path


def test_h5_inspect_tree_matches_jax(tmp_path, capsys):
    path = _case_h5(tmp_path / "case.h5")
    h5_inspect.print_structure(path)
    ours = capsys.readouterr().out
    j_h5_inspect.print_structure(path)
    assert ours == capsys.readouterr().out
    for needle in ("turbulence", "(3, 9, 16, 24)", "lzf", "@config_json", "nu=0.02",
                   "@stats_min"):
        assert needle in ours, needle
    # the CLI over a directory prints the same tree
    h5_inspect.main([str(tmp_path)])
    assert capsys.readouterr().out == ours


def test_h5_inspect_plots_match_jax(tmp_path):
    path = _case_h5(tmp_path / "case.h5")
    ours = h5_inspect.render_plots(path, tmp_path / "torch", frame=-1)
    ref = j_h5_inspect.render_plots(path, tmp_path / "jax", frame=-1)
    assert [p.name for p in ours] == [p.name for p in ref]
    assert len(ours) == 14 and "case_mean_jx.png" in {p.name for p in ours}
    for a, b in zip(ours, ref):
        assert a.read_bytes() == b.read_bytes(), a.name


def _bench_files(tmp_path):
    rng = np.random.default_rng(3)
    turb = rng.normal(0, 1, (24, 9, 32, 48)).astype(np.float16)
    h5_path = str(tmp_path / "case.h5")
    with h5py.File(h5_path, "w") as f:
        f.create_dataset("turbulence", data=turb, compression="lzf")
    zdir = str(tmp_path / "case.zarr")
    zarrlite.ZarrGroup(zdir, overwrite=True).create_array("turbulence", turb,
                                                          chunks=(8, 9, 32, 16))
    return h5_path, zdir


def test_io_bench_draws_the_jax_crops(tmp_path, monkeypatch):
    """The port draws its crops from the generator it is given; the JAX
    package from the global one: the same seed reads the same regions."""
    h5_path, zdir = _bench_files(tmp_path)
    sels = {"torch": [], "jax": []}
    for tag, mod in (("torch", zarrlite), ("jax", j_zarrlite)):
        real = mod.read_region

        def recording(path, sel, real=real, tag=tag):
            sels[tag].append(tuple((s.start, s.stop) for s in sel))
            return real(path, sel)

        monkeypatch.setattr(mod, "read_region", recording)
    grid = dict(t_list=[1, 8], hw_list=[8, 16], trials=2)
    ours = io_bench.run_multi_benchmark(h5_path, zdir, rng=random.Random(9), **grid)
    random.seed(9)
    ref = j_io_bench.run_multi_benchmark(h5_path, zdir, **grid)
    assert sels["torch"] == sels["jax"] and len(sels["torch"]) == 8
    assert [(r["T"], r["HW"]) for r in ours] == [(r["T"], r["HW"]) for r in ref]
    for r in ours:
        assert set(r) == {"T", "HW", "h5_s", "zarr_s", "speedup"}
        assert r["h5_s"] > 0 and r["zarr_s"] > 0 and np.isfinite(r["speedup"])
    png = str(tmp_path / "heat.png")
    io_bench.plot_heatmap(ours, png)
    assert os.path.getsize(png) > 1000
    # without a generator: a fresh one, never the global state
    state = random.getstate()
    assert io_bench._timed_zarr(zdir, 4, 8) > 0
    assert random.getstate() == state


def test_video_stats_match_jax(tmp_path):
    pngs = {}
    for tag, mod in (("torch", video_stats), ("jax", j_video_stats)):
        vis = tmp_path / tag / "outputs" / "P" / "vis"
        vis.mkdir(parents=True)
        _write_tiny_mp4(str(vis / "case.mp4"))
        (vis / "junk.mp4").write_bytes(b"not a video")
        assert mod.walk_and_process(str(tmp_path / tag / "outputs")) == 1
        assert mod.walk_and_process(str(tmp_path / tag / "outputs")) == 0
        pngs[tag] = [(vis / f"case_{k}.png").read_bytes() for k in ("last", "avg")]
    assert pngs["torch"] == pngs["jax"]
    assert video_stats.process_video(str(tmp_path / "torch" / "outputs" / "P" / "vis" /
                                         "case.mp4"), overwrite=True) is not None


@pytest.mark.parametrize("module,call,package", [
    ("analysis.video_stats", "process_video('x.mp4')", "cv2"),
    ("analysis.h5_inspect", "print_structure('x.h5')", "h5py"),
    ("analysis.h5_inspect", "_save_jet(__import__('numpy').zeros((2, 2)), 't', 'x.png')",
     "matplotlib"),
    ("analysis.io_bench", "_timed_h5('x.h5', 1, 1)", "h5py"),
    ("analysis.io_bench", "plot_heatmap([], 'x.png')", "matplotlib"),
])
def test_missing_package_is_named(tmp_path, module, call, package):
    code = (
        "import sys\n"
        "for m in ('h5py', 'cv2', 'matplotlib'):\n"
        "    sys.modules[m] = None\n"
        f"from lbm2d_tpu_torch.{module} import *\n"
        f"import lbm2d_tpu_torch.{module} as mod\n"
        "try:\n"
        f"    mod.{call}\n"
        "except ImportError as e:\n"
        f"    assert {package!r} in str(e), e\n"
        "else:\n"
        "    raise SystemExit('no ImportError')\n"
    )
    path = os.pathsep.join(filter(None, (REPO, os.environ.get("PYTHONPATH"))))
    r = subprocess.run([sys.executable, "-c", code], cwd=str(tmp_path),
                       env=dict(os.environ, PYTHONPATH=path), capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:] + r.stdout[-3000:]
