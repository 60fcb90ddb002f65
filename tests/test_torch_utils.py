"""The port's small utilities that replace JAX-only pieces:
``utils/system.force_clean_cache`` (PyTorch's CUDA cache and the port's
per-shape host caches, for ``jax.clear_caches``), ``utils/profiling``
(``device_trace`` on torch.profiler, for jax.profiler; ``mlups`` and
``PhaseTimer`` copied) and the environment doctor ``python -m
lbm2d_tpu_torch.native``."""

import json
import os
import random
import subprocess
import sys

import pytest
import torch

from lbm2d_tpu.utils import profiling as j_profiling
from lbm2d_tpu.utils import system as j_system
from lbm2d_tpu_torch.ops import cuda_build, cuda_step
from lbm2d_tpu_torch.utils import profiling, system
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_force_clean_cache_clears_host_caches_and_keeps_libraries(monkeypatch):
    cuda_step.BlockGeom.whole(16, 32)
    assert cuda_step._whole_grid.cache_info().currsize >= 1
    libs = {"k1_step": object()}
    monkeypatch.setattr(cuda_build, "_LIBS", libs)
    emptied = []
    monkeypatch.setattr(torch.cuda, "is_initialized", lambda: True)
    monkeypatch.setattr(torch.cuda, "empty_cache", lambda: emptied.append(1))
    system.force_clean_cache()
    assert cuda_step._whole_grid.cache_info().currsize == 0
    assert cuda_build._LIBS is libs and list(libs) == ["k1_step"]
    assert emptied == [1]
    # a later case rebuilds the geometry it needs
    assert cuda_step.BlockGeom.whole(16, 32).wl == 32


def test_force_clean_cache_without_cuda():
    assert not torch.cuda.is_initialized()
    system.force_clean_cache()
    assert not torch.cuda.is_initialized()


def test_pick_random_png_matches_jax(tmp_path):
    for name in ("b.png", "a.PNG", "c.png", "notes.txt"):
        (tmp_path / name).write_bytes(b"x")
    ours = [system.pick_random_png(str(tmp_path), r) for r in [random.Random(4)] * 10]
    ref = [j_system.pick_random_png(str(tmp_path), r) for r in [random.Random(4)] * 10]
    assert ours == ref and {os.path.basename(p) for p in ours} <= {"a.PNG", "b.png", "c.png"}
    state = random.getstate()
    system.pick_random_png(str(tmp_path))
    assert random.getstate() == state
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        system.pick_random_png(str(tmp_path / "empty"))


def test_mlups_and_phase_timer_match_jax():
    assert profiling.mlups(2432, 1152, 3000, 1.5) == j_profiling.mlups(2432, 1152, 3000, 1.5)
    t = profiling.PhaseTimer()
    for name in ("step", "io", "step"):
        with t.phase(name):
            pass
    assert t.counts == {"step": 2, "io": 1}
    assert set(t.totals) == {"step", "io"} and "x2" in t.report()


def test_device_trace_writes_a_chrome_trace_on_the_cpu(tmp_path):
    with profiling.device_trace(None):
        torch.ones(64, 64) @ torch.ones(64, 64)
    assert not os.listdir(tmp_path)
    log_dir = tmp_path / "trace"
    for _ in range(2):
        with profiling.device_trace(str(log_dir)):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = sorted(os.listdir(log_dir))
    assert len(files) == 2 and all(f.endswith(".json") for f in files)
    with open(log_dir / files[0]) as fh:
        events = json.load(fh)["traceEvents"]
    assert any("mm" in str(e.get("name", "")) for e in events)


def test_device_trace_writes_on_error(tmp_path):
    with pytest.raises(ValueError):
        with profiling.device_trace(str(tmp_path)):
            raise ValueError("inside")
    assert len(os.listdir(tmp_path)) == 1


def test_doctor_reports_this_machine():
    r = subprocess.run([sys.executable, "-m", "lbm2d_tpu_torch.native"], cwd=REPO,
                       capture_output=True, text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    out = r.stdout
    for section in ("[python packages]", "[cuda]", "[cuda kernels]", "[native video encoder]"):
        assert section in out, section
    for pkg in ("torch", "numpy", "scipy", "h5py", "PyYAML", "opencv-python", "matplotlib",
                "zstandard", "pytest"):
        assert f"  {pkg} " in out, pkg
    assert f"torch.version.cuda={torch.version.cuda}" in out
    # it names the devices PyTorch finds and no other
    if torch.cuda.is_available():
        assert f"device 0: {torch.cuda.get_device_name(0)}" in out
    else:
        assert "no CUDA device" in out and "device 0" not in out
    try:
        cuda_build.nvcc_path()
    except RuntimeError:
        assert "nvcc: unavailable" in out
        assert "  unavailable: nvcc not found" in out
