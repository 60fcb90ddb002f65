"""The port imports neither JAX nor the JAX package, and its solver path
imports without the optional IO libraries."""

import ast
import os
import pkgutil
import subprocess
import sys

import pytest

import lbm2d_tpu_torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKG = os.path.dirname(os.path.abspath(lbm2d_tpu_torch.__file__))
SMOKE = os.path.join(REPO, "chip_smoke.py")
FORBIDDEN = ("jax", "jaxlib", "flax", "lbm2d_tpu")


def port_modules():
    names = ["lbm2d_tpu_torch"]
    for info in pkgutil.walk_packages([PKG], prefix="lbm2d_tpu_torch."):
        names.append(info.name)
    return sorted(names)


def port_sources():
    out = [SMOKE]
    for dirpath, _, files in os.walk(PKG):
        out += [os.path.join(dirpath, f) for f in files if f.endswith(".py")]
    return sorted(out)


def _run_blocked(blocked, code):
    prelude = "import sys\n" + "".join(f"sys.modules[{m!r}] = None\n" for m in blocked)
    return subprocess.run(
        [sys.executable, "-c", prelude + code], cwd=REPO, capture_output=True,
        text=True, timeout=300,
    )


def test_every_module_imports_without_jax():
    mods = port_modules()
    assert len(mods) >= 30
    assert {
        "lbm2d_tpu_torch.parallel.batch", "lbm2d_tpu_torch.ops.render",
        "lbm2d_tpu_torch.pipeline.batch_datagen", "lbm2d_tpu_torch.pipeline.fetch_pacer",
    } <= set(mods)
    code = (
        "import importlib, importlib.util\n"
        f"for m in {mods!r}:\n"
        "    importlib.import_module(m)\n"
        f"spec = importlib.util.spec_from_file_location('chip_smoke', {SMOKE!r})\n"
        "spec.loader.exec_module(importlib.util.module_from_spec(spec))\n"
        "bad = [m for m in sys.modules if m.split('.')[0] in ('jax', 'flax', 'lbm2d_tpu')"
        " and sys.modules[m] is not None]\n"
        "assert not bad, bad\n"
    )
    r = _run_blocked(["jax", "jaxlib", "flax", "lbm2d_tpu"], code)
    assert r.returncode == 0, r.stderr[-3000:]


def test_solver_path_imports_without_optional_io_libs():
    code = (
        "import lbm2d_tpu_torch.core.engine, lbm2d_tpu_torch.ops.cuda_step\n"
        "import lbm2d_tpu_torch.pipeline.sim_loop\n"
    )
    r = _run_blocked(["jax", "lbm2d_tpu", "h5py", "yaml", "cv2", "matplotlib"], code)
    assert r.returncode == 0, r.stderr[-3000:]


def test_lockstep_path_imports_without_h5py_or_matplotlib():
    # the render LUTs ship as data, so the lockstep path needs neither
    code = (
        "import lbm2d_tpu_torch.pipeline.batch_run, lbm2d_tpu_torch.pipeline.batch_datagen\n"
        "from lbm2d_tpu_torch.ops.render import make_device_frame_renderer\n"
        "make_device_frame_renderer(64, 48, yuv420=True, batched=True)\n"
    )
    r = _run_blocked(["jax", "lbm2d_tpu", "h5py", "matplotlib"], code)
    assert r.returncode == 0, r.stderr[-3000:]


def _imported_names(tree):
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            yield node.module
        elif isinstance(node, ast.Call) and node.args:
            fn = node.func
            name = getattr(fn, "attr", None) or getattr(fn, "id", None)
            arg = node.args[0]
            if name in ("import_module", "__import__") and isinstance(arg, ast.Constant):
                yield str(arg.value)


@pytest.mark.parametrize("path", port_sources(), ids=lambda p: os.path.relpath(p, REPO))
def test_no_source_imports_jax_or_the_jax_package(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for name in _imported_names(tree):
        top = name.split(".")[0]
        assert top not in FORBIDDEN, f"{path} imports {name}"


def test_smoke_script_refuses_to_run_without_a_card(tmp_path):
    # alone in a directory and with no CUDA device it must fail and print
    # no result line
    alone = tmp_path / "chip_smoke.py"
    alone.write_text(open(SMOKE).read())
    for cwd, script in ((REPO, SMOKE), (str(tmp_path), str(alone))):
        r = subprocess.run([sys.executable, script], cwd=cwd, capture_output=True,
                           text=True, timeout=300)
        assert r.returncode != 0
        assert '"ok"' not in r.stdout
