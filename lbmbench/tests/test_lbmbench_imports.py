"""Nothing under lbmbench/ imports JAX or the JAX package, and the plain
reference imports nothing of the program either. Top-level module names
are compared whole: ``lbm2d_tpu_torch`` begins with ``lbm2d_tpu``."""

import ast
import os

import pytest

from lbmbench import harness

BANNED = {"jax", "jaxlib", "flax", "lbm2d_tpu"}


def sources(sub=""):
    base = os.path.join(harness.HERE, sub)
    for dirpath, _, files in os.walk(base):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(dirpath, f)


def top_level_imports(path):
    tree = ast.parse(open(path).read(), path)
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
        elif isinstance(node, ast.Call) and getattr(node.func, "id", None) == "__import__":
            if node.args and isinstance(node.args[0], ast.Constant):
                names.add(str(node.args[0].value).split(".")[0])
    return names


@pytest.mark.parametrize("path", sorted(sources()), ids=lambda p: os.path.relpath(p, harness.HERE))
def test_no_jax_anywhere(path):
    assert not top_level_imports(path) & BANNED


@pytest.mark.parametrize("path", sorted(sources("reference")),
                         ids=lambda p: os.path.relpath(p, harness.HERE))
def test_reference_imports_nothing_of_the_program(path):
    names = top_level_imports(path)
    assert not names & (BANNED | {"lbm2d_tpu_torch"}), names


def test_names_compared_whole():
    assert top_level_imports.__name__
    assert harness.banned_loaded({"lbm2d_tpu_torch": 1, "lbm2d_tpu_torch.ops": 1}) == []
    assert harness.banned_loaded({"lbm2d_tpu.core": 1, "numpy": 1}) == ["lbm2d_tpu"]
    assert harness.banned_loaded({"jaxlib.xla_client": 1, "jaxtyping": 1}) == ["jaxlib"]


def test_the_scan_sees_a_banned_import(tmp_path):
    p = tmp_path / "m.py"
    p.write_text("import lbm2d_tpu.core as c\nfrom lbm2d_tpu_torch import ops\n")
    assert top_level_imports(str(p)) == {"lbm2d_tpu", "lbm2d_tpu_torch"}
