"""The port's mask and case-config generators and file tools
(``lbm2d_tpu_torch/tools``) against the JAX package's on the CPU: the same
master config and seed must write byte-equal files (masks,
``metadata.json``, ``map_gen_config.json``, case YAMLs, ``config_meta.json``),
and the helpers must return what the JAX ones return. Domains are
tests/test_tools.py's."""

import filecmp
import json
import os
import random
import subprocess
import sys

import numpy as np
import pytest
import yaml

from lbm2d_tpu.tools import config_batch_gen as j_cbg
from lbm2d_tpu.tools import file_ops as j_file_ops
from lbm2d_tpu.tools import gen_masks as j_gen_masks
from lbm2d_tpu.tools import re_calc as j_re_calc
from lbm2d_tpu.tools import sampling as j_sampling
from lbm2d_tpu.tools import shapes as j_shapes
from lbm2d_tpu.tools import validators as j_validators
from lbm2d_tpu.tools import configgen as j_configgen
from lbm2d_tpu.tools.configgen import nu_sampler as j_nu_sampler
from lbm2d_tpu_torch.tools import config_batch_gen, file_ops, gen_masks, re_calc, sampling
from lbm2d_tpu_torch.tools import shapes, validators
from lbm2d_tpu_torch.tools import configgen
from lbm2d_tpu_torch.tools.configgen import nu_sampler
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def small_master(project="ToolTest"):
    """master_config.yaml cut to tests/test_tools.py's domain, with pads
    that are not multiples of 128 / 8, so the generators grow them."""
    with open(os.path.join(REPO, "master_config.yaml")) as fh:
        master = yaml.safe_load(fh)
    master["settings"]["project_name"] = project
    master["settings"]["blockage_buffer"] = 16
    mg = master["map_generator"]
    mg["domain"] = {"width": 384, "height": 192}
    mg["padding"] = {"left": 48, "right": 70, "top": 31, "bot": 32}
    mg["validation"]["boundary_buffer"] = 8
    mg["step_urban"]["rect_size"] = {"w": [12, 40], "h": [12, 40]}
    mg["step_urban"]["min_distance"] = [4, 8]
    master["rect_generator"] = {
        "nx": 256, "ny": 128, "rect_count": 6,
        "rect_size": {"MIN_W": 6, "MAX_W": 20, "MIN_H": 6, "MAX_H": 20},
        "buffers": {"TOP": 16, "BOTTOM": 16, "LEFT": 16, "RIGHT": 48},
        "min_distance": 4, "max_blockage_ratio": 0.8, "rotate_angle_max": 80,
        "max_attempts": 60,
    }
    return master


def write_master(root, master, name="master_small.yaml"):
    path = os.path.join(root, name)
    with open(path, "w") as fh:
        yaml.safe_dump(master, fh)
    return path


def run_jax_main(monkeypatch, main, argv):
    """The JAX package's CLI ``main`` reads sys.argv."""
    monkeypatch.setattr(sys, "argv", ["prog"] + list(argv))
    main()


def tree_bytes(root):
    """{relative path: bytes} of every file under ``root``."""
    out = {}
    for dirpath, _, files in os.walk(root):
        for f in files:
            p = os.path.join(dirpath, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


def assert_same_tree(a, b):
    ta, tb = tree_bytes(a), tree_bytes(b)
    assert sorted(ta) == sorted(tb)
    diff = [k for k in ta if ta[k] != tb[k]]
    assert not diff, diff
    return ta


def gen_both(tmp_path, monkeypatch, mode, n=2, seed=7, master=None):
    """Run both packages' gen_masks CLI in their own directory; return the
    two mask directories."""
    master = master or small_master()
    dirs = []
    for tag, run in (("jax", None), ("torch", gen_masks.main)):
        root = tmp_path / tag
        root.mkdir()
        monkeypatch.chdir(root)
        argv = ["-c", write_master(str(root), master), "-n", str(n), "--mode", mode,
                "--seed", str(seed)]
        if run is None:
            run_jax_main(monkeypatch, j_gen_masks.main, argv)
        else:
            run(argv)
        dirs.append(str(root / "SimCases" / master["settings"]["project_name"] / "masks"))
    return dirs


@pytest.mark.parametrize("mode", ["hybrid", "urban", "rect"])
def test_gen_masks_matches_jax(tmp_path, monkeypatch, mode):
    d_jax, d_torch = gen_both(tmp_path, monkeypatch, mode)
    files = assert_same_tree(d_jax, d_torch)
    pngs = [f for f in files if f.endswith(".png")]
    assert len(pngs) == 2 and "metadata.json" in files
    assert ("map_gen_config.json" in files) == (mode != "rect")
    meta = json.loads(files["metadata.json"])
    for e in meta:
        assert e["domain_W_total"] % 128 == 0 or mode == "rect"
        assert e["domain_H_total"] % 8 == 0
    if mode != "rect":
        assert meta[0]["domain_W_total"] == 512 and meta[0]["domain_H_total"] == 256
        assert meta[0]["pad_right"] == 80 and meta[0]["pad_top"] == 32


def test_config_batch_gen_matches_jax(tmp_path, monkeypatch):
    master = small_master()
    d_jax, d_torch = gen_both(tmp_path, monkeypatch, "hybrid", seed=11, master=master)
    outs = []
    for tag, d in (("jax", d_jax), ("torch", d_torch)):
        root = tmp_path / tag
        monkeypatch.chdir(root)
        argv = ["-c", "master_small.yaml"]
        if tag == "jax":
            run_jax_main(monkeypatch, j_cbg.main, argv)
        else:
            config_batch_gen.main(argv)
        outs.append(str(root / "SimCases" / "ToolTest"))
    files = assert_same_tree(*outs)
    cfgs = [f for f in files if f.startswith("configs")]
    metas = json.loads(files["config_meta.json"])
    assert cfgs and len(cfgs) == len(metas)
    assert {m["status"] for m in metas} == {"Pending"}
    # --dry-run writes no config
    monkeypatch.chdir(tmp_path / "torch")
    assert config_batch_gen.generate_all("master_small.yaml", dry_run=True) == []


@pytest.mark.parametrize("value", [5, [1, 10], [0.1, 0.9], ["a", "b", "c"],
                                   ["aligned", "staggered"], [7], [], [10, 1]])
def test_sampling_matches_jax(value):
    a = [sampling.get_sampled_value(value, r) for r in [random.Random(3)] * 20]
    b = [j_sampling.get_sampled_value(value, r) for r in [random.Random(3)] * 20]
    assert a == b
    # without a generator the port draws from a fresh one, never from the
    # global random state
    random.seed(0)
    state = random.getstate()
    sampling.get_sampled_value(value)
    assert random.getstate() == state


def test_nu_sampler_matches_jax():
    sim_ctx = {"rho_out": 1.0, "nu_lb_list": [0.05, 0.03, 0.02, 0.01, 0.007]}
    mask_ctx = {"l_char": 60}
    for seed in range(8):
        a, b = {"rho_in_case": 1.002}, {"rho_in_case": 1.002}
        assert nu_sampler.fill_nu_sample(a, mask_ctx, sim_ctx, random.Random(seed))
        assert j_nu_sampler.fill_nu_sample(b, mask_ctx, sim_ctx, random.Random(seed))
        assert a == b
    random.seed(1)
    state = random.getstate()
    assert nu_sampler.fill_nu_sample({"rho_in_case": 1.002}, mask_ctx, sim_ctx)
    assert random.getstate() == state


SHAPE_CALLS = [
    ("add_circle", (16, 16, 5)),
    ("add_circle", (40.5, 20.25, 9.5)),
    ("add_rotated_rect", (40, 40, 10, 6, 30.0)),
    ("add_rotated_rect", (20, 30, 24, 8, -55.0)),
    ("add_triangle", (50, 16, 6, 0.0, "vertex_left")),
    ("add_triangle", (30, 36, 11, 17.0, "edge_left")),
    ("fill_polygon", (np.array([[5, 5], [40, 9], [30, 50], [8, 33]]),)),
]


@pytest.mark.parametrize("name,args", SHAPE_CALLS, ids=lambda v: str(v)[:24])
def test_shapes_match_jax(name, args):
    a = np.zeros((64, 64), np.uint8)
    b = np.zeros((64, 64), np.uint8)
    getattr(shapes, name)(a, *args)
    getattr(j_shapes, name)(b, *args)
    np.testing.assert_array_equal(a, b)
    assert a.sum() > 0


def test_shape_points_match_jax():
    for args in ((40, 40, 10, 6, 30.0), (12.5, 7.25, 3, 19, 89.0)):
        np.testing.assert_array_equal(shapes.rect_points(*args), j_shapes.rect_points(*args))
    for args in ((50, 16, 6, 0.0, "vertex_left"), (30, 36, 11, 17.0, "edge_left")):
        np.testing.assert_array_equal(shapes.triangle_points(*args),
                                      j_shapes.triangle_points(*args))


def _validator_grid():
    g = np.zeros((64, 64), np.uint8)
    shapes.add_rotated_rect(g, 32, 32, 10, 10, 0)
    return g


# tests/test_tools.py::test_validators' cases, with their expected results
VALIDATOR_CASES = [
    ("check_sdf_validity", (40, 32, 6, 6, 0), 10, False),
    ("check_sdf_validity", (56, 10, 6, 6, 0), 10, True),
    ("check_blockage_ratio", (10, 32, 6, 60, 0), 0.5, False),
    ("check_blockage_ratio", (56, 10, 6, 6, 0), 0.5, True),
]


@pytest.mark.parametrize("name,rect,limit,want", VALIDATOR_CASES)
def test_validators_match_jax(name, rect, limit, want):
    g = _validator_grid()
    pts = shapes.rect_points(*rect)
    assert getattr(validators, name)(g, pts, limit) is want
    assert getattr(j_validators, name)(g, pts, limit) is want
    # an empty grid accepts any shape
    if name == "check_sdf_validity":
        assert validators.check_sdf_validity(np.zeros_like(g), pts, limit)


def _configgen_calls():
    sim_ctx = {
        "rho_in": 1.002, "rho_out": 1.0, "warmup_passes": 8, "total_passes": 50,
        "start_record_passes": 20, "saves_per_ctu": 20, "U_phys": 1.0, "nu_air": 1.5e-5,
        "nu_lb_list": [0.05, 0.02, 0.007],
        "physical_constants": {"inlet_velocity_ms": [1.0, 5.0]},
    }
    mask_ctx = {"l_char": 150, "max_blockage": 0.5}
    case = {"u_bernoulli": 0.05, "nu_lb": 0.02, "max_steps": 100000, "rho_in_case": 1.0015}

    def steps(pkg):
        c = {}
        pkg.fill_blockage_adj(c, mask_ctx, sim_ctx)
        c["nu_lb"] = 0.02
        pkg.fill_physics_and_steps(c, mask_ctx, sim_ctx)
        return c

    return {
        "feasible": lambda pkg, _: [pkg.check_feasibility(*a) for a in (
            (1.002, 1.0, 0.02, 100), (1.10, 1.0, 0.02, 100), (1.002, 1.0, 0.001, 100),
            (1.002, 1.0, 0.007, 5000))],
        "all_feasible_nu": lambda pkg, _: pkg.get_all_feasible_nu(
            1.002, 1.0, [0.05, 0.02, 0.007, 0.001], 150, verbose=False),
        "blockage_and_steps": lambda pkg, _: steps(pkg),
        "tiers": lambda _, cbg: [cbg.build_tier1(dict(case, **steps(configgen)), dict(
            mask_ctx, nx=512, ny=256), sim_ctx), cbg.build_tier2(case, mask_ctx, sim_ctx),
            cbg.build_tier3(case, mask_ctx, sim_ctx, {"m_per_px": 2.0}),
            cbg.build_tier3(case, mask_ctx, sim_ctx, {})],
    }


@pytest.mark.parametrize("name", sorted(_configgen_calls()))
def test_configgen_matches_jax(name):
    call = _configgen_calls()[name]
    assert call(configgen, config_batch_gen) == call(j_configgen, j_cbg)


def test_re_calc_matches_jax(tmp_path, monkeypatch, capsys):
    re_calc.print_point(1.002, 1.0, 0.02, 150)
    re_calc.print_point(1.1, 1.0, 0.001, 5000)
    ours = capsys.readouterr().out
    j_re_calc.print_point(1.002, 1.0, 0.02, 150)
    j_re_calc.print_point(1.1, 1.0, 0.001, 5000)
    assert ours == capsys.readouterr().out
    assert "feasible         : YES" in ours and "NO" in ours
    master = write_master(str(tmp_path), small_master())
    re_calc.main(["-c", master, "--l_min", "20", "--l_max", "90"])
    ours = capsys.readouterr().out
    run_jax_main(monkeypatch, j_re_calc.main, ["-c", master, "--l_min", "20", "--l_max", "90"])
    assert ours == capsys.readouterr().out and "[Preview]" in ours


def _file_ops_tree(root):
    (root / "SimCases" / "P" / "configs").mkdir(parents=True)
    (root / "SimCases" / "P" / "masks").mkdir(parents=True)
    (root / "outputs" / "P" / "plots").mkdir(parents=True)
    (root / "outputs" / "P" / "raw").mkdir(parents=True)
    (root / "SimCases" / "P" / "configs" / "c.yaml").write_text("a: 1")
    for name in ("zebra.png", "alpha.png", "mid.png", "notes.txt"):
        (root / "SimCases" / "P" / "masks" / name).write_bytes(name.encode())
    (root / "SimCases" / "P" / "config_meta.json").write_text("[]")
    (root / "outputs" / "P" / "plots" / "sim_results.json").write_text("[]")
    (root / "outputs" / "P" / "raw" / "case.h5").write_bytes(b"h5")
    (root / "pkg").mkdir()
    (root / "pkg" / "a.py").write_text("print('hi')\n")
    (root / "README.md").write_text("# readme\n")
    (root / "skip.bin").write_bytes(b"\x00")


FILE_OPS = {
    "rename": lambda m, root, out: m.rename_masks(str(root / "SimCases" / "P" / "masks")),
    "rename_dry": lambda m, root, out: m.rename_masks(str(root / "SimCases" / "P" / "masks"),
                                                      prefix="m", dry_run=True),
    "export": lambda m, root, out: m.export_codebase(str(root), str(out / "dump.txt")),
    "backup": lambda m, root, out: m.backup_project("P", str(out / "bak"), root=str(root)),
    "backup_no_h5": lambda m, root, out: m.backup_project("P", str(out / "bak"),
                                                          root=str(root), include_h5=False),
}


@pytest.mark.parametrize("op", sorted(FILE_OPS))
def test_file_ops_match_jax(tmp_path, op):
    results = []
    for tag, mod in (("jax", j_file_ops), ("torch", file_ops)):
        root, out = tmp_path / tag / "ws", tmp_path / tag / "out"
        root.mkdir(parents=True)
        out.mkdir()
        _file_ops_tree(root)
        results.append(FILE_OPS[op](mod, root, out))
    assert results[0] == results[1]
    assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))
    assert results[1]  # every operation did something


def test_generators_without_cv2_match_jax(tmp_path):
    """Where cv2 is missing both packages fill polygons by the scanline
    rule, measure distances by the exact transform and write PNGs with PIL:
    the same files again."""
    master = write_master(str(tmp_path), small_master())
    code = (
        "import sys\n"
        "sys.modules['cv2'] = None\n"
        "import yaml\n"
        "from lbm2d_tpu.tools.map_generators import generate_mask_set as j\n"
        "from lbm2d_tpu_torch.tools.map_generators import generate_mask_set as t\n"
        f"m = yaml.safe_load(open({master!r}))\n"
        f"j(m, {str(tmp_path / 'jax')!r}, 1, mode='hybrid', seed=5)\n"
        f"t(m, {str(tmp_path / 'torch')!r}, 1, mode='hybrid', seed=5)\n"
        "assert 'cv2' not in sys.modules or sys.modules['cv2'] is None\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]
    assert not filecmp.dircmp(str(tmp_path / "jax"), str(tmp_path / "torch")).diff_files
    assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))
