"""The port's dataset post-processing (``lbm2d_tpu_torch/post``) against the
JAX package's on the CPU: bloscmini chunks and zarrlite arrays byte-equal
on seeded arrays under every codec, h5_to_zarr's whole output directory
byte-equal on the same HDF5 files, and the port's output read back by the
independent spec reader (tests/zarr_spec_reader.py)."""

import json
import os
import subprocess
import sys

import numpy as np
import pytest

from lbm2d_tpu.post import bloscmini as j_bloscmini
from lbm2d_tpu.post import zarrlite as j_zarrlite
from lbm2d_tpu.post.h5_to_zarr import run as j_h5_to_zarr
from lbm2d_tpu_torch.post import bloscmini, zarrlite
from lbm2d_tpu_torch.post.h5_to_zarr import main as h5_to_zarr_main
from lbm2d_tpu_torch.post.h5_to_zarr import run as h5_to_zarr
from test_post import make_fake_case
from test_torch_tools import assert_same_tree
from zarr_spec_reader import read_array, read_group_attrs
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _arrays():
    rng = np.random.default_rng(3)
    return {
        "f16": rng.standard_normal((5, 9, 16, 33)).astype(np.float16),
        "f32": rng.normal(1.0, 0.05, (70_001,)).astype(np.float32),
        "u8": (rng.random((3, 64, 64)) * 255).astype(np.uint8),
        "zeros": np.zeros((4, 100), np.float64),
    }


@pytest.mark.parametrize("shuffle", ["NOSHUFFLE", "SHUFFLE", "BITSHUFFLE"])
@pytest.mark.parametrize("name", sorted(_arrays()))
def test_bloscmini_chunk_bytes_match_jax(name, shuffle):
    if not bloscmini.available():
        pytest.skip("zstandard module absent")
    arr = _arrays()[name]
    raw = arr.tobytes()
    for blocksize in (0, 4096):
        ours = bloscmini.compress(raw, arr.dtype.itemsize, clevel=5,
                                  shuffle=getattr(bloscmini, shuffle), blocksize=blocksize)
        ref = j_bloscmini.compress(raw, arr.dtype.itemsize, clevel=5,
                                   shuffle=getattr(j_bloscmini, shuffle), blocksize=blocksize)
        assert ours == ref
        assert bloscmini.decompress(ours) == raw


@pytest.mark.parametrize("codec", ["blosc", "zstd", "zlib", None])
def test_zarrlite_arrays_match_jax(tmp_path, codec):
    if codec in ("blosc", "zstd") and zarrlite._zstd is None:
        pytest.skip("zstandard module absent")
    data = _arrays()
    for tag, mod in (("jax", j_zarrlite), ("torch", zarrlite)):
        root = mod.ZarrGroup(str(tmp_path / tag / "case.zarr"), overwrite=True)
        root.update_attrs({"case_name": "t", "reynolds_number": 123.4})
        sub = root.create_group("sub")
        for name, arr in data.items():
            chunks = tuple(max(1, s // 2) for s in arr.shape)
            (sub if name == "u8" else root).create_array(name, arr, chunks=chunks,
                                                         compressor=codec)
    assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))
    base = str(tmp_path / "torch" / "case.zarr")
    np.testing.assert_array_equal(zarrlite.open_array(os.path.join(base, "f16")), data["f16"])
    sel = (slice(1, 4), slice(2, 9), slice(3, 15), slice(7, 30))
    np.testing.assert_array_equal(zarrlite.read_region(os.path.join(base, "f16"), sel),
                                  data["f16"][sel])
    assert zarrlite.read_attrs(base)["reynolds_number"] == 123.4


def test_default_codec_rule():
    # blosc/zstd-5/bitshuffle when zstandard imports, zlib otherwise: in
    # both packages, here and with zstandard blocked
    assert zarrlite.DEFAULT_CODEC == j_zarrlite.DEFAULT_CODEC
    assert zarrlite.DEFAULT_CODEC == ("blosc" if zarrlite._zstd is not None else "zlib")
    code = (
        "import sys\n"
        "sys.modules['zstandard'] = None\n"
        "from lbm2d_tpu_torch.post import zarrlite, bloscmini\n"
        "from lbm2d_tpu.post import zarrlite as j\n"
        "assert zarrlite.DEFAULT_CODEC == j.DEFAULT_CODEC == 'zlib', zarrlite.DEFAULT_CODEC\n"
        "assert not bloscmini.available()\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:]


def _summary(tmp_path, cases):
    summary = [{"case_name": name, "status": "Success", "run_summary": {"h5_file": f"{name}.h5"},
                "parameters": {"physical_scaled": {"reynolds_number_calculated": re}}}
               for name, re in cases]
    summary.append({"case_name": "bad", "status": "Failed"})
    path = str(tmp_path / "summary.json")
    with open(path, "w") as fh:
        json.dump(summary, fh)
    return path


def test_h5_to_zarr_tree_matches_jax(tmp_path):
    raw = str(tmp_path / "raw")
    make_fake_case(raw, "case_a", t=11)  # 11 frames: edge chunks
    make_fake_case(raw, "case_b", t=4, h=24, w=70)
    spath = _summary(tmp_path, [("case_a", 42.0), ("case_b", 7.5)])
    stats = h5_to_zarr(spath, raw, str(tmp_path / "torch"))
    assert stats == j_h5_to_zarr(spath, raw, str(tmp_path / "jax"))
    assert stats["cases"] == ["case_a", "case_b"]
    files = assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "torch"))
    assert "global_stats.json" in files and not any(f.startswith("bad") for f in files)
    # the CLI writes the same tree
    h5_to_zarr_main(["--summary", spath, "--raw_dir", raw, "--out", str(tmp_path / "cli")])
    assert_same_tree(str(tmp_path / "jax"), str(tmp_path / "cli"))


def test_h5_to_zarr_output_reads_with_the_spec_reader(tmp_path):
    raw = str(tmp_path / "raw")
    make_fake_case(raw, "case_a", t=11, h=16, w=24)
    out = str(tmp_path / "zarr")
    h5_to_zarr(_summary(tmp_path, [("case_a", 7.0)]), raw, out)
    zdir = os.path.join(out, "case_a.zarr")
    for name in ("turbulence", "static_mask", "mean_vel_field", "mean_vel_sq_field",
                 "sampling_weights/vor", "sampling_weights/sdf", "sampling_weights/mix"):
        path = os.path.join(zdir, name)
        np.testing.assert_array_equal(read_array(path), zarrlite.open_array(path), err_msg=name)
    assert read_group_attrs(zdir)["reynolds_number"] == 7.0
    for name in ("vor", "sdf", "mix"):
        w = zarrlite.open_array(os.path.join(zdir, "sampling_weights", name))
        assert w.dtype == np.float32 and 0.0 <= w.min() and w.max() <= 1.0


def test_h5_to_zarr_needs_h5py(tmp_path):
    # the module imports without h5py; a conversion names it
    code = (
        "import sys\n"
        "sys.modules['h5py'] = None\n"
        "from lbm2d_tpu_torch.post import h5_to_zarr\n"
        "try:\n"
        f"    h5_to_zarr.run('s.json', {str(tmp_path)!r}, {str(tmp_path / 'o')!r})\n"
        "except ImportError as e:\n"
        "    assert 'h5py' in str(e), e\n"
        "else:\n"
        "    raise SystemExit('no ImportError')\n"
    )
    r = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                       text=True, timeout=300)
    assert r.returncode == 0, r.stderr[-3000:] + r.stdout[-3000:]
