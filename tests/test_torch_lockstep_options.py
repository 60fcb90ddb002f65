"""The port's lockstep options against the port's own runs, on the CPU:
the lockstep artifacts equal the serial path's, and each transport option
(--device_resize, --f16_transfer, --fetch_at_idle, --yuv_video) keeps the
artifacts within the JAX package's own tolerances for it
(tests/test_batch_datagen.py), or within f16's own rounding for
--f16_transfer; the group checkpoint resumes.

Every run here is compared with one default lockstep run of the same
two-case project (``reference``), made once for the module.
"""

import hashlib
import os

import h5py
import numpy as np
import pytest
import yaml

from lbm2d_tpu_torch.parallel.batch import BatchEngine
from lbm2d_tpu_torch.pipeline import batch_datagen, paths
from lbm2d_tpu_torch.pipeline.batch_datagen import run_batched
from lbm2d_tpu_torch.pipeline.batch_run import run_batch
from lbm2d_tpu_torch.utils.masks import create_mask
from test_batch_datagen import make_two_case_project
from test_pipeline_e2e import make_project

PROJECT = "LockProj"
CASES = ("mask_00_Nu0-0500", "mask_00_Nu0-0300")


def _h5(root, case, name=PROJECT):
    with h5py.File(os.path.join(root, "outputs", name, "raw", f"{case}.h5"), "r") as f:
        return {k: f[k][()] for k in f}


def _run(tmp_path_factory, tag, lockstep=True, **flags):
    root = str(tmp_path_factory.mktemp(tag))
    make_two_case_project(root)
    stats = run_batch(PROJECT, root=root, progress=False, lockstep=lockstep, device="cpu",
                      **flags)
    assert stats["success"] == 2, stats
    return root


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    return _run(tmp_path_factory, "reference")


def test_lockstep_equals_the_ports_serial_path(reference, tmp_path_factory):
    serial = _run(tmp_path_factory, "serial", lockstep=False)
    for case in CASES:
        ds, dl = _h5(serial, case), _h5(reference, case)
        assert sorted(ds) == sorted(dl)
        for k in ds:
            np.testing.assert_array_equal(dl[k], ds[k], err_msg=k)


def test_device_resize_matches_host_path(reference, tmp_path_factory):
    dev = _run(tmp_path_factory, "resize", device_resize=True)
    for case in CASES:
        ta, tb = _h5(reference, case)["turbulence"], _h5(dev, case)["turbulence"]
        assert ta.shape == tb.shape
        np.testing.assert_allclose(tb, ta, atol=5e-5)


def test_f16_transfer_quantizes_but_matches(reference, tmp_path_factory):
    f16 = _run(tmp_path_factory, "f16", f16_transfer=True)
    for case in CASES:
        ta, tb = _h5(reference, case)["turbulence"], _h5(f16, case)["turbulence"]
        assert tb.dtype == np.float32
        # f16 rounds to within half an ulp, 2**-11 relative (4.9e-4), down to
        # its smallest subnormal step 2**-24 in absolute terms; read on the
        # CPU: at most 4.6e-4 relative, and 2e-8 beyond 2**-11 |ref| (PERF.md)
        np.testing.assert_allclose(tb, ta, rtol=1e-3, atol=2.0**-24)
        assert not np.array_equal(ta, tb)


def test_fetch_at_idle_matches_overlapped(reference, tmp_path_factory):
    idle = _run(tmp_path_factory, "idle", fetch_overlap=False)
    for case in CASES:
        da, db = _h5(reference, case), _h5(idle, case)
        for ds in ("turbulence", "mean_vel_field", "sum_vor"):
            np.testing.assert_array_equal(db[ds], da[ds])


def test_serial_device_resize_matches_host_path(tmp_path):
    runs = {}
    for tag, resize in (("host", False), ("dev", True)):
        root = str(tmp_path / tag)
        os.makedirs(root)
        make_project(root, name="SR")
        assert run_batch("SR", root=root, progress=False, device_resize=resize,
                         device="cpu")["success"] == 1
        runs[tag] = root
    ta = _h5(runs["host"], "mask_00_Nu0-0500", "SR")["turbulence"]
    tb = _h5(runs["dev"], "mask_00_Nu0-0500", "SR")["turbulence"]
    np.testing.assert_allclose(tb, ta, atol=5e-5)
    vis = os.path.join(runs["dev"], "outputs", "SR", "vis", "mask_00_Nu0-0500.mp4")
    assert os.path.getsize(vis) > 0


def test_yuv_video_matches_rgb_video(tmp_path):
    import cv2

    runs = {}
    for tag, yuv in (("rgb", False), ("yuv", True)):
        root = str(tmp_path / tag)
        os.makedirs(root)
        make_project(root, name="V")
        run_batched("V", max_batch=4, root=root, progress=False, yuv_video=yuv, device="cpu")
        runs[tag] = os.path.join(root, "outputs", "V", "vis", "mask_00_Nu0-0500.mp4")

    def decode(path):
        cap = cv2.VideoCapture(path)
        frames = []
        while True:
            ok, frame = cap.read()
            if not ok:
                break
            frames.append(frame.astype(np.int32))
        cap.release()
        return frames

    fa, fb = decode(runs["rgb"]), decode(runs["yuv"])
    assert len(fa) == len(fb) == 3  # steps 20, 40, 60
    for a, b in zip(fa, fb):
        assert a.shape == b.shape and np.mean(np.abs(a - b)) < 3.0


def test_group_checkpoint_resume(tmp_path, capsys):
    root = str(tmp_path)
    make_two_case_project(root, name="CK")
    project_paths = paths.get_project_paths("CK", root=root)
    output_dirs = paths.setup_output_directories(project_paths["outputs"])
    members = []
    for fname in sorted(os.listdir(project_paths["configs"])):
        with open(os.path.join(project_paths["configs"], fname)) as fh:
            cfg = yaml.safe_load(fh)
        cfg["outputs"]["dataset"]["enable"] = False
        cfg["outputs"]["checkpoint"] = {"enable": True, "interval_steps": 40, "resume": True}
        members.append((fname, cfg))
    run = batch_datagen.run_lockstep_group
    ref = run(members, project_paths, output_dirs, progress=False, device="cpu")

    # the snapshot a crash after step 40 leaves, written as the loop writes it
    masks = [
        create_mask(c, os.path.join(project_paths["masks"], os.path.basename(c["mask"]["path"])))
        .astype(np.float32) for _, c in members
    ]
    eng = BatchEngine([c for _, c in members], masks, device="cpu")
    for _ in range(4):
        eng.run_step(10)
    gid = hashlib.sha1("|".join(f for f, _ in members).encode()).hexdigest()[:12]
    ckpt = os.path.join(output_dirs["raw"], f".lockstep_ckpt_{gid}.npz")
    st = eng.state
    np.savez(ckpt, f=st.f.numpy(), f_post=st.f_post.numpy(), rho=st.rho.numpy(),
             u=st.u.numpy(), step=st.step.numpy(), alive=eng.alive_mask, steps=40,
             n_cases=len(members))

    capsys.readouterr()
    resumed = run(members, project_paths, output_dirs, progress=False, device="cpu")
    assert "group resumed at step 40" in capsys.readouterr().out
    for a, b in zip(resumed, ref):
        assert a["parameters"]["lattice_inputs"] == b["parameters"]["lattice_inputs"]
        assert (a["parameters"]["simulation_outputs"]["total_steps_executed"]
                == b["parameters"]["simulation_outputs"]["total_steps_executed"] == 60)
    assert not os.path.exists(ckpt), "a completed group removes its checkpoint"
