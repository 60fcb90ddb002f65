"""The port's asynchronous HDF5 case writer against the JAX package's, on
the smoke case's crop (frames handed over already resized, as the
lockstep path's device resize does): the same file, and a close that
drains the queue without waiting out the worker's poll timeout."""

import time

import h5py
import numpy as np

from lbm2d_tpu.io.h5_writer import AsyncLBMCaseWriter as JaxAsyncWriter
from lbm2d_tpu_torch.io.h5_writer import AsyncLBMCaseWriter
from lbm2d_tpu_torch.tools import smoke_case
import torch_threads  # noqa: F401  (the test processes' torch thread budget)


def _frames(writer, n):
    rng = np.random.default_rng(0)
    shape = (9, writer.writer.target_h, writer.writer.target_w)
    return [rng.standard_normal(shape).astype(np.float32) for _ in range(n)]


def _write(cls, path, config, mask, n=3):
    w = cls(path, config, config["simulation"]["nx"], config["simulation"]["ny"], mask_yx=mask)
    for fr in _frames(w, n):
        w.append(fr, pre_resized=True)
    t0 = time.perf_counter()
    w.close()
    return time.perf_counter() - t0


def test_async_writer_matches_jax(tmp_path):
    config, mask = smoke_case.load_smoke_case()
    ours, ref = str(tmp_path / "ours.h5"), str(tmp_path / "ref.h5")
    _write(AsyncLBMCaseWriter, ours, config, mask)
    _write(JaxAsyncWriter, ref, config, mask)
    with h5py.File(ours, "r") as a, h5py.File(ref, "r") as b:
        assert sorted(a) == sorted(b) and a["turbulence"].shape[0] == 3
        for k in b:
            np.testing.assert_array_equal(a[k][()], b[k][()], err_msg=k)
        assert sorted(a.attrs) == sorted(b.attrs)
        for k in ("stats_min", "stats_max", "stats_mean"):
            np.testing.assert_array_equal(a.attrs[k], b.attrs[k])


def test_async_writer_close_does_not_wait_for_its_poll(tmp_path):
    config, mask = smoke_case.load_smoke_case()
    path = str(tmp_path / "case.h5")
    # the worker is idle in its 0.5 s poll when close() comes
    w = AsyncLBMCaseWriter(path, config, config["simulation"]["nx"],
                           config["simulation"]["ny"], mask_yx=mask)
    frames = _frames(w, 2)
    for fr in frames:
        w.append(fr, pre_resized=True)
    w.queue.join()
    time.sleep(0.05)
    t0 = time.perf_counter()
    w.close()
    assert time.perf_counter() - t0 < 0.25
    w.close()  # a second close is a no-op
    with h5py.File(path, "r") as f:
        np.testing.assert_array_equal(f["turbulence"][()], np.stack(frames))
