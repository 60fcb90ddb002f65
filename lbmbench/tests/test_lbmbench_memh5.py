"""The in-memory HDF5 stand-in: what the writer appends reads back."""

import numpy as np

from lbmbench import memh5


def test_append_and_read_back(tmp_path):
    path = str(tmp_path / "case.h5")
    f = memh5.MemH5File(path, "w")
    d = f.create_dataset("turbulence", shape=(0, 2, 3), dtype="f4")
    frames = [np.full((2, 3), i, np.float32) for i in range(9)]
    for i, fr in enumerate(frames):
        d.resize(i + 1, axis=0)
        d[i] = fr
    assert d.shape == (9, 2, 3)
    assert np.array_equal(memh5.MemH5File(path, "r")["turbulence"].a, np.stack(frames))
    d.resize(4)
    assert d.shape == (4, 2, 3) and np.array_equal(d[3], frames[3])
    s = f.create_dataset("static_mask", data=np.ones((2, 2)), dtype="f4")
    assert s.shape == (2, 2) and "static_mask" in f
    memh5.MemH5File.FILES.clear()
