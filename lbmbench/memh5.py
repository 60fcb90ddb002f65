"""An in-memory stand-in for the part of ``h5py`` the case writer uses.

The card's machine has no h5py. The benchmark puts the program's HDF5
writer on this stand-in, so a run writes its dataset frames to host memory,
where the check reads them back, and drops each group's files once read.
A frozen copy of the stand-in the program's smoke tools carry, so a change
there cannot change what the benchmark reads.
"""

from __future__ import annotations

import numpy as np


class MemDataset:
    """The part of h5py.Dataset the writer uses. Growing along axis 0
    doubles a buffer, as a chunked HDF5 dataset grows without copying what
    it holds: a copy of every frame on every append would put host work
    into the run that the real file never does."""

    def __init__(self, data=None, shape=None, dtype=None, compression=None):
        self._buf = np.array(data, dtype=dtype) if data is not None else np.zeros(shape, dtype)
        self._n = self._buf.shape[0] if self._buf.ndim else 0
        self.attrs = {}
        self.compression = compression

    @property
    def a(self) -> np.ndarray:
        return self._buf[: self._n] if self._buf.ndim else self._buf

    @property
    def shape(self):
        return self.a.shape

    @property
    def dtype(self):
        return self._buf.dtype

    def __getitem__(self, idx):
        return self.a[idx].copy()

    def __setitem__(self, idx, value):
        self.a[idx] = value

    def resize(self, n, axis=0):
        if axis != 0:
            raise ValueError("the stand-in grows along axis 0 only")
        if n > self._buf.shape[0]:
            grown = np.zeros((max(n, 2 * self._buf.shape[0]),) + self._buf.shape[1:],
                             self._buf.dtype)
            grown[: self._n] = self._buf[: self._n]
            self._buf = grown
        elif n < self._n:
            self._buf[n: self._n] = 0
        self._n = n


class MemH5File:
    """The part of h5py.File the writer uses; files stay in ``FILES`` by
    path until the benchmark drops them."""

    FILES: dict = {}

    def __new__(cls, path, mode="r", **kw):
        if mode == "r":
            if path not in cls.FILES:
                raise FileNotFoundError(f"no in-memory HDF5 file {path}")
            return cls.FILES[path]
        self = super().__new__(cls)
        self.datasets, self.attrs = {}, {}
        cls.FILES[path] = self
        return self

    def create_dataset(self, name, data=None, shape=None, dtype=None, compression=None, **kw):
        self.datasets[name] = MemDataset(data, shape, dtype, compression)
        return self.datasets[name]

    def __getitem__(self, name):
        return self.datasets[name]

    def __contains__(self, name):
        return name in self.datasets

    def keys(self):
        return sorted(self.datasets)

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        pass


# what the h5py module offers the writer
MemH5 = type("MemH5", (), {"File": MemH5File, "Dataset": MemDataset})


def install(h5_writer_module):
    """Put a case-writer module on the stand-in, whether or not h5py is
    installed, so every run keeps its frames in memory. Returns the
    (module, name, value) triples that undo it."""
    undo = [(h5_writer_module, name, getattr(h5_writer_module, name, None))
            for name in ("h5py", "_HAS_H5PY")]
    h5_writer_module.h5py = MemH5
    h5_writer_module._HAS_H5PY = True
    return undo
