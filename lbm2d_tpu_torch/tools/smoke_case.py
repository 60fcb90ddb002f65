"""The production-shaped smoke case in ``lbm2d_tpu_torch/data`` and the
sibling-case project made from it, shared by ``chip_smoke.py`` and
``tools/trace.py``.

The case is the production configuration of ``master_config.yaml`` at
2432x1152, cut in depth only (3000 steps). Its sibling project is the group
``config_batch_gen`` emits for one mask: the same case at several
viscosities, video on. Where h5py is missing (the GPU machine has none),
``use_memory_h5`` puts the HDF5 writer and readers (``post/h5_to_zarr``,
``analysis/h5_inspect``, ``analysis/io_bench``) on an in-memory stand-in of
``h5py.File``, and ``read_turbulence`` reads the frames back from it.
"""

from __future__ import annotations

import json
import os

import numpy as np

DATA = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))), "data")
SIBLING_NUS = (0.02, 0.03, 0.05)  # all feasible for the smoke mask


def load_smoke_case():
    """(config dict, mask [H, W] float32) of the production-shaped case."""
    with open(os.path.join(DATA, "smoke_case.json")) as fh:
        config = json.load(fh)
    with np.load(os.path.join(DATA, "smoke_case_mask.npz")) as z:
        h, w = (int(v) for v in z["shape"])
        mask = np.unpackbits(z["mask_yx"], axis=1, count=w)[:h].astype(np.float32)
    return config, mask


class MemDataset:
    """The part of h5py.Dataset the case writer and the readers use, kept in
    memory. Growing along axis 0 doubles a buffer, as a chunked HDF5
    dataset grows without copying what it holds: the case writer grows its
    dataset by one frame an append, and a copy of every frame held on each
    would put host work into a run that the real file never does."""

    def __init__(self, data=None, shape=None, dtype=None, compression=None):
        self._buf = np.array(data, dtype=dtype) if data is not None else np.zeros(shape, dtype)
        self._n = self._buf.shape[0] if self._buf.ndim else 0
        self.attrs = {}
        self.compression = compression

    @property
    def a(self) -> np.ndarray:
        """What the dataset holds (a view of the buffer)."""
        return self._buf[: self._n] if self._buf.ndim else self._buf

    @property
    def shape(self):
        return self.a.shape

    @property
    def dtype(self):
        return self._buf.dtype

    def __getitem__(self, idx):
        return self.a[idx].copy()

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

    def __setitem__(self, idx, value):
        self.a[idx] = value


class MemH5File:
    """The part of h5py.File the case writer and the readers use; files
    stay in ``FILES``. Mode "r" opens a stored file (FileNotFoundError for
    a path it does not hold); any other mode makes a new, empty one."""

    FILES = {}

    def __new__(cls, path, mode="r", **kw):
        if mode == "r":
            if path not in cls.FILES:
                raise FileNotFoundError(f"no in-memory HDF5 file {path}")
            return cls.FILES[path]
        self = super().__new__(cls)
        self.datasets, self.attrs = {}, {}
        cls.FILES[path] = self
        return self

    def create_dataset(self, name, data=None, shape=None, dtype=None, compression=None,
                       **kw):
        self.datasets[name] = MemDataset(data, shape, dtype, compression)
        return self.datasets[name]

    def __getitem__(self, name):
        return self.datasets[name]

    def __contains__(self, name):
        return name in self.datasets

    def keys(self):
        return sorted(self.datasets)

    def visititems(self, fn):
        """Call ``fn(name, dataset)`` in name order, as h5py visits a flat
        file."""
        for name in sorted(self.datasets):
            fn(name, self.datasets[name])

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def close(self):
        pass


# what the h5py module offers the writer and the readers
MemH5 = type("MemH5", (), {"File": MemH5File, "Dataset": MemDataset})


def use_memory_h5() -> bool:
    """Put the HDF5 case writer and readers on ``MemH5File`` where h5py is
    missing. Returns True if it did."""
    from ..analysis import h5_inspect, io_bench
    from ..io import h5_writer
    from ..post import h5_to_zarr

    if h5_writer._HAS_H5PY:
        return False
    h5_writer.h5py = MemH5
    h5_writer._HAS_H5PY = True
    for reader in (h5_to_zarr, h5_inspect, io_bench):
        reader._h5py = lambda: MemH5
    return True


def read_turbulence(path: str) -> np.ndarray:
    """The ``turbulence`` dataset of a case file, from disk or the stand-in."""
    return read_datasets(path)["turbulence"]


def read_datasets(path: str) -> dict:
    """{name: array} of every dataset of a case file, from the stand-in,
    or from disk (the ``<path>.npz`` dump of another process where the
    file itself is not there)."""
    if path in MemH5File.FILES:
        return {k: d.a for k, d in MemH5File.FILES[path].datasets.items()}
    if not os.path.exists(path) and os.path.exists(path + ".npz"):
        with np.load(path + ".npz") as z:
            return {k: z[k] for k in z.files}
    import h5py

    with h5py.File(path, "r") as f:
        return {k: f[k][()] for k in f}


def write_sibling_project(root: str, config: dict, mask: np.ndarray, nus=SIBLING_NUS,
                          name: str = "Smoke4", video: bool = True) -> list:
    """SimCases/<name> under ``root``: the smoke case at each nu, one mask
    PNG, video on unless ``video`` is False (the serial path's composer
    needs matplotlib). Returns [(config file name, case name)]."""
    import cv2
    import yaml

    base = os.path.join(root, "SimCases", name)
    os.makedirs(os.path.join(base, "configs"))
    os.makedirs(os.path.join(base, "masks"))
    mask_file = os.path.join(base, "masks", "smoke_mask.png")
    cv2.imwrite(mask_file, np.where(mask > 0.5, 0, 255).astype(np.uint8))
    names = []
    for nu in nus:
        cfg = json.loads(json.dumps(config))
        tag = f"Nu{nu:.4f}".replace(".", "-")
        cfg["simulation"]["nu"] = nu
        cfg["simulation"]["name"] = f"L114_0000_{tag}"
        cfg["mask"]["path"] = mask_file
        cfg["outputs"]["video"]["enable"] = video
        cfg["outputs"]["video"]["filename"] = f"L114_0000_{tag}.mp4"
        names.append((f"L114_0000_cfg_{tag}.yaml", cfg["simulation"]["name"]))
        with open(os.path.join(base, "configs", names[-1][0]), "w") as fh:
            yaml.safe_dump(cfg, fh, sort_keys=False)
    return names


# the keys in which a case config_batch_gen writes from master_config.yaml
# may differ from the smoke case: its depth, video, project and mask path
QUICKSTART_FREE_KEYS = frozenset({
    "simulation.warmup_steps", "simulation.max_steps", "simulation.compute_step_size",
    "outputs.start_record_step", "outputs.gui.interval_steps",
    "outputs.video.interval_steps", "outputs.dataset.interval_steps",
    "outputs.video.enable", "outputs.project_name", "outputs.data_save_root",
    "mask.path", "_source",
})


def flat_keys(d: dict, prefix: str = "") -> dict:
    """{"a.b.c": value} of a nested config."""
    out = {}
    for k, v in d.items():
        if isinstance(v, dict):
            out.update(flat_keys(v, f"{prefix}{k}."))
        else:
            out[prefix + k] = v
    return out


def config_diff(a: dict, b: dict) -> set:
    """The dotted keys whose values differ between configs ``a`` and ``b``
    (a key missing on one side differs)."""
    fa, fb = flat_keys(a), flat_keys(b)
    missing = object()
    return {k for k in fa.keys() | fb.keys() if fa.get(k, missing) != fb.get(k, missing)}


def cut_depth(cfg_dir: str, warmup: int = 1000, chunk: int = 100, max_steps: int = 3000,
              interval: int = 1000, video: bool = True) -> list:
    """Cut every case YAML in ``cfg_dir`` in depth only, as the smoke case
    is cut: ``warmup`` steps, chunks of ``chunk``, ``max_steps`` in all,
    recording and the GUI, video and dataset intervals at ``interval``
    (recording from step ``interval``), video on or off. Returns the file
    names, sorted."""
    import yaml

    names = sorted(f for f in os.listdir(cfg_dir) if f.endswith(".yaml"))
    for fname in names:
        path = os.path.join(cfg_dir, fname)
        with open(path) as fh:
            cfg = yaml.safe_load(fh)
        sim, out = cfg["simulation"], cfg["outputs"]
        sim.update(warmup_steps=warmup, compute_step_size=chunk, max_steps=max_steps)
        out["start_record_step"] = interval
        for sec in ("gui", "video", "dataset"):
            out[sec]["interval_steps"] = interval
        out["video"]["enable"] = video
        with open(path, "w") as fh:
            yaml.safe_dump(cfg, fh, sort_keys=False)
    return names


# the lockstep production command's flags (README.md)
PRODUCTION_FLAGS = dict(lockstep=True, device_resize=True, max_batch=5, f16_state=True,
                        f16_transfer=True, yuv_video=True, f16_retry=True)


# the eager monitors every chunk path now takes from the monitor kernel
EAGER_MONITORS = ("obstacle_force", "max_velocity")


def watch_eager_monitors(counted: dict) -> dict:
    """Count in ``counted`` every call of the eager monitors
    (``solver.obstacle_force``, ``solver.max_velocity``) on a CUDA tensor,
    in each module of the port that calls them, so a run can show that its
    chunk paths computed no monitor eagerly on the card. Returns the
    unwatched functions, for a caller's own comparisons. Idempotent."""
    from ..analysis import dfg_validation
    from ..core import engine, solver
    from ..parallel import batch, sharded

    orig = {name: getattr(getattr(solver, name), "__wrapped__", getattr(solver, name))
            for name in EAGER_MONITORS}
    for name, fn in orig.items():
        def wrapper(t, *a, _fn=fn, _name=name, **kw):
            if t.is_cuda:
                counted[_name] = counted.get(_name, 0) + 1
            return _fn(t, *a, **kw)

        wrapper.__wrapped__ = fn
        for mod in (solver, engine, batch, sharded, dfg_validation):
            if hasattr(mod, name):
                setattr(mod, name, wrapper)
    return orig
