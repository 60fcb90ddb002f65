"""The production-shaped smoke case in ``lbm2d_tpu_torch/data`` and the
sibling-case project made from it, shared by ``chip_smoke.py`` and
``tools/trace.py``.

The case is the production configuration of ``master_config.yaml`` at
2432x1152, cut in depth only (3000 steps). Its sibling project is the group
``config_batch_gen`` emits for one mask: the same case at several
viscosities, video on. Where h5py is missing (the GPU machine has none),
``use_memory_h5`` puts the HDF5 writer on an in-memory stand-in of
``h5py.File`` and ``read_turbulence`` reads the frames back from it.
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
    """The part of h5py.Dataset the case writer uses, kept in memory."""

    def __init__(self, data=None, shape=None, dtype=None):
        self.a = np.array(data, dtype=dtype) if data is not None else np.zeros(shape, dtype)
        self.attrs = {}

    @property
    def shape(self):
        return self.a.shape

    def resize(self, n, axis=0):
        grown = np.zeros((n,) + self.a.shape[1:], self.a.dtype)
        grown[: min(n, self.a.shape[0])] = self.a[:n]
        self.a = grown

    def __setitem__(self, idx, value):
        self.a[idx] = value


class MemH5File:
    """The part of h5py.File the case writer uses; files stay in ``FILES``."""

    FILES = {}

    def __init__(self, path, mode="w", **kw):
        self.datasets, self.attrs = {}, {}
        MemH5File.FILES[path] = self

    def create_dataset(self, name, data=None, shape=None, dtype=None, **kw):
        self.datasets[name] = MemDataset(data, shape, dtype)
        return self.datasets[name]

    def close(self):
        pass


def use_memory_h5() -> bool:
    """Put the HDF5 case writer on ``MemH5File`` where h5py is missing.
    Returns True if it did."""
    from ..io import h5_writer

    if h5_writer._HAS_H5PY:
        return False
    h5_writer.h5py = type("MemH5", (), {"File": MemH5File})
    h5_writer._HAS_H5PY = True
    return True


def read_turbulence(path: str) -> np.ndarray:
    """The ``turbulence`` dataset of a case file, from disk or the stand-in."""
    if path in MemH5File.FILES:
        return MemH5File.FILES[path].datasets["turbulence"].a
    import h5py

    with h5py.File(path, "r") as f:
        return f["turbulence"][()]


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


# the lockstep production command's flags (README.md)
PRODUCTION_FLAGS = dict(lockstep=True, device_resize=True, max_batch=5, f16_state=True,
                        f16_transfer=True, yuv_video=True, f16_retry=True)
