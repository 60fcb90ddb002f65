"""HDF5 case writer: crops the ROI, resizes to the dataset resolution, appends
9-channel MRT moment frames and accumulates statistics.

Dataset schema is kept bit-compatible with the reference writer
(io/lbm_writer.py:12-296) so the downstream 02-nca-cfd consumer works
unchanged:
  turbulence       f4 [T, 9, H, W]   resizable, per-frame chunks, lzf
  static_mask      f4 [2, H, W]      C0 = binary mask, C1 = signed EDT SDF
  mean_vel_field   f4 [9, H, W]
  mean_vel_sq_field f4 [H, W]
  sum_vor          f4 [H, W]
  attrs: config_json (with _dataset_info), stats_min/max/mean per channel

Crop windows (x asymmetric on purpose, matching the reference :37-41):
  x: [sponge_in, nx - sponge_out - buffer)
  y: [sponge_bot + buffer, ny - sponge_top - buffer)

Layout difference: this writer takes moment frames as ``[9, H, W]`` (y, x) --
the solver's native layout -- so no transpose is needed before resize.

The async variant uses a single worker thread with a bounded queue so device
compute never blocks on disk (reference :260-296).
"""

from __future__ import annotations

import json
import os
import queue
import threading
from typing import Any, Dict, Optional

import numpy as np

try:
    import h5py

    _HAS_H5PY = True
except Exception:  # pragma: no cover
    _HAS_H5PY = False

try:
    import cv2

    _HAS_CV2 = True
except Exception:  # pragma: no cover
    _HAS_CV2 = False

from .sdf import signed_distance_field
from ..ops.resize import resize_area, resize_nearest


class LBMCaseWriter:
    """Synchronous writer. ``mask_yx`` is [ny, nx] with 1 = solid."""

    def __init__(
        self,
        file_path: str,
        config: Dict[str, Any],
        nx: int,
        ny: int,
        channels: int = 9,
        mask_yx: Optional[np.ndarray] = None,
    ):
        if not _HAS_H5PY:
            raise RuntimeError("h5py is unavailable; dataset output disabled")
        os.makedirs(os.path.dirname(file_path) or ".", exist_ok=True)
        self.file_path = file_path
        self.config = config
        self.nx, self.ny, self.channels = nx, ny, channels
        self.is_closed = False

        z = config["domain_zones"]
        buf = z["buffer"]
        self.slice_x = slice(z["sponge_in"], nx - z["sponge_out"] - buf)
        self.slice_y = slice(z["sponge_bot"] + buf, ny - z["sponge_top"] - buf)
        self.crop_w = (nx - z["sponge_out"] - buf) - z["sponge_in"]
        self.crop_h = (ny - z["sponge_top"] - buf) - (z["sponge_bot"] + buf)
        if self.crop_w <= 0 or self.crop_h <= 0:
            raise ValueError(
                f"Invalid crop area W={self.crop_w}, H={self.crop_h}; "
                "check domain_zones"
            )

        save_h = config["outputs"]["dataset"]["save_resolution_height"]
        scale = save_h / self.crop_h
        self.target_w = int(self.crop_w * scale)
        self.target_h = save_h
        self._compression = config["outputs"]["dataset"].get("compression", "lzf")

        self.f = h5py.File(file_path, "w", libver="latest")

        if mask_yx is not None:
            mask_c = np.asarray(mask_yx, np.float32)[self.slice_y, self.slice_x]
            mask_r = resize_nearest(mask_c, self.target_w, self.target_h)
            mask_r = (mask_r > 0.5).astype(np.float32)
            sdf = signed_distance_field(mask_r)
            self.f.create_dataset(
                "static_mask",
                data=np.stack([mask_r, sdf], axis=0),
                dtype="f4",
                compression=self._compression,
            )

        self.dset = self.f.create_dataset(
            "turbulence",
            shape=(0, channels, self.target_h, self.target_w),
            maxshape=(None, channels, self.target_h, self.target_w),
            dtype="f4",
            compression=self._compression,
            chunks=(1, channels, self.target_h, self.target_w),
        )

        self.running_sum = np.zeros((channels, self.target_h, self.target_w), np.float64)
        self.running_vel_sq_sum = np.zeros((self.target_h, self.target_w), np.float64)
        self.sum_abs_vor = np.zeros((self.target_h, self.target_w), np.float64)
        self.running_count = 0
        self.global_min = np.full(channels, np.inf)
        self.global_max = np.full(channels, -np.inf)

    # -- frame path ---------------------------------------------------------

    def append(self, moments_chw: np.ndarray, pre_resized: bool = False) -> None:
        """Append one frame.

        ``moments_chw``: [9, ny, nx] full-grid moments, or -- when
        ``pre_resized`` -- an already cropped+resized [9, target_h, target_w]
        frame (the on-device resize fast path).
        """
        if self.is_closed:
            return
        if pre_resized:
            data = np.asarray(moments_chw, np.float32)
        else:
            cropped = np.asarray(moments_chw)[:, self.slice_y, self.slice_x]
            data = np.stack(
                [
                    resize_area(cropped[c], self.target_w, self.target_h)
                    for c in range(self.channels)
                ]
            ).astype(np.float32)

        n = self.dset.shape[0]
        self.dset.resize(n + 1, axis=0)
        self.dset[n] = data

        self.running_sum += data
        self.running_count += 1
        self.global_min = np.minimum(self.global_min, data.min(axis=(1, 2)))
        self.global_max = np.maximum(self.global_max, data.max(axis=(1, 2)))

        rho_safe = np.maximum(data[0], 1e-6)
        u = data[3] / rho_safe
        v = data[5] / rho_safe
        self.running_vel_sq_sum += u * u + v * v
        vor = np.gradient(v, axis=1) - np.gradient(u, axis=0)
        self.sum_abs_vor += np.abs(vor)

    # -- finalize -----------------------------------------------------------

    def finalize(self) -> None:
        if self.is_closed:
            return
        if self.running_count == 0:
            self.f.close()
            self.is_closed = True
            return

        mean_field = (self.running_sum / self.running_count).astype(np.float32)
        self.f.create_dataset("mean_vel_field", data=mean_field)
        self.f.create_dataset(
            "mean_vel_sq_field",
            data=(self.running_vel_sq_sum / self.running_count).astype(np.float32),
        )
        self.f.create_dataset("sum_vor", data=self.sum_abs_vor.astype(np.float32))

        meta = dict(self.config)
        meta["_dataset_info"] = {
            "original_crop": [self.crop_w, self.crop_h],
            "saved_resolution": [self.target_w, self.target_h],
            "resize_algo": "area-average (cv2.INTER_AREA-compatible)",
        }
        try:
            self.f.attrs["config_json"] = json.dumps(meta, default=str)
        except Exception:
            pass
        self.f.attrs["stats_min"] = self.global_min
        self.f.attrs["stats_max"] = self.global_max
        self.f.attrs["stats_mean"] = np.mean(mean_field, axis=(1, 2))
        self.f.close()
        self.is_closed = True

    def close(self) -> None:
        self.finalize()


class AsyncLBMCaseWriter:
    """Bounded-queue worker thread decoupling HDF5 IO from the device loop."""

    def __init__(self, *args, mask_yx=None, queue_size: int = 5, **kwargs):
        self.writer = LBMCaseWriter(*args, mask_yx=mask_yx, **kwargs)
        self.queue: "queue.Queue" = queue.Queue(maxsize=queue_size)
        self.stop_event = threading.Event()
        self.errors: list = []
        self.thread = threading.Thread(target=self._worker, daemon=True)
        self.thread.start()

    def _worker(self) -> None:
        while not self.stop_event.is_set() or not self.queue.empty():
            try:
                item = self.queue.get(timeout=0.5)
            except queue.Empty:
                continue
            if item is None:
                break
            data, pre_resized = item
            try:
                self.writer.append(data, pre_resized=pre_resized)
            except Exception as exc:  # keep draining; surface at close
                self.errors.append(exc)
            finally:
                self.queue.task_done()

    def append(self, moments_chw, pre_resized: bool = False) -> None:
        self.queue.put((np.asarray(moments_chw), pre_resized))

    def finalize(self) -> None:
        self.stop_event.set()
        if self.thread.is_alive():
            # wake the worker behind the queued frames; without it the
            # worker sees the stop only when its 0.5 s poll times out
            self.queue.put(None)
        self.thread.join()
        self.writer.finalize()
        if self.errors:
            raise RuntimeError(f"Async writer had {len(self.errors)} errors: {self.errors[0]}")

    def close(self) -> None:
        self.finalize()
