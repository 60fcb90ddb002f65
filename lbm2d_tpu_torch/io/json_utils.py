"""JSON encoder tolerant of numpy scalars/arrays (reference
io/NumpySafeJSONEncoder.py:4-30 equivalent) plus atomic-write helpers."""

from __future__ import annotations

import contextlib
import json
import os
from typing import Any

import numpy as np


_flock_unavailable_warned = False


@contextlib.contextmanager
def file_lock(path: str):
    """Exclusive advisory lock on ``path + '.lock'`` serializing
    read-modify-write cycles across processes (multi-worker batch
    coordination). flock where available; degrades to lock-free
    single-process semantics elsewhere -- including filesystems where
    flock itself errors (ENOLCK / EOPNOTSUPP on some NFS/SMB mounts),
    with a one-time warning that multi-worker merging is unprotected."""
    global _flock_unavailable_warned
    lock_path = path + ".lock"
    os.makedirs(os.path.dirname(lock_path) or ".", exist_ok=True)
    fd = os.open(lock_path, os.O_CREAT | os.O_RDWR)
    try:
        try:
            import fcntl

            fcntl.flock(fd, fcntl.LOCK_EX)
        except ImportError:  # non-POSIX
            pass
        except OSError as exc:  # flock unsupported on this filesystem
            if not _flock_unavailable_warned:
                _flock_unavailable_warned = True
                print(
                    f"[Warning] flock unavailable on {lock_path!r} ({exc}); "
                    "status writes stay atomic but multi-worker "
                    "read-modify-write merging is UNPROTECTED on this "
                    "filesystem -- concurrent workers may lose updates"
                )
        yield
    finally:
        os.close(fd)  # closing drops the flock


class NumpySafeJSONEncoder(json.JSONEncoder):
    def default(self, obj: Any):
        if isinstance(obj, np.integer):
            return int(obj)
        if isinstance(obj, np.floating):
            return float(obj)
        if isinstance(obj, np.bool_):
            return bool(obj)
        if isinstance(obj, np.ndarray):
            return obj.tolist()
        return super().default(obj)


def read_json(path: str, default=None):
    """Read JSON; return ``default`` on missing/corrupt file."""
    if not os.path.exists(path):
        return default
    try:
        with open(path, "r", encoding="utf-8") as fh:
            return json.load(fh)
    except Exception:
        return default


def write_json_atomic(data, path: str, indent: int = 2) -> None:
    """Write via .tmp + os.replace so a crash never corrupts the store
    (reference io/sim_results_io.py:55-64 semantics). The tmp name carries
    the pid so concurrent workers never clobber each other's staging file."""
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    tmp = f"{path}.tmp.{os.getpid()}"
    try:
        with open(tmp, "w", encoding="utf-8") as fh:
            json.dump(data, fh, indent=indent, ensure_ascii=False, cls=NumpySafeJSONEncoder)
        os.replace(tmp, path)
    except Exception:
        if os.path.exists(tmp):
            os.remove(tmp)
        raise
