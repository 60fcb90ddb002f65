"""Multi-worker batch coordination: per-case claims over a shared filesystem.

Counterpart of ``lbm2d_tpu/pipeline/coordination.py``, with the steal's
races of that copy fixed (below): every steal runs under one lock.

SURVEY.md §2.2 names "independent processes over DCN" as the case-level
distributed axis: N workers (processes on one host, or one process per TPU
host sharing a network filesystem) all point at the same project and split
the pending cases between them. The reference is strictly single-process —
its status store only guards torn writes (reference
io/sim_results_io.py:55-64); two concurrent reference runs would double-run
cases and lose each other's status updates.

Design (no coordinator process, no network protocol — the filesystem IS the
coordination plane, which is exactly the reference's L6→L5 contract style):

* **Claim = atomic file creation.** A worker may run a case only after
  creating ``plots/.claims/<config>.claim`` with O_CREAT|O_EXCL — the one
  filesystem primitive that is atomic everywhere including NFS. The file
  body records owner id, pid, host, and start time for debuggability.
* **Status merge-on-write.** All sim_results.json / summary updates take a
  flock'd read-modify-write (io/json_utils.file_lock), so workers never
  lose each other's entries.
* **Crash recovery.** A claim whose owner died must not orphan its case:
  - same host: the owner pid is checked for liveness; dead → stealable.
  - cross host: owners touch their claims as a heartbeat while working;
    a claim silent for ``stale_s`` (default: off) is stealable with
    ``--reclaim_stale``. Stealing renames the stale claim to a unique
    tombstone first: os.rename is atomic, so of N concurrent stealers
    exactly one removes the claim, and any worker that then wins the
    O_EXCL re-create is the single new owner (unlink-then-recreate had a
    window where a second stealer could unlink the winner's FRESH claim
    and double-own the case).
  - Steals run one at a time, under ``io/json_utils.file_lock`` on
    ``<plots>/.claims.lock`` (beside ``.claims/``, which a finished
    project leaves empty): the staleness check, the rename, the second
    check, the give-back, the unlink and the re-create. A lock-free
    pre-check keeps live claims from taking the lock. Under the lock no
    rival steal can re-create a fresh claim between this stealer's check
    and its rename; only the owner can change the claim there (a
    heartbeat, or a release that a first-time claim may follow), so the
    give-back is rarely needed. The give-back never overwrites: ``os.link`` fails on a
    claim a first-time ``_try_create`` made while the path was empty
    (renaming the tombstone back, as the JAX copy does, would replace that
    winner's claim, and both would own the case).
  - Where flock errors (some NFS/SMB mounts), ``file_lock`` runs lock-free
    and the steal is the lock-free protocol alone: of stealers that all
    checked one stale claim, exactly one rename succeeds; a stealer that
    renamed a rival's fresh claim finds it fresh on the second check and
    links it back, never over another claim; but a third worker that
    creates the claim in that window leaves the rival's case with two
    owners until one finishes. Single-owner under every interleaving needs
    the lock.
  - Under the ``stale_s`` timeout a live owner whose heartbeat stalls
    longer than ``stale_s`` is stolen from while it still runs the case:
    that is the policy (choose stale_s well above the heartbeat period),
    not a race. One form of it passes through the give-back: the owner's
    heartbeat lands after the stealer's check, and a first-time claim takes
    the empty path before the link, so the stale claim cannot go back and
    its tombstone is removed. Either way the owner is told: ``heartbeat``
    drops (and logs, and returns) every owned case whose claim file is gone
    or names another worker, and ``release`` never removes a claim file
    that is not this worker's.
* **Terminal cases release their claims**; a completed project leaves an
  empty ``.claims/``. Finalization (NPZ/summary) is idempotent and runs in
  every worker under the lock — the last worker out writes the complete
  matrix.
"""

from __future__ import annotations

import json
import logging
import os
import socket
import time
import uuid
from typing import Dict, List, Optional

from ..io.json_utils import file_lock

CLAIMS_DIRNAME = ".claims"

log = logging.getLogger(__name__)


class ClaimStore:
    """Per-case claim files under ``<plots_dir>/.claims/``."""

    def __init__(
        self,
        plots_dir: str,
        worker_id: Optional[str] = None,
        stale_s: Optional[float] = None,
    ):
        self.dir = os.path.join(plots_dir, CLAIMS_DIRNAME)
        os.makedirs(self.dir, exist_ok=True)
        self.host = socket.gethostname()
        self.pid = os.getpid()
        self.worker_id = (
            worker_id or f"{self.host}:{self.pid}:{uuid.uuid4().hex[:8]}"
        )
        self.stale_s = stale_s
        self._owned: Dict[str, str] = {}  # config_filename -> claim path

    def _path(self, config_filename: str) -> str:
        return os.path.join(self.dir, config_filename + ".claim")

    def _try_create(self, path: str) -> bool:
        try:
            fd = os.open(path, os.O_CREAT | os.O_EXCL | os.O_WRONLY)
        except FileExistsError:
            return False
        with os.fdopen(fd, "w", encoding="utf-8") as fh:
            json.dump(
                {
                    "worker": self.worker_id,
                    "host": self.host,
                    "pid": self.pid,
                    "claimed_at": time.time(),
                },
                fh,
            )
        return True

    def _is_stale(self, path: str) -> bool:
        """Dead same-host owner, or heartbeat older than stale_s."""
        try:
            with open(path, encoding="utf-8") as fh:
                body = json.load(fh)
        except (OSError, ValueError):
            # unreadable/torn claim: stale only under the timeout policy
            body = None
        if body is not None and body.get("host") == self.host:
            pid = body.get("pid")
            if isinstance(pid, int) and pid != self.pid:
                try:
                    os.kill(pid, 0)  # signal 0: existence probe only
                except ProcessLookupError:
                    return True
                except PermissionError:
                    pass  # alive, different user
        if self.stale_s is not None:
            try:
                return (time.time() - os.path.getmtime(path)) > self.stale_s
            except OSError:
                return False
        return False

    def claim(self, config_filename: str) -> bool:
        """True iff this worker now owns the case."""
        path = self._path(config_filename)
        if config_filename in self._owned:
            return True
        if self._try_create(path):
            self._owned[config_filename] = path
            return True
        if not self._is_stale(path):
            return False
        with file_lock(self.dir):
            return self._steal(config_filename, path)

    def _steal(self, config_filename: str, path: str) -> bool:
        """The steal of a claim found stale, under the steal lock: check
        again (a rival's steal may have re-created it fresh), rename it to
        a unique tombstone, check what was renamed, then re-create."""
        if not self._is_stale(path):
            return False
        tomb = f"{path}.stale.{uuid.uuid4().hex[:8]}"
        try:
            os.rename(path, tomb)
        except OSError:
            return False  # released meanwhile
        if not self._is_stale(tomb):
            # a heartbeat refreshed it after the check: give it back to its
            # owner, never over a claim made while the path was empty
            try:
                os.link(tomb, path)
            except OSError:
                log.warning("claim %s: a first-time claim took the path before the stale "
                            "claim could go back; its owner loses it at its next heartbeat",
                            path)
            os.unlink(tomb)
            return False
        os.unlink(tomb)
        if self._try_create(path):
            self._owned[config_filename] = path
            return True
        return False

    def _mine(self, path: str) -> bool:
        """Whether the claim file at ``path`` exists and names this worker."""
        try:
            with open(path, encoding="utf-8") as fh:
                return json.load(fh).get("worker") == self.worker_id
        except (OSError, ValueError, AttributeError):
            return False

    def heartbeat(self) -> List[str]:
        """Refresh owned claims' mtimes (cross-host liveness signal); an
        owned case whose claim file is gone or names another worker (stolen
        under the ``stale_s`` policy) is dropped from ``owned()``, logged and
        returned. Safe to call from a background timer thread: the snapshot
        below tolerates concurrent claim/release from the worker's main
        thread."""
        now = time.time()
        lost = []
        for fname, path in list(self._owned.items()):
            if not self._mine(path):
                self._owned.pop(fname, None)
                lost.append(fname)
                log.warning("claim of %s lost to another worker (stale under stale_s=%s)",
                            fname, self.stale_s)
                continue
            try:
                os.utime(path, (now, now))
            except OSError:
                pass
        return lost

    def release(self, config_filename: str) -> None:
        path = self._owned.pop(config_filename, None)
        if path and self._mine(path):
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass

    def release_all(self) -> None:
        for fname in list(self._owned):
            self.release(fname)

    def owned(self) -> List[str]:
        return sorted(self._owned)
