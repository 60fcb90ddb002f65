"""Multi-worker batch coordination: per-case claims over a shared filesystem.

Counterpart of ``lbm2d_tpu/pipeline/coordination.py``, with one fault of
that copy fixed (the steal's check-then-rename race, below).

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
  - The rename does not check what it renames: a stealer whose staleness
    check ran just before a rival's steal and re-create would rename the
    rival's FRESH claim. So the stealer checks the tombstone again after
    its rename; a tombstone that is not stale goes back to the claim path
    and the steal is refused.
* **Terminal cases release their claims**; a completed project leaves an
  empty ``.claims/``. Finalization (NPZ/summary) is idempotent and runs in
  every worker under the lock — the last worker out writes the complete
  matrix.
"""

from __future__ import annotations

import json
import os
import socket
import time
import uuid
from typing import Dict, List, Optional

CLAIMS_DIRNAME = ".claims"


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
        if self._is_stale(path):
            # Single-winner steal: atomically rename the stale claim to a
            # per-steal unique tombstone. Exactly one concurrent stealer's
            # rename succeeds; losers see ENOENT and back off, so nobody can
            # unlink a FRESH claim another stealer just re-created.
            tomb = f"{path}.stale.{uuid.uuid4().hex[:8]}"
            try:
                os.rename(path, tomb)
            except OSError:
                return False  # a racing stealer took it first
            if not self._is_stale(tomb):
                # what we renamed is a claim made fresh after our check:
                # give it back to its owner
                try:
                    os.rename(tomb, path)
                except OSError:
                    pass
                return False
            try:
                os.unlink(tomb)
            except FileNotFoundError:
                pass
            if self._try_create(path):
                self._owned[config_filename] = path
                return True
        return False

    def heartbeat(self) -> None:
        """Refresh owned claims' mtimes (cross-host liveness signal).
        Safe to call from a background timer thread: the snapshot below
        tolerates concurrent claim/release from the worker's main thread."""
        now = time.time()
        for path in list(self._owned.values()):
            try:
                os.utime(path, (now, now))
            except OSError:
                pass

    def release(self, config_filename: str) -> None:
        path = self._owned.pop(config_filename, None)
        if path:
            try:
                os.unlink(path)
            except FileNotFoundError:
                pass

    def release_all(self) -> None:
        for fname in list(self._owned):
            self.release(fname)

    def owned(self) -> List[str]:
        return sorted(self._owned)
