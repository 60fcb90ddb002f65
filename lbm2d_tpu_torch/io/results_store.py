"""Crash-safe run-state store: config_meta.json -> sim_results.json bridge.

Parity target: reference io/sim_results_io.py. Status machine per case
(keyed by config_filename): Pending -> Running -> Success | Failed; "Running"
entries are retried after a crash, Success/Failed are skipped. All writes are
atomic (tmp + os.replace).
"""

from __future__ import annotations

import contextlib
import os
from typing import Any, Dict, Optional

from .json_utils import read_json, write_json_atomic

STATUS_PENDING = "Pending"
STATUS_RUNNING = "Running"
STATUS_SUCCESS = "Success"
STATUS_FAILED = "Failed"
# Transient: failed under --f16_state, exact-f32 retry still owed. Resume
# treats it like Running (re-run), so a crash between the f16 pass and the
# retry pass cannot strand a quantization failure as permanently Failed.
STATUS_RETRY_PENDING = "RetryPending"


@contextlib.contextmanager
def store_lock(sim_results_path: str):
    """Exclusive advisory lock serializing read-modify-write cycles on the
    store, so N concurrent workers sharing one project never lose each
    other's status updates (the reference is single-process and needs none;
    its atomic replace only guards torn writes,
    reference io/sim_results_io.py:55-64). flock is used when available
    (Linux/macOS, incl. modern NFS); elsewhere this degrades to the
    reference's lock-free behavior."""
    from .json_utils import file_lock

    with file_lock(sim_results_path):
        yield


def load_config_meta(config_meta_path: str) -> Dict[str, dict]:
    """Return {config_filename: entry} from config_meta.json (read-only source)."""
    entries = read_json(config_meta_path, default=[]) or []
    result: Dict[str, dict] = {}
    for entry in entries:
        key = entry.get("config_filename")
        if key:
            result[key] = entry
    return result


def init_sim_results(config_meta: Dict[str, dict], sim_results_path: str) -> None:
    """Seed sim_results.json from config_meta if absent; never overwrite.
    The lock closes the check-then-write race between concurrent workers
    (a late seed write would erase an early worker's first status)."""
    with store_lock(sim_results_path):
        if os.path.exists(sim_results_path):
            return
        write_json_atomic(list(config_meta.values()), sim_results_path)


def get_status_map(sim_results_path: str) -> Dict[str, str]:
    entries = read_json(sim_results_path, default=[]) or []
    return {
        e["config_filename"]: e.get("status", "Unknown")
        for e in entries
        if "config_filename" in e
    }


def set_status(
    config_filename: str,
    status: str,
    sim_results_path: str,
    extra_fields: Optional[Dict[str, Any]] = None,
) -> None:
    """Update one entry's status in place; create a minimal entry if missing.

    Re-marking a case Running (a retry/resume) clears any stale failure
    fields from an earlier attempt so a later Success entry never carries a
    leftover 'reason'."""
    with store_lock(sim_results_path):
        entries = read_json(sim_results_path, default=[]) or []
        for entry in entries:
            if entry.get("config_filename") == config_filename:
                entry["status"] = status
                if status == STATUS_RUNNING:
                    entry.pop("reason", None)
                if extra_fields:
                    entry.update(extra_fields)
                break
        else:
            new_entry: Dict[str, Any] = {"config_filename": config_filename, "status": status}
            if extra_fields:
                new_entry.update(extra_fields)
            entries.append(new_entry)
        write_json_atomic(entries, sim_results_path)


def fill_simulation_outputs(
    config_filename: str,
    simulation_outputs: Dict[str, Any],
    run_summary: Dict[str, Any],
    wall_time_s: float,
    sim_results_path: str,
) -> bool:
    """Record a successful run's measured outputs; Tier 1/2/3 physics stay as
    precomputed in config_meta. Returns False if the entry is missing."""
    with store_lock(sim_results_path):
        entries = read_json(sim_results_path, default=[]) or []
        for entry in entries:
            if entry.get("config_filename") != config_filename:
                continue
            entry["status"] = STATUS_SUCCESS
            # a Success entry carries no failure fields from earlier attempts
            # (e.g. the f16 pass's breaker reason before an f32 retry)
            entry.pop("reason", None)
            entry["wall_time_s"] = round(wall_time_s, 2)
            sim_out = entry.get("parameters", {}).get("simulation_outputs", {})
            sim_out.update(
                {
                    "actual_reynolds_number": simulation_outputs.get("actual_reynolds_number"),
                    "total_steps_executed": simulation_outputs.get("total_steps_executed"),
                    "tensor_shapes": simulation_outputs.get("tensor_shapes"),
                }
            )
            sim_out.pop("_note", None)
            entry.setdefault("parameters", {})["simulation_outputs"] = sim_out
            entry["run_summary"] = run_summary
            write_json_atomic(entries, sim_results_path)
            return True
        return False
