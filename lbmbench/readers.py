"""The per-layer metrics' arithmetic; each file under ``metrics/`` names the
one it reads. A reader returns None where the run holds nothing to read."""

from lbmbench import yardstick


def _groups(record):
    return [g for g in record.get("groups", []) if g.get("program_wall_s") is not None]


def group_overhead_s(record):
    """Set-up and wind-down a group: the harness's clock around each
    ``run_batch`` call less that group's own loop wall (``group_wall_s`` of
    the transfer record in its ``sim_results.json``), averaged over the
    window's groups."""
    groups = _groups(record)
    if not groups:
        return None
    return sum(g["harness_wall_s"] - g["program_wall_s"] for g in groups) / len(groups)


def us_case_step(record):
    """The lockstep loop alone: the groups' own loop walls over their
    cases x steps, in microseconds."""
    groups = _groups(record)
    case_steps = sum(g["cases"] * g["steps"] for g in groups)
    if not case_steps:
        return None
    return sum(g["program_wall_s"] for g in groups) / case_steps * 1e6


def fetch_stall(record):
    """The fetch pacer's stall fraction (``fetch_stall_fraction`` of the
    transfer record), weighted by each group's loop wall, in percent."""
    groups = [g for g in _groups(record) if g.get("fetch_stall_fraction") is not None]
    wall = sum(g["program_wall_s"] for g in groups)
    if not wall:
        return None
    return 100.0 * sum(g["fetch_stall_fraction"] * g["program_wall_s"] for g in groups) / wall


def lattice_share(record, trace, kind):
    """The least time the chip could take for the traced window's lattice
    work (every step, each chunk's closing step and its monitors, their
    bytes read once and written once at the chip's HBM peak;
    ``yardstick.chunk_bytes``) over the device's busy time in the same
    window, in percent."""
    if trace is None or record.get("kind") != kind or not trace.get("busy_s"):
        return None
    least = yardstick.bound_seconds(record.get("trace_lattice_bytes", 0), record["device_kind"])
    if not least:
        return None
    return 100.0 * least / trace["busy_s"]


def idle_share(record, trace, kind):
    """1 - (the union of the device-side kernel, copy and memset
    intervals) / (the traced window's wall), in percent."""
    if trace is None or record.get("kind") != kind or not trace.get("window_s"):
        return None
    return 100.0 * (1.0 - trace["busy_s"] / trace["window_s"])
