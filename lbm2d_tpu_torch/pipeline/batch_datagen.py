"""Lockstep batch datagen: advance many same-shape cases per device together.

Counterpart of ``lbm2d_tpu/pipeline/batch_datagen.py``, the throughput path:
cases that share a grid shape run as one group on a ``BatchEngine``
(parallel/batch.py); each case still gets its own HDF5 file, resume entry,
mp4 and summary, so downstream consumers see the same artifacts as the
serial pipeline. A diverged case freezes via its alive flag and is recorded
Failed without disturbing its batchmates.

All cases in one lockstep group must share (ny, nx), bc_type, LES on/off,
and the save/record cadence (guaranteed for sibling configs emitted by
config_batch_gen for the same mask).

``coordinate`` lets N concurrent workers split a project through per-case
claim files (pipeline/coordination.py); ``runner="sharded"`` spreads each
group's cases over several devices (parallel/batch.py).

Usage:
  python -m lbm2d_tpu_torch.pipeline.batch_datagen --project_name Urban-1 [--max_batch 16]
  python -m lbm2d_tpu_torch.pipeline.batch_datagen --project_name Urban-1 --coordinate \
      [--runner sharded --n_devices 4]
"""

from __future__ import annotations

import argparse
import hashlib
import os
import threading
import time
import uuid
from collections import defaultdict
from typing import Any, Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.engine import resolve_device
from ..core.solver import LBMState
from ..core.stability import check_stability
from ..io import results_store, summary
from ..io.h5_writer import AsyncLBMCaseWriter
from ..io.summary import build_summary_entry
from ..io.vectors import build_npz
from ..parallel.batch import BatchEngine
from ..utils.config import load_config
from ..utils.masks import create_mask
from ..utils.scaling import calculate_physical_params
from . import paths
from .batch_run import build_resume_plan, find_config_files
from .fetch_pacer import FetchPacer, probe_d2h_mbps

def _group_key(cfg: Dict[str, Any]) -> Tuple:
    sim = cfg["simulation"]
    out = cfg["outputs"]
    # domain_zones + save resolution + dataset.enable participate because the
    # --device_resize path builds ONE crop window / resizer from writers[0]
    # (run_lockstep_group) -- members with different crop geometry must not
    # share a lockstep group.
    z = cfg.get("domain_zones", {})
    vid = out.get("video", {})
    gui = out.get("gui", {})
    return (
        sim["nx"],
        sim["ny"],
        tuple(cfg["boundary_condition"]["type"]),
        sim["smagorinsky_constant"] > 0.001,
        sim["compute_step_size"],
        out["dataset"]["enable"],
        out["dataset"]["interval_steps"],
        out["dataset"].get("save_resolution_height"),
        out.get("start_record_step", 0),
        sim["max_steps"],
        # device-video members share ONE renderer (gui geometry) and one
        # frame cadence, so those settings split groups too
        vid.get("enable", False),
        vid.get("interval_steps", 0),
        vid.get("fps", 30),
        gui.get("max_size"),
        gui.get("gaussian_sigma", 1.0),
        gui.get("show_zone_overlay", False),
        z.get("sponge_in", 0),
        z.get("sponge_out", 0),
        z.get("sponge_top", 0),
        z.get("sponge_bot", 0),
        z.get("buffer", 0),
    )


def group_configs(
    cfg_files: Sequence[str], config_dir: str, max_batch: int
) -> List[List[Tuple[str, Dict[str, Any]]]]:
    """Group config files into lockstep-compatible batches of <= max_batch."""
    groups: Dict[Tuple, List[Tuple[str, Dict[str, Any]]]] = defaultdict(list)
    for fname in cfg_files:
        cfg = load_config(os.path.join(config_dir, fname))
        groups[_group_key(cfg)].append((fname, cfg))
    batches: List[List[Tuple[str, Dict[str, Any]]]] = []
    for members in groups.values():
        for i in range(0, len(members), max_batch):
            batches.append(members[i : i + max_batch])
    return batches


def _to_host(t: torch.Tensor) -> np.ndarray:
    return t.cpu().numpy()


def run_lockstep_group(
    members: Sequence[Tuple[str, Dict[str, Any]]],
    project_paths: Dict[str, str],
    output_dirs: Dict[str, str],
    progress: bool = True,
    device_resize: bool = False,
    f16_transfer: bool = False,
    video: bool = True,
    fetch_overlap: bool = True,
    f16_state: bool = False,
    yuv_video: bool = False,
    adaptive_fetch: bool = True,
    pacer: Optional[Any] = None,
    device="cuda",
    runner: str = "auto",
    n_devices: Optional[int] = None,
    heartbeat_cb: Optional[Any] = None,
) -> List[Dict[str, Any]]:
    """Run one same-shape group in lockstep; returns per-case summary entries.

    ``f16_state`` keeps each case's f as 16-bit deviations between monitor
    steps (``ops/cuda_step.run_chunk_cuda(store_dev=True)``): half K1's f
    bytes for a bounded quantization cost (lossy, opt-in).

    ``f16_transfer`` casts the saved moment frames to float16 on the device
    before the device-to-host fetch, halving transfer bytes; the HDF5 stays
    float32 (values f16-quantized, ~5e-4 relative).

    ``device_resize`` crops the ROI and area-averages the moment frames to
    the save resolution on the device (ops/resize.py), so only
    [B, 9, 256, W'] crosses to the host.

    ``video``: render per-case mp4 frames on the device (ops/render.py) and
    fetch only the composed uint8 frames; respects outputs.video.enable.
    ``yuv_video`` fetches them as YUV 4:2:0 (half the bytes of RGB).

    ``fetch_overlap``: run the device-to-host save/video fetch on a worker
    thread while the next chunk is issued. ``adaptive_fetch`` (with
    ``fetch_overlap``) feeds the measured per-chunk fetch stall into a
    FetchPacer that coalesces save/video events into grouped transfers when
    the link can't hide them; artifact bytes are identical either way.
    ``pacer`` injects a pre-built controller (tests).

    ``runner`` / ``n_devices``: the BatchEngine runner ("sharded" spreads
    the cases over ``n_devices`` devices). ``heartbeat_cb``: zero-arg
    callable invoked at each progress interval (the multi-worker claim
    heartbeat, pipeline/coordination.py).
    """
    cfg0 = members[0][1]
    sim0 = cfg0["simulation"]
    chunk = int(sim0["compute_step_size"])
    data_interval = cfg0["outputs"]["dataset"]["interval_steps"]
    start_record = cfg0["outputs"].get("start_record_step", 0)
    max_steps = int(sim0["max_steps"])
    dataset_on = cfg0["outputs"]["dataset"]["enable"]
    vid_cfg = cfg0["outputs"].get("video", {})
    gui_cfg = cfg0["outputs"].get("gui", {})
    vid_interval = int(vid_cfg.get("interval_steps", 0) or 0)
    video_on = bool(video and vid_cfg.get("enable") and vid_interval > 0)

    masks, writers, h5_paths, video_paths = [], [], [], []
    for fname, cfg in members:
        mask_path = os.path.join(
            project_paths["masks"], os.path.basename(cfg["mask"]["path"])
        )
        mask = create_mask(cfg, mask_path).astype(np.float32)
        masks.append(mask)
        h5_path = os.path.join(
            output_dirs["raw"], f"{cfg['simulation']['name']}.h5"
        )
        h5_paths.append(h5_path)
        video_paths.append(
            os.path.join(output_dirs["vis"], f"{cfg['simulation']['name']}.mp4")
        )
        if dataset_on:
            writers.append(
                AsyncLBMCaseWriter(
                    h5_path, cfg, sim0["nx"], sim0["ny"], mask_yx=mask
                )
            )
        else:
            writers.append(None)

    # Device-side video: one batched renderer for the group, one recorder
    # per case; frames ride the same deferred-fetch overlap as the dataset
    # transfers (u8 frames at display size, ~1/30 the bytes of the raw field)
    recorders: List[Optional[Any]] = [None] * len(members)
    renderer = None
    zones = None
    if video_on:
        from ..io.video import VideoRecorder
        from ..ops.render import make_device_frame_renderer
        from ..utils.config import get_zone_config
        from ..viz.frames import calc_gui_size

        gui_w, gui_h = calc_gui_size(
            sim0["nx"], sim0["ny"], gui_cfg.get("max_size")
        )
        renderer = make_device_frame_renderer(
            gui_w, gui_h, viz_sigma=gui_cfg.get("gaussian_sigma", 1.0),
            batched=True, yuv420=yuv_video,
        )
        if gui_cfg.get("show_zone_overlay", False):
            zones = get_zone_config(cfg0)
        for b, _ in enumerate(members):
            rec = VideoRecorder(
                video_paths[b], width=gui_w, height=gui_h,
                fps=vid_cfg.get("fps", 30),
            )
            rec.start()
            recorders[b] = rec

    engine = BatchEngine(
        [cfg for _, cfg in members], masks, store_dev=f16_state or None,
        device=device, runner=runner, n_devices=n_devices,
    )
    n_cases = len(members)

    resizer = None
    if device_resize and dataset_on and writers[0] is not None:
        from ..ops.resize import make_device_resizer

        w0 = writers[0].writer
        _crop = (slice(None), slice(None), w0.slice_y, w0.slice_x)
        resizer = make_device_resizer(w0.crop_h, w0.crop_w, w0.target_h, w0.target_w)
    fail_reason: List[Optional[str]] = [None] * n_cases
    steps = 0

    # Group-level in-case checkpointing (run_one_case's per-case checkpoint
    # semantics): the whole lockstep state (batched f/f_post/rho/u, alive
    # flags, step counter) snapshots atomically every interval; a rerun with
    # resume enabled restarts the surviving group from the snapshot instead
    # of step 0. Like the serial path, dataset writers restart fresh.
    ckpt_cfg = cfg0["outputs"].get("checkpoint", {})
    ckpt_path = None
    ckpt_interval = 0
    if ckpt_cfg.get("enable"):
        gid = hashlib.sha1(
            "|".join(f for f, _ in members).encode()
        ).hexdigest()[:12]
        ckpt_path = os.path.join(
            output_dirs["raw"], f".lockstep_ckpt_{gid}.npz"
        )
        ckpt_interval = int(ckpt_cfg.get("interval_steps", 0))
        if ckpt_cfg.get("resume") and os.path.exists(ckpt_path):
            with np.load(ckpt_path) as z:
                if int(z["n_cases"]) == n_cases:
                    engine.set_state(
                        LBMState(
                            f=torch.from_numpy(z["f"]),
                            f_post=torch.from_numpy(z["f_post"]),
                            rho=torch.from_numpy(z["rho"]),
                            u=torch.from_numpy(z["u"]),
                            step=torch.from_numpy(z["step"]),
                        ),
                        z["alive"],
                    )
                    steps = int(z["steps"])
                    print(f"[Checkpoint] group resumed at step {steps}")

    def save_group_ckpt():
        # temp file + os.replace: a crash mid-write never corrupts the only
        # restart state (same pattern as engine.save_checkpoint)
        tmp = ckpt_path + ".tmp"
        st = engine.state
        with open(tmp, "wb") as fh:
            np.savez(
                fh, f=_to_host(st.f), f_post=_to_host(st.f_post),
                rho=_to_host(st.rho), u=_to_host(st.u),
                step=_to_host(st.step), alive=engine.alive_mask,
                steps=steps, n_cases=n_cases,
            )
        os.replace(tmp, ckpt_path)

    # Save/video fetch pipeline. With fetch_overlap the device-to-host copy
    # runs on a worker thread while the next chunk is issued; otherwise it
    # runs right after a chunk's monitors sync. Either way only host-side
    # work -- video encode, HDF5 queueing -- rides in write_fetched. Pending
    # save/video events accumulate as lists of device tensors: the
    # FetchPacer may coalesce several events into one grouped transfer
    # (order within each list is write order -- preserved).
    pending_moments: List[Tuple[Any, bool]] = []
    pending_videos: List[Any] = []
    fetch_thread: Optional[threading.Thread] = None
    fetch_box: Dict[str, Any] = {}
    bytes_fetched = [0]  # cumulative device-to-host payload (run stats)

    if pacer is None:
        pacer = FetchPacer() if (adaptive_fetch and fetch_overlap) else None
    link_pre = probe_d2h_mbps(device=engine.device) if (dataset_on or video_on) else None

    def _take_pending():
        nonlocal pending_moments, pending_videos
        pm, pv = pending_moments, pending_videos
        pending_moments = []
        pending_videos = []
        return pm, pv

    def _fetch(pm, pv):
        """Device tensors -> host dict for write_fetched."""
        out: Dict[str, Any] = {}
        nb = 0
        if pv:
            if yuv_video:
                planes = [(_to_host(y), _to_host(uv)) for y, uv in pv]
                nb += sum(y.nbytes + uv.nbytes for y, uv in planes)
                out["frames_yuv"] = planes
            else:
                frames = [_to_host(f) for f in pv]
                nb += sum(f.nbytes for f in frames)
                out["frames"] = frames
        if pm:
            moms = []
            for dev, pre in pm:
                moments = _to_host(dev)
                nb += moments.nbytes
                if moments.dtype != np.float32:
                    moments = moments.astype(np.float32)
                moms.append((moments, pre))
            out["moments"] = moms
        bytes_fetched[0] += nb
        return out

    def fetch_pending():
        return _fetch(*_take_pending())

    def start_fetch():
        """Start the device-to-host copy on a worker thread; the device
        tensors are captured now (main thread) so the next iteration can
        safely queue new pending events."""
        nonlocal fetch_thread
        pm, pv = _take_pending()

        def _worker():
            fetch_box.update(_fetch(pm, pv))

        fetch_thread = threading.Thread(target=_worker, daemon=True)
        fetch_thread.start()

    def join_fetch():
        nonlocal fetch_thread
        if fetch_thread is None:
            return {}
        fetch_thread.join()
        fetch_thread = None
        out = dict(fetch_box)
        fetch_box.clear()
        return out

    def write_fetched(out):
        """Host-side writes of already-fetched data (no device traffic)."""
        if not out:
            return
        for frames_ev, yuv_ev in _frame_events(out):
            from ..io.video import i420_to_rgb

            for b in range(n_cases):
                if fail_reason[b] is None and recorders[b] is not None:
                    if yuv_ev is not None and zones is None:
                        # planes go straight to the recorder (the native
                        # backend feeds them to its yuv420p encoder)
                        recorders[b].write_frame_i420(yuv_ev[0][b], yuv_ev[1][b])
                        continue
                    if yuv_ev is not None:
                        frame = i420_to_rgb(yuv_ev[0][b], yuv_ev[1][b])
                    else:
                        frame = (
                            frames_ev[b].copy() if zones is not None
                            else frames_ev[b]
                        )
                    if zones is not None:
                        from ..viz.frames import draw_zone_overlay

                        frame = draw_zone_overlay(frame, zones)
                    recorders[b].write_frame_u8(frame)
        for moments, pre in out.get("moments", ()):
            for b in range(n_cases):
                if fail_reason[b] is None and writers[b] is not None:
                    writers[b].append(moments[b], pre_resized=pre)

    def _frame_events(out):
        if "frames" in out:
            return [(f, None) for f in out["frames"]]
        if "frames_yuv" in out:
            return [(None, yv) for yv in out["frames_yuv"]]
        return []

    def flush_pending():
        write_fetched(fetch_pending())

    # opt-in per-phase wall breakdown (outputs.enable_profiling), printed
    # with each progress line
    profiling = bool(cfg0["outputs"].get("enable_profiling"))
    prof = {"dispatch": 0.0, "write": 0.0, "monitor": 0.0, "queue": 0.0,
            "fetch": 0.0}
    fetched = {}

    t0 = time.perf_counter()
    while steps < max_steps:
        tp0 = time.perf_counter()
        mon_dev = engine.run_step(chunk, sync=False)
        tp1 = time.perf_counter()
        steps += chunk
        stall_s = 0.0
        fetching = fetch_thread is not None
        if fetching:
            tj = time.perf_counter()
            fetched = join_fetch()
            stall_s = time.perf_counter() - tj
        tw = time.perf_counter()
        write_fetched(fetched)  # host-only IO
        fetched = {}
        tp2 = time.perf_counter()
        mon = engine.sync_monitors(mon_dev)
        tp3 = time.perf_counter()
        prof["dispatch"] += tp1 - tp0
        prof["write"] += tp2 - tp1
        prof["monitor"] += tp3 - tp2
        if pacer is not None:
            # the chunk's wall without the host writes: they take as long
            # however the fetches are grouped
            pacer.record_wall(tp3 - tp0 - (tp2 - tw), tp3 - tp2, stall_s, fetching)
        alive = engine.alive_mask
        for b in range(n_cases):
            if fail_reason[b] is None and not alive[b]:
                ok, reason = check_stability(
                    mon["force"][b], mon["max_v"][b], steps,
                    warmup_step=members[b][1]["simulation"]["warmup_steps"],
                )
                fail_reason[b] = reason or f"Instability at step {steps}"
        if (
            dataset_on
            and data_interval
            and steps % data_interval == 0
            and steps >= start_record
        ):
            if resizer is not None:
                dev = resizer(engine.get_moments_device()[_crop])
                pre = True
            else:
                dev = engine.get_moments_device()
                pre = False
            if f16_transfer:
                dev = dev.to(torch.float16)
            pending_moments.append((dev, pre))
        if (
            video_on
            and steps % vid_interval == 0
            and steps >= start_record
        ):
            pending_videos.append(
                renderer(engine.get_velocity_device(), engine.params.mask)
            )
        if (
            ckpt_path
            and ckpt_interval
            and steps % ckpt_interval < chunk
        ):
            save_group_ckpt()
        tp4 = time.perf_counter()
        prof["queue"] += tp4 - tp3
        n_pending = len(pending_moments) + len(pending_videos)
        if fetch_overlap:
            # with the pacer, a stalling link grows the group: several save
            # events coalesce into one transfer spanning several chunks
            if n_pending and (pacer is None or pacer.should_fetch(n_pending)):
                start_fetch()
        elif n_pending:
            fetched = fetch_pending()
        prof["fetch"] += time.perf_counter() - tp4
        if heartbeat_cb is not None and steps % (chunk * 50) == 0:
            heartbeat_cb()
        if progress and steps % (chunk * 50) == 0:
            done = steps / max_steps
            line = f"  [lockstep x{n_cases}] {steps}/{max_steps} ({done:.0%})"
            if profiling:
                line += (
                    f" | per-chunk ms: dispatch={prof['dispatch']/50*1e3:.0f}"
                    f" write={prof['write']/50*1e3:.0f}"
                    f" monitor={prof['monitor']/50*1e3:.0f}"
                    f" queue={prof['queue']/50*1e3:.0f}"
                    f" fetch={prof['fetch']/50*1e3:.0f}"
                )
                prof = {k: 0.0 for k in prof}
            print(line, flush=True)
    write_fetched(join_fetch())  # in-flight overlapped transfer, if any
    write_fetched(fetched)  # last iteration's fetched-but-unwritten frame
    flush_pending()
    wall = time.perf_counter() - t0
    if ckpt_path and os.path.exists(ckpt_path):
        os.remove(ckpt_path)  # completed groups don't need restart state

    for rec in recorders:
        if rec is not None:
            rec.stop()

    # structured link/transfer record, into sim_results via
    # run_summary.transfer
    transfer_stats = None
    if link_pre is not None:
        transfer_stats = {
            "group_uid": uuid.uuid4().hex[:8],  # group members share one record
            "link_d2h_mbps_pre": link_pre,
            "link_d2h_mbps_post": probe_d2h_mbps(device=engine.device),
            "bytes_fetched": int(bytes_fetched[0]),
            "group_wall_s": round(wall, 2),
        }
        if pacer is not None:
            transfer_stats.update(pacer.stats())
            if pacer.stats()["lean_recommended"]:
                print(
                    "  [FetchPacer] link stalls persist at max batching -- "
                    "consider --f16_transfer / --yuv_video for this link"
                )

    u_np = _to_host(engine.get_velocity_device())  # [B, 2, H, W]
    entries = []
    for b, (fname, cfg) in enumerate(members):
        writer = writers[b]
        tensor_shapes = {}
        if writer is not None:
            writer.close()  # drain the async queue BEFORE reading running_count
            w = writer.writer
            tensor_shapes = {
                "static_mask": [2, w.target_h, w.target_w],
                "turbulence": [w.running_count, w.channels, w.target_h, w.target_w],
            }
        if fail_reason[b] is not None:
            # failed cases keep no partial artifacts (case_executor parity)
            for path in (h5_paths[b], video_paths[b]):
                if os.path.exists(path):
                    os.remove(path)
            entries.append(
                {
                    "case_name": cfg["simulation"]["name"],
                    "config_filename": fname,
                    "status": "Failed",
                    "reason": fail_reason[b],
                    "wall_time_s": round(wall, 2),
                }
            )
            continue
        inlet_u = float(np.mean(u_np[b, 0, 1:-1, 1]))
        l_char = cfg["simulation"]["characteristic_length"]
        nu = cfg["simulation"]["nu"]
        lattice_md = {
            "u_inlet_lattice_lu": inlet_u,
            "reynolds_number_lattice_actual": (
                inlet_u * l_char / nu if nu > 0 else float("inf")
            ),
            "l_char_lattice_px": l_char,
            "nu_lattice_lu": nu,
            "total_steps_executed": steps,
            "h5_file": os.path.basename(h5_paths[b]),
            "video_file": (
                os.path.basename(video_paths[b])
                if recorders[b] is not None
                else "N/A"
            ),
        }
        entry = build_summary_entry(
            cfg,
            lattice_md,
            calculate_physical_params(cfg, lattice_md),
            {"config_file": fname, "mask_file": os.path.basename(cfg["mask"]["path"])},
        )
        entry["config_filename"] = fname
        entry["wall_time_s"] = round(wall, 2)
        if transfer_stats is not None:
            entry["run_summary"]["transfer"] = transfer_stats
        entry.setdefault("parameters", {})["simulation_outputs"] = {
            "actual_reynolds_number": round(
                lattice_md["reynolds_number_lattice_actual"], 4
            ),
            "total_steps_executed": steps,
            "tensor_shapes": tensor_shapes,
        }
        entries.append(entry)
    return entries


def run_batched(
    project_name: str,
    max_batch: int = 16,
    root: str = ".",
    progress: bool = True,
    device_resize: bool = False,
    f16_transfer: bool = False,
    video: bool = True,
    fetch_overlap: bool = True,
    f16_state: bool = False,
    yuv_video: bool = False,
    f16_retry: bool = False,
    max_success: Optional[int] = None,
    coordinate: bool = False,
    adaptive_fetch: bool = True,
    device="cuda",
    runner: str = "auto",
    n_devices: Optional[int] = None,
    reclaim_stale_s: Optional[float] = None,
    worker_id: Optional[str] = None,
) -> Dict[str, int]:
    """Run every pending case of a project on the lockstep engine.

    ``f16_retry`` (with ``f16_state``): cases that fail under the lossy
    16-bit deviation state are re-run once in exact f32 before being
    recorded Failed. Quantization can nudge a near-breaker flow over the
    0.25 velocity threshold that the exact path survives, so the retry
    recovers those cases while everything healthy keeps the f16 state. A
    case whose divergence is physical fails again in f32 and is recorded
    Failed with its f32 reason. Crash safety: a pass-1 f16 failure is
    persisted as RetryPending (not Failed) until the retry decides, so an
    interruption between the passes re-attempts the case on resume.

    ``max_success`` (reference CLI contract): stop launching lockstep
    groups once the project's Success count (prior runs + this one)
    reaches N. Stopping is group-granular.

    ``coordinate``: multi-worker mode. N invocations -- processes on one
    host or across hosts sharing the project filesystem -- split the
    pending cases: each case is claimed via atomic O_EXCL file creation
    before it joins a lockstep group, statuses merge under a file lock, and
    every worker's final NPZ/summary build is idempotent so the last worker
    out writes the complete matrix. ``reclaim_stale_s`` additionally lets a
    worker steal claims whose heartbeat is older than that many seconds
    (crashed remote workers; same-host dead pids are reclaimed
    automatically) -- set it well above a group's wall time. ``worker_id``
    names this worker in the claims and the Running entries.

    ``runner`` / ``n_devices``: the BatchEngine runner of every group
    ("auto", or "sharded" over ``n_devices`` devices).
    """
    if reclaim_stale_s is not None and not coordinate:
        raise ValueError("--reclaim_stale requires --coordinate")
    resolve_device(device)  # no GPU -> raise here, not once per group
    project_paths = paths.get_project_paths(project_name, root=root)
    output_dirs = paths.setup_output_directories(project_paths["outputs"])
    config_meta_path = os.path.join(project_paths["project_base"], "config_meta.json")
    sim_results_path = os.path.join(output_dirs["plots"], "sim_results.json")
    legacy_summary_path = os.path.join(output_dirs["plots"], "all_cases_summary.json")
    npz_path = os.path.join(output_dirs["plots"], "all_cases_vectors.npz")

    config_meta = results_store.load_config_meta(config_meta_path)
    if config_meta:
        results_store.init_sim_results(config_meta, sim_results_path)
    cfg_files = find_config_files(project_paths["configs"])
    status_map = results_store.get_status_map(sim_results_path)
    already_success, skip = build_resume_plan(cfg_files, status_map)
    todo = [f for f in cfg_files if f not in skip]
    if not os.path.exists(legacy_summary_path):
        summary.init_summary_file(legacy_summary_path)
    if f16_retry and not f16_state:
        print("[BatchDatagen] WARNING: --f16_retry has no effect without "
              "--f16_state (nothing runs in f16, so nothing is retried)")
    if max_success is not None and max_success - already_success <= 0:
        print(f"[BatchDatagen] max_success={max_success} already reached; "
              f"nothing to do.")
        return {"success": 0, "failed": 0, "skipped": len(skip)}

    batches = group_configs(todo, project_paths["configs"], max_batch)
    print(
        f"[BatchDatagen] {len(todo)} pending cases -> {len(batches)} lockstep "
        f"group(s), max_batch={max_batch}"
    )
    stats = {"success": 0, "failed": 0, "skipped": len(skip)}

    claims = None
    if coordinate:
        from .coordination import ClaimStore

        claims = ClaimStore(
            output_dirs["plots"], worker_id=worker_id, stale_s=reclaim_stale_s
        )
        print(f"[BatchDatagen] multi-worker mode, worker={claims.worker_id}")

    def _global_success() -> int:
        """Project-wide Success count; re-read in multi-worker mode (other
        workers advance it), local tally otherwise."""
        if claims is None:
            return already_success + stats["success"]
        return sum(
            1
            for s in results_store.get_status_map(sim_results_path).values()
            if s == results_store.STATUS_SUCCESS
        )

    def _run_groups(groups, use_f16, label="",
                    fail_status=results_store.STATUS_FAILED,
                    stop_at_max=False):
        """Run lockstep groups; return filenames of cases that failed."""
        failed_names = []
        for gi, members in enumerate(groups):
            if (
                stop_at_max
                and max_success is not None
                and _global_success() >= max_success
            ):
                left = sum(len(m) for m in groups[gi:])
                print(f"\n[BatchDatagen] reached max_success={max_success}; "
                      f"leaving {left} case(s) for later/other workers.")
                break
            if claims is not None:
                # another worker may have finished a case since our scan:
                # terminal cases are skipped, the rest are claimed; members
                # another worker owns right now are simply not ours
                status_now = results_store.get_status_map(sim_results_path)
                members = [
                    m for m in members
                    if status_now.get(m[0]) not in (
                        results_store.STATUS_SUCCESS,
                        results_store.STATUS_FAILED,
                    )
                    and claims.claim(m[0])
                ]
                if not members:
                    continue
            names = [f for f, _ in members]
            print(f"\n--- {label}Group {gi + 1}/{len(groups)}: "
                  f"{len(members)} cases")
            extra = {"worker": claims.worker_id} if claims is not None else None
            run_extra = {"heartbeat_cb": claims.heartbeat} if claims is not None else {}
            for fname in names:
                results_store.set_status(
                    fname, results_store.STATUS_RUNNING, sim_results_path,
                    extra_fields=extra)
            entries = run_lockstep_group(
                members, project_paths, output_dirs, progress, device_resize,
                f16_transfer=f16_transfer, video=video,
                fetch_overlap=fetch_overlap, f16_state=use_f16,
                yuv_video=yuv_video, adaptive_fetch=adaptive_fetch,
                device=device, runner=runner, n_devices=n_devices, **run_extra,
            )
            for entry in entries:
                fname = entry["config_filename"]
                if entry.get("status") == "Success":
                    results_store.fill_simulation_outputs(
                        fname,
                        entry["parameters"]["simulation_outputs"],
                        entry.get("run_summary", {}),
                        entry.get("wall_time_s", 0.0),
                        sim_results_path,
                    )
                    stats["success"] += 1
                else:
                    results_store.set_status(
                        fname, fail_status, sim_results_path,
                        extra_fields={"reason": entry.get("reason", "Unknown")},
                    )
                    stats["failed"] += 1
                    failed_names.append(fname)
                summary.update_summary_file(entry, legacy_summary_path)
                if claims is not None and (
                    entry.get("status") == "Success"
                    or fail_status != results_store.STATUS_RETRY_PENDING
                ):
                    # terminal -> the claim's job is done; RetryPending keeps
                    # its claim so this worker's own f32 retry owns the case
                    claims.release(fname)
        return failed_names

    # With the retry armed, pass-1 f16 failures persist as RetryPending: a
    # crash before the retry pass leaves them re-runnable on resume (Failed
    # would be skipped by build_resume_plan forever).
    pass1_fail_status = (
        results_store.STATUS_RETRY_PENDING
        if (f16_state and f16_retry)
        else results_store.STATUS_FAILED
    )
    failed = _run_groups(batches, f16_state, fail_status=pass1_fail_status,
                         stop_at_max=True)
    if f16_state and f16_retry and failed:
        print(f"\n[BatchDatagen] {len(failed)} case(s) failed under "
              f"--f16_state; retrying in exact f32")
        retry_batches = group_configs(
            sorted(failed), project_paths["configs"], max_batch)
        still_failed = set(
            _run_groups(retry_batches, False, label="f32-retry "))
        recovered = len(failed) - len(still_failed)
        # each retried case was tallied Failed in pass 1 and again
        # (Success or Failed) in the retry pass; drop the pass-1 tally so
        # the final stats reflect the retry outcome only
        stats["failed"] -= len(failed)
        stats["f16_retried"] = len(failed)
        stats["f16_recovered"] = recovered
    if claims is not None:
        claims.release_all()
    try:
        build_npz(legacy_summary_path, npz_path)
    except Exception as exc:
        print(f"[Warning] NPZ build failed: {exc}")
    print(f"\n[BatchDatagen] done: {stats}")
    return stats


def main() -> None:
    ap = argparse.ArgumentParser(description="Lockstep batch datagen.")
    ap.add_argument("--project_name", required=True)
    ap.add_argument("--root", default=".",
                    help="directory holding SimCases/ and outputs/")
    ap.add_argument("--max_batch", type=int, default=16)
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument(
        "--device_resize", action="store_true",
        help="crop+resize dataset frames on device before the host transfer",
    )
    ap.add_argument(
        "--f16_transfer", action="store_true",
        help="cast saved frames to f16 on device before the host fetch "
        "(halves transfer bytes)",
    )
    ap.add_argument(
        "--f16_state", action="store_true",
        help="keep the solver state as 16-bit deviations between monitor "
        "steps (lossy -- bounded quantization noise, see ops/cuda_step)",
    )
    ap.add_argument(
        "--no_video", action="store_true",
        help="skip the device-rendered per-case mp4 (outputs.video config "
        "is honored when omitted)",
    )
    ap.add_argument(
        "--yuv_video", action="store_true",
        help="fetch video frames as YUV 4:2:0 instead of RGB -- half the "
        "bytes per frame",
    )
    ap.add_argument(
        "--fetch_at_idle", action="store_true",
        help="fetch saves/video right after each chunk's monitors instead of "
        "on a worker thread while the next chunk is issued",
    )
    ap.add_argument(
        "--no_adaptive_fetch", action="store_true",
        help="disable the FetchPacer (adaptive save-fetch batching on "
        "stalling links; artifact bytes identical either way)",
    )
    ap.add_argument(
        "--f16_retry", action="store_true",
        help="re-run cases that fail under --f16_state once in exact f32 "
        "before recording them Failed",
    )
    ap.add_argument(
        "--max_success", type=int, default=None,
        help="stop launching groups once the project has N total successes "
        "(group-granular; prior runs count)",
    )
    ap.add_argument(
        "--runner", choices=("auto", "sharded"), default="auto",
        help="batch execution strategy; 'sharded' spreads each group's cases "
        "over --n_devices devices (cross-card independent-case parallelism)",
    )
    ap.add_argument(
        "--n_devices", type=int, default=None,
        help="device count for --runner sharded (default: all CUDA devices; "
        "with --device cpu, the CPU named that many times)",
    )
    ap.add_argument(
        "--coordinate", action="store_true",
        help="multi-worker mode: claim cases via atomic files so N "
        "concurrent invocations sharing this project split the work",
    )
    ap.add_argument(
        "--reclaim_stale", type=float, default=None, metavar="SECONDS",
        help="with --coordinate: steal claims whose heartbeat is older "
        "than SECONDS (crashed cross-host workers; same-host dead pids "
        "are reclaimed automatically). Set well above a group's wall time",
    )
    args = ap.parse_args()
    run_batched(
        args.project_name, args.max_batch, root=args.root,
        device_resize=args.device_resize,
        f16_transfer=args.f16_transfer, video=not args.no_video,
        fetch_overlap=not args.fetch_at_idle, f16_state=args.f16_state,
        yuv_video=args.yuv_video, f16_retry=args.f16_retry,
        max_success=args.max_success, coordinate=args.coordinate,
        adaptive_fetch=not args.no_adaptive_fetch, device=args.device,
        runner=args.runner, n_devices=args.n_devices,
        reclaim_stale_s=args.reclaim_stale,
    )


if __name__ == "__main__":
    main()
