"""Batch CLI: run every case config of a project with crash-safe resume.

Counterpart of ``lbm2d_tpu/pipeline/batch_run.py`` (reference
pipeline/batch_run.py). Resume is keyed by config filename through
sim_results.json: Success/Failed are skipped, Running (a previous crash) is
retried, unknown configs run. Status is pre-written as Running before each
case. After the loop the legacy summary is converted to the
all_cases_vectors.npz feature matrix. ``--lockstep`` hands the project to
the lockstep engine (pipeline/batch_datagen.py) under the same contract;
``--spatial_mesh RxC`` runs each case on the blocks of a device mesh.

Usage:
    python -m lbm2d_tpu_torch.pipeline.batch_run --project_name Urban-1 [--max_success N] [--device cpu]
    python -m lbm2d_tpu_torch.pipeline.batch_run --project_name Urban-1 --spatial_mesh 2x2 [--device cpu]
    python -m lbm2d_tpu_torch.pipeline.batch_run --project_name Urban-1 --lockstep \
        --device_resize --max_batch 5 --f16_state --f16_transfer --yuv_video --f16_retry
"""

from __future__ import annotations

import argparse
import os
import sys
import time
from typing import Dict, List, Set, Tuple

from ..core.engine import resolve_device
from ..io import results_store, summary
from ..io.vectors import build_npz
from ..utils.config import load_config
from . import case_executor, paths


def find_config_files(config_dir: str) -> List[str]:
    if not os.path.isdir(config_dir):
        print(f"[Error] Config directory not found: {config_dir}")
        sys.exit(1)
    files = sorted(f for f in os.listdir(config_dir) if f.endswith(".yaml"))
    if not files:
        print(f"[Error] No YAML config files found in {config_dir}")
        sys.exit(1)
    return files


def build_resume_plan(
    config_files: List[str], status_map: Dict[str, str]
) -> Tuple[int, Set[str]]:
    """Return (already_success_count, filenames to skip)."""
    if not status_map:
        return 0, set()
    skip: Set[str] = set()
    success = 0
    for cfg in config_files:
        status = status_map.get(cfg)
        if status == results_store.STATUS_SUCCESS:
            skip.add(cfg)
            success += 1
        elif status == results_store.STATUS_FAILED:
            skip.add(cfg)
        # Running / unknown -> re-run
    return success, skip


# flags of paths not ported yet -> the ROADMAP.md item that adds them
NOT_PORTED = {
    "coordinate": "queue 1, item 2 (multi-worker coordination, --coordinate)",
}


def run_batch(
    project_name: str,
    max_success: int | None = None,
    root: str = ".",
    progress: bool = True,
    device_resize: bool = False,
    lockstep: bool = False,
    max_batch: int = 16,
    f16_transfer: bool = False,
    video: bool = True,
    fetch_overlap: bool = True,
    f16_state: bool = False,
    yuv_video: bool = False,
    f16_retry: bool = False,
    adaptive_fetch: bool = True,
    device="cuda",
    spatial_mesh=None,
    **not_ported,
) -> Dict[str, int]:
    """Run every pending case of a project on ``device`` (the reference
    batch_run contract: resume, status, summary and NPZ).

    ``lockstep=True`` delegates to the lockstep engine
    (pipeline/batch_datagen.run_batched), which shares this entry's resume/
    status/summary/NPZ contract and artifact set but advances same-shape
    cases together; ``max_batch``, ``f16_state``, ``f16_transfer``,
    ``yuv_video``, ``f16_retry``, ``video``, ``fetch_overlap`` and
    ``adaptive_fetch`` apply there. ``device_resize`` applies to both
    loops. ``spatial_mesh`` ("2x4" / "auto") runs each case spatially
    sharded over a device mesh (parallel/sharded.py), with the serial
    path's artifacts. The flags of paths not ported yet (``NOT_PORTED``)
    raise NotImplementedError when set; they are never ignored.
    """
    for flag, value in not_ported.items():
        if flag not in NOT_PORTED:
            raise TypeError(f"run_batch() got an unexpected keyword argument {flag!r}")
        if value:
            raise NotImplementedError(
                f"--{flag} is not ported yet (ROADMAP.md {NOT_PORTED[flag]})"
            )
    if f16_retry and not (lockstep and f16_state):
        # without lockstep + f16_state nothing runs in f16, so a silently
        # ignored --f16_retry would fake retry protection
        raise ValueError("--f16_retry requires --lockstep and --f16_state "
                         "(it re-runs f16-state failures in exact f32)")
    if lockstep and spatial_mesh:
        raise ValueError(
            "--spatial_mesh shards one case over many devices; --lockstep "
            "batches many cases per device -- pick one (case-parallel "
            "cross-chip lockstep, BatchEngine(runner='sharded'), is ROADMAP.md "
            "queue 1, item 4)"
        )
    resolve_device(device)  # no GPU -> raise here, not once per case
    if lockstep:
        from .batch_datagen import run_batched

        return run_batched(
            project_name, max_batch=max_batch, root=root, progress=progress,
            device_resize=device_resize, f16_transfer=f16_transfer,
            video=video, fetch_overlap=fetch_overlap, f16_state=f16_state,
            yuv_video=yuv_video, f16_retry=f16_retry,
            max_success=max_success, adaptive_fetch=adaptive_fetch,
            device=device,
        )
    project_paths = paths.get_project_paths(project_name, root=root)
    output_dirs = paths.setup_output_directories(project_paths["outputs"])

    config_meta_path = os.path.join(project_paths["project_base"], "config_meta.json")
    sim_results_path = os.path.join(output_dirs["plots"], "sim_results.json")
    legacy_summary_path = os.path.join(output_dirs["plots"], "all_cases_summary.json")
    npz_path = os.path.join(output_dirs["plots"], "all_cases_vectors.npz")

    config_meta = results_store.load_config_meta(config_meta_path)
    if config_meta:
        results_store.init_sim_results(config_meta, sim_results_path)

    config_files = find_config_files(project_paths["configs"])
    print(f"[Batch] project '{project_name}': {len(config_files)} configs found.")

    status_map = results_store.get_status_map(sim_results_path)
    already_success, skip_set = build_resume_plan(config_files, status_map)

    if not os.path.exists(legacy_summary_path):
        summary.init_summary_file(legacy_summary_path)

    if max_success is not None and max_success - already_success <= 0:
        print(f"[Batch] max_success={max_success} already reached; nothing to do.")
        return {"success": 0, "skipped": len(skip_set), "failed": 0}

    new_success = new_failed = new_skip = 0
    for i, cfg_file in enumerate(config_files):
        full_config_path = os.path.join(project_paths["configs"], cfg_file)
        job_id = i + 1

        if cfg_file in skip_set:
            new_skip += 1
            continue
        if max_success is not None and already_success + new_success >= max_success:
            print(f"[Batch] reached max_success={max_success}; stopping.")
            break
        print(f"\n--- Job {job_id}/{len(config_files)}: {cfg_file}")
        # Crash-safe: mark Running before starting.
        results_store.set_status(
            cfg_file, results_store.STATUS_RUNNING, sim_results_path
        )
        try:
            cfg = load_config(full_config_path)
            sim_cfg = cfg.get("simulation", {})
            summary.update_summary_file(
                {
                    "case_name": sim_cfg.get("name", cfg_file),
                    "status": "Running",
                    "job_id": job_id,
                    "parameters": {
                        "lattice": {
                            "resolution_px": [sim_cfg.get("nx"), sim_cfg.get("ny")]
                        }
                    },
                    "source_files": {
                        "config_file": cfg_file,
                        "mask_file": os.path.basename(
                            cfg.get("mask", {}).get("path", "N/A")
                        ),
                    },
                },
                legacy_summary_path,
            )
        except Exception as exc:
            print(f"  [Warning] legacy summary pre-write failed: {exc}")

        wall_t0 = time.perf_counter()
        entry = case_executor.execute_case(
            full_config_path, project_paths, output_dirs, job_id,
            progress=progress, device_resize=device_resize, device=device,
            spatial_mesh=spatial_mesh,
        )
        wall_time_s = time.perf_counter() - wall_t0
        entry["wall_time_s"] = round(wall_time_s, 2)

        if entry.get("status") == "Success":
            results_store.fill_simulation_outputs(
                config_filename=cfg_file,
                simulation_outputs=entry.get("parameters", {}).get(
                    "simulation_outputs", {}
                ),
                run_summary=entry.get("run_summary", {}),
                wall_time_s=wall_time_s,
                sim_results_path=sim_results_path,
            )
            new_success += 1
        else:
            results_store.set_status(
                cfg_file,
                results_store.STATUS_FAILED,
                sim_results_path,
                extra_fields={
                    "wall_time_s": round(wall_time_s, 2),
                    "reason": entry.get("reason", "Unknown"),
                },
            )
            new_failed += 1

        summary.update_summary_file(entry, legacy_summary_path)
        tag = "OK" if entry.get("status") == "Success" else "FAIL"
        print(f"  [{tag}] {cfg_file}  wall_time={wall_time_s:.1f}s")

    print(
        f"\n[Batch] done: prev_success={already_success} new_success={new_success} "
        f"failed={new_failed} skipped={new_skip}"
    )

    try:
        build_npz(legacy_summary_path, npz_path)
    except Exception as exc:
        print(f"[Warning] NPZ build failed (sim_results.json still valid): {exc}")

    return {"success": new_success, "skipped": new_skip, "failed": new_failed}


def main() -> None:
    ap = argparse.ArgumentParser(description="Multi-case LBM batch runner.")
    ap.add_argument("--project_name", type=str, required=True)
    ap.add_argument("--root", type=str, default=".",
                    help="directory holding SimCases/ and outputs/")
    ap.add_argument("--max_success", type=int, default=None,
                    help="stop after N total successful cases (prior runs "
                    "count; reference CLI contract). With --lockstep the "
                    "stop is group-granular: the in-flight group finishes "
                    "and may overshoot N by up to --max_batch")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument(
        "--device_resize", action="store_true",
        help="crop+resize dataset frames and render video frames on device "
        "before the host fetch (ships [9,256,W'] instead of the full grid)",
    )
    ap.add_argument(
        "--lockstep", action="store_true",
        help="advance same-shape cases together on the lockstep engine "
        "(same resume/status/artifact contract, higher throughput)",
    )
    ap.add_argument("--max_batch", type=int, default=16,
                    help="lockstep group size cap (with --lockstep)")
    ap.add_argument("--f16_transfer", action="store_true",
                    help="f16 dataset fetches (with --lockstep)")
    ap.add_argument("--f16_state", action="store_true",
                    help="16-bit deviation solver state between monitor "
                    "steps -- half K1's f bytes, bounded quantization noise "
                    "(with --lockstep)")
    ap.add_argument("--no_video", action="store_true",
                    help="skip per-case mp4 (with --lockstep)")
    ap.add_argument("--yuv_video", action="store_true",
                    help="fetch video frames as YUV 4:2:0 -- half the bytes, "
                    "encoder-equivalent quality (with --lockstep)")
    ap.add_argument("--fetch_at_idle", action="store_true",
                    help="fetch saves/video right after each chunk instead of "
                    "on a worker thread (with --lockstep)")
    ap.add_argument("--no_adaptive_fetch", action="store_true",
                    help="disable the FetchPacer (with --lockstep)")
    ap.add_argument("--f16_retry", action="store_true",
                    help="re-run cases that fail under --f16_state once in "
                    "exact f32 before recording them Failed")
    ap.add_argument("--spatial_mesh", default=None, metavar="RxC",
                    help="run each case spatially sharded over a device "
                    "mesh, e.g. '2x4' or 'auto' (most-square over all "
                    "CUDA devices; 1x1 with --device cpu)")
    for flag, item in NOT_PORTED.items():
        ap.add_argument(f"--{flag}", action="store_true",
                        help=f"not ported yet: raises (ROADMAP.md {item})")
    args = ap.parse_args()
    run_batch(
        args.project_name, args.max_success, root=args.root,
        device_resize=args.device_resize, lockstep=args.lockstep,
        max_batch=args.max_batch, f16_transfer=args.f16_transfer,
        video=not args.no_video, fetch_overlap=not args.fetch_at_idle,
        f16_state=args.f16_state, yuv_video=args.yuv_video,
        f16_retry=args.f16_retry, adaptive_fetch=not args.no_adaptive_fetch,
        device=args.device, spatial_mesh=args.spatial_mesh,
        **{flag: getattr(args, flag) for flag in NOT_PORTED},
    )


if __name__ == "__main__":
    main()
