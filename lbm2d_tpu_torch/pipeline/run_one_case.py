"""Single-case runner: build engine/viz/recorder/writer from one case YAML,
run the loop, measure the actual inlet velocity and Reynolds number.

Counterpart of ``lbm2d_tpu/pipeline/run_one_case.py`` (reference
pipeline/run_one_case.py, init_simulation_env:18, main:71): max_steps comes straight from config; the measured inlet velocity
is the y-average of u_x on the x=1 column (x=0 is a BC node); tensor shapes
are collected from the writer for the summary.

A case on a spatial mesh spanning several processes
(``parallel/multihost.py``, ``--coordinator``) runs this entry on every
rank; rank 0 alone writes artifacts, and it alone decides whether to
resume from a checkpoint (``_resume_decision``).

    python -m lbm2d_tpu_torch.pipeline.run_one_case --config C --mask M --h5 H --video V \
        --spatial_mesh 2x1 --coordinator 127.0.0.1:29500 --num_processes 2 --process_id R
"""

from __future__ import annotations

import os
import traceback
from typing import Any, Dict, Optional, Tuple

import numpy as np

from ..core.engine import LBMEngine, resolve_device
from ..io.h5_writer import AsyncLBMCaseWriter
from ..io.video import VideoRecorder
from ..utils.config import load_config
from ..utils.masks import create_mask
from ..viz.frames import FrameComposer, calc_gui_size
from .sim_loop import run_simulation_loop


def process_rank() -> int:
    """This process's torch.distributed rank, 0 when no group is set up."""
    import torch.distributed as dist

    if dist.is_available() and dist.is_initialized():
        return dist.get_rank()
    return 0


def _resume_decision(engine: LBMEngine, ckpt_path: str) -> bool:
    """Whether to resume from ``ckpt_path``. Multi-host: rank 0, the only
    writer of checkpoints, decides from its own filesystem and every rank
    takes its decision (the engine then broadcasts rank 0's state), so the
    ranks never start from different steps, whatever the other ranks'
    filesystems hold."""
    exists = os.path.exists(ckpt_path)
    if getattr(engine, "_multihost", False):
        from ..parallel.multihost import broadcast_object

        exists = broadcast_object(exists)
    return exists


def init_simulation_env(
    config: Dict[str, Any],
    mask_path: Optional[str],
    h5_output_path: Optional[str],
    video_output_path: Optional[str],
    device="cuda",
    spatial_mesh=None,
):
    sim_cfg = config["simulation"]
    gui_cfg = config["outputs"]["gui"]
    vid_cfg = config["outputs"]["video"]
    data_cfg = config["outputs"]["dataset"]

    mask = create_mask(config, mask_path)  # [ny, nx] bool

    gui_w, gui_h = calc_gui_size(
        sim_cfg["nx"], sim_cfg["ny"], gui_cfg.get("max_size")
    )
    composer = FrameComposer(gui_w, gui_h, viz_sigma=gui_cfg.get("gaussian_sigma", 1.0))

    engine = LBMEngine(config, mask_yx=mask.astype(np.float32), device=device,
                       spatial_mesh=spatial_mesh)
    engine.init()

    # only rank 0 of a torch.distributed group owns artifacts
    io_rank = process_rank() == 0

    gui = None
    if gui_cfg.get("enable") and io_rank:
        from ..viz.gui import GuiWindow

        gui = GuiWindow("LBM", res=(gui_w, gui_h))

    recorder = None
    if vid_cfg["enable"] and video_output_path and io_rank:
        recorder = VideoRecorder(
            video_output_path, width=gui_w, height=gui_h, fps=vid_cfg.get("fps", 30)
        )
        recorder.start()

    writer = None
    if data_cfg["enable"] and h5_output_path and io_rank:
        writer = AsyncLBMCaseWriter(
            h5_output_path,
            config,
            engine.nx,
            engine.ny,
            mask_yx=mask.astype(np.float32),
        )

    return engine, composer, gui, recorder, writer


def main(
    config_path: str,
    mask_path: Optional[str],
    h5_output_path: Optional[str],
    video_output_path: Optional[str],
    progress: bool = True,
    device_resize: bool = False,
    spatial_mesh=None,
    device="cuda",
) -> Dict[str, Any]:
    """Run one case on ``device`` (``cuda`` unless the caller passes
    ``cpu``). ``device_resize`` crops and resizes dataset frames and renders
    video frames on the device; ``spatial_mesh`` ("2x4" / (2, 4) / "auto")
    runs the case on the blocks of a device mesh (overrides the config's
    ``simulation.spatial_mesh``), with the serial path's artifacts
    (``tests/test_torch_spatial_pipeline.py``)."""
    resolve_device(device)
    metadata: Dict[str, Any] = {"status": "Failed", "reason": "Unknown error"}
    engine = composer = gui = recorder = writer = None
    try:
        if not os.path.exists(config_path):
            raise FileNotFoundError(f"Config file not found: {config_path}")
        config = load_config(config_path)

        engine, composer, gui, recorder, writer = init_simulation_env(
            config, mask_path, h5_output_path, video_output_path,
            device=device, spatial_mesh=spatial_mesh,
        )

        max_steps = int(config["simulation"]["max_steps"])

        # optional in-case solver-state checkpointing (the reference can only
        # restart a case from step 0; SURVEY.md section 5 checkpoint gap)
        ckpt_cfg = config["outputs"].get("checkpoint", {})
        ckpt_path = None
        ckpt_interval = 0
        if ckpt_cfg.get("enable"):
            ckpt_path = ckpt_cfg.get("path") or (
                (h5_output_path or "case") + ".ckpt.npz"
            )
            ckpt_interval = int(ckpt_cfg.get("interval_steps", 0))
            if ckpt_cfg.get("resume") and _resume_decision(engine, ckpt_path):
                engine.load_checkpoint(ckpt_path)
                print(f"[Checkpoint] resumed at step {engine.step_count}")

        metadata.update(
            run_simulation_loop(
                config, engine, composer, recorder, writer, max_steps,
                gui=gui,
                checkpoint_path=ckpt_path,
                checkpoint_interval=ckpt_interval,
                progress=progress,
                device_resize=device_resize,
            )
        )
        if ckpt_path and metadata.get("status") == "Success":
            # completed cases don't need their restart state any more
            if os.path.exists(ckpt_path):
                os.remove(ckpt_path)

        if metadata.get("status") == "Success":
            metadata["reason"] = "Completed successfully"
            # Measured inlet velocity: mean u_x over the x=1 column, walls
            # excluded (reference run_one_case.py:152-166).
            u_np, _ = engine.get_physical_fields()
            inlet_u = float(np.mean(u_np[0, 1:-1, 1]))
            l_char = config["simulation"]["characteristic_length"]
            nu = config["simulation"]["nu"]
            metadata["u_inlet_lattice_lu"] = inlet_u
            metadata["reynolds_number_lattice_actual"] = (
                (inlet_u * l_char) / nu if nu > 0 else float("inf")
            )
            metadata["l_char_lattice_px"] = l_char
            metadata["nu_lattice_lu"] = nu
            metadata["nx"] = engine.nx
            metadata["ny"] = engine.ny
            metadata["total_steps_executed"] = metadata.get("final_steps", 0)
            metadata["h5_file"] = (
                os.path.basename(h5_output_path) if h5_output_path else "N/A"
            )
            metadata["video_file"] = (
                os.path.basename(video_output_path) if video_output_path else "N/A"
            )
    except Exception as exc:
        traceback.print_exc()
        metadata["reason"] = str(exc)
    finally:
        if gui:
            gui.close()
        if recorder:
            recorder.stop()
        if writer:
            writer.close()  # drain the async queue BEFORE reading running_count
            try:
                if metadata.get("status") == "Success":
                    w = writer.writer
                    metadata["tensor_shape_static_mask"] = [2, w.target_h, w.target_w]
                    metadata["tensor_shape_turbulence"] = [
                        w.running_count,
                        w.channels,
                        w.target_h,
                        w.target_w,
                    ]
            except Exception:
                pass
    return metadata


if __name__ == "__main__":
    import argparse

    ap = argparse.ArgumentParser(description="Run a single LBM case.")
    ap.add_argument("--config", required=True)
    ap.add_argument("--mask", required=True)
    ap.add_argument("--h5", default="outputs/test_run/test_case.h5")
    ap.add_argument("--video", default="outputs/test_run/test_case.mp4")
    ap.add_argument("--device", default="cuda",
                    help="torch device: cuda (default) or cpu")
    ap.add_argument("--spatial_mesh", default=None,
                    help="run spatially sharded over a device mesh, e.g. "
                    "'2x4' or 'auto' (most-square over all devices)")
    ap.add_argument("--coordinator", default=None, metavar="HOST:PORT",
                    help="multi-process run: rank 0's address; start one process "
                    "per rank with --num_processes and --process_id, the same "
                    "--spatial_mesh over all ranks' devices")
    ap.add_argument("--num_processes", type=int, default=1)
    ap.add_argument("--process_id", type=int, default=0)
    ap.add_argument("--backend", default=None, choices=("nccl", "gloo"),
                    help="torch.distributed backend (default: nccl when every "
                    "rank has a card of its own, else gloo)")
    args = ap.parse_args()
    if args.coordinator:
        from ..parallel.multihost import init_multihost

        init_multihost(args.coordinator, args.num_processes, args.process_id,
                       backend=args.backend, device=args.device)
    md = main(args.config, args.mask, args.h5, args.video, device=args.device,
              spatial_mesh=args.spatial_mesh)
    if args.coordinator:
        from ..parallel.multihost import sync

        sync()  # rank 0's writer is closed before any rank exits
    print(md)
