"""Chunked host loop: advance on device, monitor, visualize, write dataset.

Counterpart of ``lbm2d_tpu/pipeline/sim_loop.py`` (reference
core/simulation_ops.py:60-242): the device advances ``compute_step_size``
lattice steps per host interaction (monitor scalars returned with the
chunk, fetched in one transfer), the GUI is the matplotlib-backed
viz.gui.GuiWindow (headless-safe; closing it aborts the case like the
reference's ti.GUI), and optional periodic solver-state checkpoints are
supported (the reference can only restart a case from step 0).
"""

from __future__ import annotations

import time
from typing import Any, Dict, Optional

import numpy as np

from ..core.engine import LBMEngine
from ..core.stability import check_stability
from ..utils.config import get_zone_config
from ..viz.frames import FrameComposer, draw_zone_overlay


def run_simulation_loop(
    config: Dict[str, Any],
    engine: LBMEngine,
    composer: Optional[FrameComposer],
    recorder,
    writer,
    max_steps: int,
    gui=None,
    checkpoint_path: Optional[str] = None,
    checkpoint_interval: int = 0,
    progress: bool = True,
    device_resize: bool = False,
) -> Dict[str, Any]:
    sim_cfg = config["simulation"]
    out_cfg = config["outputs"]
    zones = get_zone_config(config)

    chunk = int(sim_cfg["compute_step_size"])
    gui_interval = out_cfg["gui"]["interval_steps"]
    vid_interval = out_cfg["video"]["interval_steps"]
    data_interval = out_cfg["dataset"]["interval_steps"]
    start_record = out_cfg.get("start_record_step", 0)
    show_overlay = out_cfg["gui"].get("show_zone_overlay", False)
    profiling = out_cfg.get("enable_profiling", False)

    current_steps = int(engine.step_count)
    exit_status = "Success"
    exit_reason = "Reached max_steps"

    # Optional on-device dataset resize (same design as the lockstep path,
    # pipeline/batch_datagen.py): crop + area-average on the device so the
    # device-to-host transfer ships [9, 256, W'] instead of the full grid.
    resizer = None
    _crop = None
    if device_resize and writer is not None:
        from ..ops.resize import make_device_resizer

        w0 = writer.writer
        _crop = (slice(None), w0.slice_y, w0.slice_x)
        resizer = make_device_resizer(
            w0.crop_h, w0.crop_w, w0.target_h, w0.target_w
        )
    # With device_resize, video/GUI frames are also rendered on the device
    # (ops/render.py: |u| + vorticity + colormap LUT at display size) and
    # fetched as uint8 instead of the full-resolution u field.
    dev_renderer = None
    if (
        device_resize
        and composer is not None
        and (out_cfg["video"]["enable"] or out_cfg["gui"]["enable"])
    ):
        from ..ops.render import make_device_frame_renderer

        dev_renderer = make_device_frame_renderer(
            composer.width,
            composer.height,
            viz_sigma=out_cfg["gui"].get("gaussian_sigma", 1.0),
        )
    timings = {"compute": 0.0, "viz_proc": 0.0, "video_io": 0.0, "moment_fetch": 0.0, "hdf5_io": 0.0}

    pbar = None
    if progress:
        try:
            from tqdm import tqdm

            pbar = tqdm(total=max_steps, initial=current_steps, unit="step")
        except Exception:
            pbar = None

    try:
        while current_steps < max_steps:
            # user closed the live window -> abort the case (reference
            # core/simulation_ops.py:91-95)
            if gui is not None and not gui.running:
                exit_status = "Aborted"
                exit_reason = "GUI closed by user"
                break
            t0 = time.perf_counter()
            engine.run_step(chunk)
            forces = engine.get_force()
            max_v = engine.get_max_velocity()
            current_steps += chunk
            timings["compute"] = (time.perf_counter() - t0) * 1000

            is_stable, reason = check_stability(
                forces, max_v, current_steps, warmup_step=sim_cfg["warmup_steps"]
            )
            if not is_stable:
                exit_status = "Failed"
                exit_reason = reason
                break

            if pbar:
                pbar.set_postfix(
                    Fx=f"{forces[0]:.2e}", Fy=f"{forces[1]:.2e}", MaxV=f"{max_v:.4f}"
                )
                pbar.update(chunk)

            is_vid_frame = (
                out_cfg["video"]["enable"]
                and vid_interval
                and current_steps % vid_interval == 0
                and current_steps >= start_record
            )
            is_gui_frame = (
                out_cfg["gui"]["enable"]
                and gui_interval
                and current_steps % gui_interval == 0
            )
            if (is_vid_frame or is_gui_frame) and composer is not None:
                t0 = time.perf_counter()
                if dev_renderer is not None:
                    img = dev_renderer(engine.state.u, engine.params.mask).cpu().numpy()
                    if show_overlay:
                        img = draw_zone_overlay(img.copy(), zones)
                else:
                    u_np, mask_np = engine.get_physical_fields()
                    img = composer.process_frame(u_np, mask_np)
                    if show_overlay:
                        img = draw_zone_overlay(img, zones)
                timings["viz_proc"] = (time.perf_counter() - t0) * 1000
                if is_gui_frame and gui is not None:
                    gui.set_image(img)
                    gui.show()
                if is_vid_frame and recorder:
                    t0 = time.perf_counter()
                    if dev_renderer is not None:
                        recorder.write_frame_u8(img)
                    else:
                        recorder.write_frame(img)
                    timings["video_io"] = (time.perf_counter() - t0) * 1000

            is_data_step = (
                out_cfg["dataset"]["enable"]
                and data_interval
                and current_steps % data_interval == 0
                and current_steps >= start_record
            )
            if is_data_step and writer is not None:
                t0 = time.perf_counter()
                if resizer is not None:
                    moments = resizer(engine.get_moments_device()[_crop]).cpu().numpy()
                else:
                    moments = engine.get_moments()
                timings["moment_fetch"] = (time.perf_counter() - t0) * 1000
                t0 = time.perf_counter()
                writer.append(moments, pre_resized=resizer is not None)
                timings["hdf5_io"] = (time.perf_counter() - t0) * 1000

            if (
                checkpoint_path
                and checkpoint_interval
                and current_steps % checkpoint_interval == 0
            ):
                engine.save_checkpoint(checkpoint_path)

            if profiling and (current_steps // chunk) % 10 == 0:
                mlups = chunk * engine.nx * engine.ny / max(timings["compute"], 1e-9) / 1e3
                print(
                    f"[Profile] step {current_steps} compute={timings['compute']:.1f}ms "
                    f"({mlups:.0f} MLUPS) viz={timings['viz_proc']:.1f}ms "
                    f"h5={timings['moment_fetch'] + timings['hdf5_io']:.1f}ms"
                )

    except KeyboardInterrupt:
        exit_status = "Aborted"
        exit_reason = "User Interrupted (Ctrl+C)"
    except Exception as exc:  # runtime containment, reference :216-221
        exit_status = "Error"
        exit_reason = f"Runtime Error: {exc}"
        import traceback

        traceback.print_exc()
    finally:
        if pbar:
            pbar.close()

    return {
        "status": exit_status,
        "reason": exit_reason,
        "final_steps": current_steps,
        "target_steps": max_steps,
        "re_val": float(engine.Re),
        "u_max": float(engine.u_inlet_estimate),
        "D": float(config["simulation"]["characteristic_length"]),
        "nu": float(config["simulation"]["nu"]),
    }
