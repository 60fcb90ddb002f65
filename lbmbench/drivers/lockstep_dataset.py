"""Driver of the lockstep dataset run: whole ``run_batch`` groups with the
README's production flags, back to back, until the window has passed.

Set-up makes the group's mask from the seed, a project a group (the
configuration at each viscosity of the group, as ``config_batch_gen``
writes them for one mask), and runs one short group of two chunks that
builds and warms every shape the window uses. The window then runs whole
groups, each one ``run_batch`` call, its own set-up and wind-down inside,
and ends with the first group that ends after ``--seconds`` (and not
before the group the check samples).

The check follows the program. It takes the program's state before and
after two chunks, and what the program saved from the second: the first
chunk of the first group, which the reference runs from its own rest state
(the start: parameters, mask, ramp and edges), and one chunk drawn from the
seed, which the reference runs from the program's state before it (the
group step with deviation storage and the closing full step: f, and the
f_post, rho and u that only the full step writes), with the monitors, the
breaker's verdict, the saved dataset frame and the rendered video frame of
that chunk judged against the reference's from the program's state after
it.
"""

from __future__ import annotations

import copy
import json
import os
import shutil
import tempfile
import time

import numpy as np


class Probe:
    """Takes the program's state and outputs at the chunks the check
    samples, and starts and stops the trace, from wrappers around the
    group engine's chunk and the frame renderer."""

    def __init__(self, start_chunk, sample, trace_span=None):
        self.group = None            # index of the timed group; None outside the window
        self.engine = None
        self.chunk = 0
        self.start_chunk = start_chunk   # (group, chunk) whose state after it is kept
        self.sample = sample             # (group, chunk) followed by the reference
        self.trace_span = trace_span     # (group, first chunk, last chunk) or None
        self.tracer = None
        self.render_next = False
        self.kept = {}

    def begin(self, g):
        self.group, self.engine, self.chunk, self.follow = g, None, 0, False

    def end(self):
        self.group, self.engine, self.render_next = None, None, False

    @staticmethod
    def snapshot(engine, names=("f", "f_post", "rho", "u")):
        st = engine.state
        out = {k: getattr(st, k).clone() for k in names}
        out["step"] = [int(s) for s in st.step]
        out["alive"] = engine.alive_mask
        return out

    def wrap_run_step(self, orig):
        probe = self

        def run_step(engine, n=1, sync=True):
            if probe.group is None:
                return orig(engine, n, sync)
            if engine is not probe.engine:
                # a group's first engine; an f32 retry's engine is not followed
                first = probe.engine is None
                probe.engine, probe.chunk = engine, 0
                probe.follow = first
            probe.chunk += 1
            at = (probe.group, probe.chunk) if probe.follow else None
            span = probe.trace_span
            if span and at == (span[0], span[1]):
                probe.tracer.start()
            if at == probe.sample:
                probe.kept["pre"] = probe.snapshot(engine)
            out = orig(engine, n, sync)
            if at == probe.start_chunk:
                probe.kept["start"] = probe.snapshot(engine, ("f",))
            if at == probe.sample:
                probe.kept["post"] = probe.snapshot(engine)
                packed = out if not isinstance(out, dict) else None
                probe.kept["packed"] = None if packed is None else packed.clone()
                probe.render_next = True
            if span and at == (span[0], span[2]):
                probe.tracer.stop()
            return out

        return run_step

    def wrap_renderer(self, make):
        probe = self

        def make_renderer(*a, **kw):
            render = make(*a, **kw)

            def wrapped(u, mask):
                out = render(u, mask)
                if probe.render_next:
                    probe.render_next = False
                    probe.kept["render"] = tuple(t.clone() for t in out) \
                        if isinstance(out, tuple) else out.clone()
                return out

            return wrapped

        return make_renderer


def case_configs(cfgfile, seed, steps, start_record):
    """[(file name, case config)] of the group, one a viscosity."""
    out = []
    for nu in cfgfile["group"]["nus"]:
        cfg = copy.deepcopy(cfgfile["case"])
        tag = f"Nu{nu:.4f}".replace(".", "-")
        cfg["simulation"].update(nu=nu, name=f"S{seed}_{tag}", max_steps=int(steps))
        cfg["outputs"]["start_record_step"] = int(start_record)
        cfg["outputs"]["video"]["filename"] = f"S{seed}_{tag}.mp4"
        cfg["mask"]["path"] = "mask.png"
        out.append((f"cfg_{tag}.yaml", cfg))
    return out


def make_project(root, name, mask_png, configs):
    import yaml

    base = os.path.join(root, "SimCases", name)
    os.makedirs(os.path.join(base, "configs"))
    os.makedirs(os.path.join(base, "masks"))
    os.link(mask_png, os.path.join(base, "masks", "mask.png"))
    for fname, cfg in configs:
        with open(os.path.join(base, "configs", fname), "w") as fh:
            yaml.safe_dump(cfg, fh, sort_keys=False)


def read_results(root, name):
    with open(os.path.join(root, "outputs", name, "plots", "sim_results.json")) as fh:
        return json.load(fh)


def draw_sample(seed, wl, chunks, first_record):
    """(group, chunk) the check follows, drawn from the seed: a group among
    the first ``sample_groups``, a chunk that saves where the cell records
    (else any chunk after the first)."""
    rng = np.random.default_rng(seed)
    g = int(rng.integers(0, int(wl["sample_groups"])))
    lo = first_record if wl["record"] else 2
    return g, int(rng.integers(lo, chunks + 1))


def run(run):
    import torch

    from lbm2d_tpu_torch.io import h5_writer
    from lbm2d_tpu_torch.ops import render as render_mod
    from lbm2d_tpu_torch.parallel.batch import BatchEngine
    from lbm2d_tpu_torch.pipeline.batch_run import run_batch

    from lbmbench import masks, memh5, yardstick
    from lbmbench.harness import Outcome
    from lbmbench.trace import DeviceTrace

    cfgfile, wl = run.config, run.workload
    sim = cfgfile["case"]["simulation"]
    chunk, steps = int(sim["compute_step_size"]), int(sim["max_steps"])
    ny, nx = int(sim["ny"]), int(sim["nx"])
    chunks = steps // chunk
    start_record = int(cfgfile["case"]["outputs"]["start_record_step"]) if wl["record"] \
        else steps + chunk
    first_record = -(-start_record // chunk)
    flags = dict(cfgfile["group"]["flags"])
    device = run.device

    mask = masks.urban_mask(run.seed, cfgfile["mask"]["domain"], cfgfile["mask"]["padding"])
    if mask.shape != (ny, nx):
        raise ValueError(f"mask {mask.shape} does not fit the grid ({ny}, {nx})")
    work = tempfile.mkdtemp(prefix="lbmbench-")
    patched = memh5.install(h5_writer)
    try:
        import cv2

        png = os.path.join(work, "mask.png")
        cv2.imwrite(png, np.where(mask > 0.5, 0, 255).astype(np.uint8))
        sample = draw_sample(run.seed, wl, chunks, first_record)
        span = None
        if run.trace:
            span = (sample[0], int(wl["trace_chunks"][0]), int(wl["trace_chunks"][1]))
        probe = Probe((0, 1), sample, span)
        probe.tracer = DeviceTrace() if run.trace else None
        patched.append((BatchEngine, "run_step", BatchEngine.run_step))
        patched.append((render_mod, "make_device_frame_renderer",
                        render_mod.make_device_frame_renderer))
        BatchEngine.run_step = probe.wrap_run_step(BatchEngine.run_step)
        render_mod.make_device_frame_renderer = probe.wrap_renderer(
            render_mod.make_device_frame_renderer)

        def group(name, n_steps, record_from):
            make_project(work, name, png, case_configs(cfgfile, run.seed, n_steps, record_from))
            t0 = time.perf_counter()
            run_batch(name, root=work, progress=False, device=device, **flags)
            if device != "cpu":
                torch.cuda.synchronize()
            return time.perf_counter() - t0

        # warm-up: two chunks through the same entry, saving where the cell saves
        group("warm", 2 * chunk, chunk if wl["record"] else 3 * chunk)
        memh5.MemH5File.FILES.clear()
        if device != "cpu":
            torch.cuda.reset_peak_memory_stats()
        setup_s = run.since_start()

        groups, frames, statuses = [], {}, []
        t_start = time.perf_counter()
        g = 0
        while True:
            name = f"G{g:03d}"
            probe.begin(g)
            wall = group(name, steps, start_record)
            probe.end()
            results = read_results(work, name)
            transfer = next((e["run_summary"]["transfer"] for e in results
                             if e.get("run_summary", {}).get("transfer")), {})
            ok = [e.get("status") == "Success" for e in results]
            statuses += ok
            groups.append({"harness_wall_s": wall, "program_wall_s": transfer.get("group_wall_s"),
                           "cases": len(results), "success": sum(ok), "steps": steps,
                           "fetch_stall_fraction": transfer.get("fetch_stall_fraction")})
            prefix = os.path.join(work, "outputs", name, "raw")
            if g == sample[0] and wl["record"]:
                for fname, cfg in case_configs(cfgfile, run.seed, steps, start_record):
                    f = memh5.MemH5File.FILES[os.path.join(prefix, cfg["simulation"]["name"] + ".h5")]
                    frames[cfg["simulation"]["name"]] = f.datasets["turbulence"].a[
                        sample[1] - first_record].copy()
            for path in [p for p in memh5.MemH5File.FILES if p.startswith(prefix)]:
                del memh5.MemH5File.FILES[path]
            g += 1
            elapsed = time.perf_counter() - t_start
            if elapsed >= run.seconds and g > sample[0]:
                break
        window_s = elapsed
        peak = torch.cuda.max_memory_allocated() if device != "cpu" else 0
        cells = nx * ny
        updates = sum(x["success"] * x["steps"] for x in groups) * cells
        record = {"kind": "dataset", "groups": groups, "window_s": window_s,
                  "device_kind": torch.cuda.get_device_name(0) if device != "cpu" else "cpu"}
        trace = None
        if probe.tracer is not None and probe.tracer.done:
            trace = probe.tracer.reduce()
            n_traced = span[2] - span[1] + 1
            links = yardstick.solid_links(mask)
            record["trace_lattice_bytes"] = n_traced * len(cfgfile["group"]["nus"]) * \
                yardstick.chunk_bytes(cells, chunk, links, dev=cfgfile["storage"] == "bf16_deviation")
        if device != "cpu":
            torch.cuda.empty_cache()
        args = (probe.kept, frames, cfgfile, run.seed, mask, steps, start_record, wl["record"],
                device)
        t_ref = time.perf_counter()
        checks = judge(*args)
        run.log(f"[lbmbench] window {window_s:.2f} s, {len(groups)} group(s); "
                f"check {time.perf_counter() - t_ref:.1f} s")
        notes = {"control": judge(*args, control=True)} if wl.get("control") else {}
        mlups = updates / window_s / 1e6
        return Outcome(setup_s=setup_s, e2e={"dataset_mlups": mlups},
                       attempted=len(statuses), failed=len(statuses) - sum(statuses),
                       record=record, checks=checks, memory_peak_bytes=peak, trace=trace,
                       notes=notes)
    finally:
        for owner, attr, orig in patched:
            setattr(owner, attr, orig)
        memh5.MemH5File.FILES.clear()
        shutil.rmtree(work, ignore_errors=True)


STATE = ("f", "f_post", "rho", "u")


def judge(kept, frames, cfgfile, seed, mask, steps, start_record, record, device, control=False):
    """The check's numbers against their limits, from what the probe kept.

    ``control`` puts the reference in the program's place at the precision
    below the one the configuration states (fp8 deviation storage for the
    chunk, fp8 frames for the float16 transfer, bfloat16 monitors and
    render) and reads the same numbers of it: the control, which has to
    come out not correct."""
    import torch

    from lbmbench.harness import Check
    from lbmbench.reference import frames as rframes
    from lbmbench.reference import lbm

    lim = cfgfile["limits"]
    f64 = torch.float64
    # the chunks in float32 (the configuration's arithmetic; matrix products
    # never in TF32): float64 would double a check that runs after every run
    f32 = torch.float32
    start_case = int(np.random.default_rng(seed + 1).integers(len(cfgfile["group"]["nus"])))
    chunk = int(cfgfile["case"]["simulation"]["compute_step_size"])
    configs = [c for _, c in case_configs(cfgfile, seed, steps, start_record)]
    fp8 = torch.float8_e4m3fn
    worst = {k: 0.0 for k in ("start_f", "chunk_f", "chunk_f_post", "chunk_rho", "chunk_u",
                              "monitor_force", "monitor_maxv", "frame_rel", "render_off")}
    mismatch = 0
    packed = kept["packed"].double().cpu().numpy() if kept.get("packed") is not None else None
    b_n = len(configs)
    for b, cfg in enumerate(configs):
        case = lbm.make_case(cfg, mask, device=device, dtype=f32)
        if b == start_case:
            # the start: the first chunk of one case, drawn from the seed,
            # from the reference's own rest state
            rest = lbm.rest_state(*mask.shape, device=device, dtype=f32)
            ref = lbm.chunk(rest, 0, chunk, case)
            got = kept["start"]["f"][b] if not control else lbm.chunk(
                rest, 0, chunk, case, store=fp8)["f"]
            worst["start_f"] = float((got - ref["f"]).abs().max())
            del ref, got, rest
        # the sampled chunk of every case from the program's state before it
        pre, post = kept["pre"], kept["post"]
        if not pre["alive"][b]:
            continue
        state = {k: pre[k][b].clone() for k in STATE}
        ref = lbm.chunk(state, pre["step"][b], chunk, case)
        got = {k: post[k][b] for k in STATE} if not control else lbm.chunk(
            state, pre["step"][b], chunk, case, store=fp8)
        # f, and what only the closing full step writes: f_post, rho, u
        for k in STATE:
            worst["chunk_" + k] = max(worst["chunk_" + k], float((got[k] - ref[k]).abs().max()))
        del ref, got, state
        # monitors and verdict of the program's state after the chunk
        f_post, u = post["f_post"][b].to(f64), post["u"][b].to(f64)
        force = lbm.force_equilibrium(f_post, case.solid)
        speed = lbm.max_speed(u)
        if control:
            bf = torch.bfloat16
            p_force = lbm.force_equilibrium(f_post.to(bf), case.solid).double()
            p_speed = float(lbm.max_speed(u.to(bf)))
            p_stable = lbm.stable(p_force.tolist(), p_speed, post["step"][b], case.warmup)
        else:
            p_force = torch.as_tensor(packed[2 * b:2 * b + 2], device=device)
            p_speed = float(packed[2 * b_n + b])
            p_stable = bool(packed[3 * b_n + b] > 0.5)
        worst["monitor_force"] = max(worst["monitor_force"], float(
            (p_force - force).abs().max() / max(1.0, float(force.abs().max()))))
        worst["monitor_maxv"] = max(worst["monitor_maxv"],
                                    abs(p_speed - float(speed)) / max(float(speed), 1e-30))
        mismatch += int(p_stable != lbm.stable(force.tolist(), float(speed), post["step"][b],
                                                case.warmup))
        if record:
            ref_frame = rframes.dataset_frame(f_post, cfg)
            got = rframes.dataset_frame(f_post, cfg, store=fp8) if control else torch.as_tensor(
                frames[cfg["simulation"]["name"]], device=device).to(f64)
            # against the frame's largest moment (the energy, ~2): a channel
            # near zero, as early in a run, would otherwise read any
            # rounding as a whole departure
            worst["frame_rel"] = max(worst["frame_rel"], float(
                (got - ref_frame).abs().max() / ref_frame.abs().max()))
            y, uv = rframes.video_frame(u, case.solid, cfg)
            if control:
                gy, guv = rframes.video_frame(u, case.solid, cfg, dtype=torch.bfloat16)
            else:
                gy, guv = kept["render"][0][b], kept["render"][1][b]
            # rounding moves a pixel whose index sits on a colormap boundary
            # by one level; a pixel more than one level off is a departure
            diff = torch.cat([(gy.int() - y.int()).abs().flatten(),
                              (guv.int() - uv.int()).abs().flatten()])
            worst["render_off"] = max(worst["render_off"], float((diff > 1).double().mean()))
        del f_post, u
    names = ["start_f", "chunk_f", "chunk_f_post", "chunk_rho", "chunk_u", "monitor_force",
             "monitor_maxv"] + \
        (["frame_rel", "render_off"] if record else [])
    checks = [Check(n, worst[n], lim[n]) for n in names]
    checks.append(Check("verdict_mismatch", mismatch, 0))
    return checks
