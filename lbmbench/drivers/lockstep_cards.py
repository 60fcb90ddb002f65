"""Driver of the lockstep dataset run over a case mesh of cards: whole
``run_batch`` groups of several masks with the README's production flags
and ``runner="sharded"`` over the configuration's ``n_devices`` cards,
back to back, until the window has passed.

Set-up makes the group's masks from the seed (mask i from seed + i), one
project a group (the configuration at each viscosity of the group for each
mask, as ``config_batch_gen`` writes them; the files sort mask by mask, so
each card holds one mask's viscosities), and runs one short group of two
chunks through the same entry, which builds and warms every shape the
window uses on every card. The window then runs whole groups, each one
``run_batch`` call with its own set-up and wind-down inside, every card
synchronized after it, and ends with the first group that ends after
``--seconds`` (and not before the group the check samples).

The check follows the program on every card. It takes, from the card that
holds each, the state of the cases it follows before and after two chunks,
and what the program saved from the second: the first chunk of one case of
the first group, drawn from the seed, which the reference runs from its own
rest state; and one chunk drawn from the seed, of one case a card, also
drawn from the seed, which the reference runs from the program's state
before it (f, and the f_post, rho and u that only the closing full step
writes), with that case's saved dataset frame and its card's rendered
video frame of the chunk judged against the reference's. The monitors and
breaker verdicts of that chunk are judged for every case of the group,
from each case's f_post and u after it, read on its card.

It needs the program's per-card parts (``BatchEngine.parts``); a program
without them gives no result, at once.
"""

from __future__ import annotations

import copy
import os
import shutil
import tempfile
import time

import numpy as np

from lbmbench import harness

_BASE = harness.load_module(os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                         "lockstep_dataset.py"),
                            "lbmbench_driver_lockstep_dataset")
read_results, draw_sample = _BASE.read_results, _BASE.draw_sample
STATE = _BASE.STATE


def case_configs(cfgfile, seed, steps, start_record):
    """[(file name, case config, mask index)] of the group: mask by mask,
    one a viscosity, in the order the program's config scan sorts them."""
    out = []
    for m in range(int(cfgfile["group"]["masks"])):
        for nu in cfgfile["group"]["nus"]:
            cfg = copy.deepcopy(cfgfile["case"])
            tag = f"Nu{nu:.4f}".replace(".", "-")
            cfg["simulation"].update(nu=nu, name=f"S{seed}_M{m}_{tag}", max_steps=int(steps))
            cfg["outputs"]["start_record_step"] = int(start_record)
            cfg["outputs"]["video"]["filename"] = f"S{seed}_M{m}_{tag}.mp4"
            cfg["mask"]["path"] = f"mask{m}.png"
            out.append((f"cfg_M{m}_{tag}.yaml", cfg, m))
    return out


def make_project(root, name, pngs, configs):
    import yaml

    base = os.path.join(root, "SimCases", name)
    os.makedirs(os.path.join(base, "configs"))
    os.makedirs(os.path.join(base, "masks"))
    for png in pngs:
        os.link(png, os.path.join(base, "masks", os.path.basename(png)))
    for fname, cfg, _ in configs:
        with open(os.path.join(base, "configs", fname), "w") as fh:
            yaml.safe_dump(cfg, fh, sort_keys=False)


class CardsProbe:
    """Takes the state of the followed cases, each from its own card, at the
    chunks the check samples, every card's render of the sampled chunk, and
    starts and stops the trace, from wrappers around the group engine's
    chunk and the frame renderer."""

    def __init__(self, start_chunk, sample, start_case, follow_seed, trace_span=None):
        self.group = None
        self.engine = None
        self.chunk = 0
        self.start_chunk = start_chunk   # (group, chunk) whose state after it is kept
        self.sample = sample             # (group, chunk) followed by the reference
        self.start_case = start_case     # the case whose start chunk is judged
        self.follow_seed = follow_seed   # draws the followed case of each card
        self.trace_span = trace_span
        self.tracer = None
        self.renders_left = 0
        self.kept = {"render": []}
        self.layout = None               # [(device, case indices)] a part
        self.followed = None             # one case a part

    def begin(self, g):
        self.group, self.engine, self.chunk, self.follow = g, None, 0, False

    def end(self):
        self.group, self.engine, self.renders_left = None, None, 0

    def where(self, engine):
        """{case: (part, row)} of the engine's parts."""
        return {b: (p, r) for p, part in enumerate(engine.parts) for r, b in enumerate(part.idx)}

    def snapshot(self, engine, cases, names):
        """{case: {name: its tensor, cloned on its card}, "step", "alive"}."""
        where, alive = self.where(engine), engine.alive_mask
        out = {}
        for b in cases:
            p, r = where[b]
            st = engine.parts[p].state
            out[b] = {k: getattr(st, k)[r].clone() for k in names}
            out[b]["step"] = int(st.step[r])
            out[b]["alive"] = bool(alive[b])
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
                if first and probe.layout is None:
                    probe.layout = [(str(p.device), list(p.idx)) for p in engine.parts]
                    rng = np.random.default_rng(probe.follow_seed)
                    probe.followed = [idx[int(rng.integers(len(idx)))]
                                      for _, idx in probe.layout]
            probe.chunk += 1
            at = (probe.group, probe.chunk) if probe.follow else None
            span = probe.trace_span
            if span and at == (span[0], span[1]):
                probe.tracer.start()
            if at == probe.sample:
                probe.kept["pre"] = probe.snapshot(engine, probe.followed, STATE)
            out = orig(engine, n, sync)
            if at == probe.start_chunk:
                probe.kept["start"] = probe.snapshot(engine, [probe.start_case], ("f",))
            if at == probe.sample:
                every = range(engine.batch)
                post = probe.snapshot(engine, every, ("f_post", "u"))
                for b, more in probe.snapshot(engine, probe.followed, ("f", "rho")).items():
                    post[b].update(more)
                probe.kept["post"] = post
                packs = out if isinstance(out, list) else [out]
                probe.kept["packed"] = [x.clone() for x in packs]
                probe.renders_left = len(engine.parts)
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
                if probe.renders_left:
                    # the sampled chunk's renders come next, one a part, in
                    # part order
                    probe.renders_left -= 1
                    probe.kept["render"].append(tuple(t.clone() for t in out)
                                                if isinstance(out, tuple) else out.clone())
                return out

            return wrapped

        return make_renderer


def run(run):
    import torch

    from lbm2d_tpu_torch.io import h5_writer
    from lbm2d_tpu_torch.ops import render as render_mod
    from lbm2d_tpu_torch.parallel.batch import BatchEngine
    from lbm2d_tpu_torch.pipeline.batch_run import run_batch

    from lbmbench import masks, memh5, yardstick
    from lbmbench.harness import Outcome
    from lbmbench.trace_cards import CardsTrace

    if not hasattr(BatchEngine, "parts"):
        raise harness.Refused("the program's BatchEngine has no per-card parts "
                              "(BatchEngine.parts), which this driver follows")
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
    on_card = device != "cpu"
    cards = list(range(int(flags["n_devices"]))) if on_card else []

    def sync():
        for d in cards:
            torch.cuda.synchronize(d)

    n_masks = int(cfgfile["group"]["masks"])
    domain, padding = cfgfile["mask"]["domain"], cfgfile["mask"]["padding"]
    mask_list = [masks.urban_mask(run.seed + m, domain, padding) for m in range(n_masks)]
    if mask_list[0].shape != (ny, nx):
        raise ValueError(f"mask {mask_list[0].shape} does not fit the grid ({ny}, {nx})")
    configs = case_configs(cfgfile, run.seed, steps, start_record)
    work = tempfile.mkdtemp(prefix="lbmbench-")
    patched = memh5.install(h5_writer)
    try:
        import cv2

        pngs = []
        for m, mask in enumerate(mask_list):
            pngs.append(os.path.join(work, f"mask{m}.png"))
            cv2.imwrite(pngs[-1], np.where(mask > 0.5, 0, 255).astype(np.uint8))
        sample = draw_sample(run.seed, wl, chunks, first_record)
        start_case = int(np.random.default_rng(run.seed + 1).integers(len(configs)))
        span = None
        if run.trace:
            span = (sample[0], int(wl["trace_chunks"][0]), int(wl["trace_chunks"][1]))
        probe = CardsProbe((0, 1), sample, start_case, run.seed + 2, span)
        probe.tracer = CardsTrace(cards) if run.trace and on_card else None
        patched.append((BatchEngine, "run_step", BatchEngine.run_step))
        patched.append((render_mod, "make_device_frame_renderer",
                        render_mod.make_device_frame_renderer))
        BatchEngine.run_step = probe.wrap_run_step(BatchEngine.run_step)
        render_mod.make_device_frame_renderer = probe.wrap_renderer(
            render_mod.make_device_frame_renderer)

        def group(name, n_steps, record_from):
            make_project(work, name, pngs, case_configs(cfgfile, run.seed, n_steps, record_from))
            t0 = time.perf_counter()
            run_batch(name, root=work, progress=False, device=device, **flags)
            sync()
            return time.perf_counter() - t0

        # warm-up: two chunks through the same entry on every card, saving
        # where the cell saves
        group("warm", 2 * chunk, chunk if wl["record"] else 3 * chunk)
        memh5.MemH5File.FILES.clear()
        for d in cards:
            torch.cuda.reset_peak_memory_stats(d)
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
                for b in probe.followed:
                    cname = configs[b][1]["simulation"]["name"]
                    f = memh5.MemH5File.FILES[os.path.join(prefix, cname + ".h5")]
                    frames[b] = f.datasets["turbulence"].a[sample[1] - first_record].copy()
            for path in [p for p in memh5.MemH5File.FILES if p.startswith(prefix)]:
                del memh5.MemH5File.FILES[path]
            g += 1
            elapsed = time.perf_counter() - t_start
            if elapsed >= run.seconds and g > sample[0]:
                break
        window_s = elapsed
        peak = max((torch.cuda.max_memory_allocated(d) for d in cards), default=0)
        cells = nx * ny
        updates = sum(x["success"] * x["steps"] for x in groups) * cells
        record = {"kind": "cards", "groups": groups, "window_s": window_s,
                  "device_kind": torch.cuda.get_device_name(0) if on_card else "cpu"}
        trace = None
        if probe.tracer is not None and probe.tracer.done:
            trace = probe.tracer.reduce()
            n_traced = span[2] - span[1] + 1
            dev = cfgfile["storage"] == "bf16_deviation"
            links = [yardstick.solid_links(m) for m in mask_list]
            per_card = {}
            for d, idx in probe.layout:
                case_bytes = sum(yardstick.chunk_bytes(cells, chunk, links[configs[b][2]], dev=dev)
                                 for b in idx)
                per_card[torch.device(d).index] = n_traced * case_bytes
            record["trace_lattice_bytes_cards"] = per_card
        for d in cards:
            with torch.cuda.device(d):
                torch.cuda.empty_cache()
        args = (probe, frames, cfgfile, configs, mask_list, wl["record"], device)
        t_ref = time.perf_counter()
        checks = judge(*args)
        run.log(f"[lbmbench] window {window_s:.2f} s, {len(groups)} group(s) of "
                f"{len(configs)} cases on {len(probe.layout)} part(s); "
                f"check {time.perf_counter() - t_ref:.1f} s")
        notes = {"control": judge(*args, control=True)} if wl.get("control") else {}
        return Outcome(setup_s=setup_s, e2e={"dataset_mlups": updates / window_s / 1e6},
                       attempted=len(statuses), failed=len(statuses) - sum(statuses),
                       record=record, checks=checks, memory_peak_bytes=peak, trace=trace,
                       notes=notes)
    finally:
        for owner, attr, orig in patched:
            setattr(owner, attr, orig)
        memh5.MemH5File.FILES.clear()
        shutil.rmtree(work, ignore_errors=True)


def judge(probe, frames, cfgfile, configs, mask_list, record, device, control=False):
    """The check's numbers against the configuration's limits, from what the
    probe kept (``lockstep_dataset.judge``'s numbers, over every card).

    ``control`` puts the reference in the program's place at the precision
    below the one the configuration states, as there: it has to come out
    not correct."""
    import torch

    from lbmbench.harness import Check
    from lbmbench.reference import frames as rframes
    from lbmbench.reference import lbm

    kept, lim = probe.kept, cfgfile["limits"]
    f64, f32, fp8 = torch.float64, torch.float32, torch.float8_e4m3fn
    chunk = int(cfgfile["case"]["simulation"]["compute_step_size"])
    worst = {k: 0.0 for k in ("start_f", "chunk_f", "chunk_f_post", "chunk_rho", "chunk_u",
                              "monitor_force", "monitor_maxv", "frame_rel", "render_off")}
    mismatch = 0
    packs = [x.double().cpu().numpy() for x in kept["packed"]]
    where = {b: (p, r) for p, (_, idx) in enumerate(probe.layout) for r, b in enumerate(idx)}
    pre, post = kept["pre"], kept["post"]
    for b, (_, cfg, m) in enumerate(configs):
        on = post[b]["f_post"].device if device != "cpu" else "cpu"
        case = lbm.make_case(cfg, mask_list[m], device=on, dtype=f32)
        if b == probe.start_case:
            rest = lbm.rest_state(*mask_list[m].shape, device=on, dtype=f32)
            ref = lbm.chunk(rest, 0, chunk, case)
            got = kept["start"][b]["f"] if not control else lbm.chunk(
                rest, 0, chunk, case, store=fp8)["f"]
            worst["start_f"] = float((got - ref["f"]).abs().max())
            del ref, got, rest
        if not post[b]["alive"]:
            continue  # dead before the chunk: frozen, no verdict to judge
        p, r = where[b]
        followed = b in pre
        if followed:
            # the sampled chunk of this card's followed case, from the
            # program's state before it
            state = {k: pre[b][k].clone() for k in STATE}
            ref = lbm.chunk(state, pre[b]["step"], chunk, case)
            got = {k: post[b][k] for k in STATE} if not control else lbm.chunk(
                state, pre[b]["step"], chunk, case, store=fp8)
            for k in STATE:
                worst["chunk_" + k] = max(worst["chunk_" + k],
                                          float((got[k] - ref[k]).abs().max()))
            del ref, got, state
        # monitors and verdict of every case after the chunk
        step = post[b]["step"]
        f_post, u = post[b]["f_post"].to(f64), post[b]["u"].to(f64)
        force = lbm.force_equilibrium(f_post, case.solid)
        speed = lbm.max_speed(u)
        if control:
            bf = torch.bfloat16
            p_force = lbm.force_equilibrium(f_post.to(bf), case.solid).double()
            p_speed = float(lbm.max_speed(u.to(bf)))
            p_stable = lbm.stable(p_force.tolist(), p_speed, step, case.warmup)
        else:
            packed, n_p = packs[p], len(probe.layout[p][1])
            p_force = torch.as_tensor(packed[2 * r:2 * r + 2], device=on)
            p_speed = float(packed[2 * n_p + r])
            p_stable = bool(packed[3 * n_p + r] > 0.5)
        worst["monitor_force"] = max(worst["monitor_force"], float(
            (p_force - force).abs().max() / max(1.0, float(force.abs().max()))))
        worst["monitor_maxv"] = max(worst["monitor_maxv"],
                                    abs(p_speed - float(speed)) / max(float(speed), 1e-30))
        mismatch += int(p_stable != lbm.stable(force.tolist(), float(speed), step, case.warmup))
        if record and followed:
            ref_frame = rframes.dataset_frame(f_post, cfg)
            got = rframes.dataset_frame(f_post, cfg, store=fp8) if control else torch.as_tensor(
                frames[b], device=on).to(f64)
            worst["frame_rel"] = max(worst["frame_rel"], float(
                (got - ref_frame).abs().max() / ref_frame.abs().max()))
            y, uv = rframes.video_frame(u, case.solid, cfg)
            if control:
                gy, guv = rframes.video_frame(u, case.solid, cfg, dtype=torch.bfloat16)
            else:
                gy, guv = kept["render"][p][0][r], kept["render"][p][1][r]
            diff = torch.cat([(gy.int().to(on) - y.int()).abs().flatten(),
                              (guv.int().to(on) - uv.int()).abs().flatten()])
            worst["render_off"] = max(worst["render_off"], float((diff > 1).double().mean()))
        del f_post, u
    names = ["start_f", "chunk_f", "chunk_f_post", "chunk_rho", "chunk_u", "monitor_force",
             "monitor_maxv"] + (["frame_rel", "render_off"] if record else [])
    checks = [Check(n, worst[n], lim[n]) for n in names]
    checks.append(Check("verdict_mismatch", mismatch, 0))
    return checks
