"""Driver of the DFG-2D validation: whole ``run_validation`` runs of the
configured benchmark case, back to back, until the window has passed.

Set-up runs one short validation (a few chunks) that builds and warms every
shape and the coefficients' fit. The window runs whole validations and ends
with the first that ends after ``--seconds`` (and not before the run the
check samples).

The check: every run's coefficients within the published ranges; the first
chunk of the first run against the reference's own rest state (the start:
the Bouzidi fractions, the profiled NEBB inlet, the no-slip walls, the
ramp); one chunk drawn from the seed against the reference run from the
program's state before it (f, and the f_post, rho and u that the closing
full step writes); the cylinder force the program recorded for
that chunk against the reference's force of the program's state after it;
and the sampled run's coefficients worked out again from the force series
the program recorded and its final inlet velocity.
"""

from __future__ import annotations

import time

import numpy as np


class Probe:
    """Keeps the program's state around the sampled chunks and the cylinder
    force of every chunk of the sampled run, from wrappers around the
    serial engine's chunk and the cylinder-force call."""

    def __init__(self, sample, trace_span=None):
        self.run_no = None
        self.chunk = 0
        self.sample = sample            # (run, chunk)
        self.trace_span = trace_span    # (run, first chunk, last chunk)
        self.tracer = None
        self.kept = {"forces": []}
        self.last_engine = None

    def begin(self, r):
        self.run_no, self.chunk = r, 0

    def end(self):
        if self.last_engine is not None:
            # the sampled run's final state, taken once the run has ended
            self.kept["last"] = _state(self.last_engine)
        self.run_no, self.last_engine = None, None

    def wrap_run_step(self, orig):
        probe = self

        def run_step(engine, steps=1):
            if probe.run_no is None:
                return orig(engine, steps)
            probe.chunk += 1
            at = (probe.run_no, probe.chunk)
            span = probe.trace_span
            if span and at == (span[0], span[1]):
                probe.tracer.start()
            if at == probe.sample:
                probe.kept["pre"] = _state(engine)
            out = orig(engine, steps)
            if at == (0, 1):
                probe.kept["start"] = _state(engine)
            if at == probe.sample:
                probe.kept["post"] = _state(engine)
            if probe.run_no == probe.sample[0]:
                probe.last_engine = engine
            if span and at == (span[0], span[2]):
                probe.tracer.stop()
            return out

        return run_step

    def wrap_force(self, orig):
        probe = self

        def case_force(*a, **kw):
            out = orig(*a, **kw)
            if probe.run_no == probe.sample[0]:
                probe.kept["forces"].append(out)
            return out

        return case_force


def _state(engine):
    """Copies of the engine's state: the engine may write the next chunk
    into the same tensors."""
    st = engine.state
    return {"f": st.f.clone(), "f_post": st.f_post.clone(), "rho": st.rho.clone(),
            "u": st.u.clone(), "step": int(st.step)}


def validation_args(cfgfile, steps=None):
    args = dict(cfgfile["validation"])
    if steps is not None:
        args["steps"] = steps
    return args


def run(run):
    import torch

    from lbm2d_tpu_torch.analysis import dfg_validation
    from lbm2d_tpu_torch.core.engine import LBMEngine
    from lbm2d_tpu_torch.ops import cuda_step

    from lbmbench import yardstick
    from lbmbench.harness import Outcome
    from lbmbench.trace import DeviceTrace

    cfgfile, wl = run.config, run.workload
    args = validation_args(cfgfile)
    chunk = int(args["chunk"])
    chunks = int(args["steps"]) // chunk
    rng = np.random.default_rng(run.seed)
    sample = (int(rng.integers(0, int(wl["sample_runs"]))), int(rng.integers(2, chunks + 1)))
    span = (sample[0], *wl["trace_chunks"]) if run.trace else None
    probe = Probe(sample, span)
    probe.tracer = DeviceTrace() if run.trace else None
    # the cylinder force is one monitor-kernel call a chunk on the card and
    # the eager force on the CPU; both are kept
    patched = [(LBMEngine, "run_step", LBMEngine.run_step),
               (cuda_step, "case_force", cuda_step.case_force),
               (dfg_validation, "obstacle_force", dfg_validation.obstacle_force)]
    LBMEngine.run_step = probe.wrap_run_step(LBMEngine.run_step)
    cuda_step.case_force = probe.wrap_force(cuda_step.case_force)
    dfg_validation.obstacle_force = probe.wrap_force(dfg_validation.obstacle_force)
    try:
        dfg_validation.run_validation(progress=False, device=run.device,
                                      **validation_args(cfgfile, wl["warm_steps"]))
        if run.device != "cpu":
            torch.cuda.synchronize()
            torch.cuda.reset_peak_memory_stats()
        setup_s = run.since_start()
        results = []
        t_start = time.perf_counter()
        r = 0
        while True:
            probe.begin(r)
            res = dfg_validation.run_validation(progress=False, device=run.device, **args)
            if run.device != "cpu":
                torch.cuda.synchronize()
            probe.end()
            results.append(res)
            r += 1
            elapsed = time.perf_counter() - t_start
            if elapsed >= run.seconds and r > sample[0]:
                break
        peak = torch.cuda.max_memory_allocated() if run.device != "cpu" else 0
    finally:
        for owner, attr, orig in patched:
            setattr(owner, attr, orig)
    kind = torch.cuda.get_device_name(0) if run.device != "cpu" else "cpu"
    record = {"kind": "dfg", "runs": len(results), "window_s": elapsed, "device_kind": kind}
    trace = None
    if probe.tracer is not None and probe.tracer.done:
        trace = probe.tracer.reduce()
        from lbmbench.reference import lbm

        cfg, mask = case_of(cfgfile)
        case = lbm.make_case(cfg, mask)
        solid = case.solid.numpy()
        links = yardstick.fluid_links(solid)
        cells = solid.size
        n = span[2] - span[1] + 1
        record["trace_lattice_bytes"] = n * yardstick.chunk_bytes(
            cells, chunk, links, bouzidi=True, force_links=links)
    t_ref = time.perf_counter()
    checks = judge(probe.kept, results, sample, cfgfile, run.device)
    run.log(f"[lbmbench] window {elapsed:.2f} s, {len(results)} run(s); "
            f"check {time.perf_counter() - t_ref:.1f} s")
    notes = {"control": judge(probe.kept, results, sample, cfgfile, run.device, control=True)} \
        if wl.get("control") else {}
    ranges_ok = [in_ranges(x, cfgfile["published_ranges"]) for x in results]
    return Outcome(setup_s=setup_s, e2e={"dfg_solve_s": elapsed / len(results)},
                   attempted=len(results), failed=len(results) - sum(ranges_ok),
                   record=record, checks=checks, memory_peak_bytes=peak, trace=trace,
                   notes=notes)


def case_of(cfgfile):
    """(configuration dict, mask) of the DFG-2D case the validation runs,
    built from the benchmark's own definition: a channel of 2.2 x 0.41
    units on ny rows, a cylinder of diameter 0.1 centred at (0.2, 0.2)."""
    v = cfgfile["validation"]
    ny = int(v["ny"])
    scale = (ny - 1) / 0.41
    nx = int(round(2.2 * scale)) + 1
    d = int(round(0.1 * scale))
    c = int(round(0.2 * scale))
    u_max = float(v["u_target"])
    nu = (2.0 / 3.0) * u_max * d / float(v["re"])
    yy, xx = np.mgrid[0:ny, 0:nx]
    mask = (((xx - c) ** 2 + (yy - c) ** 2) <= (d / 2.0) ** 2).astype(np.float32)
    cfg = {
        "simulation": {"nx": nx, "ny": ny, "nu": nu, "ghost_moments_s": 1.2,
                       "rho_in": 1.0, "rho_out": 1.0, "smagorinsky_constant": 0.0,
                       "warmup_steps": 8000, "characteristic_length": d},
        "boundary_condition": {"type": [4, 0, 1, 0], "value": [[u_max, 0.0]] + [[0.0, 0.0]] * 3,
                               "obstacle": "bounce_back_bouzidi",
                               "obstacle_geometry": {"shape": "cylinder", "cx": float(c),
                                                     "cy": float(c), "r": d / 2.0}},
        "domain_zones": {"sponge_in": 1, "sponge_out": 1, "sponge_top": 1, "sponge_bot": 1,
                         "sponge_strength": 0.0},
    }
    return cfg, mask


def in_ranges(res, ranges) -> bool:
    return all(lo <= res.get(k, float("nan")) <= hi for k, (lo, hi) in ranges.items())


def coefficients(fx, fy, u_in, cfg, chunk):
    """(cd_mean, cl_amplitude, strouhal, re_measured) of a force series, by
    the definitions: over the second half, Cd and Cl over 0.5 U_mean^2 D
    with U_mean = 2/3 u_max; the Strouhal number at the largest peak of the
    Hann-windowed spectrum of the lift's last quarter (at least 16
    samples) with a quadratic trend removed; Re from the mean inlet speed."""
    d = float(cfg["simulation"]["characteristic_length"])
    u_max = float(cfg["boundary_condition"]["value"][0][0])
    u_mean = 2.0 / 3.0 * u_max
    half = len(fx) // 2
    denom = 0.5 * u_mean * u_mean * d
    cd = float(np.mean(fx[half:] / denom))
    cl = fy[half:] / denom
    amp = float((cl.max() - cl.min()) / 2)
    tail = fy[-max(16, len(fy) // 4):]
    t = np.arange(len(tail), dtype=float)
    osc = tail - np.polyval(np.polyfit(t, tail, 2), t)
    spec = np.abs(np.fft.rfft(osc * np.hanning(len(osc))))
    freqs = np.fft.rfftfreq(len(osc), d=chunk)
    st = float(freqs[1 + int(np.argmax(spec[1:]))] * d / u_mean)
    return cd, amp, st, u_in * d / float(cfg["simulation"]["nu"])


def judge(kept, results, sample, cfgfile, device, control=False):
    import torch

    from lbmbench.harness import Check
    from lbmbench.reference import lbm

    lim = cfgfile["limits"]
    chunk = int(cfgfile["validation"]["chunk"])
    cfg, mask = case_of(cfgfile)
    f64 = torch.float64
    low = torch.bfloat16
    case = lbm.make_case(cfg, mask, device=device)
    cyl = case.solid
    checks = []
    # the start, from the reference's own rest state
    rest = lbm.rest_state(*mask.shape, device=device)
    ref = lbm.chunk(rest, 0, chunk, case)
    if control:
        lcase = lbm.make_case(cfg, mask, device=device, dtype=low)
        got = lbm.chunk(lbm.rest_state(*mask.shape, device=device, dtype=low), 0, chunk, lcase)["f"]
    else:
        got = kept["start"]["f"]
    checks.append(Check("start_f", float((got.to(f64) - ref["f"]).abs().max()), lim["start_f"]))
    # the sampled chunk, from the program's state before it
    pre, post = kept["pre"], kept["post"]
    names = ("f", "f_post", "rho", "u")
    state = {k: pre[k].to(f64) for k in names}
    ref = lbm.chunk(state, pre["step"], chunk, case)
    if control:
        got = lbm.chunk({k: v.to(low) for k, v in state.items()}, pre["step"], chunk, lcase)
    else:
        got = post
    # f, and what only the chunk's closing full step writes: f_post, rho, u
    for k in names:
        checks.append(Check("chunk_" + k, float((got[k].to(f64) - ref[k]).abs().max()),
                            lim["chunk_" + k]))
    # the cylinder force of the program's state after the chunk
    f_post = post["f_post"].to(f64)
    force = lbm.force_bouzidi(f_post, cyl, case.bouzidi_q)
    if control:
        got = lbm.force_bouzidi(f_post.to(low), cyl, case.bouzidi_q.to(low)).to(f64)
    else:
        got = kept["forces"][sample[1] - 1].to(f64).reshape(2)
    # the gap in units of the coefficients, 0.5 U_mean^2 D: early in a run
    # the force is a small difference of large sums
    u_mean = 2.0 / 3.0 * float(cfg["boundary_condition"]["value"][0][0])
    unit = 0.5 * u_mean * u_mean * float(cfg["simulation"]["characteristic_length"])
    checks.append(Check("force_coeff", float((got - force).abs().max()) / unit,
                        lim["force_coeff"]))
    # the sampled run's coefficients from the force series it recorded
    series = torch.stack([x.reshape(2) for x in kept["forces"]]).double().cpu().numpy()
    u_in = float(kept["last"]["u"][0, 1:-1, 1].double().mean())
    ref_c = coefficients(series[:, 0], series[:, 1], u_in, cfg, chunk)
    if control:
        low_series = torch.as_tensor(series).to(low).double().numpy()
        got_c = coefficients(low_series[:, 0], low_series[:, 1], u_in, cfg, chunk)
    else:
        res = results[sample[0]]
        got_c = tuple(res.get(k, float("nan"))
                      for k in ("cd_mean", "cl_amplitude", "strouhal", "re_measured"))
    gap = max(abs(g - r) / max(abs(r), 1e-30) if g == g else float("inf")
              for g, r in zip(got_c, ref_c))
    checks.append(Check("coeff_rel", gap, lim["coeff_rel"]))
    # every run's coefficients against the published ranges
    for key, (lo, hi) in cfgfile["published_ranges"].items():
        vals = [x.get(key, float("nan")) for x in results]
        worst = max(vals, key=lambda v: max(lo - v, v - hi) if v == v else float("inf"))
        checks.append(Check(key, float(worst), [lo, hi]))
    return checks

