"""The drivers end to end at a tiny size on the CPU: a sound run comes out
correct, and a run with the timed path broken underneath comes out not
correct, once for each fault a cell can have: a chunk that returns its
state unchanged, half of the group left out, and an answer altered where it
is produced (a saved frame, a video frame, the cylinder force, an output
that only the chunk's closing full step writes)."""

import contextlib

import pytest
import torch

from lbmbench.tests import tiny


def correct(out):
    return bool(out.checks) and all(c.ok for c in out.checks)


@contextlib.contextmanager
def patched(owner, name, wrap):
    orig = getattr(owner, name)
    setattr(owner, name, wrap(orig))
    try:
        yield
    finally:
        setattr(owner, name, orig)


def group_fault(kind):
    """A fault in the group's chunk: its state left as it was, or the
    second half of its cases left out."""
    from lbm2d_tpu_torch.parallel.batch import BatchEngine

    def wrap(orig):
        def run_group(self, g, n):
            before = {k: getattr(g.state, k).clone() for k in ("f", "f_post", "rho", "u")}
            out = orig(self, g, n)
            keep = slice(None) if kind == "unchanged" else slice(len(g.idx) // 2, None)
            for k, v in before.items():
                getattr(g.state, k)[keep] = v[keep]
            return out
        return run_group

    return patched(BatchEngine, "_run_group", wrap)


def full_step_fault(field):
    """An output of the group chunk's closing full step (f_post, rho or u)
    off by 0.01 where it is written."""
    from lbm2d_tpu_torch.parallel.batch import BatchEngine

    def wrap(orig):
        def run_group(self, g, n):
            out = orig(self, g, n)
            getattr(g.state, field).add_(0.01)
            return out
        return run_group

    return patched(BatchEngine, "_run_group", wrap)


def check(out, name):
    (c,) = [c for c in out.checks if c.name == name]
    return c


def resize_fault():
    from lbm2d_tpu_torch.ops import resize

    def wrap(make):
        def make_resizer(*a, **kw):
            fn = make(*a, **kw)
            return lambda x: fn(x) * 1.01
        return make_resizer

    return patched(resize, "make_device_resizer", wrap)


def render_fault():
    from lbm2d_tpu_torch.ops import render

    def wrap(make):
        def make_renderer(*a, **kw):
            fn = make(*a, **kw)

            def altered(u, mask):
                y, uv = fn(u, mask)
                return torch.clamp(y.int() + 3, 0, 255).to(torch.uint8), uv
            return altered
        return make_renderer

    return patched(render, "make_device_frame_renderer", wrap)


@pytest.mark.parametrize("record", [True, False], ids=["prod", "norecord"])
def test_lockstep_sound_run_is_correct(record):
    cfg, wl = tiny.urban(record)
    out = tiny.run("lockstep_dataset", cfg, wl)
    assert correct(out), [(c.name, c.value, c.limit) for c in out.checks]
    assert out.attempted == 5 and out.failed == 0
    assert out.e2e["dataset_mlups"] > 0 and out.setup_s > 0
    g = out.record["groups"][0]
    assert g["program_wall_s"] is not None and g["harness_wall_s"] >= g["program_wall_s"]


@pytest.mark.parametrize("fault", ["unchanged", "half", "frame", "render"])
def test_lockstep_fault_is_not_correct(fault):
    cfg, wl = tiny.urban(record=True)
    ctx = {"unchanged": lambda: group_fault("unchanged"), "half": lambda: group_fault("half"),
           "frame": resize_fault, "render": render_fault}[fault]()
    with ctx:
        out = tiny.run("lockstep_dataset", cfg, wl)
    assert not correct(out)


@pytest.mark.parametrize("field", ["f_post", "rho", "u"])
def test_lockstep_full_step_fault_is_not_correct(field):
    cfg, wl = tiny.urban(record=True)
    with full_step_fault(field):
        out = tiny.run("lockstep_dataset", cfg, wl)
    assert not check(out, "chunk_" + field).ok


def dfg_fault(kind):
    from lbm2d_tpu_torch.analysis import dfg_validation
    from lbm2d_tpu_torch.core.engine import LBMEngine

    if kind == "unchanged":
        def wrap(orig):
            def run_step(self, steps=1):
                before = self._state
                orig(self, steps)
                self._state = before
            return run_step
        return patched(LBMEngine, "run_step", wrap)

    if kind in ("f_post", "rho", "u"):
        # an output of the chunk's closing full step off where it is written
        def wrap(orig):
            def run_step(self, steps=1):
                orig(self, steps)
                getattr(self._state, kind).add_(0.01)
            return run_step
        return patched(LBMEngine, "run_step", wrap)

    def wrap_force(orig):
        return lambda *a, **kw: orig(*a, **kw) + 0.01
    return patched(dfg_validation, "obstacle_force", wrap_force)


def test_dfg_sound_run_is_correct():
    cfg, wl = tiny.dfg()
    out = tiny.run("dfg_validation", cfg, wl)
    assert correct(out), [(c.name, c.value, c.limit) for c in out.checks]
    assert out.attempted == 1 and out.e2e["dfg_solve_s"] > 0


@pytest.mark.parametrize("fault", ["unchanged", "force"])
def test_dfg_fault_is_not_correct(fault):
    cfg, wl = tiny.dfg()
    with dfg_fault(fault):
        out = tiny.run("dfg_validation", cfg, wl)
    assert not correct(out)


@pytest.mark.parametrize("field", ["f_post", "rho", "u"])
def test_dfg_full_step_fault_is_not_correct(field):
    cfg, wl = tiny.dfg()
    with dfg_fault(field):
        out = tiny.run("dfg_validation", cfg, wl)
    assert not check(out, "chunk_" + field).ok
