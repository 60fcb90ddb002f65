"""Shared checks of the port's chunk monitors (torch only, so the card's
``-m cuda`` runs import it without JAX).

A chunk runner's force is the monitor kernel's f64 sum in its fixed order
(``cuda_step.monitor_sum_plain``), not the eager step's f32 sums, so it is
held bitwise to the plain monitors on the same f_post and within
``FORCE_TOL`` of max(1, |F|) of the eager force taken in float64; max |u|
is the same reduction of the same products, bitwise the eager one.
"""

import dataclasses

import torch

from lbm2d_tpu_torch.core import solver as ts
from lbm2d_tpu_torch.ops import cuda_step as cs

# the port-vs-JAX force tolerance (PERF.md §6), relative to max(1, |F|)
FORCE_TOL = 5e-6


def eager_force64(f_post: torch.Tensor, p, mask=None) -> torch.Tensor:
    """The eager ``obstacle_force`` in float64 on the same f_post."""
    q = None if p.bouzidi_q is None else p.bouzidi_q.double()
    return ts.obstacle_force(f_post.double(), dataclasses.replace(p, bouzidi_q=q), mask=mask)


def force_err(force: torch.Tensor, ref64: torch.Tensor) -> float:
    """|force - ref| / max(1, |ref|), the force tolerance's measure."""
    ref64 = ref64.cpu().double()
    return float((force.cpu().double() - ref64).abs().max()) / max(1.0, float(ref64.abs().max()))


def assert_runner_monitors(m, state, p, eager=None) -> None:
    """A chunk runner's monitors ``m`` of ``state``: the force bitwise
    ``case_monitors_plain`` on its f_post and within ``FORCE_TOL`` of the
    eager force in float64; max_v bitwise the eager ``max_velocity`` (or
    ``eager``'s, the eager runner's monitors of the same state)."""
    plain = cs.case_monitors_plain(state.f_post, state.u, cs.case_links(p))
    assert torch.equal(m["force"], plain["force"])
    assert force_err(m["force"], eager_force64(state.f_post, p)) <= FORCE_TOL
    max_v = ts.max_velocity(state.u) if eager is None else eager["max_v"]
    assert torch.equal(m["max_v"], max_v)
