"""A sharded case on a 2x2 mesh over four cards of one host: the layout
``--spatial_mesh 2x2`` gets from the engine on such a host (block i on
cuda:i, ``engine.make_spatial_mesh``), through the library loop
(``cuda_step.k1_shard_steps`` / ``k1_shard_full``: each block's K1 on its
card's stream, pushing its edge cells into the neighbours' halos over peer
access, each card's step after its neighbours' previous one, two events a
card; ``csrc/halo.cuh``) and through the per-step loop (the "stepwise" runner: a K1 call a block and the strided
halo copies of ``exchange_halos``, issued from Python each step), in turns.

Run from the repository root on a host with four NVIDIA GPUs joined by
peer access:

    python3 -m lbm2d_tpu_torch.tools.mesh_cards [--chunks 5] [--one_card]

For each case -- the demo cylinder at 4096^2 (50-step chunks) and the
production-shaped smoke case at 2432x1152 (100-step chunks):

- a check: one chunk from a seeded random state through both loops, f,
  f_post, rho, u, force and max_v bitwise, the library loop's launches one
  K1 a block a step and nothing else; any difference raises and the
  process exits non-zero;
- four turns (per-step, library, library, per-step) of ``--chunks`` chunks
  on the resident blocks: us/step from the wall clock between syncs of
  every card, and the host's issue us/step (the time to return from the
  chunks' calls: once a card's launch queue fills, the host waits on it);
- one chunk of each loop issued from idle cards, the host's issue us/step;
- one block's K1 step on card 0 in a CUDA graph (the floor of a step),
  and one fast step of the four cards through the library loop (K1 and its
  pushes) and through the per-step loop (K1 and the copies of the halo
  refresh), and the copies alone, wall time between syncs.

Prints one line a case, then the cards' name and power limit.
"""

from __future__ import annotations

import argparse
import json
import sys
import time

import torch

from ..core import solver
from ..core.engine import make_spatial_mesh
from ..core.lattice import f_eq
from ..ops import cuda_step as cs
from ..parallel import sharded as sh
from ..parallel.topology import make_mesh
from .cuda_timing import card_line, graph_ms
from .demo_case import cylinder_mask, demo_config
from .smoke_case import load_smoke_case

CHECK_STEPS = 12
SEED = 0


def _sync_all():
    for d in range(torch.cuda.device_count()):
        torch.cuda.synchronize(d)


def _wall_us(fn, steps: int):
    """(wall us/step between syncs of every card, host us/step to return)."""
    _sync_all()
    t0 = time.perf_counter()
    fn()
    issue = time.perf_counter() - t0
    _sync_all()
    return (time.perf_counter() - t0) * 1e6 / steps, issue * 1e6 / steps


def _same(tag, a, b, ma, mb):
    for k in ("f", "f_post", "rho", "u"):
        if not torch.equal(getattr(a, k).cpu(), getattr(b, k).cpu()):
            raise AssertionError(f"{tag}: {k} differs between the library and per-step loops")
    for k in ("force", "max_v"):
        if not torch.equal(ma[k].cpu(), mb[k].cpu()):
            raise AssertionError(f"{tag}: {k} differs between the library and per-step loops")


def run_case(tag: str, p: solver.CaseParams, chunk: int, n_chunks: int,
             one_card: bool = False) -> dict:
    H, W = p.shape
    if one_card:
        mesh = make_mesh((2, 2), [torch.device("cuda", 0)] * 4)
    else:
        mesh = make_spatial_mesh((2, 2), torch.device("cuda"), (H, W))
    case = sh.ShardedCase(p, mesh)
    if case.tables is None:
        raise RuntimeError(f"{tag}: the mesh takes the per-step loop: "
                           f"{sh.shard_loop_refusal(mesh)}")
    runners = {k: sh.BlockRunner(mesh, k, False, case) for k in ("cuda", "stepwise")}
    # the check, from a seeded random state whose cells all differ
    gen = torch.Generator(device="cuda:0").manual_seed(SEED)
    rho = 1.0 + 1e-3 * torch.randn((H, W), generator=gen, device="cuda:0")
    u = 0.02 * torch.randn((2, H, W), generator=gen, device="cuda:0")
    f = f_eq(rho, u[0], u[1])
    s_r = solver.LBMState(f=f, f_post=f.clone(), rho=rho, u=u, step=0)
    out = {}
    for kind, r in runners.items():
        cs.reset_launch_counts()
        bs = r.place(s_r, p)
        mon = r.advance(bs, p, CHECK_STEPS)
        _sync_all()
        out[kind] = (bs.snapshot(), mon, dict(cs.LAUNCHES))
    (a, ma, la), (b, mb, _) = out["cuda"], out["stepwise"]
    _same(f"{tag} check", a, b, ma, mb)
    obst = case.obstacle
    want = {cs.k1_variant(obst, shard=True): 4 * (CHECK_STEPS - 1),
            cs.k1_variant(obst, full=True, shard=True): 4}
    got = {k: v for k, v in la.items() if v}
    if got != want:
        raise AssertionError(f"{tag}: library loop launches {got}, want {want}")
    del a, b, s_r, f, rho, u, out
    # the turns, on resident blocks from rest
    bs = runners["cuda"].place(solver.init_state(H, W, device="cuda:0"), p)
    for r in runners.values():
        r.advance(bs, p, chunk)  # warm-up
    turns = {"cuda": [], "stepwise": []}
    steps = chunk * n_chunks
    for kind in ("stepwise", "cuda", "cuda", "stepwise"):
        r = runners[kind]

        def chunks(r=r):
            for _ in range(n_chunks):
                r.advance(bs, p, chunk)

        turns[kind].append(_wall_us(chunks, steps))
    idle = {k: _wall_us(lambda r=r: r.advance(bs, p, chunk), chunk)[1]
            for k, r in runners.items()}
    if not torch.isfinite(bs.gather("f")).all():
        raise AssertionError(f"{tag}: non-finite state")
    # one block's K1 on card 0; one step of the four cards in each loop,
    # and the per-step loop's halo copies alone
    row = cs.scalar_row(p, bs.step + 1)
    g00 = case.geoms[0][0]
    k1_ms = graph_ms(lambda: cs.k1_step(bs.f[0][0], bs.f_alt[0][0], case.aux[0][0], row,
                                        p.use_les, p.bc_type, obstacle=obst,
                                        q=None if case.q is None else case.q[0][0],
                                        prof=None if case.prof is None else case.prof[0][0],
                                        geom=g00), per_graph=10)
    reps = 50

    rows = row.reshape(1, -1).contiguous()

    def library_steps():
        for _ in range(reps):
            cs.k1_shard_steps(bs.f, bs.f_alt, bs.f, case.tables, rows, p.use_les, p.bc_type,
                              obst)

    def per_steps():
        for _ in range(reps):
            sh.fast_step(bs.f, bs.f_alt, case, row, False)

    def copies():
        for _ in range(reps):
            sh.exchange_halos(bs.f, mesh, case.hl, case.wl)

    lib_us = min(_wall_us(library_steps, reps)[0] for _ in range(3))
    per_us = min(_wall_us(per_steps, reps)[0] for _ in range(3))
    copy_us = min(_wall_us(copies, reps)[0] for _ in range(3))
    line = {
        "case": tag, "grid": [H, W],
        "mesh": "2x2 on cuda:0" if one_card else "2x2 over cuda:0-3", "chunk": chunk,
        "library_us_step": [t[0] for t in turns["cuda"]],
        "library_issue_us_step": [t[1] for t in turns["cuda"]],
        "per_step_us_step": [t[0] for t in turns["stepwise"]],
        "per_step_issue_us_step": [t[1] for t in turns["stepwise"]],
        "idle_issue_us_step": {"library": idle["cuda"], "per_step": idle["stepwise"]},
        "block_k1_us": k1_ms * 1e3, "library_step_us": lib_us, "per_step_step_us": per_us,
        "exchange_halos_us": copy_us,
        "check": f"{CHECK_STEPS} steps bitwise, launches {want}",
    }
    print(json.dumps(line), flush=True)
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--chunks", type=int, default=5, help="chunks a turn")
    ap.add_argument("--one_card", action="store_true",
                    help="the same 2x2 mesh with every block on cuda:0 (a quick check "
                    "of this tool on one card)")
    args = ap.parse_args(argv)
    if not args.one_card and torch.cuda.device_count() < 4:
        print(f"needs four CUDA devices, found {torch.cuda.device_count()}", file=sys.stderr)
        return 1
    n = 4096
    demo = solver.make_params(demo_config(n, n, nu=0.01, warmup=2000), cylinder_mask(n, n),
                              device="cuda:0")
    run_case(f"demo {n}^2", demo, 50, args.chunks, args.one_card)
    del demo
    config, mask = load_smoke_case()
    run_case("smoke 2432x1152", solver.make_params(config, mask, device="cuda:0"), 100,
             args.chunks, args.one_card)
    print(card_line())
    return 0


if __name__ == "__main__":
    sys.exit(main())
