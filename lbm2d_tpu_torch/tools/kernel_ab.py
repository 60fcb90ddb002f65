"""Time the port's K1 and K3 on the card at the production grid (the smoke
case, 2432x1152) from a developed state, against other builds of them.

    python3 -m lbm2d_tpu_torch.tools.kernel_ab --k3-tiles 4:24x112 8:48x48
    python3 -m lbm2d_tpu_torch.tools.kernel_ab --k3-breakdown
    python3 -m lbm2d_tpu_torch.tools.kernel_ab --alt k3 DIR/k3_fused.cu

``--k3-tiles S:THxTW ...`` times the repository's K3 at each depth and tile
and holds each pass bitwise against its plain version. ``--k3-breakdown``
builds csrc/k3_fused.cu with each of its timing probes (``K3_PROBE``: the
collision, the sweep's barrier or level S's stores left out, or the loads
alone) and times each in turns with the repository's build at S = 4 and 8
on the default tiles; a probe's output is wrong and only its time is read.
``--alt KIND SOURCE`` builds another source of K1 or K3 (the headers it
includes beside it) with the repository's nvcc flags and times it in turns
with the repository's build: K1's fast and full steps, K3 at S = 4 and 8
on the default tiles, each output held bitwise against the plain version.
The alternative keeps the repository's C entry (``k1_step_launch`` or
``k3_fused_launch``). Every build is launched through the port's wrappers
(``cuda_step.k1_step``, ``cuda_step.k3_fused``). Times are CUDA-graph
replays (the kernel alone), in microseconds, in the order repo, other,
other, repo, beside the card's name and power limit. Needs a CUDA device.
"""

from __future__ import annotations

import argparse
import ctypes
import hashlib
import os
import subprocess
import sys
from unittest import mock

import numpy as np
import torch

from ..core import solver
from ..core.lattice import f_eq
from ..ops import cuda_build
from ..ops import cuda_step as cs
from .cuda_timing import card_line, graph_ms
from .smoke_case import load_smoke_case

# K3_PROBE bits (csrc/k3_fused.cu) and what each leaves out
K3_PROBES = {1: "no collision", 2: "no barrier", 3: "no collision, no barrier",
             6: "loads alone", 8: "no device-memory stores",
             9: "no collision, no device-memory stores",
             11: "no collision, no barrier, no device-memory stores"}


def developed_state(dev):
    """(params, state, aux) of the smoke case after 3 eager steps from a
    seeded random state (chip_smoke.py phase 2's inputs)."""
    config, mask = load_smoke_case()
    p = solver.make_params(config, mask, dtype=torch.float32, device=dev)
    H, W = p.shape
    rng = np.random.default_rng(0)
    rho = torch.tensor(1.0 + 1e-3 * rng.standard_normal((H, W)), dtype=torch.float32, device=dev)
    u = torch.tensor(0.02 * rng.standard_normal((2, H, W)), dtype=torch.float32, device=dev)
    f = f_eq(rho, u[0], u[1])
    state, _ = solver.run_chunk(solver.LBMState(f=f, f_post=f.clone(), rho=rho, u=u, step=0),
                                p, 3)
    return p, state, cs.pack_aux(p.damping, p.mask)


def build(kind: str, builds):
    """The C entries of ``builds`` [(source path, preprocessor definitions)],
    each compiled into the build directory with the repository's flags, all
    at once; ``kind`` is k1_step or k3_fused. Prints each build's ptxas
    register and spill lines."""
    os.makedirs(cuda_build.BUILD_DIR, exist_ok=True)
    procs = []
    for path, defines in builds:
        flags = [*cuda_build.NVCC_FLAGS, *(f"-D{d}" for d in defines)]
        with open(path, "rb") as fh:
            tag = hashlib.sha256(fh.read() + " ".join(flags).encode()).hexdigest()[:16]
        out = os.path.join(cuda_build.BUILD_DIR, f"lib{kind}_other_{tag}.so")
        cmd = [cuda_build.nvcc_path(), *flags, "-o", out, path]
        procs.append((path, defines, out, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)))
    entries = []
    for path, defines, out, proc in procs:
        _, err = proc.communicate()
        if proc.returncode:
            raise RuntimeError(f"nvcc failed for {path} {defines}:\n{err}")
        for ln in err.splitlines():
            if "registers" in ln or "spill" in ln:
                print(f"  ptxas {os.path.basename(path)} {' '.join(defines)}: {ln.strip()}")
        _, c_entry, argtypes = cuda_build.KERNELS[kind]
        fn = getattr(ctypes.CDLL(out), c_entry)
        fn.argtypes = argtypes
        fn.restype = ctypes.c_int
        entries.append(fn)
    return entries


def k1_runner(entry, p, state, aux, full: bool):
    """K1 through ``cuda_step.k1_step`` with ``entry`` as its C entry, on
    the whole grid, writing fresh NaN outputs."""
    H, W = p.shape
    dev = state.f.device
    nan = float("nan")
    out = {"f": torch.full_like(state.f, nan)}
    if full:
        out.update(rho=torch.full((H, W), nan, device=dev),
                   u=torch.full((2, H, W), nan, device=dev), f_post=state.f_post.clone())
    scal = cs.scalar_row(p, state.step + 1)

    def run():
        with mock.patch.dict(cuda_build._ENTRIES, {"k1_step": entry}):
            cs.k1_step(state.f, out["f"], aux, scal, p.use_les, p.bc_type, out.get("rho"),
                       out.get("u"), out.get("f_post"))

    return run, out


def k3_rows(p, state, S: int):
    return torch.stack([cs.scalar_row(p, state.step + 1 + i) for i in range(S)])


def k3_runner(entry, p, state, aux, S: int, tile):
    """K3 through ``cuda_step.k3_fused`` with ``entry`` as its C entry."""
    out = torch.full_like(state.f, float("nan"))
    rows = k3_rows(p, state, S)

    def run():
        with mock.patch.dict(cuda_build._ENTRIES, {"k3_fused": entry}):
            cs.k3_fused(state.f, out, aux, rows, p.bc_type, p.use_les, tile=tile)

    return run, {"f": out}


def plain_k1(p, state, aux, full: bool):
    _, out = k1_runner(None, p, state, aux, full)
    cs.k1_step_plain(state.f, out["f"], aux, cs.scalar_row(p, state.step + 1), p.use_les,
                     p.bc_type, out.get("rho"), out.get("u"), out.get("f_post"))
    return out


def plain_k3(p, state, aux, S: int, tile):
    ref = torch.full_like(state.f, float("nan"))
    cs.k3_fused_plain(state.f, ref, aux, k3_rows(p, state, S), p.bc_type, p.use_les,
                      tile=tile)
    return {"f": ref}


def bitwise(a: dict, b: dict) -> bool:
    torch.cuda.synchronize()
    return all(torch.equal(a[k], b[k]) for k in a)


def parse_tile(spec: str):
    """"S:THxTW" -> (S, (TH, TW))."""
    S, tile = spec.split(":")
    return int(S), tuple(int(v) for v in tile.split("x"))


def k3_tiles(p, state, aux, specs, tag: str) -> None:
    for S, tile in map(parse_tile, specs):
        run, out = k3_runner(cuda_build.load("k3_fused"), p, state, aux, S, tile)
        run()
        same = bitwise(out, plain_k3(p, state, aux, S, tile))
        print(f"K3 S = {S} tile {tile}: {graph_ms(run) * 1e3:.1f} us a pass, "
              f"{cs.k3_blocks_per_sm(S, tile[1])} blocks a SM, bitwise {same}  [{tag}]",
              flush=True)


def in_turns(name: str, repo, other, ref, tag: str) -> None:
    """Times (run, out) pairs ``repo`` and ``other`` in the order repo,
    other, other, repo, and holds both outputs against ``ref``."""
    (run_r, out_r), (run_o, out_o) = repo, other
    run_r()
    run_o()
    same = (bitwise(out_r, ref), bitwise(out_o, ref))
    t = [graph_ms(f) * 1e3 for f in (run_r, run_o, run_o, run_r)]
    print(f"{name}: repo {t[0]:.1f} / {t[3]:.1f} us, other {t[1]:.1f} / {t[2]:.1f} us "
          f"(repo, other, other, repo); bitwise vs plain: repo {same[0]}, other {same[1]}  "
          f"[{tag}]", flush=True)


def alt(p, state, aux, kind: str, path: str, tag: str) -> None:
    (other,) = build("k1_step" if kind == "k1" else "k3_fused", [(path, ())])
    if kind == "k1":
        repo = cuda_build.load("k1_step")
        for full in (False, True):
            in_turns(f"K1 {'full' if full else 'fast'}",
                     k1_runner(repo, p, state, aux, full), k1_runner(other, p, state, aux, full),
                     plain_k1(p, state, aux, full), tag)
    else:
        repo = cuda_build.load("k3_fused")
        for S in (4, 8):
            tile = cs.k3_tile(S)
            in_turns(f"K3 S = {S} tile {tile}", k3_runner(repo, p, state, aux, S, tile),
                     k3_runner(other, p, state, aux, S, tile), plain_k3(p, state, aux, S, tile),
                     tag)


def k3_breakdown(p, state, aux, tag: str) -> None:
    src = os.path.join(cuda_build.CSRC, cuda_build.SOURCES["k3_fused"])
    probes = build("k3_fused", [(src, (f"K3_PROBE={bits}",)) for bits in K3_PROBES])
    repo = cuda_build.load("k3_fused")
    for S in (4, 8):
        tile = cs.k3_tile(S)
        ref = plain_k3(p, state, aux, S, tile)
        for (bits, what), probe in zip(K3_PROBES.items(), probes):
            in_turns(f"K3 S = {S} tile {tile}, probe {bits} ({what})",
                     k3_runner(repo, p, state, aux, S, tile),
                     k3_runner(probe, p, state, aux, S, tile), ref, tag)


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--k3-tiles", nargs="+", default=[], metavar="S:THxTW")
    ap.add_argument("--k3-breakdown", action="store_true")
    ap.add_argument("--alt", nargs=2, metavar=("KIND", "SOURCE"), help="KIND k1 or k3")
    args = ap.parse_args(argv)
    if args.alt and args.alt[0] not in ("k1", "k3"):
        ap.error("--alt KIND is k1 or k3")
    if not torch.cuda.is_available():
        print("kernel_ab: no CUDA device", file=sys.stderr)
        return 1
    tag = card_line()
    print(f"card: {tag}; torch {torch.__version__}", flush=True)
    cuda_build.build_all()
    p, state, aux = developed_state(torch.device("cuda", 0))
    if args.k3_tiles:
        k3_tiles(p, state, aux, args.k3_tiles, tag)
    if args.k3_breakdown:
        k3_breakdown(p, state, aux, tag)
    if args.alt:
        alt(p, state, aux, *args.alt, tag)
    return 0


if __name__ == "__main__":
    sys.exit(main())
