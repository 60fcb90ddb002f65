"""Roofline decomposition of the port's default step on one GPU
(counterpart of the JAX package's ``tools_roofline_4096.py``).

Run from the repository root on a machine with an NVIDIA GPU:

    python3 -m lbm2d_tpu_torch.tools.roofline [N] [chunks] [steps_per_chunk]

On the demo case (``tools/demo_case.py``) at N x N (default 4096), it
prints:

1. the default step's MLUPS and us/step through ``run_chunk_cuda`` (K1,
   one launch a step, CUDA events around ``chunks`` chunks of
   ``steps_per_chunk`` steps);
2. the bytes that step moves per cell, from the port's real buffers (f in
   and out, aux; no padding), and the rate they give;
3. the copy probe (``ops/copy_probe``, a copy of the [9, N, N] field) with
   and without the aux read, in GB/s against the 3.35 TB/s nominal of an
   H100 SXM and against ``torch.Tensor.copy_`` of the same field;
4. K1 (one fast step, its ring included) alone;
5. one JSON line: grid, mlups, us_per_step, bytes_per_cell, achieved_gbps.

Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import json
import sys

import torch

NOMINAL_GBPS = 3350.0  # H100 SXM HBM3 (NVIDIA data sheet)


def step_traffic(H: int, W: int) -> dict:
    """Bytes one fast K1 step moves, from the buffers it touches: f read (9
    planes) and written (9 planes, the ring included), aux read."""
    cells = H * W
    t = {"f_in": 36 * cells, "f_out": 36 * cells, "aux": 4 * cells}
    t["total"] = sum(t.values())
    t["per_cell"] = t["total"] / cells
    return t


def copy_traffic(H: int, W: int, aux: bool) -> int:
    """Bytes of one copy probe: 9 planes read and written, aux read."""
    return 72 * H * W + (4 * H * W if aux else 0)


def event_ms(fn, n: int, warm: int = 3) -> float:
    """Mean device ms of ``fn`` over ``n`` calls between CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(n):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / n


def measure(n_grid: int = 4096, chunks: int = 5, spc: int = 100) -> dict:
    """Every number the tool prints, as a dict (see the module docstring),
    measured on CUDA device 0."""
    if not torch.cuda.is_available():
        raise RuntimeError("the roofline tool measures a CUDA device; none is available")
    dev = torch.device("cuda", 0)
    from ..core.solver import init_state, make_params
    from ..ops import copy_probe as cp
    from ..ops import cuda_step as cs
    from .demo_case import cylinder_mask, demo_config

    H = W = n_grid
    p = make_params(demo_config(W, H, nu=0.01, warmup=2000), cylinder_mask(H, W), device=dev)
    state = init_state(H, W, torch.float32, dev)
    out = {"grid": n_grid}

    def chunk():
        nonlocal state
        state, _ = cs.run_chunk_cuda(state, p, spc)

    us_step = event_ms(chunk, chunks, warm=1) * 1e3 / spc
    traffic = step_traffic(H, W)
    out.update(mlups=H * W / us_step, us_per_step=us_step,
               bytes_per_cell=traffic["per_cell"],
               achieved_gbps=traffic["total"] / (us_step * 1e-6) / 1e9)

    aux = cs.pack_aux(p.damping, p.mask)
    f = state.f
    dst = torch.empty_like(f)
    n_copy = max(5, chunks * spc // 10)
    for tag, a in (("copy_aux", aux), ("copy", None)):
        ms = event_ms(lambda a=a: cp.copy_probe(f, dst, a), n_copy)
        out[f"{tag}_us"] = ms * 1e3
        out[f"{tag}_gbps"] = copy_traffic(H, W, a is not None) / (ms * 1e-3) / 1e9
    lib = event_ms(lambda: dst.copy_(f), n_copy)
    out["copy_lib_us"] = lib * 1e3
    out["copy_lib_gbps"] = copy_traffic(H, W, False) / (lib * 1e-3) / 1e9

    scal = cs.scalar_row(p, state.step + 1)
    obst = cs.obstacle_scheme(p)
    out["k1_us"] = event_ms(
        lambda: cs.k1_step(f, dst, aux, scal, p.use_les, p.bc_type, obstacle=obst), n_copy) * 1e3
    return out


def main(argv=None) -> int:
    argv = sys.argv[1:] if argv is None else argv
    n_grid = int(argv[0]) if len(argv) > 0 else 4096
    chunks = int(argv[1]) if len(argv) > 1 else 5
    spc = int(argv[2]) if len(argv) > 2 else 100
    if not torch.cuda.is_available():
        print("roofline: no CUDA device (torch.cuda.is_available() is False)", file=sys.stderr)
        return 1
    r = measure(n_grid, chunks, spc)
    name = torch.cuda.get_device_name(0)
    print(f"[step]  {r['mlups']:.1f} MLUPS ({r['us_per_step']:.1f} us/step) [{name}]")
    print(f"[step]  traffic {r['bytes_per_cell']:.2f} B/cell-step -> {r['achieved_gbps']:.1f} "
          f"GB/s achieved (nominal {NOMINAL_GBPS:.0f} GB/s, H100 SXM)")
    for tag in ("copy_aux", "copy"):
        print(f"[{tag:8s}] {r[f'{tag}_us']:.1f} us/pass {r[f'{tag}_gbps']:.1f} GB/s "
              f"({r[f'{tag}_gbps'] / NOMINAL_GBPS:.1%} of nominal, "
              f"{r[f'{tag}_gbps'] / r['copy_lib_gbps']:.1%} of copy_)")
    print(f"[copy_]   {r['copy_lib_us']:.1f} us/pass {r['copy_lib_gbps']:.1f} GB/s "
          "(torch.Tensor.copy_, the library call)")
    print(f"[k1]     {r['k1_us']:.1f} us per step (one launch, the ring included)")
    print(json.dumps({k: r[k] for k in ("grid", "mlups", "us_per_step", "bytes_per_cell",
                                         "achieved_gbps")}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
