"""The monitor kernel's device time on one GPU, in the forms both this
tree and the trees before it launch: ``cuda_step.group_monitors`` over a
group of 5 cases of the smoke case's grid (2432x1152) and over a group of
one, for both instances (the 2 f_j links of equilibrium, full-way and
half-way; Bouzidi's), then a group of one on the DFG grid (881x165, an odd
H W) and on the demo grid (4096^2), beside the eager monitors
(``obstacle_force`` and ``max_velocity``) of one case. On the smoke grid a
tree with ``cuda_step.launch_monitors`` also times split launches: the u
stream alone (no links) and the links alone (no u read).

    python3 -m lbm2d_tpu_torch.tools.monitor_ab

or by path from the root of another checkout of the port, whose package it
then imports (``python3 /path/to/monitor_ab.py``): two trees in turns in
one call compare on one card. Each reading is a CUDA-graph replay of the
call (``tools/cuda_timing.graph_ms``), printed as one line with the card's
name and power limit, with the bound (u read once and each link's
populations, at 3.35 TB/s). Without a CUDA device it exits non-zero.
"""

from __future__ import annotations

import dataclasses
import os
import subprocess
import sys


PEAK_BW = 3.35e12  # bytes/s, the H100 SXM's device memory
GROUP_NUS = (0.02, 0.025, 0.03, 0.04, 0.05)


def main() -> int:
    sys.path.insert(0, os.getcwd())
    import torch

    if not torch.cuda.is_available():
        print("monitor_ab: no CUDA device", file=sys.stderr)
        return 1
    import lbm2d_tpu_torch
    from lbm2d_tpu_torch.core import solver
    from lbm2d_tpu_torch.ops import cuda_step as cs
    from lbm2d_tpu_torch.tools import smoke_case
    from lbm2d_tpu_torch.tools.cuda_timing import graph_ms
    from lbm2d_tpu_torch.tools.demo_case import cylinder_mask, demo_config

    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip().splitlines()[0]
    print(f"monitor_ab: package {os.path.dirname(lbm2d_tpu_torch.__file__)} [{card}]",
          flush=True)
    dev = torch.device("cuda", 0)
    gen = torch.Generator(device=dev).manual_seed(0)
    config, mask = smoke_case.load_smoke_case()
    from lbm2d_tpu_torch.analysis.dfg_validation import dfg_case

    cfg_d, mask_d, _ = dfg_case(ny=165, obstacle="bounce_back_bouzidi", inlet="nebb")

    def case(cfg, m, nu, bouzidi):
        c = {k: dict(v) if isinstance(v, dict) else v for k, v in cfg.items()}
        c["simulation"] = dict(cfg["simulation"], nu=nu)
        c["boundary_condition"] = dict(cfg["boundary_condition"],
                                       obstacle="bounce_back_bouzidi" if bouzidi
                                       else "equilibrium")
        p = solver.make_params(c, m, dtype=torch.float32, device=dev)
        if bouzidi:
            q = 0.1 + 0.9 * torch.rand((8,) + p.shape, generator=gen, device=dev)
            p = dataclasses.replace(p, bouzidi_q=q)
        return p

    def fields(B, H, W):
        fp = 0.1 + 0.01 * torch.rand((B, 9, H, W), generator=gen, device=dev)
        u = 0.05 * torch.randn((B, 2, H, W), generator=gen, device=dev)
        return fp, u

    n = 4096
    rows = [("smoke", config, mask, 5), ("smoke", config, mask, 1),
            ("dfg", cfg_d, mask_d, 1), ("demo", demo_config(n, n, nu=0.01, warmup=2000),
                                        cylinder_mask(n, n), 1)]
    for bouzidi in (False, True):
        for tag, cfg, m, B in rows:
            if tag == "demo" and bouzidi:
                continue
            ps = [case(cfg, m, GROUP_NUS[c], bouzidi) for c in range(B)]
            g = cs.GroupParams(ps)
            H, W = ps[0].shape
            fp, u = fields(B, H, W)
            alive, later = [True] * B, [True] * B
            n_links = sum(int(cs.boundary_links(p).numel()) for p in ps)
            ms = graph_ms(lambda: cs.group_monitors(fp, u, g, alive, later))
            eager = graph_ms(lambda: (solver.obstacle_force(fp[0], ps[0]),
                                      solver.max_velocity(u[0])))
            bound = (8 * B * H * W + (20 if bouzidi else 8) * n_links) / PEAK_BW * 1e3
            name = "group_monitors" + ("_bouzidi" if bouzidi else "")
            print(f"monitor_ab {name} {tag} B={B} {H}x{W}: {ms * 1e3:.2f} us, bound "
                  f"{bound * 1e3:.2f} us ({100 * bound / ms:.1f}%), {n_links} links; the eager "
                  f"monitors of one case {eager * 1e3:.1f} us [{card}]", flush=True)
            if hasattr(cs, "launch_monitors") and tag == "smoke":
                # split launches (trees with launch_monitors): the u stream
                # alone (no links) and the links alone (no u read)
                plane = H * W
                item = cs.whole_item(fp, g.q, u, H, W)
                strides = (9 * plane, 8 * plane, 2 * plane)
                empty = cs.MonitorLinks([torch.zeros(0, dtype=torch.int32)] * B, dev)
                u_ms = graph_ms(lambda: cs.launch_monitors(empty, item, strides, bouzidi=bouzidi,
                                                           cells=plane))
                item_l = cs.whole_item(fp, g.q, None, H, W)
                l_ms = graph_ms(lambda: cs.launch_monitors(g.mon, item_l, strides,
                                                           bouzidi=bouzidi))
                print(f"monitor_ab {name} {tag} B={B} split: u stream alone {u_ms * 1e3:.2f} us "
                      f"(bound {8 * B * plane / PEAK_BW * 1e6:.2f}), links alone "
                      f"{l_ms * 1e3:.2f} us [{card}]", flush=True)
            del fp, u, g
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
