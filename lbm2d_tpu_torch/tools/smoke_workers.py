"""Worker processes of ``chip_smoke.py`` phase 9: the multi-process paths
of the port, each run as its own OS process on the card.

    python -m lbm2d_tpu_torch.tools.smoke_workers batch '<json>'
    python -m lbm2d_tpu_torch.tools.smoke_workers multihost '<json>'

``batch`` runs the batch CLI (``pipeline/batch_run.main``) with the JSON's
``argv``, as one ``--coordinate`` worker of a shared project. ``multihost``
joins a two-process gloo group (``parallel/multihost.init_multihost``) as
rank ``rank`` and runs one case through ``pipeline/run_one_case.main`` on
a spatial mesh spanning both processes, then times a few chunks of its
engine.

Both put the HDF5 writer on the in-memory stand-in where h5py is missing
(``tools/smoke_case.use_memory_h5``) and save each case file's datasets
they wrote beside it as ``<file>.npz``, so the parent can compare them.
They count the kernels' launches (``ops/cuda_step.LAUNCHES``) and every
call of a plain version or of the eager step, and end with one line
``WORKER {json}``. A faulthandler tripwire ends a worker that hangs.
"""

from __future__ import annotations

import faulthandler
import hashlib
import json
import os
import sys
import time

import numpy as np


def _count_plain_calls(counted: dict) -> None:
    """Wrap the plain versions and the eager steps so a call is counted."""
    from ..core import solver
    from ..ops import cuda_step as cs
    from ..parallel import sharded as sh

    for mod, attr in ((solver, "step"), (cs, "k1_step_plain"), (cs, "k1_step_dev_plain"),
                      (cs, "k3_fused_plain"), (sh, "local_step")):
        fn = getattr(mod, attr)

        def wrapper(*a, _fn=fn, _attr=attr, **kw):
            counted[_attr] = counted.get(_attr, 0) + 1
            return _fn(*a, **kw)

        setattr(mod, attr, wrapper)


def _record_case_files(paths: list) -> None:
    """Record the path of every case file this process's writers open."""
    from ..io import h5_writer

    init = h5_writer.AsyncLBMCaseWriter.__init__

    def recording(self, path, *a, **kw):
        paths.append(path)
        init(self, path, *a, **kw)

    h5_writer.AsyncLBMCaseWriter.__init__ = recording


def _dump_h5(paths) -> None:
    """Save the datasets of each case file in ``paths`` as
    ``<path>.npz`` (``smoke_case.read_datasets`` reads them back)."""
    from .smoke_case import MemH5File, read_datasets

    for path in paths:
        if path in MemH5File.FILES or os.path.exists(path):
            np.savez(path + ".npz", **read_datasets(path))


def _launches() -> dict:
    from ..ops import cuda_step as cs

    return {k: v for k, v in cs.LAUNCHES.items() if v}


def run_batch_worker(args: dict) -> dict:
    """One batch CLI run (``args["argv"]``); the case files it wrote are
    dumped."""
    from ..pipeline import batch_run

    counted: dict = {}
    _count_plain_calls(counted)
    written: list = []
    _record_case_files(written)
    sys.argv = ["batch_run"] + list(args["argv"])
    t0 = time.time()
    batch_run.main()
    t1 = time.time()
    _dump_h5(written)
    return {"t0": t0, "t1": t1, "launches": _launches(), "plain_calls": counted}


def run_multihost_worker(args: dict) -> dict:
    """Rank ``args["rank"]`` of a two-process gloo group on the card: one
    case through ``run_one_case.main`` on ``args["mesh"]``, then the
    engine's us/step over a few more chunks."""
    import torch

    from ..core.engine import LBMEngine
    from ..parallel import multihost
    from ..pipeline import run_one_case

    rank = int(args["rank"])
    backend = multihost.init_multihost(args["coord"], 2, rank, backend="gloo",
                                       device=args.get("device", "cuda"))
    counted: dict = {}
    _count_plain_calls(counted)
    written: list = []
    _record_case_files(written)
    engines = []

    class RecordingEngine(LBMEngine):
        def __init__(self, *a, **kw):
            super().__init__(*a, **kw)
            engines.append(self)

    run_one_case.LBMEngine = RecordingEngine
    t0 = time.time()
    md = run_one_case.main(args["cfg"], args["mask"], args["h5"][rank], None, progress=False,
                           spatial_mesh=args["mesh"], device=args.get("device", "cuda"))
    t1 = time.time()
    launches = _launches()
    out = {"rank": rank, "backend": backend, "status": md.get("status"),
           "reason": md.get("reason"), "final_steps": md.get("final_steps"),
           "t0": t0, "t1": t1, "launches": launches, "plain_calls": dict(counted)}
    if engines and md.get("status") == "Success":
        eng = engines[-1]
        out["multihost"] = bool(eng._multihost)
        f = multihost.gather_for_io(eng.state.f, eng.mesh)  # a collective
        out["f_sha256"] = hashlib.sha256(f.tobytes()).hexdigest()
        out["force"] = [float(x) for x in eng.get_force()]
        out["max_v"] = float(eng.get_max_velocity())
        chunk, timed = int(args["chunk"]), int(args.get("timed_chunks", 0))
        if timed:
            if eng.device.type == "cuda":
                torch.cuda.synchronize()
            multihost.sync()
            ts = time.perf_counter()
            for _ in range(timed):
                eng.run_step(chunk)
            eng.get_force()  # the chunk's monitors: the last collective
            if eng.device.type == "cuda":
                torch.cuda.synchronize()
            out["us_per_step"] = (time.perf_counter() - ts) * 1e6 / (timed * chunk)
    _dump_h5(written)
    multihost.sync()
    return out


def main() -> int:
    faulthandler.dump_traceback_later(float(os.environ.get("SMOKE_WORKER_TRIPWIRE_S", 280)),
                                      exit=True, file=sys.stderr)
    mode, args = sys.argv[1], json.loads(sys.argv[2])
    from .smoke_case import use_memory_h5

    use_memory_h5()
    if mode == "batch":
        out = run_batch_worker(args)
    elif mode == "multihost":
        out = run_multihost_worker(args)
    else:
        raise SystemExit(f"unknown mode {mode!r}")
    print("WORKER " + json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
