"""Multi-host spatial decomposition in the port (``parallel/multihost.py``):
two OS processes join a gloo ``torch.distributed`` group on the CPU and
run one grid over a global mesh whose blocks belong to both.

- A chunk over a global 2x1 and 2x2 mesh (one and two CPU blocks a
  process): bitwise against the one-process ``run_chunk_sharded_plain``
  (f32, the kernels' plain versions) and ``run_chunk_sharded`` (f64, the
  eager step), and against the JAX ``run_chunk`` (f64 1e-12, f32 1e-6);
  the monitors equal on both ranks and within the force tolerance of the
  one-process chunk.
- The production entry ``run_one_case.main`` on a 2x1 mesh: rank 0's HDF5
  byte-equal to a one-process run (the JAX ``tests/test_multihost.py:61``
  criterion).
- Resume from a checkpoint only rank 0 can see: both ranks resume at rank
  0's step; a checkpoint rank 0 cannot read fails both ranks with the same
  error. Neither hangs.

Each worker has a hard timeout and a faulthandler tripwire. A test skips
only when a worker prints the ``MH_SKIP`` sentinel, which it does for one
named condition (this torch build has no gloo backend), never on words in
a traceback.
"""

import json
import os
import shutil
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch
import yaml

from lbm2d_tpu.core.solver import init_state as jax_init_state
from lbm2d_tpu.core.solver import make_params as jax_make_params
from lbm2d_tpu.core.solver import run_chunk as jax_run_chunk
from lbm2d_tpu_torch.core import solver as ts
from lbm2d_tpu_torch.parallel import sharded as sh
from lbm2d_tpu_torch.parallel.topology import make_mesh
from lbm2d_tpu_torch.pipeline import run_one_case
from test_parallel import block_mask, grid_config
from test_pipeline_e2e import make_project
from test_torch_spatial_pipeline import _h5_tree

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
NX, NY, STEPS = 64, 32, 12
TIMEOUT_S = 240

_PRELUDE = """
import faulthandler, json, os, sys
# hang tripwire: a lost peer leaves a collective waiting forever -- dump
# the stacks and die instead of wedging the suite
faulthandler.dump_traceback_later(%d, exit=True, file=sys.stderr)
sys.modules["jax"] = None  # the port needs no JAX
import torch.distributed as dist
if not dist.is_available() or not dist.is_gloo_available():
    print("MH_SKIP this torch build has no gloo backend", flush=True)
    sys.exit(0)
from lbm2d_tpu_torch.parallel import multihost
coord, nprocs, rank = sys.argv[1], int(sys.argv[2]), int(sys.argv[3])
args = json.loads(sys.argv[4])
""" % (TIMEOUT_S - 30)

_CHUNK = _PRELUDE + """
import numpy as np, torch
from lbm2d_tpu_torch.core import solver as ts
from lbm2d_tpu_torch.parallel import sharded as sh
ry, rx = args["mesh"]
multihost.init_multihost(coord, nprocs, rank, local_device_ids=tuple(range(ry * rx // nprocs)),
                         backend="gloo", device="cpu")
dtype = getattr(torch, args["dtype"])
cfg = json.load(open(args["cfg"]))
p = ts.make_params(cfg, np.load(args["mask"]), dtype=dtype)
mesh = multihost.make_global_mesh((ry, rx))
assert multihost.is_cross_rank(mesh)
run = sh.run_chunk_sharded_plain if args["runner"] == "plain" else sh.run_chunk_sharded
st, mon = run(ts.init_state(cfg["simulation"]["ny"], cfg["simulation"]["nx"], dtype), p,
              args["steps"] // 2, mesh)
st, mon = run(st, p, args["steps"] - args["steps"] // 2, mesh)  # a restart mid-warmup
out = {k: multihost.gather_for_io(getattr(st, k), mesh) for k in ("f", "f_post", "rho", "u")}
np.savez(args["out"] + f".{rank}.npz", force=mon["force"].numpy(), max_v=mon["max_v"].numpy(),
         step=st.step, **out)
multihost.sync()
print("MH_OK", rank, flush=True)
"""

_PIPE = _PRELUDE + """
from lbm2d_tpu_torch.pipeline import run_one_case
multihost.init_multihost(coord, nprocs, rank, backend="gloo", device="cpu")
md = run_one_case.main(args["cfg"][rank], args["mask"], args["h5"][rank], args["mp4"][rank],
                       progress=False, spatial_mesh="2x1", device="cpu")
multihost.sync()
print("MH_PIPE " + json.dumps({"rank": rank, "status": md.get("status"),
      "reason": md.get("reason"), "steps": md.get("final_steps"),
      "re": md.get("reynolds_number_lattice_actual")}), flush=True)
"""


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _two_ranks(snippet, args):
    """Run ``snippet`` as ranks 0 and 1; their stdouts (skips on MH_SKIP)."""
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    procs = [subprocess.Popen([sys.executable, "-c", snippet, coord, "2", str(r),
                               json.dumps(args)], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
             for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    joined = "\n----\n".join(o[-4000:] for o in outs)
    if any("MH_SKIP" in o for o in outs):
        pytest.skip(joined)
    assert all(p.returncode == 0 for p in procs), joined
    return outs, joined


def _case(tmp_path, dtype):
    cfg = grid_config(NX, NY)
    mask = block_mask(NY, NX)
    cfg_path, mask_path = str(tmp_path / "cfg.json"), str(tmp_path / "mask.npy")
    json.dump(cfg, open(cfg_path, "w"))
    np.save(mask_path, mask)
    return cfg, mask, cfg_path, mask_path


@pytest.mark.parametrize("mesh", [(2, 1), (2, 2)], ids=["2x1", "2x2"])
@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_two_process_chunk_matches_one_process(tmp_path, mesh, dtype):
    cfg, mask, cfg_path, mask_path = _case(tmp_path, dtype)
    runner = "plain" if dtype == "float32" else "eager"
    out = str(tmp_path / "chunk")
    _two_ranks(_CHUNK, {"mesh": mesh, "dtype": dtype, "cfg": cfg_path, "mask": mask_path,
                        "runner": runner, "steps": STEPS, "out": out})
    got = [np.load(f"{out}.{r}.npz") for r in (0, 1)]
    # the one-process chunk on the same mesh, the same restart
    tdt = getattr(torch, dtype)
    p = ts.make_params(cfg, mask, dtype=tdt)
    run = sh.run_chunk_sharded_plain if runner == "plain" else sh.run_chunk_sharded
    one_mesh = make_mesh(mesh, ["cpu"] * (mesh[0] * mesh[1]))
    st, mon = run(ts.init_state(NY, NX, tdt), p, STEPS // 2, one_mesh)
    st, mon = run(st, p, STEPS - STEPS // 2, one_mesh)
    for g in got:  # every rank gathers the whole field
        for k in ("f", "f_post", "rho", "u"):
            np.testing.assert_array_equal(g[k], getattr(st, k).numpy(), err_msg=k)
        assert int(g["step"]) == STEPS
    # the ranks reduce the monitors in one order: the same bits
    np.testing.assert_array_equal(got[0]["force"], got[1]["force"])
    np.testing.assert_array_equal(got[0]["max_v"], got[1]["max_v"])
    assert float(got[0]["max_v"]) == float(mon["max_v"])
    np.testing.assert_allclose(got[0]["force"], mon["force"].numpy(), rtol=0,
                               atol=5e-6 if dtype == "float32" else 1e-12)
    # against the JAX package's single-device chunk
    import jax.numpy as jnp

    jdt = jnp.float32 if dtype == "float32" else jnp.float64
    ref, _ = jax_run_chunk(jax_init_state(NY, NX, jdt), jax_make_params(cfg, mask, dtype=jdt),
                           STEPS)
    np.testing.assert_allclose(got[0]["f"], np.asarray(ref.f), rtol=0,
                               atol=1e-6 if dtype == "float32" else 1e-12)


def _project(root):
    make_project(root, name="MH")
    base = os.path.join(root, "SimCases", "MH")
    cfg_name = "mask_00_cfg_Nu0-0500.yaml"
    return base, os.path.join(base, "configs", cfg_name), os.path.join(base, "masks", "mask_00.png")


def test_two_process_pipeline_artifact_parity(tmp_path):
    root = str(tmp_path)
    base, cfg, mask = _project(root)
    ser = os.path.join(root, "serial")
    os.makedirs(ser)
    md = run_one_case.main(cfg, mask, os.path.join(ser, "case.h5"),
                           os.path.join(ser, "case.mp4"), progress=False, device="cpu")
    assert md["status"] == "Success", md
    mh = os.path.join(root, "mh")
    os.makedirs(mh)
    h5 = [os.path.join(mh, f"case{r}.h5") for r in (0, 1)]
    mp4 = [os.path.join(mh, f"case{r}.mp4") for r in (0, 1)]
    outs, joined = _two_ranks(_PIPE, {"cfg": [cfg, cfg], "mask": mask, "h5": h5, "mp4": mp4})
    stats = [json.loads([x for x in o.splitlines() if x.startswith("MH_PIPE ")][-1][8:])
             for o in outs]
    assert [s["status"] for s in stats] == ["Success", "Success"], joined
    assert "backend=gloo" in outs[0]
    a, b = _h5_tree(os.path.join(ser, "case.h5")), _h5_tree(h5[0])
    assert set(a) == set(b)
    for k in a:
        assert a[k] == b[k], f"h5 mismatch at {k}"
    assert os.path.getsize(mp4[0]) > 0
    assert not os.path.exists(h5[1]) and not os.path.exists(mp4[1])  # rank 0 alone writes
    assert stats[0]["re"] == stats[1]["re"] == md["reynolds_number_lattice_actual"]


def _checkpointed(root, cfg_path):
    """The case with checkpoints every 20 steps and resume on, at the
    default path beside each rank's HDF5 (so one config serves all)."""
    with open(cfg_path) as fh:
        cfg = yaml.safe_load(fh)
    cfg["outputs"]["video"]["enable"] = False
    cfg["outputs"]["checkpoint"] = {"enable": True, "interval_steps": 20, "resume": True}
    out = os.path.join(root, "checkpointed.yaml")
    with open(out, "w") as fh:
        yaml.safe_dump(cfg, fh)
    return out


@pytest.mark.parametrize("readable", [True, False], ids=["resumes", "unreadable"])
def test_resume_from_a_checkpoint_only_rank0_sees(tmp_path, readable):
    """ADVICE.md:3: each rank used to check for the checkpoint on its own
    filesystem, so rank 0 resumed at step N while rank 1 started at 0."""
    from lbm2d_tpu_torch.core.engine import LBMEngine
    from lbm2d_tpu_torch.utils.config import load_config
    from lbm2d_tpu_torch.utils.masks import create_mask

    root = str(tmp_path)
    _, cfg_path, mask = _project(root)
    cfg_file = _checkpointed(root, cfg_path)
    dirs = [os.path.join(root, d) for d in ("rank0", "rank1", "serial")]
    for d in dirs:
        os.makedirs(d)
    h5 = [os.path.join(d, "case.h5") for d in dirs]
    # rank 0's filesystem holds a step-20 checkpoint; rank 1's holds none
    cfg = load_config(cfg_file)
    eng = LBMEngine(cfg, mask_yx=create_mask(cfg, mask).astype(np.float32), device="cpu")
    eng.run_step(20)
    if readable:
        eng.save_checkpoint(h5[0] + ".ckpt.npz")
        shutil.copy(h5[0] + ".ckpt.npz", h5[2] + ".ckpt.npz")  # a Success deletes rank 0's
    else:
        with open(h5[0] + ".ckpt.npz", "wb") as fh:
            fh.write(b"not an npz")
    outs, joined = _two_ranks(_PIPE, {"cfg": [cfg_file] * 2, "mask": mask, "h5": h5[:2],
                                      "mp4": [None, None]})
    stats = [json.loads([x for x in o.splitlines() if x.startswith("MH_PIPE ")][-1][8:])
             for o in outs]
    if readable:
        assert all("[Checkpoint] resumed at step 20" in o for o in outs), joined
        assert [s["status"] for s in stats] == ["Success", "Success"], joined
        # the resumed run equals a one-process run resumed from the same file
        md = run_one_case.main(cfg_file, mask, h5[2], None, progress=False, device="cpu")
        assert md["status"] == "Success", md
        a, b = _h5_tree(h5[2]), _h5_tree(h5[0])
        assert set(a) == set(b)
        for k in a:
            assert a[k] == b[k], f"h5 mismatch at {k}"
    else:
        assert [s["status"] for s in stats] == ["Failed", "Failed"], joined
        assert stats[0]["reason"] == stats[1]["reason"], joined
        assert "unreadable on rank 0" in stats[0]["reason"]


def test_two_process_cli(tmp_path):
    """``run_one_case --coordinator``: two ranks on the CPU, rank 0 alone
    writes the case file."""
    root = str(tmp_path)
    _, cfg, mask = _project(root)
    coord = f"127.0.0.1:{_free_port()}"
    env = dict(os.environ, OMP_NUM_THREADS="2",
               PYTHONPATH=REPO + os.pathsep + os.environ.get("PYTHONPATH", ""))
    h5 = [os.path.join(root, f"case{r}.h5") for r in (0, 1)]
    procs = [subprocess.Popen(
        [sys.executable, "-m", "lbm2d_tpu_torch.pipeline.run_one_case", "--config", cfg,
         "--mask", mask, "--h5", h5[r], "--video", os.path.join(root, f"case{r}.mp4"),
         "--device", "cpu", "--spatial_mesh", "2x1", "--coordinator", coord,
         "--num_processes", "2", "--process_id", str(r), "--backend", "gloo"],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True, env=env, cwd=REPO)
        for r in (0, 1)]
    outs = []
    try:
        for p in procs:
            outs.append(p.communicate(timeout=TIMEOUT_S)[0])
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    joined = "\n----\n".join(o[-3000:] for o in outs)
    assert all(p.returncode == 0 for p in procs), joined
    assert all("'status': 'Success'" in o for o in outs), joined
    assert os.path.exists(h5[0]) and not os.path.exists(h5[1])


@pytest.mark.parametrize("what", ["device_resize", "gui"])
def test_multihost_loop_refusals(tmp_path, what):
    """The JAX ``sim_loop.py:63-80`` guards: every rank raises before the
    first collective (here a stand-in engine flagged multi-host)."""
    from lbm2d_tpu_torch.pipeline.sim_loop import run_simulation_loop
    from lbm2d_tpu_torch.utils.config import load_config

    cfg = load_config(_project(str(tmp_path))[1])
    cfg["outputs"]["gui"]["enable"] = what == "gui"

    class Engine:
        _multihost = True
        step_count = 0

    with pytest.raises(ValueError, match="multi-host"):
        run_simulation_loop(cfg, Engine(), None, None, None, 10, progress=False,
                            device_resize=what == "device_resize")
