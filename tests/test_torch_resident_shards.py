"""A sharded case's state stays on its blocks across chunks
(``topology.BlockState``, ``sharded.BlockRunner``, ``LBMEngine`` on a
spatial mesh), on the CPU, on grids of at most 64 x 128.

- Against the JAX package: its ``LBMEngine(spatial_mesh="2x2")`` (the jnp
  ``shard_map`` step on 4 of the root conftest's 8 host devices) and the
  port's, from one config and seeded mask, two chunks with a
  ``get_moments()`` between them: moments within 1e-12 in float64 and
  1e-5 relative in float32, ``get_force()`` within 1e-12 in float64.
- Within the port, bitwise: the resident engine on the 1x1, 2x2 and
  (5, 1) meshes against the single-device engine, and the resident
  kernels' plain runner against ``cuda_step.run_chunk_plain``, on f,
  f_post, rho, u, max_v and the force, for the four obstacle schemes.
- A mesh that is not on one device (blocks on ``cpu`` and ``cpu:0``,
  distinct torch devices of one CPU) takes the blocks' float64 partial
  force: state and max_v bitwise, the force within the multi-host bar
  (``chip_smoke`` phase 9(d)'s: 5e-6 in float32, 1e-12 in float64,
  relative to the force where it exceeds 1).
- No per-chunk gather: two chunks cut and gather nothing and allocate no
  tensor of the global f, rho or u shape; a field read gathers exactly
  the fields it reads.
- A checkpoint written on a 2x2 mesh resumes bitwise.
"""

import dataclasses

import jax
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402
from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from lbm2d_tpu.core.engine import LBMEngine as JaxEngine  # noqa: E402
from lbm2d_tpu_torch.core import solver as ts  # noqa: E402
from lbm2d_tpu_torch.core.engine import LBMEngine  # noqa: E402
from lbm2d_tpu_torch.ops import cuda_step as cs  # noqa: E402
from lbm2d_tpu_torch.parallel import multihost, topology  # noqa: E402
from lbm2d_tpu_torch.parallel import sharded as sh  # noqa: E402
from lbm2d_tpu_torch.parallel.topology import make_mesh  # noqa: E402
from test_torch_sharded import SCHEME_IDS, SCHEMES, make_config, seam_mask  # noqa: E402

NY, NX = 40, 64
CHUNKS = (7, 8)  # odd then even: both parities of the ping-pong
MESHES = [(1, 1), (2, 2), (5, 1)]
FIELDS = ("f", "f_post", "rho", "u")


def engine_config(bc_type=(0, 2, 1, 2), obstacle="equilibrium", ny=NY, nx=NX):
    cfg = make_config(bc_type, obstacle, ny=ny, nx=nx)
    cfg["simulation"].update(name="resident", characteristic_length=8.0)
    return cfg


def seeded_mask(seed=0, ny=NY, nx=NX, edge_solids=True):
    """``seam_mask``'s disc across the seams, plus solid cells scattered
    from ``seed`` at least 4 cells inside the grid."""
    scatter = np.random.default_rng(seed).random((ny, nx)) < 0.03
    scatter[:4] = scatter[-4:] = False
    scatter[:, :4] = scatter[:, -4:] = False
    return np.maximum(seam_mask(ny, nx, edge_solids), scatter.astype(np.float32))


def ids(shape):
    return f"{shape[0]}x{shape[1]}"


def assert_fields_equal(a, b):
    for k in FIELDS:
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert a.step == b.step


# ---------------------------------------------------------------------------
# Against the JAX package's sharded engine
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bc_type, obstacle", [SCHEMES[0], SCHEMES[3]],
                         ids=[SCHEME_IDS[0], SCHEME_IDS[3]])
@pytest.mark.parametrize("dtype", ["float64", "float32"])
def test_engine_matches_jax_sharded_engine(dtype, bc_type, obstacle):
    assert len(jax.devices()) >= 8, "needs the root conftest's 8 host devices"
    cfg, mask = engine_config(bc_type, obstacle), seeded_mask(edge_solids=False)
    je = JaxEngine(cfg, mask, dtype=getattr(jnp, dtype), spatial_mesh="2x2")
    te = LBMEngine(cfg, mask, dtype=getattr(torch, dtype), device="cpu", spatial_mesh="2x2")
    assert je.mesh.devices.shape == (2, 2) and te.mesh.grid == (2, 2)
    for n in CHUNKS:
        je.run_step(n)
        te.run_step(n)
        a, b = te.get_moments(), je.get_moments()
        assert a.dtype == np.dtype(dtype) and a.shape == (9, NY, NX)
        err = np.abs(a - b).max()
        if dtype == "float64":
            assert err <= 1e-12, err
        else:
            assert err <= 1e-5 * np.abs(b).max(), err
    assert te.step_count == je.step_count == sum(CHUNKS)
    if dtype == "float64":
        np.testing.assert_allclose(te.get_force(), je.get_force(), rtol=0, atol=1e-12)
        assert abs(te.get_max_velocity() - je.get_max_velocity()) <= 1e-12


# ---------------------------------------------------------------------------
# Within the port, bitwise
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("bc_type, obstacle", SCHEMES, ids=SCHEME_IDS)
@pytest.mark.parametrize("shape", MESHES, ids=ids)
def test_resident_engine_equals_single_device(shape, bc_type, obstacle):
    cfg, mask = engine_config(bc_type, obstacle), seeded_mask()
    one = LBMEngine(cfg, mask, device="cpu")
    res = LBMEngine(cfg, mask, device="cpu", spatial_mesh=shape)
    assert res.mesh.grid == shape
    for n in CHUNKS:
        one.run_step(n)
        res.run_step(n)
        assert np.array_equal(res.get_force(), one.get_force())
        assert res.get_max_velocity() == one.get_max_velocity()
    assert_fields_equal(res.state, one.state)
    assert np.array_equal(res.get_moments(), one.get_moments())


@pytest.mark.parametrize("store_dev", [False, True], ids=["f32", "dev"])
@pytest.mark.parametrize("bc_type, obstacle", SCHEMES, ids=SCHEME_IDS)
@pytest.mark.parametrize("shape", MESHES, ids=ids)
def test_resident_plain_runner_equals_run_chunk_plain(shape, bc_type, obstacle, store_dev):
    p = ts.make_params(engine_config(bc_type, obstacle), seeded_mask())
    runner = sh.BlockRunner(make_mesh(shape, ["cpu"] * (shape[0] * shape[1])), "plain",
                            store_dev)
    bs = runner.place(ts.init_state(NY, NX), p)
    st = ts.init_state(NY, NX)
    for n in CHUNKS:
        ma = runner.advance(bs, p, n)
        st, mb = cs.run_chunk_plain(st, p, n, store_dev=store_dev)
        assert torch.equal(ma["force"], mb["force"]) and torch.equal(ma["max_v"], mb["max_v"])
    assert_fields_equal(bs.snapshot(), st)


def test_resident_engine_store_dev_equals_single_device():
    # the kernels' plain sharded runner in deviation storage, through the
    # engine, against the single-device plain split, on a grid whose 2x2
    # blocks have the JAX sharded split-BC geometry (16x128), where the
    # engines engage it
    cfg, mask = engine_config(ny=32, nx=256), seeded_mask(ny=32, nx=256)
    one = LBMEngine(cfg, mask, device="cpu", store_dev=True)
    res = LBMEngine(cfg, mask, device="cpu", store_dev=True, spatial_mesh="2x2")
    assert res.store_dev and isinstance(res._runner, sh.BlockRunner)
    assert res._runner.kind == "plain"
    for n in CHUNKS:
        one.run_step(n)
        res.run_step(n)
    assert np.array_equal(res.get_force(), one.get_force())
    assert_fields_equal(res.state, one.state)


# ---------------------------------------------------------------------------
# A mesh not on one device: the blocks' float64 partial force
# ---------------------------------------------------------------------------


def two_device_mesh(shape):
    """A mesh whose blocks alternate between two distinct torch devices of
    the CPU, so ``Mesh.single_device`` is None."""
    n = shape[0] * shape[1]
    mesh = make_mesh(shape, [torch.device("cpu", 0) if i % 2 else torch.device("cpu")
                             for i in range(n)])
    assert mesh.single_device is None
    return mesh


@pytest.mark.parametrize("kind, dtype", [("plain", torch.float32), ("eager", torch.float32),
                                         ("eager", torch.float64)],
                         ids=["plain-f32", "eager-f32", "eager-f64"])
@pytest.mark.parametrize("bc_type, obstacle", SCHEMES, ids=SCHEME_IDS)
def test_force_from_block_partials(kind, dtype, bc_type, obstacle):
    p = ts.make_params(engine_config(bc_type, obstacle), seeded_mask(), dtype=dtype)
    runner = sh.BlockRunner(two_device_mesh((2, 2)), kind)
    bs = runner.place(ts.init_state(NY, NX, dtype), p)
    assert bs.f_post_global is None
    st = ts.init_state(NY, NX, dtype)
    ref = cs.run_chunk_plain if kind == "plain" else ts.run_chunk
    for n in CHUNKS:
        ma = runner.advance(bs, p, n)
        st, mb = ref(st, p, n)
        assert ma["force"].dtype == dtype and torch.equal(ma["max_v"], mb["max_v"])
        err = float((ma["force"] - mb["force"]).abs().max())
        bar = (5e-6 if dtype == torch.float32 else 1e-12) * max(1.0, float(mb["force"].abs().max()))
        assert err <= bar, (err, bar)
    assert_fields_equal(bs.snapshot(), st)
    # before any chunk the monitors come from the blocks too
    bs0 = runner.place(ts.init_state(NY, NX, dtype), p)
    m0 = runner.monitors(bs0, p)
    assert float(m0["max_v"]) == 0.0 and torch.isfinite(m0["force"]).all()


# ---------------------------------------------------------------------------
# No per-chunk gather, no global-shaped allocation
# ---------------------------------------------------------------------------


class NewTensors(TorchDispatchMode):
    """Records the shape of every tensor an operation allocates (an output
    sharing no storage with the operation's inputs: views and in-place
    results are not allocations)."""

    def __init__(self):
        super().__init__()
        self.shapes = set()

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        seen = {t.untyped_storage().data_ptr() for t in tree_leaves((args, kwargs))
                if isinstance(t, torch.Tensor)}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and t.untyped_storage().data_ptr() not in seen:
                self.shapes.add(tuple(t.shape))
        return out


def counting(monkeypatch):
    """Wrap the gather and the halo cut wherever they are looked up; the
    calls land in the returned list as (name, shape of the first block or
    of the cut tensor)."""
    calls = []
    gather, cut = topology.gather_blocks, topology.halo_blocks

    def gather_blocks(blocks, device):
        calls.append(("gather", tuple(next(b for r in blocks for b in r).shape)))
        return gather(blocks, device)

    def halo_blocks(x, *a, **kw):
        calls.append(("cut", tuple(x.shape)))
        return cut(x, *a, **kw)

    for mod in (topology, multihost):
        monkeypatch.setattr(mod, "gather_blocks", gather_blocks)
    for mod in (topology, sh):
        monkeypatch.setattr(mod, "halo_blocks", halo_blocks)
    return calls


def global_shaped(held, shape):
    return [t for t in held if t is not None and tuple(t.shape[-2:]) == shape]


@pytest.mark.parametrize("how", ["eager", "plain", "plain-dev", "eager-two-devices"])
def test_chunks_gather_and_allocate_no_global_field(monkeypatch, how):
    calls = counting(monkeypatch)
    cfg, mask = engine_config(), seeded_mask()
    eng = LBMEngine(cfg, mask, device="cpu", store_dev=how == "plain-dev",
                    spatial_mesh="2x2")
    if how == "plain":
        eng._runner = sh.BlockRunner(eng.mesh, "plain")
        eng._set_state(ts.init_state(NY, NX))
    elif how == "eager-two-devices":
        eng.mesh = two_device_mesh((2, 2))
        eng._runner = sh.BlockRunner(eng.mesh, "eager")
        eng._set_state(ts.init_state(NY, NX))
    one_device = how != "eager-two-devices"
    eng.run_step(3)
    calls.clear()
    with NewTensors() as new:
        eng.run_step(CHUNKS[0])
        eng.run_step(CHUNKS[1])
    assert calls == []
    forbidden = {(9, NY, NX), (2, NY, NX)} | (set() if one_device else {(NY, NX)})
    assert not new.shapes & forbidden, new.shapes & forbidden
    # between chunks the engine holds its blocks, and on one device the
    # closing f_post, only
    bs = eng._blocks
    assert eng._state is None and eng._snapshot is None
    held = [b for k in FIELDS for row in getattr(bs, k) for b in row]
    held += [b for row in bs.f_alt or [] for b in row]
    assert global_shaped(held, (NY, NX)) == []
    assert (bs.f_post_global is not None) == one_device
    # a field read gathers the fields it reads, once each
    hl, wl = NY // 2, NX // 2
    eng.get_moments()
    assert calls == ([] if one_device else [("gather", (9, hl, wl))])
    calls.clear()
    eng.get_physical_fields()
    assert calls == [("gather", (2, hl, wl))]
    calls.clear()
    st = eng.state
    assert calls == [("gather", (9, hl, wl))] * (1 if one_device else 2) + [
        ("gather", (hl, wl)), ("gather", (2, hl, wl))]
    calls.clear()
    assert eng.state is st and calls == []  # cached until the next chunk
    eng.run_step(1)
    assert eng.state is not st and calls.count(("gather", (hl, wl))) == 1


def test_snapshot_shares_no_storage_with_the_blocks():
    cfg, mask = engine_config(), seeded_mask()
    eng = LBMEngine(cfg, mask, device="cpu", spatial_mesh="2x2")
    eng.run_step(CHUNKS[0])
    st = eng.state
    before = {k: getattr(st, k).clone() for k in FIELDS}
    eng.run_step(CHUNKS[1])
    for k in FIELDS:
        assert torch.equal(getattr(st, k), before[k]), k
    assert not torch.equal(eng.state.f_post, st.f_post)


# ---------------------------------------------------------------------------
# Checkpoints
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("store_dev", [False, True], ids=["eager", "plain-dev"])
def test_checkpoint_round_trip_on_2x2(tmp_path, store_dev):
    cfg, mask = engine_config(), seeded_mask()
    a = LBMEngine(cfg, mask, device="cpu", store_dev=store_dev, spatial_mesh="2x2")
    a.run_step(CHUNKS[0])
    ckpt = str(tmp_path / "case.ckpt.npz")
    a.save_checkpoint(ckpt)
    a.run_step(CHUNKS[1])
    b = LBMEngine(cfg, mask, device="cpu", store_dev=store_dev, spatial_mesh="2x2")
    b.run_step(2)  # overwritten by the load
    b.load_checkpoint(ckpt)
    assert b.step_count == CHUNKS[0] and b._snapshot is None
    b.run_step(CHUNKS[1])
    assert_fields_equal(b.state, a.state)
    assert np.array_equal(b.get_force(), a.get_force())
    with np.load(ckpt) as z:
        assert z["f"].shape == (9, NY, NX) and int(z["step"]) == CHUNKS[0]


def test_wrappers_keep_their_contract():
    # the (state, p, n) -> (state, monitors) runners are place, advance,
    # gather: a fresh global state, the input untouched
    p = ts.make_params(engine_config(), seeded_mask())
    s0 = ts.init_state(NY, NX)
    keep = dataclasses.replace(s0, **{k: getattr(s0, k).clone() for k in FIELDS})
    for run in (sh.run_chunk_sharded, sh.run_chunk_sharded_plain):
        st, mon = run(s0, p, CHUNKS[0], make_mesh((2, 2), ["cpu"] * 4))
        assert st.f.shape == (9, NY, NX) and st.step == CHUNKS[0]
        assert_fields_equal(s0, keep)
    with pytest.raises(ValueError, match="runner kind"):
        sh.BlockRunner(make_mesh((1, 1), ["cpu"]), "fused")
