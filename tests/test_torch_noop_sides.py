"""BC layouts with a no-op side on the port's kernels, and where 16-bit
deviation storage engages.

A side whose BC type has no rule in ``apply_bc`` (left 1, right 3/4,
top/bottom 1/3/4: ``bc_*_values`` return None) is a no-op there: its cells
keep the previous step's f, rho and u, only the obstacle pass acts on them,
and a corner of an active top or bottom row reads the no-op side's cell as
it stood. The JAX package runs such layouts on its jnp step (its kernels'
``supports`` refuses them); the port runs them on K1, whose ring threads
read the cells' previous values (``cuda_step.RingPrev``). ``make_params``
(both packages) refuses top/bottom 1 and right/top/bottom 3/4, so the
layouts other than a left no-op reach the step through ``CaseParams``
built with another ``bc_type``, as here.

On the CPU, from a seeded state whose rho and u are not those of its f (u
nonzero on solid cells too, so the rule that a solid cell's u reads 0
after the first step shows), 32x64 with solids on the no-op ring and on
the side cells the corners read:

- the port's ``run_chunk_plain`` against the JAX jnp ``run_chunk``, 20
  steps, within 1e-6 relative on f, rho and f_post and 1e-6 absolute on u
  (the port's f32 bar against JAX, PERF.md; ``test_torch_ring_fold.py``
  holds u the same way). u is O(0.1) here, but the outlet's u is
  -1 + sum / rho: its rounding is that of O(1) values, 2.4e-7 on every
  layout, the production one included, which is 2.7e-6 to 8.9e-6 of
  max |u|;
- ``BlockRunner("plain")`` on a 2x2 mesh against the same, and bitwise
  against the whole grid, one-step chunks included;
- ``k1_step_plain`` against the eager ``solver.step`` bitwise, on the
  chunk's first step and on a later one.

Deviation storage engages where the JAX package's runners engage it
(``cuda_step.engine_dev_storage_refusal``): one test per rule, each run
bitwise the f32 run with the reason logged. The ``cuda`` tests hold the
kernels against their plain versions on the card.
"""

import dataclasses
import functools
import logging

import numpy as np
import pytest
import torch

from lbm2d_tpu_torch.core import solver as ts
from lbm2d_tpu_torch.core.engine import LBMEngine
from lbm2d_tpu_torch.core.lattice import f_eq
from lbm2d_tpu_torch.ops import cuda_step as cs
from lbm2d_tpu_torch.parallel import sharded as sh
from lbm2d_tpu_torch.parallel.batch import BatchEngine
from lbm2d_tpu_torch.parallel.topology import make_mesh
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

H, W = 32, 64
STEPS = 20
VS_JAX_F32 = 1e-6
CASES = [((1, 2, 1, 2), "equilibrium"), ((0, 1, 1, 1), "equilibrium"),
         ((0, 2, 3, 2), "equilibrium"), ((0, 2, 1, 4), "equilibrium"),
         ((3, 0, 4, 1), "equilibrium"), ((1, 3, 4, 1), "equilibrium"),
         ((1, 2, 1, 2), "bounce_back"), ((0, 1, 1, 1), "bounce_back_halfway"),
         ((4, 0, 3, 1), "bounce_back_bouzidi")]
IDS = ["eq-1212", "eq-0111", "eq-0232", "eq-0214", "eq-3041", "eq-1341", "full-1212",
       "half-0111", "bouzidi-4031"]
ENGINE_LOG = "lbm2d_tpu_torch.core.engine"


def make_config(left=0, obstacle="equilibrium", ny=H, nx=W):
    """A config make_params accepts: the case's left type, right outlet,
    free-slip top and bottom; ``params`` puts the case's layout in."""
    return {
        "simulation": {
            "nx": nx, "ny": ny, "nu": 0.02, "ghost_moments_s": 1.2, "name": "noop",
            "rho_in": 1.02, "rho_out": 1.0, "warmup_steps": 6, "characteristic_length": 8,
            "smagorinsky_constant": 0.1,
        },
        "domain_zones": {
            "sponge_in": 4, "sponge_out": 6, "sponge_top": 3, "sponge_bot": 3,
            "sponge_strength": 3.0,
        },
        "boundary_condition": {
            "type": [left, 2, 1, 2],
            "value": [[0.06, 0.0], [0.02, 0.01], [0.03, -0.01], [0.01, 0.02]],
            "obstacle": obstacle,
        },
    }


def noop_mask(ny=H, nx=W):
    """A disc, solids on the strips the BCs read, on every side of the ring
    and on the four side cells one row in from the corners, which a corner
    of an active row reads where its side is a no-op; the corners fluid."""
    yy, xx = np.mgrid[0:ny, 0:nx]
    mask = ((yy - (ny / 2 - 0.4)) ** 2 + (xx - (nx / 2 + 0.3)) ** 2 < 20).astype(np.float32)
    for y, x in ((1, 0), (ny - 2, 0), (1, nx - 1), (ny - 2, nx - 1), (ny // 2, 0),
                 (ny // 3, nx - 1), (0, nx // 3), (ny - 1, nx // 2), (5, 1), (ny - 7, nx - 2),
                 (1, nx // 4), (ny - 2, 2 * nx // 3)):
        mask[y, x] = 1.0
    return mask


def params(bc_type, obstacle, ny=H, nx=W, device="cpu"):
    """The port's CaseParams of the case, with ``bc_type`` put in."""
    p = ts.make_params(make_config(bc_type[0], obstacle, ny, nx), noop_mask(ny, nx),
                       device=device)
    return dataclasses.replace(p, bc_type=tuple(bc_type))


def seeded_state(seed=0, ny=H, nx=W, device="cpu"):
    """f from one draw of rho and u, the state's rho and u from another
    (u nonzero on solid cells too)."""
    rng = np.random.default_rng(seed)

    def draw():
        return (torch.tensor(1.0 + 0.01 * rng.standard_normal((ny, nx)), dtype=torch.float32),
                torch.tensor(0.03 * rng.standard_normal((2, ny, nx)), dtype=torch.float32))

    rho_f, u_f = draw()
    rho, u = draw()
    f = f_eq(rho_f, u_f[0], u_f[1])
    f_post = f + torch.tensor(1e-3 * rng.standard_normal(f.shape), dtype=torch.float32)
    return ts.LBMState(f=f.to(device), f_post=f_post.to(device), rho=rho.to(device),
                       u=u.to(device), step=0)


@functools.lru_cache(maxsize=None)
def jax_chunk(bc_type, obstacle):
    """The JAX jnp ``run_chunk`` of the case, STEPS steps from
    ``seeded_state()``, as numpy arrays {f, rho, u, f_post}."""
    from lbm2d_tpu.core import solver as js

    pj = js.make_params(make_config(bc_type[0], obstacle), noop_mask()).replace(
        bc_type=tuple(bc_type))
    s0 = seeded_state()
    st = js.LBMState(f=s0.f.numpy(), f_post=s0.f_post.numpy(), rho=s0.rho.numpy(),
                     u=s0.u.numpy(), step=np.int32(0))
    out, _ = js.run_chunk(st, pj, n_steps=STEPS)
    return {k: np.asarray(getattr(out, k)) for k in ("f", "rho", "u", "f_post")}


def assert_vs_jax(st, ref):
    for k, b in ref.items():
        a = getattr(st, k).cpu().numpy().astype(np.float64)
        err = np.abs(a - b).max() / (1.0 if k == "u" else np.abs(b).max())
        assert err <= VS_JAX_F32, (k, err)


def assert_equal(a, b):
    for k in ("f", "f_post", "rho", "u"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert a.step == b.step


@pytest.mark.parametrize("bc_type, obstacle", CASES, ids=IDS)
def test_plain_chunk_matches_jax(bc_type, obstacle):
    p = params(bc_type, obstacle)
    assert cs.unsupported(p) is None and cs.noop_sides(bc_type)
    st, mon = cs.run_chunk_plain(seeded_state(), p, STEPS)
    assert_vs_jax(st, jax_chunk(bc_type, obstacle))
    assert torch.isfinite(mon["force"]).all() and torch.isfinite(mon["max_v"])


@pytest.mark.parametrize("bc_type, obstacle", CASES, ids=IDS)
def test_mesh_plain_runner_matches_jax_and_the_whole_grid(bc_type, obstacle):
    p = params(bc_type, obstacle)
    mesh = make_mesh((2, 2), [torch.device("cpu")] * 4)
    runner = sh.BlockRunner(mesh, "plain")
    bs = runner.place(seeded_state(), p)
    runner.advance(bs, p, STEPS)
    assert_vs_jax(bs.snapshot(), jax_chunk(bc_type, obstacle))
    # chunks of 1 (the full step reads the resident rho and u it writes:
    # the runner copies them) and 7, bitwise the whole grid's
    whole = seeded_state()
    bs = runner.place(whole, p)
    for n in (1, 7):
        runner.advance(bs, p, n)
        whole, _ = cs.run_chunk_plain(whole, p, n)
        assert_equal(bs.snapshot(), whole)


@pytest.mark.parametrize("bc_type, obstacle", CASES, ids=IDS)
def test_k1_step_plain_is_the_eager_step(bc_type, obstacle):
    p = params(bc_type, obstacle)
    s0 = seeded_state(2)
    s1 = ts.step(s0, p)
    s2 = ts.step(s1, p)
    aux = cs.pack_aux(p.damping, p.mask)
    obst = cs.obstacle_scheme(p)
    q = p.bouzidi_q if obst == cs.OBSTACLE_BOUZIDI else None
    prof = p.inlet_profile if bc_type[0] in (cs.BC_VEL_INLET, cs.BC_VEL_INLET_NEBB) else None
    # the first step reads the state's rho and u as they are; a later step
    # the same planes, not fresh (a solid cell's u zeroed since)
    prev = cs.RingPrev(s0.rho, s0.u)
    f1, f2 = torch.empty_like(s0.f), torch.empty_like(s0.f)
    cs.k1_step_plain(s0.f, f1, aux, cs.scalar_row(p, 1), p.use_les, p.bc_type, obstacle=obst,
                     q=q, prof=prof, prev=prev)
    assert torch.equal(f1, s1.f)
    rho, u, f_post = torch.empty_like(s0.rho), torch.empty_like(s0.u), s1.f_post.clone()
    cs.k1_step_plain(f1, f2, aux, cs.scalar_row(p, 2), p.use_les, p.bc_type, rho, u, f_post,
                     obstacle=obst, q=q, prof=prof, prev=prev._replace(fresh=False))
    for a, b in ((f2, s2.f), (rho, s2.rho), (u, s2.u), (f_post, s2.f_post)):
        assert torch.equal(a, b)
    # a one-step full step: fresh, into buffers other than the state's
    rho, u, f_post = torch.empty_like(s0.rho), torch.empty_like(s0.u), s0.f_post.clone()
    cs.k1_step_plain(s0.f, f1, aux, cs.scalar_row(p, 1), p.use_les, p.bc_type, rho, u, f_post,
                     obstacle=obst, q=q, prof=prof, prev=prev)
    for a, b in ((f1, s1.f), (rho, s1.rho), (u, s1.u), (f_post, s1.f_post)):
        assert torch.equal(a, b)


def test_k1_needs_the_previous_state_where_a_side_is_a_no_op():
    p = params((0, 1, 1, 1), "equilibrium")
    s0 = seeded_state()
    aux = cs.pack_aux(p.damping, p.mask)
    out = torch.empty_like(s0.f)
    with pytest.raises(ValueError, match="RingPrev"):
        cs.k1_step(s0.f, out, aux, cs.scalar_row(p, 1), p.use_les, p.bc_type)
    rho, u = s0.rho.clone(), s0.u.clone()
    with pytest.raises(ValueError, match="fresh RingPrev"):
        cs.k1_step(s0.f, out, aux, cs.scalar_row(p, 1), p.use_les, p.bc_type, rho, u,
                   s0.f_post.clone(), prev=cs.RingPrev(rho, u))
    # K3 runs every side active; the chunk runner never fuses this layout
    rows = torch.stack([cs.scalar_row(p, 1 + i) for i in range(2)])
    with pytest.raises(ValueError, match="no-op sides"):
        cs.k3_fused(s0.f, out, aux, rows, p.bc_type, p.use_les, tile=(8, 16))
    assert "no-op sides (top, bottom)" in cs.fuse_refusal(p)


# ---------------------------------------------------------------------------
# Where deviation storage engages: the JAX package's rules
# ---------------------------------------------------------------------------


def engine_pair(cfg, mask, caplog, **kw):
    """(engine with f16_state requested, the exact one), the first built
    under caplog."""
    with caplog.at_level(logging.WARNING, logger=ENGINE_LOG):
        dev = LBMEngine(cfg, mask, device="cpu", store_dev=True, **kw)
    return dev, LBMEngine(cfg, mask, device="cpu", **kw)


def assert_refused_and_exact(dev, exact, caplog, why, steps=(9, 7)):
    assert not dev.store_dev
    assert len(caplog.records) == 1, caplog.text
    msg = caplog.records[0].getMessage()
    assert "not engaged" in msg and why in msg, msg
    for n in steps:
        dev.run_step(n)
        exact.run_step(n)
    for k in ("f", "rho", "u", "f_post"):
        assert torch.equal(getattr(dev.state, k), getattr(exact.state, k)), k


def test_store_dev_engages_on_the_split_bc_grid():
    # the control: 32x128 has the JAX split-BC geometry, so it engages, lossy
    cfg, mask = make_config(0, ny=32, nx=128), noop_mask(32, 128)
    assert cs.engine_dev_storage_refusal(ts.make_params(cfg, mask)) is None
    dev, exact = LBMEngine(cfg, mask, device="cpu", store_dev=True), LBMEngine(
        cfg, mask, device="cpu")
    assert dev.store_dev
    dev.run_step(9)
    exact.run_step(9)
    assert 0 < float((dev.state.f - exact.state.f).abs().max()) <= 5e-4


def test_store_dev_refused_for_a_no_op_layout(caplog):
    # left type 1, on the split-BC grid: the JAX engine runs its jnp step
    dev, exact = engine_pair(make_config(1, ny=32, nx=128), noop_mask(32, 128), caplog)
    assert_refused_and_exact(dev, exact, caplog, "no-op sides (left)")


@pytest.mark.parametrize("ny, nx", [(32, 64), (36, 128), (8, 128)], ids=["W64", "H36", "H8"])
def test_store_dev_refused_off_the_split_bc_grid(ny, nx, caplog):
    dev, exact = engine_pair(make_config(0, ny=ny, nx=nx), noop_mask(ny, nx), caplog)
    assert_refused_and_exact(dev, exact, caplog, "split-BC mode")


def test_store_dev_refused_on_a_mesh_of_narrow_blocks(caplog):
    # a 1x2 mesh of 32x64 blocks: rx > 1 with wl % 128 != 0 runs the JAX
    # jnp sharded step
    dev, exact = engine_pair(make_config(0, ny=32, nx=128), noop_mask(32, 128), caplog,
                             spatial_mesh="1x2")
    assert_refused_and_exact(dev, exact, caplog, "jnp sharded step")


def test_store_dev_refused_on_a_mesh_of_short_blocks(caplog):
    # a 4x1 mesh of 8x128 blocks: the block's split-BC mode needs hl >= 16
    dev, exact = engine_pair(make_config(0, ny=32, nx=128), noop_mask(32, 128), caplog,
                             spatial_mesh="4x1")
    assert_refused_and_exact(dev, exact, caplog, "hl >= 16")


def test_store_dev_refused_in_lockstep_below_65536_cells(caplog):
    # 32x128 engages in a serial engine; the lockstep engine runs its vmap
    # jnp chunk below 65536 cells
    cfgs = [make_config(0, ny=32, nx=128), make_config(0, ny=32, nx=128)]
    cfgs[1]["simulation"]["rho_in"] = 1.03
    masks = [noop_mask(32, 128)] * 2
    with caplog.at_level(logging.WARNING, logger=ENGINE_LOG):
        dev = BatchEngine(cfgs, masks, store_dev=True, device="cpu")
    exact = BatchEngine(cfgs, masks, device="cpu")
    assert not dev._store_dev
    assert len(caplog.records) == 1 and "65536 cells" in caplog.records[0].getMessage()
    for n in (9, 7):
        dev.run_step(n)
        exact.run_step(n)
    for k in ("f", "rho", "u", "f_post"):
        assert torch.equal(getattr(dev.state, k), getattr(exact.state, k)), k
    assert cs.engine_dev_storage_refusal(ts.make_params(cfgs[0], masks[0])) is None


# ---------------------------------------------------------------------------
# On the card: the kernels against their plain versions
# ---------------------------------------------------------------------------


def needs_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("bc_type, obstacle", CASES, ids=IDS)
def test_k1_no_op_ring_matches_plain_on_card(bc_type, obstacle):
    # the library loop and the closing full step, chunks of 1 and 8: the
    # ring threads that keep a no-op side's cells, fresh and later
    dev = needs_card()
    p = params(bc_type, obstacle, device=dev)
    scheme = cs.obstacle_scheme(p)
    a = b = seeded_state(device=dev)
    cs.reset_launch_counts()
    for n in (1, 8):
        a, ma = cs.run_chunk_cuda(a, p, n)
        b, mb = cs.run_chunk_plain(b, p, n)
        assert_equal(a, b)
        assert torch.equal(ma["force"], mb["force"]) and torch.equal(ma["max_v"], mb["max_v"])
    assert {k: v for k, v in cs.LAUNCHES.items() if v} == {
        cs.k1_variant(scheme): 7, cs.k1_variant(scheme, full=True): 2,
        cs.monitor_variant(scheme): 2}


@pytest.mark.cuda
@pytest.mark.parametrize("bc_type", [(1, 2, 1, 2), (0, 1, 1, 1), (3, 0, 4, 1)],
                         ids=["1212", "0111", "3041"])
@pytest.mark.parametrize("obstacle", ["equilibrium", "bounce_back"])
def test_k1_dev_no_op_ring_matches_plain_on_card(bc_type, obstacle):
    # the deviation-storage forms take RingPrev too (the engines never
    # engage them on such a layout): one fast step, then a later one
    dev = needs_card()
    p = params(bc_type, obstacle, device=dev)
    s0 = seeded_state(device=dev)
    aux = cs.pack_aux(p.damping, p.mask)
    obst = cs.obstacle_scheme(p)
    prof = p.inlet_profile if bc_type[0] == cs.BC_VEL_INLET else None
    prev = cs.RingPrev(s0.rho, s0.u)
    src = cs.quantize(s0.f)
    for i in range(2):
        a, b = torch.full_like(src, float("nan")), torch.full_like(src, float("nan"))
        pv = cs.prev_at_step(prev, i)
        cs.k1_step_dev(src, a, aux, cs.scalar_row(p, i + 1), p.use_les, p.bc_type, obst, prof,
                       prev=pv)
        cs.k1_step_dev_plain(src, b, aux, cs.scalar_row(p, i + 1), p.use_les, p.bc_type, obst,
                             prof, prev=pv)
        assert torch.equal(a.view(torch.int16), b.view(torch.int16))
        src = a


@pytest.mark.cuda
@pytest.mark.parametrize("bc_type, obstacle", CASES, ids=IDS)
def test_k1_shard_no_op_ring_matches_plain_on_card(bc_type, obstacle):
    # the _shard forms on a 2x2 mesh of one card, the library loop and the
    # per-step runner, bitwise the whole grid's plain chunk
    dev = needs_card()
    p = params(bc_type, obstacle, device=dev)
    mesh = make_mesh((2, 2), [dev] * 4)
    whole = seeded_state(device=dev)
    runners = [sh.BlockRunner(mesh, kind) for kind in ("cuda", "stepwise")]
    states = [r.place(whole, p) for r in runners]
    for n in (1, 8):
        whole, _ = cs.run_chunk_plain(whole, p, n)
        for r, bs in zip(runners, states):
            r.advance(bs, p, n)
            assert_equal(bs.snapshot(), whole)


@pytest.mark.cuda
def test_engines_run_a_no_op_layout_on_card(caplog):
    # the serial engine, a 1x1 spatial mesh and the lockstep engine take K1
    # for left type 1, the no-op layout a YAML can give; f16_state is
    # refused (logged) and the chunks are the plain runner's, bitwise
    dev = needs_card()
    cfg, mask = make_config(1, ny=32, nx=128), noop_mask(32, 128)
    p = ts.make_params(cfg, mask, device=dev)
    ref, _ = cs.run_chunk_plain(ts.init_state(32, 128, device=dev), p, 9)
    with caplog.at_level(logging.WARNING, logger=ENGINE_LOG):
        engines = [LBMEngine(cfg, mask, device=dev, store_dev=True),
                   LBMEngine(cfg, mask, device=dev, spatial_mesh="1x1"),
                   BatchEngine([cfg], [mask], store_dev=True, device=dev)]
    assert sum("no-op sides (left)" in r.getMessage() for r in caplog.records) == 2
    for eng in engines:
        cs.reset_launch_counts()
        eng.run_step(9)
        st = eng.state
        f = st.f[0] if st.f.dim() == 4 else st.f
        assert torch.equal(f, ref.f)
        launched = {k for k, v in cs.LAUNCHES.items() if v}
        # the lockstep engine's chunk is the group program (K1's _group
        # instances); every chunk's monitors are the monitor kernel's
        assert launched in ({"k1_step", "k1_step_full", "group_monitors"},
                            {"k1_step_shard", "k1_step_shard_full", "group_monitors"},
                            {"k1_step_group", "k1_step_group_full", "group_monitors"}), launched
