"""A lockstep group's chunk as one program (``cuda_step.run_chunk_group_cuda``
and its plain version, ``group_monitors``, ``parallel/batch.py``'s runner
choices), on the CPU.

- The plain group runner against the JAX ``run_chunk_batched`` (the vmap
  lockstep chunk, f32 on the CPU): fields within 1e-6, forces within 5e-6
  (relative to max(1, |F|)), the stable and alive flags equal chunk by
  chunk, a case that diverges mid-run frozen in both.
- The plain group runner bit for bit ``run_chunk_plain`` a case, for each
  obstacle scheme, with and without ``store_dev``, and on a layout with a
  no-op side; a dead case's state untouched.
- ``group_monitors_plain`` within 5e-6 of the eager ``obstacle_force`` /
  ``max_velocity`` / ``is_stable_device`` for the three force schemes, and
  a NaN in u away from every link read as unstable.
- Each ``--runner`` through ``BatchEngine`` and ``batch_datagen``'s and
  ``batch_run``'s argparse.

The JAX package is imported inside the test that compares with it. The
``cuda`` tests hold the kernels to their plain versions on the card and
skip here; on the card they run with ``--noconftest -m cuda``.
"""

import dataclasses
import sys

import numpy as np
import pytest
import torch

from lbm2d_tpu_torch.core import solver as ts
from lbm2d_tpu_torch.core.lattice import f_eq
from lbm2d_tpu_torch.core.stability import is_stable_device
from lbm2d_tpu_torch.ops import cuda_step as cs
from lbm2d_tpu_torch.parallel.batch import BatchEngine, init_batch_state, params_to
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

H, W = 32, 64
FORCE_TOL = 5e-6
VS_JAX_F32 = 1e-6
SCHEMES = [((0, 2, 1, 2), "equilibrium"), ((0, 2, 1, 2), "bounce_back"),
           ((3, 0, 1, 0), "bounce_back_halfway"), ((4, 2, 1, 2), "bounce_back_bouzidi"),
           ((1, 2, 1, 2), "equilibrium")]
SCHEME_IDS = ["eq-0212", "full-0212", "half-3010", "bouzidi-4212", "noop-1212"]
FORCE_SCHEMES = [s for s in SCHEMES if s[0] == (0, 2, 1, 2) and s[1] == "equilibrium"] + [
    SCHEMES[2], SCHEMES[3]]


def make_config(bc_type=(0, 2, 1, 2), obstacle="equilibrium", nu=0.02, rho_in=1.02,
                warmup=6, ny=H, nx=W):
    return {
        "simulation": {
            "nx": nx, "ny": ny, "nu": nu, "ghost_moments_s": 1.2, "rho_in": rho_in,
            "rho_out": 1.0, "warmup_steps": warmup, "smagorinsky_constant": 0.1,
            "characteristic_length": 8, "name": "group",
        },
        "domain_zones": {
            "sponge_in": 4, "sponge_out": 6, "sponge_top": 3, "sponge_bot": 3,
            "sponge_strength": 3.0,
        },
        "boundary_condition": {
            "type": [bc_type[0], 2, 1, 2] if cs.noop_sides(bc_type) else list(bc_type),
            "value": [[0.05, 0.0], [0.02, 0.01], [0.03, -0.01], [0.01, 0.02]],
            "obstacle": obstacle,
        },
    }


def disc_mask(c, ny=H, nx=W):
    """Case c's obstacle: a disc at its own place and size."""
    yy, xx = np.mgrid[0:ny, 0:nx]
    cy, cx, r2 = ny / 2 - 0.4 + (c % 3) - 1, nx / 3 + 0.3 + 4 * c, 20 + 8 * c
    return ((yy - cy) ** 2 + (xx - cx) ** 2 < r2).astype(np.float32)


def case_params(c, bc_type, obstacle, **kw):
    p = ts.make_params(make_config(bc_type, obstacle, nu=0.02 + 0.01 * c,
                                   rho_in=1.02 + 0.005 * c, **kw), disc_mask(c))
    return dataclasses.replace(p, bc_type=tuple(bc_type))


def seeded_group(B, seed=0, ny=H, nx=W, step=0):
    """A developed-looking stacked state, each case its own draw."""
    rng = np.random.default_rng(seed)
    st = init_batch_state(B, ny, nx)
    for c in range(B):
        rho = torch.tensor(1.0 + 0.01 * rng.standard_normal((ny, nx)), dtype=torch.float32)
        u = torch.tensor(0.03 * rng.standard_normal((2, ny, nx)), dtype=torch.float32)
        st.f[c] = f_eq(rho, u[0], u[1])
        st.f_post[c] = st.f[c] + torch.tensor(1e-3 * rng.standard_normal((9, ny, nx)),
                                             dtype=torch.float32)
        rho2 = torch.tensor(1.0 + 0.01 * rng.standard_normal((ny, nx)), dtype=torch.float32)
        st.rho[c] = rho2
        st.u[c] = torch.tensor(0.03 * rng.standard_normal((2, ny, nx)), dtype=torch.float32)
    st.step[:] = step
    return st


def case_of(st, c):
    return ts.LBMState(f=st.f[c].clone(), f_post=st.f_post[c].clone(), rho=st.rho[c].clone(),
                       u=st.u[c].clone(), step=int(st.step[c]))


def clone(st):
    return ts.LBMState(f=st.f.clone(), f_post=st.f_post.clone(), rho=st.rho.clone(),
                       u=st.u.clone(), step=st.step.clone())


def force_close(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return np.abs(a - b).max() <= FORCE_TOL * max(1.0, np.abs(b).max())


def unpack(packed, B):
    x = packed.cpu()
    return x[:2 * B].view(B, 2), x[2 * B:3 * B], x[3 * B:] > 0.5


# ---------------------------------------------------------------------------
# against the JAX vmap chunk
# ---------------------------------------------------------------------------


def test_group_plain_matches_jax_run_chunk_batched():
    from lbm2d_tpu.core.solver import make_params as jax_make_params
    from lbm2d_tpu.parallel.batch import init_batch_state as jax_init
    from lbm2d_tpu.parallel.batch import run_chunk_batched
    from lbm2d_tpu.parallel.batch import stack_params as jax_stack

    cfgs = [make_config(nu=0.02 + 0.01 * c, rho_in=1.02 + 0.01 * c, warmup=4) for c in range(3)]
    cfgs[1]["simulation"]["nu"] = -0.16  # tau < 1/2: unconditionally unstable
    cfgs[1]["simulation"]["warmup_steps"] = 1
    masks = [disc_mask(c) for c in range(3)]
    g = cs.GroupParams([ts.make_params(c, m) for c, m in zip(cfgs, masks)])
    pj = jax_stack([jax_make_params(c, m) for c, m in zip(cfgs, masks)])
    sj = jax_init(3, H, W)
    aj = np.ones(3, bool)
    st = init_batch_state(3, H, W)
    alive = [True] * 3
    frozen = None
    for chunk in range(6):
        sj, aj, mj = run_chunk_batched(sj, pj, aj, n_steps=10)
        st, al, packed = cs.run_chunk_group_plain(st, g, alive, 10)
        force, max_v, stable = unpack(packed, 3)
        np.testing.assert_array_equal(stable.numpy(), np.asarray(mj["stable"]))
        np.testing.assert_array_equal(al.numpy(), np.asarray(aj))
        alive = [bool(a) for a in al]
        for c in (0, 2):
            assert force_close(force[c], np.asarray(mj["force"])[c]), chunk
            for k in ("f", "rho", "u"):
                a = getattr(st, k)[c].numpy().astype(np.float64)
                b = np.asarray(getattr(sj, k))[c]
                err = np.abs(a - b).max() / (1.0 if k == "u" else np.abs(b).max())
                assert err <= VS_JAX_F32, (chunk, c, k, err)
        if not alive[1]:
            if frozen is None:
                frozen = case_of(st, 1)
            else:  # frozen bit for bit from the chunk it died in
                for k in ("f", "f_post", "rho", "u"):
                    assert torch.equal(getattr(st, k)[1].view(torch.int32),
                                       getattr(frozen, k).view(torch.int32)), k
    assert alive == [True, False, True] and frozen is not None
    assert st.step.tolist() == np.asarray(sj.step).tolist()


# ---------------------------------------------------------------------------
# bit for bit the per-case chunk runner
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("store_dev", [False, True], ids=["f32", "store_dev"])
@pytest.mark.parametrize("bc_type, obstacle", SCHEMES, ids=SCHEME_IDS)
def test_group_plain_equals_run_chunk_plain(bc_type, obstacle, store_dev):
    B = 3
    ps = [case_params(c, bc_type, obstacle) for c in range(B)]
    g = cs.GroupParams(ps)
    st = seeded_group(B, seed=1, step=3)
    before = clone(st)
    alive = [True, False, True]
    for n in (7, 1):  # straddles the warmup; a one-step chunk too
        ref = []
        for c in range(B):
            if alive[c]:
                ref.append(cs.run_chunk_plain(case_of(st, c), ps[c], n, store_dev))
            else:
                ref.append(None)
        st, al, packed = cs.run_chunk_group_plain(st, g, alive, n, store_dev)
        force, max_v, stable = unpack(packed, B)
        for c in range(B):
            if ref[c] is None:
                continue
            sc, mon = ref[c]
            for k in ("f", "f_post", "rho", "u"):
                assert torch.equal(getattr(st, k)[c], getattr(sc, k)), (n, c, k)
            assert int(st.step[c]) == sc.step
            assert torch.equal(max_v[c], mon["max_v"])
            assert force_close(force[c], mon["force"])
            assert bool(stable[c]) == bool(is_stable_device(mon["force"], mon["max_v"], sc.step,
                                                            ps[c].warmup_steps))
    for k in ("f", "f_post", "rho", "u"):  # the dead case: every bit kept
        assert torch.equal(getattr(st, k)[1], getattr(before, k)[1]), k
    assert st.step.tolist() == [11, 3, 11]


def test_group_with_every_case_dead_leaves_the_state():
    ps = [case_params(c, (0, 2, 1, 2), "equilibrium") for c in range(2)]
    g = cs.GroupParams(ps)
    st = seeded_group(2, seed=2)
    before = clone(st)
    st, al, packed = cs.run_chunk_group_plain(st, g, [False, False], 5, True)
    for k in ("f", "f_post", "rho", "u"):
        assert torch.equal(getattr(st, k), getattr(before, k)), k
    assert st.step.tolist() == [0, 0] and not al.any()


def test_group_params_refuses_mixed_groups():
    a = case_params(0, (0, 2, 1, 2), "equilibrium")
    b = case_params(1, (0, 2, 1, 2), "bounce_back")
    with pytest.raises(ValueError, match="share"):
        cs.GroupParams([a, b])
    with pytest.raises(ValueError, match="at least one"):
        cs.GroupParams([])


# ---------------------------------------------------------------------------
# the monitors
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("later", [False, True], ids=["warmup", "later"])
@pytest.mark.parametrize("bc_type, obstacle", FORCE_SCHEMES,
                         ids=["equilibrium", "halfway", "bouzidi"])
def test_group_monitors_plain_matches_eager(bc_type, obstacle, later):
    B = 3
    ps = [case_params(c, bc_type, obstacle) for c in range(B)]
    g = cs.GroupParams(ps)
    st = seeded_group(B, seed=3)
    st.u[2] *= 12.0  # past V_THRESHOLD: unstable only after the warmup
    packed, al = cs.group_monitors_plain(st.f_post, st.u, g, [True, True, False], [later] * B)
    force, max_v, stable = unpack(packed, B)
    for c in range(B):
        f_ref = ts.obstacle_force(st.f_post[c], ps[c])
        v_ref = ts.max_velocity(st.u[c])
        assert force_close(force[c], f_ref), (c, force[c], f_ref)
        assert torch.equal(max_v[c], v_ref)
        step = int(ps[c].warmup_steps) + (1 if later else 0)
        assert bool(stable[c]) == bool(is_stable_device(f_ref, v_ref, step, ps[c].warmup_steps))
    assert bool(stable[2]) == (not later)
    assert al.tolist() == [bool(stable[0]), bool(stable[1]), False]


def test_boundary_links_are_the_force_links():
    p = case_params(0, (0, 2, 1, 2), "equilibrium")
    links = cs.boundary_links(p).numpy()
    solid = disc_mask(0) > 0.5
    want = 0
    for j in range(1, 9):
        ex, ey = int(cs.E_LAT[j, 0]), int(cs.E_LAT[j, 1])
        nb = np.zeros_like(solid)
        nb[max(0, -ey):H - max(0, ey), max(0, -ex):W - max(0, ex)] = solid[
            max(0, ey):H - max(0, -ey), max(0, ex):W - max(0, -ex)]
        want += int((~solid & nb).sum())
    assert len(links) == want > 0
    cells, js = links >> cs.LINK_CELL_SHIFT, links & 15
    assert not solid.reshape(-1)[cells].any() and ((js >= 1) & (js <= 8)).all()


def test_nan_in_u_reads_unstable():
    # a NaN planted in u far from every obstacle link: torch.max keeps it,
    # so the case reads unstable (fmaxf would drop it and keep it alive)
    B = 2
    ps = [case_params(c, (0, 2, 1, 2), "equilibrium") for c in range(B)]
    g = cs.GroupParams(ps)
    st = seeded_group(B, seed=4)
    st.u[1, 0, 3, W - 5] = float("nan")
    packed, al = cs.group_monitors_plain(st.f_post, st.u, g, [True, True], [False, False])
    force, max_v, stable = unpack(packed, B)
    assert torch.isnan(max_v[1]) and not torch.isnan(max_v[0])
    assert stable.tolist() == [True, False] and al.tolist() == [True, False]
    assert torch.isfinite(force).all()
    # through the group program: a NaN in one case's f spreads into its u
    # and kills that case alone, whose state then stays as it was left
    st = seeded_group(B, seed=4)
    st.f[1, :, 3, W - 5] = float("nan")
    st, al, packed = cs.run_chunk_group_plain(st, g, [True, True], 2)
    assert al.tolist() == [True, False]
    frozen = case_of(st, 1)
    st, al, _ = cs.run_chunk_group_plain(st, g, al.tolist(), 3)
    for k in ("f", "f_post", "rho", "u"):  # raw bits: NaN != NaN
        assert torch.equal(getattr(st, k)[1].view(torch.int32),
                           getattr(frozen, k).view(torch.int32)), k
    assert st.step.tolist() == [5, 2]


# ---------------------------------------------------------------------------
# the runner choices
# ---------------------------------------------------------------------------


def _engine_configs(n, nx=W, ny=H, f16=False):
    cfgs = []
    for c in range(n):
        cfg = make_config(nu=0.02 + 0.01 * c, rho_in=1.02 + 0.005 * c, nx=nx, ny=ny)
        cfg["simulation"]["f16_state"] = f16
        cfgs.append(cfg)
    return cfgs, [disc_mask(c, ny, nx) for c in range(n)]


@pytest.mark.parametrize("runner, big, small", [("auto", True, False), ("vmap", False, False),
                                                ("pallas", True, True),
                                                ("sharded", True, False)])
def test_runner_store_dev_rule(runner, big, small):
    # the JAX BatchEngine's rule (lbm2d_tpu/parallel/batch.py:336-347):
    # 1024x64 = 65,536 cells and 64x128 = 8,192, both split-BC grids
    for (ny, nx), want in (((64, 1024), big), ((64, 128), small)):
        cfgs, masks = _engine_configs(2, nx, ny, f16=True)
        eng = BatchEngine(cfgs, masks, device="cpu", runner=runner)
        assert eng._store_dev is want, (runner, ny, nx)


@pytest.mark.parametrize("runner", ["auto", "vmap", "pallas", "sharded"])
def test_runner_choices_through_the_engine(runner):
    cfgs, masks = _engine_configs(3)
    kw = {"n_devices": 2} if runner == "sharded" else {}
    eng = BatchEngine(cfgs, masks, device="cpu", runner=runner, **kw)
    # on the CPU pallas runs the group program's plain version, the others
    # the eager step a case
    assert (eng._groups[0].tables is not None) == (runner == "pallas")
    ps = [ts.make_params(c, m) for c, m in zip(cfgs, masks)]
    mons = [eng.run_step(6), eng.run_step(4)]
    run = cs.run_chunk_plain if runner == "pallas" else ts.run_chunk
    for c in range(3):
        ref, mon = run(ts.init_state(H, W), ps[c], 6)
        ref, mon = run(ref, ps[c], 4)
        for k in ("f", "f_post", "rho", "u"):
            assert torch.equal(getattr(eng.state, k)[c], getattr(ref, k)), (c, k)
        assert mons[-1]["max_v"][c] == float(mon["max_v"])
        assert force_close(mons[-1]["force"][c], mon["force"].numpy())
    assert eng.state.step.tolist() == [10, 10, 10] and eng.alive_mask.all()
    moments = eng.get_moments_device()
    assert moments.shape == (3, 9, H, W) and moments.is_contiguous()
    assert torch.equal(moments[1], ts.moments_output(case_of(eng.state, 1)))
    assert torch.equal(eng.get_velocity_device(), eng.state.u)


def test_set_state_round_trip_on_the_group_program():
    cfgs, masks = _engine_configs(3)
    a = BatchEngine(cfgs, masks, device="cpu", runner="pallas")
    a.run_step(5)
    b = BatchEngine(cfgs, masks, device="cpu", runner="pallas")
    b.set_state(clone(a.state), np.array([True, False, True]))
    a.set_state(clone(a.state), np.array([True, False, True]))
    kept = clone(b.state)
    a.run_step(5)
    b.run_step(5)
    for k in ("f", "f_post", "rho", "u"):
        assert torch.equal(getattr(a.state, k), getattr(b.state, k)), k
        assert torch.equal(getattr(b.state, k)[1], getattr(kept, k)[1]), k
    assert b.state.step.tolist() == [10, 5, 10]


@pytest.mark.parametrize("runner", ["auto", "vmap", "pallas", "sharded"])
def test_cli_runner_choices(runner, monkeypatch):
    from lbm2d_tpu_torch.pipeline import batch_datagen, batch_run

    seen = {}
    monkeypatch.setattr(batch_datagen, "run_batched",
                        lambda *a, **kw: seen.setdefault("datagen", kw))
    monkeypatch.setattr(sys, "argv", ["batch_datagen", "--project_name", "P", "--runner",
                                      runner, "--device", "cpu"])
    batch_datagen.main()
    assert seen["datagen"]["runner"] == runner
    monkeypatch.setattr(batch_run, "run_batch", lambda *a, **kw: seen.setdefault("run", kw))
    monkeypatch.setattr(sys, "argv", ["batch_run", "--project_name", "P", "--lockstep",
                                      "--runner", runner, "--device", "cpu"])
    batch_run.main()
    assert seen["run"]["runner"] == runner and seen["run"]["lockstep"]
    monkeypatch.setattr(sys, "argv", ["batch_datagen", "--project_name", "P", "--runner",
                                      "lockstep"])
    with pytest.raises(SystemExit):
        batch_datagen.main()


# ---------------------------------------------------------------------------
# on the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _on(st, dev):
    return ts.LBMState(f=st.f.to(dev), f_post=st.f_post.to(dev), rho=st.rho.to(dev),
                       u=st.u.to(dev), step=st.step.clone())


@pytest.mark.cuda
@pytest.mark.parametrize("store_dev", [False, True], ids=["f32", "store_dev"])
@pytest.mark.parametrize("bc_type, obstacle", SCHEMES, ids=SCHEME_IDS)
def test_group_program_on_the_card(cuda_dev, bc_type, obstacle, store_dev):
    # the group program against its plain version on the card and against
    # run_chunk_cuda a case, bitwise; one K1 launch a step for the group
    B = 3
    ps = [params_to(case_params(c, bc_type, obstacle), cuda_dev) for c in range(B)]
    g = cs.GroupParams(ps)
    host = seeded_group(B, seed=5, step=3)
    alive = [True, False, True]
    outs = []
    for plain in (False, True):
        st = _on(host, cuda_dev)
        cs.reset_launch_counts()
        run = cs.run_chunk_group_plain if plain else cs.run_chunk_group_cuda
        for n in (7, 1):
            st, al, packed = run(st, g, alive, n, store_dev)
        torch.cuda.synchronize()
        outs.append((st, packed, dict(cs.LAUNCHES), dict(cs.CASE_STEPS)))
    (a, pa, la, ca), (b, pb, lb, _) = outs
    for k in ("f", "f_post", "rho", "u"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert torch.equal(pa, pb)
    dev = store_dev and cs.obstacle_scheme(ps[0]) in cs.DEV_OBSTACLES and not cs.noop_sides(
        bc_type)
    fast = cs.k1_variant(cs.obstacle_scheme(ps[0]), dev=dev, group=True)
    full = cs.k1_variant(cs.obstacle_scheme(ps[0]), full=True, group=True)
    mon = cs.monitor_variant(cs.obstacle_scheme(ps[0]))
    assert {k: v for k, v in la.items() if v} == {fast: 6, full: 2, mon: 2}
    assert ca[fast] == 12 and ca[full] == 4 and ca[mon] == 6
    assert not any(lb.values())
    for c in (0, 2):
        sc, _ = cs.run_chunk_cuda(case_of(_on(host, cuda_dev), c), ps[c], 7, store_dev)
        sc, _ = cs.run_chunk_cuda(sc, ps[c], 1, store_dev)
        for k in ("f", "f_post", "rho", "u"):
            assert torch.equal(getattr(a, k)[c], getattr(sc, k)), (c, k)
    for k in ("f", "f_post", "rho", "u"):
        assert torch.equal(getattr(a, k)[1].cpu(), getattr(host, k)[1]), k


@pytest.mark.cuda
@pytest.mark.parametrize("bc_type, obstacle", FORCE_SCHEMES,
                         ids=["equilibrium", "halfway", "bouzidi"])
def test_group_monitors_on_the_card(cuda_dev, bc_type, obstacle):
    B = 3
    ps = [params_to(case_params(c, bc_type, obstacle), cuda_dev) for c in range(B)]
    g = cs.GroupParams(ps)
    st = _on(seeded_group(B, seed=6), cuda_dev)
    st.u[2, 1, 5, 7] = float("nan")
    for later in (False, True):
        ka, kal = cs.group_monitors(st.f_post, st.u, g, [True] * B, [later] * B)
        pa, pal = cs.group_monitors_plain(st.f_post, st.u, g, [True] * B, [later] * B)
        torch.cuda.synchronize()
        assert torch.equal(ka[:3 * B], pa[:3 * B]) or (
            torch.equal(ka[:2 * B], pa[:2 * B]) and torch.isnan(ka[2 * B + 2]))
        assert torch.equal(ka[3 * B:], pa[3 * B:]) and torch.equal(kal, pal)
        assert not bool(kal[2])


@pytest.mark.cuda
def test_group_instances_do_not_spill(cuda_dev):
    from lbm2d_tpu_torch.ops import cuda_build

    cuda_build.build_all()
    regs = cuda_build.k1_group_registers(cuda_build.BUILD_LOG["k1_step"])
    assert len(regs) == 10
    for key, use in regs.items():
        assert use[1:] == (0, 0), (key, use)
    mon = cuda_build.monitor_registers(cuda_build.BUILD_LOG["monitors"])
    assert set(mon) == {False, True} and all(u[1:] == (0, 0) for u in mon.values())
