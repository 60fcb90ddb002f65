"""The monitor kernel's forms (``csrc/monitors.cu``) through their plain
versions on the CPU, and (on a card only) the kernel itself.

Every chunk path's monitors are one launch of the monitor kernel: a
lockstep group (``cuda_step.group_monitors``), a serial chunk's case, a
group of one (``case_monitors``), the DFG path's cylinder-only force over
another mask (``case_force``) and a mesh's blocks
(``parallel/sharded.kernel_block_monitors``: one launch a card over its
blocks' window links, or on a one-device mesh the global f_post's links
and the blocks' u). The force is an f64 sum in one fixed order
(``cuda_step.monitor_sum_plain``), so limits against other orders, each
relative to max(1, |F|) and set from a reading on the CPU:

- the plain order against the eager force in float64, for the three force
  sums (equilibrium and full-way share one) x {a group of 5 with a dead
  case, one case, the DFG override mask, 2x2 blocks of each window rule}:
  5e-6 (read below 1e-7); max |u| bitwise the eager ``max_velocity``, a
  NaN in u kept;
- the plain serial chunk against the JAX jnp ``run_chunk`` and
  ``run_chunk_pallas(interpret=True)``: the existing force limits, 2e-6
  absolute and 5e-6 of max(1, |F|);
- the DFG override force through the port's wrapper on CPU tensors against
  the JAX ``obstacle_force(mask=)`` on the same f_post: the same limits;
- the 2x2 plain mesh's monitors against the JAX ``run_chunk_sharded``'s:
  the same limits.

The JAX package is imported inside the tests that compare with it. The
``cuda`` tests hold each kernel form to its plain version bitwise on the
card and skip here; on the card they run with ``--noconftest -m cuda``.
"""

import dataclasses

import numpy as np
import pytest
import torch

from lbm2d_tpu_torch.core import solver as ts
from lbm2d_tpu_torch.core.lattice import f_eq
from lbm2d_tpu_torch.ops import cuda_step as cs
from lbm2d_tpu_torch.parallel import sharded as sh
from lbm2d_tpu_torch.parallel import topology
from lbm2d_tpu_torch.parallel.topology import BlockState, make_mesh
from torch_monitor_checks import FORCE_TOL, eager_force64, force_err
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

H, W = 32, 64
STEPS = 9
FORCE_ATOL = 2e-6
SCHEMES = ("equilibrium", "bounce_back", "bounce_back_halfway", "bounce_back_bouzidi")
FORMS = ("group5_dead", "one_case", "dfg_mask", "blocks_2x2")


def make_config(obstacle="equilibrium", bc_type=(0, 2, 1, 2), nu=0.02, ny=H, nx=W):
    return {
        "simulation": {
            "nx": nx, "ny": ny, "nu": nu, "ghost_moments_s": 1.2,
            "rho_in": 1.02, "rho_out": 1.0, "warmup_steps": 12,
            "smagorinsky_constant": 0.1,
        },
        "domain_zones": {
            "sponge_in": 4, "sponge_out": 6, "sponge_top": 3, "sponge_bot": 3,
            "sponge_strength": 3.0,
        },
        "boundary_condition": {
            "type": list(bc_type),
            "value": [[0.05, 0.0], [0.02, 0.01], [0.03, -0.01], [0.01, 0.02]],
            "obstacle": obstacle,
        },
    }


def make_mask(ny=H, nx=W):
    """Channel walls (the DFG override drops them), a disc across the 2x2
    mesh's seams, solids on the global edge and beside the seams."""
    yy, xx = np.mgrid[:ny, :nx]
    mask = ((yy - ny / 2 + 0.5) ** 2 + (xx - nx / 2 + 0.5) ** 2 <= 36).astype(np.float32)
    mask[0, :] = mask[-1, :] = 1.0
    mask[5:9, 0] = 1.0  # on the left edge
    mask[ny // 2 - 1, 3] = mask[ny // 2, 9] = 1.0  # on and beside the y seam
    mask[4, nx // 2] = mask[ny - 6, nx // 2 - 1] = 1.0  # either side of the x seam
    return mask


def walls_excluded(mask):
    cyl = mask.copy()
    cyl[0, :] = cyl[-1, :] = 0.0
    return torch.as_tensor(cyl)


def seeded_state(seed=0, ny=H, nx=W):
    rng = np.random.default_rng(seed)
    rho = torch.tensor(1.0 + 0.01 * rng.standard_normal((ny, nx)), dtype=torch.float32)
    u = torch.tensor(0.03 * rng.standard_normal((2, ny, nx)), dtype=torch.float32)
    f = f_eq(rho, u[0], u[1])
    # f_post apart from f, so the force reads its own planes
    fp = f * torch.tensor(1.0 + 0.05 * rng.standard_normal((9, ny, nx)), dtype=torch.float32)
    return ts.LBMState(f=f, f_post=fp, rho=rho, u=u, step=0)


def case_params(obstacle, nu=0.02, device="cpu"):
    return ts.make_params(make_config(obstacle, nu=nu), make_mask(), device=device)


def two_dev_mesh(dev_a, dev_b):
    """A 2x2 mesh over two device objects (so not a one-device mesh): its
    blocks take the per-card block form."""
    return make_mesh((2, 2), [dev_a, dev_b, dev_b, dev_a])


def halo_state(state, p, mesh):
    """``state`` placed on ``mesh``'s halo'd blocks with the runner's
    pitch, and the case's ``BlockMonitors``."""
    case = sh.ShardedCase(p, mesh)
    bs = BlockState.place(state, mesh, halo=1, pitch=case.pitch)
    return bs, case


# ---------------------------------------------------------------------------
# The plain order against the eager monitors in float64
# ---------------------------------------------------------------------------


def plain_form(form, obstacle, state, nan_at=None):
    """(force f32 [n, 2], max_v [n], eager force f64 [n, 2], eager max_v
    [n]) of a form's plain monitors, n its outputs."""
    p = case_params(obstacle)
    if form == "group5_dead":
        ps = [case_params(obstacle, nu=0.02 + 0.005 * c) for c in range(5)]
        g = cs.GroupParams(ps)
        fp = torch.stack([state.f_post * (1.0 + 1e-3 * c) for c in range(5)])
        u = torch.stack([state.u * (1.0 + 0.01 * c) for c in range(5)])
        if nan_at is not None:
            u[3][nan_at] = float("nan")
        packed, _ = cs.group_monitors_plain(fp, u, g, [c != 1 for c in range(5)], [True] * 5)
        force = packed[:10].reshape(5, 2)
        return (force, packed[10:15], torch.stack([eager_force64(fp[c], ps[c]) for c in range(5)]),
                torch.stack([ts.max_velocity(u[c]) for c in range(5)]))
    u = state.u.clone()
    if nan_at is not None:
        u[nan_at] = float("nan")
    if form == "one_case":
        m = cs.case_monitors_plain(state.f_post, u, cs.case_links(p))
        return (m["force"][None], m["max_v"][None], eager_force64(state.f_post, p)[None],
                ts.max_velocity(u)[None])
    if form == "dfg_mask":
        cyl = walls_excluded(make_mask())
        force = cs.case_force_plain(state.f_post, cs.CaseLinks(p, mask=cyl))
        return force[None], None, eager_force64(state.f_post, p, mask=cyl)[None], None
    mesh = two_dev_mesh(torch.device("cpu"), torch.device("cpu", 0))
    bs, case = halo_state(dataclasses.replace(state, u=u), p, mesh)
    m = sh.kernel_block_monitors(bs, case.monitors, plain=True)
    return (m["force"][None], m["max_v"][None], eager_force64(state.f_post, p)[None],
            ts.max_velocity(u)[None])


@pytest.mark.parametrize("form", FORMS)
@pytest.mark.parametrize("obstacle", SCHEMES)
def test_plain_order_matches_eager_f64(obstacle, form):
    force, max_v, ref, ref_v = plain_form(form, obstacle, seeded_state(1))
    assert force.dtype == torch.float32
    for c in range(force.shape[0]):
        assert float(ref[c].abs().max()) > 0.05  # the links carry a force
        assert force_err(force[c], ref[c]) <= FORCE_TOL, (c, force[c], ref[c])
    if max_v is not None:
        assert torch.equal(max_v, ref_v)


@pytest.mark.parametrize("form", ["group5_dead", "one_case", "blocks_2x2"])
def test_nan_in_u_is_kept(form):
    # a NaN far from every link: torch.max keeps it, and so must the order
    force, max_v, _, ref_v = plain_form(form, "equilibrium", seeded_state(2), (0, 20, 5))
    assert torch.isnan(max_v).tolist() == torch.isnan(ref_v).tolist()
    assert torch.isnan(max_v).any() and torch.isfinite(force).all()


def test_empty_and_single_link_sums():
    z = cs.monitor_sum_plain(torch.zeros(0, dtype=torch.float64))
    assert z.item() == 0.0 and not torch.signbit(z)
    one = cs.monitor_sum_plain(torch.tensor([-0.25], dtype=torch.float64))
    assert one.item() == -0.25
    # more links than lanes: each lane adds its terms in order; every
    # partial and the final sum match a sum of the same terms in float64
    t = torch.tensor(np.random.default_rng(3).standard_normal(3 * cs.MON_LINK_LANES + 17))
    assert abs(cs.monitor_sum_plain(t).item() - float(t.sum())) <= 1e-12


@pytest.mark.parametrize("obstacle", SCHEMES)
def test_window_links_partition_the_links(obstacle):
    """Each global boundary link falls in exactly one block's window, by
    the scheme's rule (solid cell in the block for equilibrium and
    full-way, fluid cell for half-way and Bouzidi), and reads the same
    cell through the block's halo'd layout."""
    p = case_params(obstacle)
    mesh = two_dev_mesh(torch.device("cpu"), torch.device("cpu", 0))
    case = sh.ShardedCase(p, mesh)
    hl, wl, pitch = case.hl, case.wl, case.pitch
    links = cs.boundary_links(p)
    seen = []
    for dev, (ml, blocks) in case.monitors.cards.items():
        for c, (iy, ix) in enumerate(blocks):
            lk = ml.links_host[c].long()
            local, flags = lk >> cs.LINK_CELL_SHIFT, lk & 31
            y = iy * hl + local // pitch - 1
            x = ix * wl + local % pitch - 1
            seen.append((((y * W + x) << cs.LINK_CELL_SHIFT) | flags).to(torch.int32))
            j = lk & 15
            e = torch.as_tensor(cs.E_LAT, dtype=torch.long)
            ry, rx = (y + e[j, 1], x + e[j, 0]) if obstacle in ("equilibrium",
                                                                 "bounce_back") else (y, x)
            assert ((ry // hl == iy) & (rx // wl == ix)).all()
    seen = torch.cat(seen)
    assert sorted(seen.tolist()) == sorted(links.tolist())
    # the seams cut links under either rule
    assert all(ml.links_host[c].numel() for ml, bl in case.monitors.cards.values()
               for c in range(len(bl)))


def test_serial_chunk_monitors_are_one_plain_call(monkeypatch):
    """``run_chunk_plain`` returns the plain monitors of its f_post and u,
    built from links cut once per params object."""
    p = case_params("bounce_back_bouzidi")
    s0 = seeded_state(4)
    calls = []
    real = cs.CaseLinks.__init__

    def counting(self, *a, **kw):
        calls.append(1)
        real(self, *a, **kw)

    monkeypatch.setattr(cs.CaseLinks, "__init__", counting)
    a, ma = cs.run_chunk_plain(s0, p, 3)
    b, mb = cs.run_chunk_plain(a, p, 3)
    assert len(calls) == 1
    want = cs.case_monitors_plain(b.f_post, b.u, cs.case_links(p))
    assert torch.equal(mb["force"], want["force"]) and torch.equal(mb["max_v"], want["max_v"])


# ---------------------------------------------------------------------------
# Against the JAX package
# ---------------------------------------------------------------------------


def _jax():
    import jax

    jax.config.update("jax_enable_x64", True)
    from lbm2d_tpu.core import solver as js

    return jax, js


def jax_state(st):
    from lbm2d_tpu.core import solver as js

    return js.LBMState(f=st.f.numpy(), f_post=st.f_post.numpy(), rho=st.rho.numpy(),
                       u=st.u.numpy(), step=np.int32(st.step))


def assert_force_close(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    assert np.abs(got - want).max() <= FORCE_ATOL, (got, want)
    assert np.abs(got - want).max() <= FORCE_TOL * max(1.0, np.abs(want).max()), (got, want)


@pytest.mark.parametrize("obstacle", ["equilibrium", "bounce_back_halfway",
                                      "bounce_back_bouzidi"])
def test_plain_serial_chunk_matches_jax(obstacle):
    _, js = _jax()
    from lbm2d_tpu.ops.pallas_step import run_chunk_pallas

    cfg, mask = make_config(obstacle), make_mask()
    pt = ts.make_params(cfg, mask)
    pj = js.make_params(cfg, mask)
    s0 = seeded_state(5)
    st, mt = cs.run_chunk_plain(s0, pt, STEPS)
    sj, mj = js.run_chunk(jax_state(s0), pj, STEPS)
    sp, mp = run_chunk_pallas(jax_state(s0), pj, n_steps=STEPS, interpret=True, split_bc=False)
    for ref in (mj, mp):
        assert_force_close(mt["force"].numpy(), ref["force"])
        assert abs(float(mt["max_v"]) - float(ref["max_v"])) <= 1e-6


@pytest.mark.parametrize("obstacle", ["bounce_back", "bounce_back_halfway",
                                      "bounce_back_bouzidi"])
def test_dfg_override_force_matches_jax(obstacle):
    _, js = _jax()
    import jax.numpy as jnp

    cfg, mask = make_config(obstacle), make_mask()
    pt = ts.make_params(cfg, mask)
    pj = js.make_params(cfg, mask)
    st = seeded_state(6)
    cyl = walls_excluded(mask)
    got = cs.case_force(st.f_post, cs.CaseLinks(pt, mask=cyl))
    want = js.obstacle_force(jnp.asarray(st.f_post.numpy()), pj, mask=jnp.asarray(cyl.numpy()))
    assert_force_close(got.numpy(), want)
    # the walls are excluded: the whole mask's force differs
    assert not np.allclose(got.numpy(), cs.case_force(st.f_post, cs.case_links(pt)).numpy())


@pytest.mark.parametrize("obstacle", ["equilibrium", "bounce_back_bouzidi"])
def test_plain_mesh_monitors_match_jax_sharded(obstacle):
    jax, js = _jax()
    from lbm2d_tpu.parallel import sharded as jsh
    from lbm2d_tpu.parallel.topology import make_mesh as jax_mesh
    from lbm2d_tpu.parallel.topology import shard_state as jax_shard_state

    assert len(jax.devices()) >= 4, "needs the root conftest's host devices"
    cfg, mask = make_config(obstacle), make_mask()
    pt = ts.make_params(cfg, mask)
    s0 = seeded_state(7)
    jm = jax_mesh(shape=(2, 2), devices=jax.devices()[:4])
    sj0, pj = jax_shard_state(jax_state(s0), js.make_params(cfg, mask), jm)
    _, mj = jsh.run_chunk_sharded(sj0, pj, n_steps=STEPS, mesh=jm, ny=H, nx=W)
    for mesh in (make_mesh((2, 2), ["cpu"] * 4),
                 two_dev_mesh(torch.device("cpu"), torch.device("cpu", 0))):
        st, mt = sh.run_chunk_sharded_plain(s0, pt, STEPS, mesh)
        assert_force_close(mt["force"].numpy(), mj["force"])
        assert abs(float(mt["max_v"]) - float(mj["max_v"])) <= 1e-6
        # and the cuda runner's wrappers on CPU tensors give the same bits
        _, mc = sh.run_chunk_sharded_cuda(s0, pt, STEPS, mesh)
        assert torch.equal(mc["force"], mt["force"]) and torch.equal(mc["max_v"], mt["max_v"])


# ---------------------------------------------------------------------------
# The repair: no quiet CPU mesh
# ---------------------------------------------------------------------------


def test_make_mesh_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        make_mesh()
    with pytest.raises(RuntimeError, match="no CUDA device"):
        topology.make_mesh((1, 1))
    mesh = make_mesh((2, 1), ["cpu"] * 2)  # a CPU mesh is named
    assert mesh.grid == (2, 1) and mesh.single_device == torch.device("cpu")


# ---------------------------------------------------------------------------
# On the card: each kernel form bitwise its plain version
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the monitor kernel has no CPU form)")
    return torch.device("cuda", 0)


def _bits(t):
    return t.contiguous().view(torch.int32 if t.element_size() == 4 else torch.int64)


def _on(state, dev):
    return ts.LBMState(f=state.f.to(dev), f_post=state.f_post.to(dev), rho=state.rho.to(dev),
                       u=state.u.to(dev), step=state.step)


@pytest.mark.cuda
@pytest.mark.parametrize("obstacle", SCHEMES)
@pytest.mark.parametrize("shape", [(H, W), (21, 37)], ids=["aligned", "odd"])
def test_case_forms_on_the_card(cuda_dev, obstacle, shape):
    """A group of one and the DFG mask's force-only form, on an aligned
    grid (16-byte u loads) and an odd one (the scalar path)."""
    ny, nx = shape
    p = ts.make_params(make_config(obstacle, ny=ny, nx=nx), make_mask(ny, nx), device=cuda_dev)
    st = _on(seeded_state(8, ny, nx), cuda_dev)
    st.u[1, 2, 3] = float("nan")
    cl = cs.case_links(p)
    before = cs.LAUNCHES[cs.monitor_variant(cs.obstacle_scheme(p))]
    km = cs.case_monitors(st.f_post, st.u, cl)
    pm = cs.case_monitors_plain(st.f_post, st.u, cl)
    cyl = cs.CaseLinks(p, mask=walls_excluded(make_mask(ny, nx)).to(cuda_dev))
    kf, pf = cs.case_force(st.f_post, cyl), cs.case_force_plain(st.f_post, cyl)
    torch.cuda.synchronize()
    assert torch.equal(_bits(km["force"]), _bits(pm["force"]))
    assert torch.isnan(km["max_v"]) and torch.isnan(pm["max_v"])
    assert torch.equal(_bits(kf), _bits(pf))
    st.u[1, 2, 3] = 0.0
    km = cs.case_monitors(st.f_post, st.u, cl)
    assert torch.equal(_bits(km["max_v"]), _bits(ts.max_velocity(st.u)))
    assert cs.LAUNCHES[cs.monitor_variant(cs.obstacle_scheme(p))] == before + 3


@pytest.mark.cuda
@pytest.mark.parametrize("obstacle", ["equilibrium", "bounce_back_bouzidi"])
def test_group_of_five_on_the_card(cuda_dev, obstacle):
    ps = [case_params(obstacle, 0.02 + 0.005 * c, cuda_dev) for c in range(5)]
    g = cs.GroupParams(ps)
    st = _on(seeded_state(9), cuda_dev)
    fp = torch.stack([st.f_post * (1.0 + 1e-3 * c) for c in range(5)]).contiguous()
    u = torch.stack([st.u * (1.0 + 0.01 * c) for c in range(5)]).contiguous()
    alive = [c != 1 for c in range(5)]
    for later in (False, True):
        ka, kal = cs.group_monitors(fp, u, g, alive, [later] * 5)
        pa, pal = cs.group_monitors_plain(fp, u, g, alive, [later] * 5)
        torch.cuda.synchronize()
        assert torch.equal(_bits(ka), _bits(pa)) and torch.equal(kal, pal)


@pytest.mark.cuda
@pytest.mark.parametrize("obstacle", SCHEMES)
@pytest.mark.parametrize("one_device", [True, False], ids=["one_device", "blocks"])
def test_mesh_forms_on_the_card(cuda_dev, obstacle, one_device):
    """A 2x2 mesh's monitors: on one device the global f_post's links and
    the blocks' u in one launch (the serial force, bitwise); over two
    device objects of the card the per-card block form (each card's
    blocks one launch, the window links, the seams' halos)."""
    p = case_params(obstacle, device=cuda_dev)
    st = _on(seeded_state(10), cuda_dev)
    mesh = (make_mesh((2, 2), [cuda_dev] * 4) if one_device
            else two_dev_mesh(torch.device("cuda"), cuda_dev))
    bs, case = halo_state(st, p, mesh)
    km = sh.kernel_block_monitors(bs, case.monitors)
    pm = sh.kernel_block_monitors(bs, case.monitors, plain=True)
    torch.cuda.synchronize()
    assert torch.equal(_bits(km["force"]), _bits(pm["force"]))
    assert torch.equal(_bits(km["max_v"]), _bits(ts.max_velocity(st.u)))
    assert force_err(km["force"], eager_force64(st.f_post, p)) <= FORCE_TOL
    if one_device:
        serial = cs.case_monitors(st.f_post, st.u, cs.case_links(p))
        assert torch.equal(_bits(km["force"]), _bits(serial["force"]))


@pytest.mark.cuda
def test_monitor_instances_do_not_spill(cuda_dev):
    from lbm2d_tpu_torch.ops import cuda_build

    cuda_build.build_all()
    mon = cuda_build.monitor_registers(cuda_build.BUILD_LOG["monitors"])
    assert set(mon) == {False, True} and all(u[1:] == (0, 0) for u in mon.values())
