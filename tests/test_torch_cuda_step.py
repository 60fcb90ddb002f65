"""The CUDA chunk runner's contract, checked through the kernels' plain
versions on the CPU, and (on a card only) the kernels themselves.

On CPU tensors ``run_chunk_cuda`` runs ``k1_step_plain`` + ``k2_edge_bc_plain``:
the same split into an interior step, an edge export and a ring rebuild as
the kernels. It must equal the eager ``run_chunk`` exactly, since both
round the same f32 operations in the same order.
"""

import copy
import dataclasses

import numpy as np
import pytest
import torch

from lbm2d_tpu_torch.core import solver as ts
from lbm2d_tpu_torch.core.lattice import f_eq
from lbm2d_tpu_torch.ops import cuda_step as cs

H, W = 20, 36


def make_config(bc_type=(0, 2, 1, 2), obstacle="equilibrium", cs_=0.1):
    return {
        "simulation": {
            "nx": W, "ny": H, "nu": 0.02, "ghost_moments_s": 1.2,
            "rho_in": 1.02, "rho_out": 1.0, "warmup_steps": 12,
            "smagorinsky_constant": cs_,
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


def make_mask(edge_solids=True):
    mask = np.zeros((H, W), np.float32)
    mask[7:12, 10:15] = 1.0
    if edge_solids:
        mask[3:6, 1] = 1.0  # column 1: read by the left BC
        mask[13, W - 2] = 1.0  # column W-2: read by the right BC
        mask[1, 20] = 1.0  # row 1: read by the bottom BC
        mask[H - 2, 5] = 1.0  # row H-2: read by the top BC
        mask[0, 25] = 1.0  # ring cells
        mask[8, 0] = 1.0
        mask[H - 1, 0] = 1.0
    return mask


def seeded_state(seed=0, device="cpu"):
    rng = np.random.default_rng(seed)
    rho = torch.tensor(1.0 + 0.01 * rng.standard_normal((H, W)), dtype=torch.float32)
    u = torch.tensor(0.03 * rng.standard_normal((2, H, W)), dtype=torch.float32)
    f = f_eq(rho, u[0], u[1])
    return ts.LBMState(f=f.to(device), f_post=f.clone().to(device), rho=rho.to(device),
                       u=u.to(device), step=0)


def assert_same(a, b, tol=0.0):
    for k in ("f", "f_post", "rho", "u"):
        x, y = getattr(a, k), getattr(b, k)
        assert (x - y).abs().max().item() <= tol * y.abs().max().item(), k
    assert a.step == b.step


@pytest.mark.parametrize(
    "bc_type, cs_",
    [((0, 2, 1, 2), 0.1), ((0, 0, 0, 0), 0.1), ((2, 0, 2, 2), 0.1), ((0, 2, 1, 2), 0.0)],
    ids=["production_0212", "all_inlet", "slip_inlet_mix", "no_les"],
)
def test_plain_chunk_runner_equals_eager(bc_type, cs_):
    p = ts.make_params(make_config(bc_type, cs_=cs_), make_mask())
    assert cs.supports(p)
    s0 = seeded_state()
    before = dict(cs.LAUNCHES)
    a, ma = cs.run_chunk_cuda(s0, p, 7)
    a, ma = cs.run_chunk_cuda(a, p, 5)  # second chunk starts mid-warmup
    b, mb = ts.run_chunk(s0, p, 12)
    assert_same(a, b)
    assert torch.equal(ma["force"], mb["force"]) and torch.equal(ma["max_v"], mb["max_v"])
    assert cs.LAUNCHES == before  # CPU tensors never count as launches
    # the input state is left as it was
    assert torch.equal(s0.f, seeded_state().f)


def test_single_step_chunk():
    p = ts.make_params(make_config(), make_mask())
    a, _ = cs.run_chunk_cuda(seeded_state(1), p, 1)
    b, _ = ts.run_chunk(seeded_state(1), p, 1)
    assert_same(a, b)


def test_f_post_ring_stays_frozen():
    p = ts.make_params(make_config(), make_mask())
    s0 = seeded_state(2)
    a, _ = cs.run_chunk_cuda(s0, p, 4)
    for sl in ((slice(None), 0), (slice(None), -1), (slice(None), slice(None), 0),
               (slice(None), slice(None), -1)):
        assert torch.equal(a.f_post[sl], s0.f_post[sl])


def test_k1_full_writes_zero_velocity_on_solids():
    p = ts.make_params(make_config(), make_mask())
    s = seeded_state(3)
    aux = cs.pack_aux(p.damping, p.mask)
    f_out = torch.zeros_like(s.f)
    rho = torch.zeros((H, W))
    u = torch.full((2, H, W), 7.0)
    cs.k1_step(s.f, f_out, aux, cs.new_edge_buffer(H, W), cs.scalar_row(p, 1), True,
               rho, u, s.f_post.clone())
    solid = p.mask[1:-1, 1:-1] > 0.5
    assert (u[:, 1:-1, 1:-1][:, solid] == 0).all()
    assert (u[:, 1:-1, 1:-1][:, ~solid] != 7.0).all()
    assert (rho[1:-1, 1:-1] > 0.9).all()


def test_pack_aux_round_trips():
    p = ts.make_params(make_config(), make_mask())
    aux = cs.pack_aux(p.damping, p.mask)
    solid, damp = cs.unpack_aux(aux)
    assert torch.equal(solid, p.mask > 0.5)
    assert torch.equal(damp, p.damping)
    # a solid cell with zero damping still carries its flag (-0.0)
    assert (p.damping[p.mask > 0.5] == 0).any()


def test_supports():
    ok = [((0, 2, 1, 2), "equilibrium"), ((2, 0, 0, 2), "equilibrium"),
          ((0, 0, 2, 0), "equilibrium"), ((3, 2, 1, 2), "equilibrium"),
          ((4, 2, 1, 2), "equilibrium"), ((0, 2, 1, 2), "bounce_back"),
          ((0, 2, 1, 2), "bounce_back_halfway"), ((0, 2, 1, 2), "bounce_back_bouzidi"),
          ((4, 0, 1, 0), "bounce_back_bouzidi")]
    for bc, obst in ok:
        assert cs.supports(ts.make_params(make_config(bc, obst), make_mask())), (bc, obst)
    p = ts.make_params(make_config((1, 2, 1, 2)), make_mask())
    bad = [
        (p, "every side"),
        (dataclasses.replace(ts.make_params(make_config((3, 2, 1, 2)), make_mask()),
                             inlet_profile=None), "inlet_profile"),
        (dataclasses.replace(ts.make_params(make_config(obstacle="bounce_back_bouzidi"),
                                            make_mask()), bouzidi_q=None), "q planes"),
    ]
    for p, why in bad:
        assert not cs.supports(p)
        assert why in cs.unsupported(p)
        with pytest.raises(ValueError, match=why):
            cs.run_chunk_cuda(seeded_state(), p, 2)
    p64 = ts.make_params(make_config(), make_mask(), dtype=torch.float64)
    assert "f32 only" in cs.unsupported(p64)


@pytest.mark.parametrize("obstacle", ["bounce_back", "bounce_back_halfway",
                                      "bounce_back_bouzidi"])
@pytest.mark.parametrize("bc_type", [(0, 2, 1, 2), (3, 0, 1, 0), (4, 2, 1, 2)],
                         ids=["0212", "3010", "4212"])
def test_plain_chunk_runner_bounce_schemes_equal_eager(obstacle, bc_type):
    # solids on the strips the BCs read and on the ring itself
    p = ts.make_params(make_config(bc_type, obstacle), make_mask())
    a, ma = cs.run_chunk_cuda(seeded_state(4), p, 9)
    b, mb = ts.run_chunk(seeded_state(4), p, 9)
    assert_same(a, b)
    assert torch.equal(ma["force"], mb["force"])


def test_kernel_wrappers_reject_bad_tensors():
    # validation happens before any build or launch; CPU tensors take the
    # plain path, so only the argument checks are reachable here
    with pytest.raises(ValueError, match="scalar row"):
        cs._scal_c(torch.zeros(13))
    with pytest.raises(ValueError, match="shape"):
        cs._check("f", torch.zeros(9, 4, 5), (9, 4, 6), torch.device("cpu"))
    with pytest.raises(ValueError, match="float32"):
        cs._check("f", torch.zeros(9, 4, 5, dtype=torch.float64), (9, 4, 5),
                  torch.device("cpu"))


@pytest.mark.cuda
def test_kernels_match_plain_on_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    dev = torch.device("cuda")
    p = ts.make_params(make_config(), make_mask(), device=dev)
    s0 = seeded_state(device=dev)
    cs.reset_launch_counts()
    a, ma = cs.run_chunk_cuda(s0, p, 9)
    assert {k: v for k, v in cs.LAUNCHES.items() if v} == {
        "k1_step": 8, "k1_step_full": 1, "k2_edge_bc": 9}
    b, mb = ts.run_chunk(s0, p, 9)
    assert_same(a, b, tol=1e-5)
    cfg = copy.deepcopy(make_config())
    assert cs.supports(ts.make_params(cfg, make_mask(), device=dev))


@pytest.mark.cuda
@pytest.mark.parametrize("obstacle", ["bounce_back", "bounce_back_halfway",
                                      "bounce_back_bouzidi"])
@pytest.mark.parametrize("bc_type", [(0, 2, 1, 2), (3, 0, 1, 0), (4, 2, 1, 2)],
                         ids=["0212", "3010", "4212"])
def test_bounce_and_inlet_variants_match_plain_on_card(obstacle, bc_type):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    dev = torch.device("cuda")
    p = ts.make_params(make_config(bc_type, obstacle), make_mask(), device=dev)
    s0 = seeded_state(device=dev)
    cs.reset_launch_counts()
    a, _ = cs.run_chunk_cuda(s0, p, 9)
    scheme = cs.obstacle_scheme(p)
    assert {k: v for k, v in cs.LAUNCHES.items() if v} == {
        cs.k1_variant(scheme): 8, cs.k1_variant(scheme, full=True): 1,
        cs.k2_variant(bc_type[0]): 9}
    b, _ = cs.run_chunk_plain(s0, p, 9)
    assert_same(a, b)
    if obstacle == "bounce_back":  # deviation storage: EQ and BOUNCE only
        a, _ = cs.run_chunk_cuda(s0, p, 9, store_dev=True)
        b, _ = cs.run_chunk_plain(s0, p, 9, store_dev=True)
        assert_same(a, b)
        assert cs.LAUNCHES[cs.k1_variant(scheme, dev=True)] == 8
        assert cs.LAUNCHES[cs.k2_variant(bc_type[0], dev=True)] == 8
