"""The CUDA chunk runner's contract, checked through the kernels' plain
versions on the CPU, and (on a card only) the kernels themselves.

On CPU tensors ``run_chunk_cuda`` runs ``k1_step_plain``: the interior
step, then the ring from the interior's collide output, the values the
kernel's ring threads compute. It must equal the eager ``run_chunk`` exactly,
since both round the same f32 operations in the same order.
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
    cs.k1_step(s.f, f_out, aux, cs.scalar_row(p, 1), True, p.bc_type, rho, u, s.f_post.clone())
    # every cell, the ring included (make_mask puts solids on it)
    solid = p.mask > 0.5
    assert solid[0].any() and solid[:, 0].any()
    assert (u[:, solid] == 0).all()
    assert (u[:, ~solid] != 7.0).all()
    assert (rho > 0.9).all()


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
    assert {k: v for k, v in cs.LAUNCHES.items() if v} == {"k1_step": 8, "k1_step_full": 1}
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
        cs.k1_variant(scheme): 8, cs.k1_variant(scheme, full=True): 1}
    b, _ = cs.run_chunk_plain(s0, p, 9)
    assert_same(a, b)
    if obstacle == "bounce_back":  # deviation storage: EQ and BOUNCE only
        a, _ = cs.run_chunk_cuda(s0, p, 9, store_dev=True)
        b, _ = cs.run_chunk_plain(s0, p, 9, store_dev=True)
        assert_same(a, b)
        assert cs.LAUNCHES[cs.k1_variant(scheme, dev=True)] == 8


@pytest.mark.cuda
@pytest.mark.parametrize("obstacle", ["equilibrium", "bounce_back", "bounce_back_halfway"])
@pytest.mark.parametrize("bc_type", [(0, 2, 1, 2), (3, 0, 1, 0)], ids=["0212", "3010"])
@pytest.mark.parametrize("S, tile", [(3, (8, 16)), (4, None), (8, None), (4, (32, 64)),
                                     (2, (5, 124))],
                         ids=["S3-small-tiles", "S4-default", "S8-default", "S4-first-tile",
                              "S2-widest"])
def test_k3_matches_plain_on_card(obstacle, bc_type, S, tile, monkeypatch):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    dev = torch.device("cuda")
    p = ts.make_params(make_config(bc_type, obstacle), make_mask(), device=dev)
    s0 = seeded_state(device=dev)
    unfused, _ = cs.run_chunk_plain(s0, p, 9)
    monkeypatch.setattr(cs, "_FUSE_STEPS", S)
    if tile is not None:
        monkeypatch.setattr(cs, "k3_tile", lambda S_: tile)
    cs.reset_launch_counts()
    a, _ = cs.run_chunk_cuda(s0, p, 9)
    scheme = cs.obstacle_scheme(p)
    passes, split = divmod(8, S)
    want = {cs.k3_variant(scheme, bc_type[0]): passes, cs.k1_variant(scheme): split,
            cs.k1_variant(scheme, full=True): 1}
    assert {k: v for k, v in cs.LAUNCHES.items() if v} == {k: v for k, v in want.items() if v}
    b, _ = cs.run_chunk_plain(s0, p, 9)
    assert_same(a, b)
    assert_same(a, unfused)


# every side's BC types the ring takes: left 0/2/3/4, right 0/1/2,
# top/bottom 0/2, each with an overwrite scheme and full-way bounce-back
FOLD_CASES = [((0, 2, 1, 2), "equilibrium"), ((2, 0, 0, 0), "bounce_back"),
              ((3, 2, 2, 0), "bounce_back_halfway"), ((4, 0, 1, 2), "bounce_back_bouzidi"),
              ((4, 2, 0, 2), "bounce_back"), ((3, 0, 1, 2), "equilibrium")]


@pytest.mark.cuda
@pytest.mark.parametrize("bc_type, obstacle", FOLD_CASES,
                         ids=["".join(map(str, b)) + "-" + o for b, o in FOLD_CASES])
def test_folded_ring_matches_plain_on_card(bc_type, obstacle):
    # K1 with the ring folded in, fast and full, and in deviation storage
    # where the scheme allows it: every cell of every output bitwise equal
    # to the plain version's (outputs start as NaN), then the same on each
    # block of a 2x2 mesh through the sharded runner
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    dev = torch.device("cuda")
    p = ts.make_params(make_config(bc_type, obstacle), make_mask(), device=dev)
    s0 = seeded_state(5, device=dev)
    aux = cs.pack_aux(p.damping, p.mask)
    scal = cs.scalar_row(p, 1)
    scheme = cs.obstacle_scheme(p)
    q = p.bouzidi_q if scheme == cs.OBSTACLE_BOUZIDI else None
    prof = p.inlet_profile if bc_type[0] in (3, 4) else None
    cs.reset_launch_counts()
    for full in (False, True):
        outs = []
        for fn in (cs.k1_step, cs.k1_step_plain):
            b = [torch.full_like(s0.f, float("nan"))]
            if full:
                b += [torch.full((H, W), float("nan"), device=dev),
                      torch.full((2, H, W), float("nan"), device=dev), s0.f_post.clone()]
            fn(s0.f, b[0], aux, scal, True, p.bc_type, *(b[1:] or [None] * 3),
               obstacle=scheme, q=q, prof=prof)
            outs.append(b)
        torch.cuda.synchronize()
        for a, b in zip(*outs):
            assert torch.equal(a, b)
    want = {cs.k1_variant(scheme): 1, cs.k1_variant(scheme, full=True): 1}
    if scheme in cs.DEV_OBSTACLES:
        fq = cs.quantize(s0.f)
        a, b = torch.full_like(fq, float("nan")), torch.full_like(fq, float("nan"))
        cs.k1_step_dev(fq, a, aux, scal, True, p.bc_type, scheme, prof)
        cs.k1_step_dev_plain(fq, b, aux, scal, True, p.bc_type, scheme, prof)
        torch.cuda.synchronize()
        assert torch.equal(a, b)
        want[cs.k1_variant(scheme, dev=True)] = 1
    assert {k: v for k, v in cs.LAUNCHES.items() if v} == want
    from lbm2d_tpu_torch.parallel import sharded as sh
    from lbm2d_tpu_torch.parallel.topology import make_mesh

    mesh = make_mesh((2, 2), [dev] * 4)
    a, _ = sh.run_chunk_sharded_cuda(s0, p, 5, mesh)
    b, _ = sh.run_chunk_sharded_plain(s0, p, 5, mesh)
    assert_same(a, b)


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(64, 128), (7, 9)], ids=["vector", "scalar-tail"])
def test_copy_probe_matches_plain_on_card(shape):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    from lbm2d_tpu_torch.ops import copy_probe as cp

    rng = np.random.default_rng(0)
    f = torch.tensor(rng.standard_normal((9,) + shape), dtype=torch.float32, device="cuda")
    aux = torch.tensor(rng.standard_normal(shape), dtype=torch.float32, device="cuda")
    cp.reset_launch_counts()
    for a in (None, aux):
        out = torch.full_like(f, float("nan"))
        ref = torch.full_like(f, float("nan"))
        cp.copy_probe(f, out, a)
        cp.copy_probe_plain(f, ref, a)
        assert torch.equal(out, ref)
    assert cp.LAUNCHES == {"copy_probe": 1, "copy_probe_aux": 1}


def seam_mask():
    """``make_mask`` plus a solid across both seams of a 2x2 mesh (row 10,
    column 18): half-way and Bouzidi links cross them."""
    mask = make_mask()
    mask[8:13, 15:21] = 1.0
    return mask


@pytest.mark.cuda
@pytest.mark.parametrize("obstacle", ["equilibrium", "bounce_back", "bounce_back_halfway",
                                      "bounce_back_bouzidi"])
@pytest.mark.parametrize("bc_type", [(0, 2, 1, 2), (4, 2, 1, 2)], ids=["0212", "4212"])
def test_shard_kernels_match_plain_on_card(obstacle, bc_type):
    # every _shard variant on a 2x2 mesh of one card: bitwise against its
    # plain version and against the single-device kernels
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device (the kernels have no CPU build)")
    from lbm2d_tpu_torch.parallel import sharded as sh
    from lbm2d_tpu_torch.parallel.topology import make_mesh

    dev = torch.device("cuda")
    mesh = make_mesh((2, 2), [dev] * 4)
    p = ts.make_params(make_config(bc_type, obstacle), seam_mask(), device=dev)
    s0 = seeded_state(device=dev)
    scheme = cs.obstacle_scheme(p)
    cs.reset_launch_counts()
    a, ma = sh.run_chunk_sharded_cuda(s0, p, 9, mesh)
    assert {k: v for k, v in cs.LAUNCHES.items() if v} == {
        cs.k1_variant(scheme, shard=True): 32, cs.k1_variant(scheme, full=True, shard=True): 4}
    b, mb = sh.run_chunk_sharded_plain(s0, p, 9, mesh)
    assert_same(a, b)
    assert torch.equal(ma["force"], mb["force"])
    c, _ = cs.run_chunk_cuda(s0, p, 9)
    assert_same(a, c)
    if scheme in cs.DEV_OBSTACLES:
        cs.reset_launch_counts()
        a, _ = sh.run_chunk_sharded_cuda(s0, p, 9, mesh, store_dev=True)
        assert {k: v for k, v in cs.LAUNCHES.items() if v} == {
            cs.k1_variant(scheme, dev=True, shard=True): 32,
            cs.k1_variant(scheme, full=True, shard=True): 4}
        b, _ = sh.run_chunk_sharded_plain(s0, p, 9, mesh, store_dev=True)
        assert_same(a, b)
        c, _ = cs.run_chunk_cuda(s0, p, 9, store_dev=True)
        assert_same(a, c)
