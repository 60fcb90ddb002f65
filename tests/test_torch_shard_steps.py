"""A sharded chunk as one host call (``cuda_step.k1_shard_steps`` /
``k1_shard_full`` and the halo kernel of ``csrc/halo.cuh``) on the CPU.

On a mesh whose blocks all live in this process -- a card each with peer
access between the cards (the engine's ``--spatial_mesh`` layout), or one
device for all (the CPU's) -- ``sharded.advance_blocks`` runs a chunk's
fast steps in the library's loop and its closing step in one more call; on
the CPU those calls take their plain versions, built on the same per-block
body as the per-step loop (``cuda_step.k1_blocks``). Held here:

- the library loop's CPU route on resident blocks, chunk after chunk,
  bitwise against the whole grid's ``cuda_step.run_chunk_plain``: meshes
  (2, 2), (1, 2), (3, 1) and (4, 1) of a 48x64 grid with a solid across
  the seams, f32 and 16-bit deviation storage, the equilibrium, full-way,
  half-way and Bouzidi schemes with bc (0, 2, 1, 2) and the inlet types
  3/4;
- the same chunk against the JAX package's ``run_chunk_sharded_pallas(
  interpret=True)``, the state and params carried across by
  ``core/convert.py``, at ``tests/test_torch_sharded.py``'s limits: 1e-6
  absolute in f32 from a seeded state, 5e-5 in deviation storage from
  rest, the conditions that limit was set under (the two packages round
  their deviations at other places, and a state far from rest grows that
  apart); the f64 limit there is the eager runner's: the kernels and their
  plain versions are f32 only;
- the halo kernel's thread map (a model that mirrors ``halo_kernel``
  line by line, every thread reading the blocks as they were before the
  launch) against ``halo_exchange_plain``, bitwise;
- which meshes take the library loop (``sharded.shard_loop_refusal``: one
  device, or cards with peer access; never a mesh spanning processes), and
  that the others keep the per-step loop; wrong host tables raise before
  any launch.

The ``cuda`` tests run the kernels on the card and skip here: the library
loop against the per-step loop through the same kernels, on meshes of one
card and, with four cards, on the engine's 2x2 layout over them and on two
blocks a card. They need torch alone, so the JAX package is imported inside
the one test that compares with it (the root conftest has put JAX on the
CPU by then), and the card runs this file with ``--noconftest -m cuda``.
"""

import numpy as np
import pytest
import torch

from lbm2d_tpu_torch.core import solver as ts
from lbm2d_tpu_torch.core.convert import params_from_numpy, state_from_numpy, state_to_numpy
from lbm2d_tpu_torch.core.lattice import f_eq
from lbm2d_tpu_torch.ops import cuda_step as cs
from lbm2d_tpu_torch.parallel import sharded as sh
from lbm2d_tpu_torch.parallel.topology import Mesh, make_mesh

H, W = 48, 64
MESHES = [(2, 2), (1, 2), (3, 1), (4, 1)]
SCHEMES = [((0, 2, 1, 2), "equilibrium"), ((0, 2, 1, 2), "bounce_back"),
           ((3, 0, 1, 0), "bounce_back_halfway"), ((4, 2, 1, 2), "bounce_back_bouzidi")]
SCHEME_IDS = ["eq-0212", "full-0212", "half-3010", "bouzidi-4212"]
VS_JAX_F32 = 1e-6
VS_JAX_DEV = 5e-5
FIELDS = ("f", "f_alt", "f_post", "rho", "u")


def make_config(bc_type=(0, 2, 1, 2), obstacle="equilibrium", ny=H, nx=W, warmup=12):
    return {
        "simulation": {
            "nx": nx, "ny": ny, "nu": 0.02, "ghost_moments_s": 1.2, "rho_in": 1.02,
            "rho_out": 1.0, "warmup_steps": warmup, "smagorinsky_constant": 0.1,
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


def seam_mask(ny=H, nx=W):
    """A disc across the seams of every mesh above (rows ny/3, ny/2 and
    ny/4 multiples, column nx/2)."""
    yy, xx = np.mgrid[0:ny, 0:nx]
    return ((yy - (ny / 2 - 0.4)) ** 2 + (xx - (nx / 2 + 0.3)) ** 2 < 60).astype(np.float32)


def seeded_leaves(seed, ny=H, nx=W):
    """A developed-looking state's numpy leaves (the checkpoint keys)."""
    rng = np.random.default_rng(seed)
    rho = torch.tensor(1.0 + 0.01 * rng.standard_normal((ny, nx)), dtype=torch.float32)
    u = torch.tensor(0.03 * rng.standard_normal((2, ny, nx)), dtype=torch.float32)
    f = f_eq(rho, u[0], u[1]).numpy()
    return {"f": f, "f_post": f.copy(), "rho": rho.numpy(), "u": u.numpy(), "step": 0}


def cpu_mesh(shape):
    return make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


def run_blocks(p, leaves, mesh, chunks, store_dev, stepwise, plain=True):
    """``leaves`` placed on ``mesh``'s blocks, then ``chunks`` (a list of
    chunk lengths) through ``advance_blocks``: (blocks, monitors)."""
    case = sh.ShardedCase(p, mesh)
    bs = sh.BlockRunner(mesh, "plain", store_dev, case).place(state_from_numpy(leaves), p)
    for n in chunks:
        mon = sh.advance_blocks(bs, case, n, store_dev, plain=plain, stepwise=stepwise)
    return bs, mon


def bits(t):
    """The tensor's raw bits (NaN halos compare equal when identical)."""
    return t.view(torch.int16 if t.element_size() == 2 else torch.int32)


def assert_blocks_equal(a, b):
    assert a.step == b.step
    for k in FIELDS:
        for ra, rb in zip(getattr(a, k), getattr(b, k)):
            for x, y in zip(ra, rb):
                assert torch.equal(bits(x), bits(y)), k
    if a.f_post_global is None:  # a mesh over several cards
        assert b.f_post_global is None
    else:
        assert torch.equal(bits(a.f_post_global), bits(b.f_post_global))


@pytest.mark.parametrize("store_dev", [False, True], ids=["f32", "store_dev"])
@pytest.mark.parametrize("bc_type, obstacle", SCHEMES, ids=SCHEME_IDS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_shard_loop_equals_the_single_device_chunk(shape, bc_type, obstacle, store_dev):
    # the library loop's route on CPU tensors (the loop entries' plain
    # versions) on resident blocks, chunk after chunk, against the whole
    # grid's cs.run_chunk_plain: the same f32 operations on every cell
    p = ts.make_params(make_config(bc_type, obstacle), seam_mask())
    leaves = seeded_leaves(1)
    mesh = cpu_mesh(shape)
    before = dict(cs.LAUNCHES)
    case = sh.ShardedCase(p, mesh)
    assert case.tables is not None
    runner = sh.BlockRunner(mesh, "cuda", store_dev, case)
    bs = runner.place(state_from_numpy(leaves), p)
    sb = state_from_numpy(leaves)
    # 7 + 5 steps: the second chunk starts mid-warmup; a 1-step chunk
    # closes with the full step alone
    for n in (7, 5, 1):
        ma = runner.advance(bs, p, n)
        sb, mb = cs.run_chunk_plain(sb, p, n, store_dev=store_dev)
        assert bs.step == sb.step
        for k in ("f", "f_post", "rho", "u"):
            assert torch.equal(bs.gather(k), getattr(sb, k)), (n, k)
        for k in ("force", "max_v"):
            assert torch.equal(ma[k], mb[k]), (n, k)
    assert cs.LAUNCHES == before  # CPU tensors: the plain versions, uncounted


def test_one_device_chunk_is_two_library_calls(monkeypatch):
    p = ts.make_params(make_config((4, 2, 1, 2), "bounce_back_bouzidi"), seam_mask())
    mesh = cpu_mesh((2, 2))
    calls = {}

    def counted(name, fn):
        def wrapper(*a, **kw):
            calls[name] = calls.get(name, 0) + 1
            return fn(*a, **kw)
        return wrapper

    for name in ("k1_shard_steps", "k1_shard_full", "k1_step", "k1_step_dev"):
        monkeypatch.setattr(cs, name, counted(name, getattr(cs, name)))
    for name in ("fast_step", "exchange_halos"):
        monkeypatch.setattr(sh, name, counted(name, getattr(sh, name)))
    case = sh.ShardedCase(p, mesh)
    runner = sh.BlockRunner(mesh, "cuda", False, case)
    bs = runner.place(state_from_numpy(seeded_leaves(2)), p)
    runner.advance(bs, p, 9)
    assert calls == {"k1_shard_steps": 1, "k1_shard_full": 1}
    calls.clear()
    sh.BlockRunner(mesh, "stepwise", False, case).advance(bs, p, 9)
    assert calls == {"fast_step": 8, "k1_step": 8 * 4 + 4, "exchange_halos": 8 + 1}


def test_meshes_over_devices_or_processes_keep_the_per_step_loop(monkeypatch):
    p = ts.make_params(make_config(), seam_mask())
    leaves = seeded_leaves(3)
    # two device names for the CPU: the blocks are on "several" devices
    spread = make_mesh((2, 2), ["cpu", "cpu:0", "cpu", "cpu:0"])
    assert spread.single_device is None
    case = sh.ShardedCase(p, spread)
    assert case.tables is None

    def refuse(*a, **kw):
        raise AssertionError("the library loop ran on a mesh over several devices")

    monkeypatch.setattr(cs, "k1_shard_steps_plain", refuse)
    monkeypatch.setattr(cs, "k1_shard_full_plain", refuse)
    monkeypatch.setattr(cs, "k1_shard_steps", refuse)
    monkeypatch.setattr(cs, "k1_shard_full", refuse)
    a, ma = run_blocks(p, leaves, spread, [6], False, stepwise=False, plain=False)
    monkeypatch.undo()
    b, mb = run_blocks(p, leaves, cpu_mesh((2, 2)), [6], False, stepwise=False, plain=False)
    for k in ("f", "f_post", "rho", "u"):
        assert torch.equal(a.gather(k), b.gather(k)), k
    # a mesh whose blocks belong to two processes: this process's blocks
    # only, the per-step loop with P2P halos
    owners = Mesh(cpu_mesh((2, 2)).devices, owners=((0, 0), (1, 1)), rank=0)
    assert owners.single_device is None
    assert sh.ShardedCase(p, owners).tables is None


def test_meshes_over_cards_take_the_library_loop_with_peer_access(monkeypatch):
    # the engine's layout on a host's cards (block i on cuda:i), decided
    # from the cards' peer access alone; a mesh spanning processes never
    peers = {"ok": True}
    monkeypatch.setattr(torch.cuda, "can_device_access_peer", lambda a, b: peers["ok"])
    cards = Mesh(((torch.device("cuda", 0), torch.device("cuda", 1)),
                  (torch.device("cuda", 2), torch.device("cuda", 3))))
    assert cards.single_device is None
    assert sh.shard_loop_refusal(cards) is None
    shared = Mesh(((torch.device("cuda", 0),) * 2, (torch.device("cuda", 1),) * 2))
    assert sh.shard_loop_refusal(shared) is None
    peers["ok"] = False
    assert "peer access" in sh.shard_loop_refusal(cards)
    assert sh.shard_loop_refusal(make_mesh((2, 2), [torch.device("cuda", 0)] * 4)) is None
    owners = Mesh(cards.devices, owners=((0, 0), (1, 1)), rank=0)
    assert "processes" in sh.shard_loop_refusal(owners)
    assert "not CUDA" in sh.shard_loop_refusal(make_mesh((1, 2), ["cpu", "cpu:0"]))
    big = make_mesh((1, cs.MAX_MESH_BLOCKS + 1), ["cpu"] * (cs.MAX_MESH_BLOCKS + 1))
    assert "blocks" in sh.shard_loop_refusal(big)


def test_wrong_host_tables_raise():
    p = ts.make_params(make_config((4, 2, 1, 2), "bounce_back_bouzidi"), seam_mask())
    mesh = cpu_mesh((2, 2))
    case = sh.ShardedCase(p, mesh)
    t = case.tables
    assert t.grid == (2, 2) and t.n_blocks == 4
    swapped = [[case.geoms[0][1], case.geoms[0][0]], case.geoms[1]]
    with pytest.raises(ValueError, match="geometry"):
        cs.ShardTables(case.aux, swapped, case.q, case.prof)
    with pytest.raises(ValueError, match="blocks"):
        cs.ShardTables(case.aux[:1], case.geoms, case.q, case.prof)
    with pytest.raises(ValueError, match="dtype"):
        cs.ShardTables([[b.double() for b in row] for row in case.aux], case.geoms)
    with pytest.raises(ValueError, match="shape"):
        cs.ShardTables(case.aux, case.geoms, [[b[:4] for b in row] for row in case.q])
    big = make_mesh((1, cs.MAX_MESH_BLOCKS + 1), ["cpu"] * (cs.MAX_MESH_BLOCKS + 1))
    wide = ts.make_params(make_config(nx=3 * (cs.MAX_MESH_BLOCKS + 1)),
                          np.zeros((H, 3 * (cs.MAX_MESH_BLOCKS + 1)), np.float32))
    assert sh.ShardedCase(wide, big).tables is None  # the per-step loop
    # the f tables: block count, shape and dtype
    f = [[b.clone() for b in row] for row in sh.BlockState.place(
        state_from_numpy(seeded_leaves(4)), mesh, halo=1, pitch=case.pitch).f]
    t.check_f("f", f, torch.float32)
    with pytest.raises(ValueError, match="dtype"):
        t.check_f("f", f, cs.DEV_DTYPE)
    with pytest.raises(ValueError, match="blocks"):
        t.check_f("f", [f[0]], torch.float32)
    with pytest.raises(ValueError, match="shape"):
        t.check_f("f", [[b[:, 1:].contiguous() for b in row] for row in f], torch.float32)
    with pytest.raises(ValueError, match="obstacle"):
        t.needs(cs.OBSTACLE_BOUZIDI, p.bc_type, cs.DEV_OBSTACLES)
    with pytest.raises(ValueError, match="inlet profile"):
        sh.ShardedCase(ts.make_params(make_config((0, 2, 1, 2)), seam_mask()),
                       mesh).tables.needs(cs.OBSTACLE_EQ, (3, 0, 1, 0))


# ---------------------------------------------------------------------------
# The halo kernel's thread map
# ---------------------------------------------------------------------------


def halo_kernel_model(blocks, hl, wl):
    """``csrc/halo.cuh`` halo_kernel, thread by thread: each thread's
    destination and source as the kernel computes them, every read taken
    from the blocks as they were before the launch (one launch: no thread
    sees another's write)."""
    ry, rx = len(blocks), len(blocks[0])
    flat = [b for row in blocks for b in row]
    before = [b.clone() for b in flat]
    for blk in range(ry * rx):
        iy, ix = divmod(blk, rx)
        for t in range(2 * hl + 2 * (wl + 2)):
            if t < 2 * hl:
                far = t >= hl
                r = sr = (t - hl if far else t) + 1
                if far:
                    if ix + 1 >= rx:
                        continue
                    c, sb, sc = wl + 1, blk + 1, 1
                else:
                    if ix == 0:
                        continue
                    c, sb, sc = 0, blk - 1, wl
            else:
                u = t - 2 * hl
                far = u >= wl + 2
                c = sc = u - (wl + 2) if far else u
                if far:
                    if iy + 1 >= ry:
                        continue
                    r, ny, sr = hl + 1, iy + 1, 1
                else:
                    if iy == 0:
                        continue
                    r, ny, sr = 0, iy - 1, hl
                nx = ix
                if c == 0 and ix > 0:
                    nx, sc = ix - 1, wl
                elif c == wl + 1 and ix + 1 < rx:
                    nx, sc = ix + 1, 1
                sb = ny * rx + nx
            flat[blk][:, r, c] = before[sb][:, sr, sc]


@pytest.mark.parametrize("dtype", [torch.float32, cs.DEV_DTYPE], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", [(2, 2), (1, 3), (3, 1), (2, 3)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_halo_kernel_map_equals_exchange_halos(shape, dtype):
    hl, wl, pitch = 5, 4, 32
    gen = torch.Generator().manual_seed(7)
    # every cell distinct, and the halos NaN: a wrong source or a missed
    # write shows
    a = [[torch.full((3, hl + 2, pitch), float("nan")) for _ in range(shape[1])]
         for _ in range(shape[0])]
    for row in a:
        for b in row:
            b[:, 1:hl + 1, 1:wl + 1] = torch.randn((3, hl, wl), generator=gen)
    a = [[b.to(dtype) for b in row] for row in a]
    b = [[x.clone() for x in row] for row in a]
    halo_kernel_model(a, hl, wl)
    cs.halo_exchange(b, hl, wl)  # CPU tensors: the plain version
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            assert torch.equal(bits(x), bits(y))


# ---------------------------------------------------------------------------
# Against the JAX package's sharded Pallas runner
# ---------------------------------------------------------------------------


def _jax_leaves(pj):
    leaves = {k: np.asarray(getattr(pj, k)) for k in (
        "mask", "damping", "tau0", "cs_factor", "s_ghost", "rho_in", "rho_out",
        "warmup_steps", "bc_value")}
    for k in ("inlet_profile", "bouzidi_q"):
        v = getattr(pj, k, None)
        leaves[k] = None if v is None else np.asarray(v)
    leaves.update(use_les=pj.use_les, bc_type=pj.bc_type, bounce_obstacle=pj.bounce_obstacle,
                  halfway_obstacle=pj.halfway_obstacle, bouzidi_obstacle=pj.bouzidi_obstacle)
    return leaves


@pytest.mark.parametrize("shape, store_dev", [((4, 1), False), ((4, 1), True), ((2, 2), False)],
                         ids=["4x1-f32", "4x1-store_dev", "2x2-f32"])
def test_shard_loop_matches_jax_pallas(shape, store_dev):
    import jax

    from lbm2d_tpu.core import solver as js
    from lbm2d_tpu.parallel import sharded as jsh
    from lbm2d_tpu.parallel.topology import make_mesh as jax_mesh
    from lbm2d_tpu.parallel.topology import shard_state as jax_shard_state

    ny, nx, n = 64, 128, 12
    cfg = make_config(ny=ny, nx=nx, warmup=30)
    mask = seam_mask(ny, nx)
    pj = js.make_params(cfg, mask)
    pt = params_from_numpy(_jax_leaves(pj))
    # deviation storage from rest, as tests/test_torch_sharded.py holds it
    leaves = state_to_numpy(ts.init_state(ny, nx)) if store_dev else seeded_leaves(6, ny, nx)
    st0 = state_from_numpy(leaves)
    mesh = cpu_mesh(shape)
    runner = sh.BlockRunner(mesh, "cuda", store_dev)
    bs = runner.place(st0, pt)
    mt = runner.advance(bs, pt, n)
    jmesh = jax_mesh(shape=shape, devices=jax.devices()[:shape[0] * shape[1]])
    sj0 = js.LBMState(**{k: leaves[k] for k in ("f", "f_post", "rho", "u")},
                      step=np.int32(0))
    sj0, pjs = jax_shard_state(sj0, pj, jmesh)
    sj, mj = jsh.run_chunk_sharded_pallas(sj0, pjs, n_steps=n, mesh=jmesh, ny=ny, nx=nx,
                                          interpret=True, store_dev=store_dev)
    keys = ("f", "rho", "u") + (() if store_dev else ("f_post",))
    err = max(float(np.abs(bs.gather(k).numpy() - np.asarray(getattr(sj, k))).max())
              for k in keys)
    assert err <= (VS_JAX_DEV if store_dev else VS_JAX_F32), err
    if store_dev:  # engaged: the chunk is not the exact one
        exact = sh.BlockRunner(mesh, "cuda").place(st0, pt)
        sh.BlockRunner(mesh, "cuda").advance(exact, pt, n)
        assert 0 < float((exact.gather("f") - bs.gather("f")).abs().max()) <= 5e-4
    if not store_dev:
        np.testing.assert_allclose(mt["force"].numpy(), np.asarray(mj["force"]), rtol=0,
                                   atol=2e-6)


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------


@pytest.fixture
def cuda_dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("store_dev", [False, True], ids=["f32", "store_dev"])
@pytest.mark.parametrize("bc_type, obstacle", SCHEMES, ids=SCHEME_IDS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_shard_loop_on_the_card_equals_stepwise(cuda_dev, shape, bc_type, obstacle,
                                                store_dev):
    p = ts.make_params(make_config(bc_type, obstacle), seam_mask(), device=cuda_dev)
    leaves = seeded_leaves(1)
    mesh = make_mesh(shape, [cuda_dev] * (shape[0] * shape[1]))
    out = []
    for stepwise in (False, True):
        cs.reset_launch_counts()
        bs, mon = run_blocks(p, leaves, mesh, [7, 5, 1], store_dev, stepwise, plain=False)
        torch.cuda.synchronize()
        out.append((bs, mon, dict(cs.LAUNCHES)))
    (a, ma, la), (b, mb, lb) = out
    assert_blocks_equal(a, b)
    for k in ("force", "max_v"):
        assert torch.equal(ma[k], mb[k]), k
    k1 = {k: v for k, v in la.items() if k.startswith("k1")}
    assert k1 == {k: v for k, v in lb.items() if k.startswith("k1")}
    halos = la["halo_exchange"] + la["halo_exchange_dev"]
    assert halos == 13 and lb["halo_exchange"] == 0  # 10 fast steps, 3 closing ones
    c, mc = run_blocks(p, leaves, mesh, [7, 5, 1], store_dev, stepwise=False)  # plain
    torch.cuda.synchronize()
    assert_blocks_equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, cs.DEV_DTYPE], ids=["f32", "bf16"])
def test_halo_kernel_on_the_card(cuda_dev, dtype):
    hl, wl, pitch = 37, 45, 64
    gen = torch.Generator(device=cuda_dev).manual_seed(3)
    a = [[torch.randn((9, hl + 2, pitch), generator=gen, device=cuda_dev).to(dtype)
          for _ in range(3)] for _ in range(2)]
    b = [[x.clone() for x in row] for row in a]
    cs.reset_launch_counts()
    cs.halo_exchange(a, hl, wl)
    cs.halo_exchange_plain(b, hl, wl)
    torch.cuda.synchronize()
    assert cs.LAUNCHES[cs.halo_variant(dtype)] == 1
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            assert torch.equal(bits(x), bits(y))
    with pytest.raises(ValueError):
        cs.halo_exchange([[x.double() for x in row] for row in a], hl, wl)
    assert cs.LAUNCHES[cs.halo_variant(dtype)] == 1


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [((0, 1), (2, 3)), ((0, 0), (1, 1))],
                         ids=["a-card-a-block", "two-blocks-a-card"])
@pytest.mark.parametrize("store_dev", [False, True], ids=["f32", "store_dev"])
@pytest.mark.parametrize("bc_type, obstacle", SCHEMES, ids=SCHEME_IDS)
def test_shard_loop_over_cards_equals_stepwise(layout, bc_type, obstacle, store_dev):
    # a 2x2 mesh over the cards of one host: the library loop (each block's
    # K1 on its card's stream, the halo kernel pulling across cards over
    # peer access after one event a card) against the per-step loop through
    # the same kernels, bitwise, and against the same mesh on one card
    n_cards = 1 + max(max(row) for row in layout)
    if torch.cuda.device_count() < n_cards:
        pytest.skip(f"needs {n_cards} CUDA devices")
    devices = [[torch.device("cuda", i) for i in row] for row in layout]
    mesh = Mesh(tuple(tuple(row) for row in devices))
    if sh.shard_loop_refusal(mesh) is not None:
        pytest.skip(sh.shard_loop_refusal(mesh))
    p = ts.make_params(make_config(bc_type, obstacle), seam_mask(), device="cuda")
    leaves = seeded_leaves(5)
    out = []
    for stepwise in (False, True):
        cs.reset_launch_counts()
        bs, mon = run_blocks(p, leaves, mesh, [7, 5, 1], store_dev, stepwise, plain=False)
        for d in range(n_cards):
            torch.cuda.synchronize(d)
        out.append((bs, mon, dict(cs.LAUNCHES)))
    (a, ma, la), (b, mb, lb) = out
    assert [[x.device.index for x in row] for row in a.f] == [list(r) for r in layout]
    assert_blocks_equal(a, b)
    for k in ("force", "max_v"):
        assert torch.equal(ma[k], mb[k]), k
    k1 = {k: v for k, v in la.items() if k.startswith("k1")}
    assert k1 == {k: v for k, v in lb.items() if k.startswith("k1")}
    # one halo launch a card a refresh: 10 fast steps and 3 closing ones
    assert la["halo_exchange"] + la["halo_exchange_dev"] == 13 * n_cards
    one = make_mesh((2, 2), ["cuda:0"] * 4)
    c, mc = run_blocks(p, leaves, one, [7, 5, 1], store_dev, stepwise=False, plain=False)
    torch.cuda.synchronize(0)
    for k in ("f", "f_post", "rho", "u"):
        assert torch.equal(a.gather(k).cpu(), c.gather(k).cpu()), k
    assert torch.equal(ma["max_v"].cpu(), mc["max_v"].cpu())
