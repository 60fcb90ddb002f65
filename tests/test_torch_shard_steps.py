"""A sharded chunk as one host call (``cuda_step.k1_shard_steps`` /
``k1_shard_full``: each step one K1 launch a block, whose edge cells are
pushed into the neighbours' halos, ``csrc/halo.cuh``) on the CPU.

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
- the push map (a model that mirrors ``k1_push`` line by line: for each
  block's own edge cell, the halo slots it writes) against
  ``halo_exchange_plain``, bitwise, with exactly one writer for every halo
  slot off the global edge and none on a global-edge side; and that every
  buffer the library loop writes holds, in the corner halo slots no cell
  pushes into, the bits the pull would copy there (the placed NaN);
- the cards' issue order (a model of ``MeshDevs``: each device's waits and
  records, step by step): no push of step i before a neighbour has
  finished its step i - 1, no two devices waiting on each other within a
  step, and the caller's work ordered before the first step and after the
  last;
- which meshes take the library loop (``sharded.shard_loop_refusal``: one
  device, or cards with peer access; never a mesh spanning processes), and
  that the others keep the per-step loop; wrong host tables raise before
  any launch.

The ``cuda`` tests run the kernels on the card and skip here: the library
loop (one K1 launch a block a step, no other) against the per-step loop
through the same kernels, whole buffers with their halos bitwise, on
meshes of one card and, with four cards, on the engine's 2x2 layout over
them and on two blocks a card; one mesh step's pushes against
``halo_exchange_plain``; and the whole-grid K1 instances' ptxas registers
and spills, which the push must not change. They need torch alone, so the JAX package is imported inside
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
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

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
# The push map and the cards' issue order
# ---------------------------------------------------------------------------


def shard_nbr_slot(dy, dx):
    """``csrc/halo.cuh`` shard_nbr_slot."""
    i = (dy + 1) * 3 + (dx + 1)
    return i - (i > 4)


def push_targets(ry, rx, iy, ix, hl, wl, y, x):
    """``csrc/k1_step.cu`` k1_push for own cell (y, x) of block (iy, ix):
    the (block, stored row, stored column) slots it writes, in its order."""
    dy = 1 if y == hl - 1 else (-1 if y == 0 else 0)
    dx = 1 if x == wl - 1 else (-1 if x == 0 else 0)
    if dy == 0 and dx == 0:
        return []
    nbrs = [None] * 8  # halo.cuh shard_nbrs
    for ny in (-1, 0, 1):
        for nx in (-1, 0, 1):
            if (ny, nx) != (0, 0) and 0 <= iy + ny < ry and 0 <= ix + nx < rx:
                nbrs[shard_nbr_slot(ny, nx)] = (iy + ny, ix + nx)
    hy, hx = (0 if dy > 0 else hl + 1), (0 if dx > 0 else wl + 1)
    dst = [nbrs[shard_nbr_slot(dy, 0)] if dy else None,
           nbrs[shard_nbr_slot(0, dx)] if dx else None,
           nbrs[shard_nbr_slot(dy, dx)] if dy and dx else None]
    at = [(hy, x + 1), (y + 1, hx), (hy, hx)]
    return [(b,) + a for b, a in zip(dst, at) if b is not None]


def push_model(blocks, hl, wl):
    """Every block's own edge cells pushed into its neighbours' halos, as
    K1's threads push them; returns {(block, row, column): writers}."""
    ry, rx = len(blocks), len(blocks[0])
    writers = {}
    for iy in range(ry):
        for ix in range(rx):
            for y in range(hl):
                for x in range(wl):
                    for b, r, c in push_targets(ry, rx, iy, ix, hl, wl, y, x):
                        blocks[b[0]][b[1]][:, r, c] = blocks[iy][ix][:, y + 1, x + 1]
                        writers.setdefault((b, r, c), []).append((iy, ix, y, x))
    return writers


PUSH_MESHES = [(2, 2), (1, 3), (3, 1), (2, 3), (5, 1), (3, 3)]


@pytest.mark.parametrize("dtype", [torch.float32, cs.DEV_DTYPE], ids=["f32", "bf16"])
@pytest.mark.parametrize("shape", PUSH_MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_push_map_equals_exchange_halos(shape, dtype):
    hl, wl, pitch = 5, 4, 32
    ry, rx = shape
    gen = torch.Generator().manual_seed(7)
    # every cell distinct, and the halos NaN: a wrong slot or a missed push
    # shows
    a = [[torch.full((3, hl + 2, pitch), float("nan")) for _ in range(rx)] for _ in range(ry)]
    for row in a:
        for b in row:
            b[:, 1:hl + 1, 1:wl + 1] = torch.randn((3, hl, wl), generator=gen)
    a = [[b.to(dtype) for b in row] for row in a]
    b = [[x.clone() for x in row] for row in a]
    writers = push_model(a, hl, wl)
    cs.halo_exchange_plain(b, hl, wl)
    for ra, rb in zip(a, b):
        for x, y in zip(ra, rb):
            assert torch.equal(bits(x), bits(y))
    # one writer for every halo slot off the global edge, none on a
    # global-edge side (row 0 of the bottom blocks, column 0 of the left
    # ones, and so on)
    for iy in range(ry):
        for ix in range(rx):
            for r in range(hl + 2):
                for c in range(wl + 2):
                    if 1 <= r <= hl and 1 <= c <= wl:
                        continue
                    off_edge = ((r != 0 or iy > 0) and (r != hl + 1 or iy + 1 < ry)
                                and (c != 0 or ix > 0) and (c != wl + 1 or ix + 1 < rx))
                    n = len(writers.get(((iy, ix), r, c), []))
                    assert n == (1 if off_edge else 0), ((iy, ix), r, c, n)


class MeshDevsModel:
    """``csrc/halo.cuh`` MeshDevs as a log of stream operations: each
    device's stream a list of ("work" | "launch", step) and ("record",
    event, step) entries, and ("wait", event, the record it caught) as a
    cudaStreamWaitEvent catches the event's last record at issue time."""

    def __init__(self, layout, events=2):
        ry, rx = len(layout), len(layout[0])
        self.ords = sorted({d for row in layout for d in row})
        self.nd = len(self.ords)
        of = {(iy, ix): self.ords.index(layout[iy][ix]) for iy in range(ry) for ix in range(rx)}
        self.nbr = {d: set() for d in range(self.nd)}
        for (iy, ix), d in of.items():
            for dy in (-1, 0, 1):
                for dx in (-1, 0, 1):
                    e = of.get((iy + dy, ix + dx))
                    if e is not None and e != d:
                        self.nbr[d].add(e)
        self.events = events
        self.last = {}  # event -> (device, position) of its last record
        self.ops = {d: [("work", "before")] for d in range(self.nd)}

    def _ev(self, d, i):
        return (d, i % self.events)

    def _record(self, d, i):
        self.ops[d].append(("record", self._ev(d, i), i))
        self.last[self._ev(d, i)] = (d, len(self.ops[d]) - 1)

    def _wait(self, d, i):
        for e in sorted(self.nbr[d]):
            caught = self.last.get(self._ev(e, i))
            if caught is not None:
                self.ops[d].append(("wait", caught))

    def run(self, n):
        """open(), n steps of enter / launch / leave, close()."""
        if self.nd > 1:
            for d in range(self.nd):
                self._record(d, -1)
        for i in range(n):
            for d in range(self.nd):
                if self.nd > 1:
                    self._wait(d, i - 1)
                self.ops[d].append(("launch", i))
                if self.nd > 1:
                    self._record(d, i)
        if self.nd > 1:
            for d in range(self.nd):
                self._wait(d, n - 1)
        for d in range(self.nd):
            self.ops[d].append(("work", "after"))
        return self

    def before(self, a, b):
        """Whether op a = (device, position) completes before op b starts:
        stream order, and a wait on a record."""
        seen, todo = set(), [b]
        while todo:
            d, i = todo.pop()
            if (d, i) in seen:
                continue
            seen.add((d, i))
            if i > 0:
                todo.append((d, i - 1))
            op = self.ops[d][i]
            if op[0] == "wait":
                todo.append(op[1])
        return a in seen and a != b

    def at(self, d, kind, step):
        return next((d, k) for k, op in enumerate(self.ops[d])
                    if op[0] == kind and op[-1] == step)


CARD_LAYOUTS = {"2x2-four-cards": ((0, 1), (2, 3)), "2x2-two-blocks-a-card": ((0, 0), (1, 1)),
                 "1x4-cards": ((0, 1, 2, 3),), "3x3-nine-cards": ((0, 1, 2), (3, 4, 5), (6, 7, 8)),
                 "2x2-one-card": ((0, 0), (0, 0))}


@pytest.mark.parametrize("layout", list(CARD_LAYOUTS.values()), ids=list(CARD_LAYOUTS))
def test_two_events_a_card_order_the_pushes(layout):
    n = 5
    m = MeshDevsModel(layout).run(n)
    for d in range(m.nd):
        if m.nd > 1:
            # a step's runtime calls: a wait a neighbouring card, its
            # launch (one a block in the library), one record
            waits = sum(op[0] == "wait" for op in m.ops[d])
            assert waits == len(m.nbr[d]) * (n + 1)
        for i in range(n):
            launch = m.at(d, "launch", i)
            for e in m.nbr[d]:
                # the push of step i writes what e read at step i - 1, and
                # reads what e pushed then: after e's step i - 1
                if i > 0:
                    assert m.before(m.at(e, "launch", i - 1), launch), (d, e, i)
                else:
                    assert m.before(m.at(e, "work", "before"), launch), (d, e)
                # no two devices of one step wait on each other
                assert not m.before(m.at(e, "launch", i), launch), (d, e, i)
            # torch's next work on the card after every neighbour's last push
        for e in m.nbr[d]:
            assert m.before(m.at(e, "launch", n - 1), m.at(d, "work", "after"))
    if m.nd == 1:  # one card: stream order only, no runtime call
        assert all(op[0] in ("work", "launch") for op in m.ops[0])


def test_one_event_a_card_would_serialise_the_cards():
    # with one event a card, card 1's wait for step i - 1 catches card 0's
    # record of step i, issued just before: the cards run one after another
    m = MeshDevsModel(((0, 1), (2, 3)), events=1).run(4)
    assert m.before(m.at(0, "launch", 2), m.at(1, "launch", 2))


@pytest.mark.parametrize("store_dev", [False, True], ids=["f32", "store_dev"])
@pytest.mark.parametrize("shape", [(2, 2), (3, 2), (4, 1)], ids=lambda s: f"{s[0]}x{s[1]}")
def test_unpushed_corner_halos_hold_the_placed_bits(monkeypatch, shape, store_dev):
    # a corner halo slot of a block side on the global edge has no pusher;
    # the pull (halo_exchange_plain) copies the neighbour's halo cell on the
    # global edge there. Every buffer the library loop writes must already
    # hold those bits, so the fold leaves what the pull would write.
    p = ts.make_params(make_config(), seam_mask())
    mesh = cpu_mesh(shape)
    case = sh.ShardedCase(p, mesh)
    hl, wl = case.hl, case.wl
    ry, rx = shape
    pushed = set()
    for iy in range(ry):
        for ix in range(rx):
            for y in range(hl):
                for x in range(wl):
                    pushed.update(push_targets(ry, rx, iy, ix, hl, wl, y, x))
    corners = [((iy, ix), r, c) for iy in range(ry) for ix in range(rx)
               for r in (0, hl + 1) for c in (0, wl + 1) if ((iy, ix), r, c) not in pushed]
    assert corners  # every mesh here has a block side on the global edge
    checked = []

    def holds_placed_bits(blocks):
        pulled = [[b.clone() for b in row] for row in blocks]
        cs.halo_exchange_plain(pulled, hl, wl)
        for (iy, ix), r, c in corners:
            got, want = blocks[iy][ix][:, r, c], pulled[iy][ix][:, r, c]
            assert torch.equal(bits(got), bits(want)), ((iy, ix), r, c)
            assert torch.isnan(got.float()).all()
        checked.append(blocks[0][0].dtype)

    steps, full = cs.k1_shard_steps, cs.k1_shard_full

    def steps_checked(f_in, f_a, f_b, *a, **kw):
        holds_placed_bits(f_a)
        holds_placed_bits(f_b)
        return steps(f_in, f_a, f_b, *a, **kw)

    def full_checked(f_in, f_out, *a, **kw):
        holds_placed_bits(f_out)
        return full(f_in, f_out, *a, **kw)

    monkeypatch.setattr(cs, "k1_shard_steps", steps_checked)
    monkeypatch.setattr(cs, "k1_shard_full", full_checked)
    runner = sh.BlockRunner(mesh, "cuda", store_dev, case)
    bs = runner.place(state_from_numpy(seeded_leaves(8)), p)
    for n in (4, 3, 1):
        runner.advance(bs, p, n)
    assert len(checked) == 2 * 2 + 3  # two loop calls' f_a and f_b, three full steps
    assert (cs.DEV_DTYPE in checked) == store_dev
    for k in ("f", "f_alt"):
        holds_placed_bits(getattr(bs, k))


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
    # one K1 a block a step, the same as the per-step loop's, and no other
    # launch but the monitors' one a chunk: 10 fast steps and 3 closing ones
    mon = cs.monitor_variant(cs.obstacle_scheme(p))
    assert la == lb and la[mon] == 3
    assert sum(v for k, v in la.items() if k != mon) == 13 * shape[0] * shape[1]
    c, mc = run_blocks(p, leaves, mesh, [7, 5, 1], store_dev, stepwise=False)  # plain
    torch.cuda.synchronize()
    assert_blocks_equal(a, c)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, cs.DEV_DTYPE], ids=["f32", "bf16"])
def test_pushes_on_the_card(cuda_dev, dtype):
    # one step of a 3x2 mesh of the card through the library loop (every
    # block's K1 pushing its edges) against K1's plain step on each block
    # and halo_exchange_plain, raw bits of the whole buffers; the outputs
    # start NaN, so a halo slot left unwritten shows
    dev_store = dtype == cs.DEV_DTYPE
    p = ts.make_params(make_config((3, 0, 1, 0), "bounce_back"), seam_mask(), device=cuda_dev)
    mesh = make_mesh((3, 2), [cuda_dev] * 6)
    case = sh.ShardedCase(p, mesh)
    f = sh.BlockRunner(mesh, "cuda", False, case).place(
        state_from_numpy(seeded_leaves(9)), p).f
    if dev_store:
        f = [[cs.quantize(b) for b in row] for row in f]
    out = [[[torch.full_like(b, float("nan")) for b in row] for row in f] for _ in range(2)]
    rows = cs.scalar_rows(p, 0, 1)
    cs.reset_launch_counts()
    cs.k1_shard_steps(f, out[0], f, case.tables, rows, p.use_les, p.bc_type, case.obstacle,
                      dev_store)
    cs.k1_shard_steps_plain(f, out[1], f, case.tables, rows, p.use_les, p.bc_type,
                            case.obstacle, dev_store)
    torch.cuda.synchronize()
    assert {k: v for k, v in cs.LAUNCHES.items() if v} == {
        cs.k1_variant(case.obstacle, dev=dev_store, shard=True): 6}
    for ra, rb in zip(*out):
        for x, y in zip(ra, rb):
            assert torch.equal(bits(x), bits(y))


# ptxas's registers a thread and spill bytes (stores, loads) of K1's
# whole-grid instances (NVIDIA H100 80GB HBM3, CUDA 12.8 toolkit): the
# sharded forms' halo push is compiled into the _shard instances only, so
# these must not move with it. The ring threads' no-op branch (RingPrev)
# moved the Bouzidi instances from 62 to 64 registers and half-way's full
# step from 52 to 56, within their launch bounds' blocks a SM, and took
# deviation-storage full-way's 4 B of spills away; the production
# instances (EQ fast and full, deviation-storage EQ) kept theirs
WHOLE_GRID_PTXAS = {
    ("F32Store", cs.OBSTACLE_EQ, False): (40, 0, 0),
    ("F32Store", cs.OBSTACLE_EQ, True): (48, 0, 0),
    ("F32Store", cs.OBSTACLE_BOUNCE, False): (40, 0, 0),
    ("F32Store", cs.OBSTACLE_BOUNCE, True): (46, 0, 0),
    ("F32Store", cs.OBSTACLE_HALFWAY, False): (40, 0, 0),
    ("F32Store", cs.OBSTACLE_HALFWAY, True): (56, 0, 0),
    ("F32Store", cs.OBSTACLE_BOUZIDI, False): (64, 0, 0),
    ("F32Store", cs.OBSTACLE_BOUZIDI, True): (64, 0, 0),
    ("DevStore", cs.OBSTACLE_EQ, False): (40, 0, 0),
    ("DevStore", cs.OBSTACLE_BOUNCE, False): (40, 0, 0),
}


@pytest.mark.cuda
def test_whole_grid_k1_keeps_its_registers(cuda_dev):
    from lbm2d_tpu_torch.ops import cuda_build

    cuda_build.build_all()
    regs = cuda_build.k1_registers(cuda_build.BUILD_LOG["k1_step"])
    whole = {(st, o, full): use for (st, o, shard, full), use in regs.items() if not shard}
    assert whole == WHOLE_GRID_PTXAS
    # no sharded instance spills more, or keeps more in local memory (its
    # stack frame: the Cell it hands the out-of-line ring store), than its
    # whole-grid twin
    stack = cuda_build.k1_stack_frames(cuda_build.BUILD_LOG["k1_step"])
    for (st, o, shard, full), use in regs.items():
        if shard:
            assert use[1:] <= WHOLE_GRID_PTXAS[st, o, full][1:], (st, o, full, use)
            assert stack[st, o, True, full] <= stack[st, o, False, full], (st, o, full)


def test_ptxas_log_parser():
    # the parser phase 1 and the test above read ptxas -v with: entries by
    # their mangled template arguments, an out-of-line function's spills
    log = """ptxas info    : Compiling entry function '_Z14k1_step_kernelI8F32StoreLi3ELb1ELb0EEvPKT_PS1_' for 'sm_90a'
ptxas info    : Function properties for _Z14k1_step_kernelI8F32StoreLi3ELb1ELb0EEvPKT_PS1_
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 62 registers, used 0 barriers, 424 bytes cmem[0]
ptxas info    : Compiling entry function '_Z14k1_step_kernelI8DevStoreLi1ELb0ELb0EEvPKT_PS1_' for 'sm_90a'
ptxas info    : Function properties for _Z14k1_step_kernelI8DevStoreLi1ELb0ELb0EEvPKT_PS1_
    8 bytes stack frame, 4 bytes spill stores, 4 bytes spill loads
ptxas info    : Used 40 registers, used 0 barriers, 424 bytes cmem[0]
ptxas info    : Function properties for _Z13k1_ring_storeI8F32StoreLi0ELb1EEvPK4Cell
    16 bytes stack frame, 8 bytes spill stores, 8 bytes spill loads
ptxas info    : Compiling entry function '_Z15k3_fused_kernelILi1ELi128EEvPKfPf' for 'sm_90a'
ptxas info    : Function properties for _Z15k3_fused_kernelILi1ELi128EEvPKfPf
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 64 registers, used 1 barriers, 108544 bytes smem
"""
    from lbm2d_tpu_torch.ops import cuda_build

    assert cuda_build.k1_registers(log) == {("F32Store", 3, True, False): (62, 0, 0),
                                            ("DevStore", 1, False, False): (40, 4, 4)}
    assert cuda_build.k3_registers(log) == {(1, 128): (64, 0, 0)}
    assert cuda_build.ptxas_usage(log)["_Z13k1_ring_storeI8F32StoreLi0ELb1EEvPK4Cell"] == (
        None, 8, 8)
    assert cuda_build.k1_stack_frames(log) == {("F32Store", 3, True, False): 0,
                                               ("DevStore", 1, False, False): 8}


@pytest.mark.cuda
@pytest.mark.parametrize("layout", [((0, 1), (2, 3)), ((0, 0), (1, 1))],
                         ids=["a-card-a-block", "two-blocks-a-card"])
@pytest.mark.parametrize("store_dev", [False, True], ids=["f32", "store_dev"])
@pytest.mark.parametrize("bc_type, obstacle", SCHEMES, ids=SCHEME_IDS)
def test_shard_loop_over_cards_equals_stepwise(layout, bc_type, obstacle, store_dev):
    # a 2x2 mesh over the cards of one host: the library loop (each block's
    # K1 on its card's stream, pushing its edges across cards over peer
    # access, each card's step after its neighbours' previous one) against
    # the per-step loop through the same kernels, whole buffers bitwise,
    # and against the same mesh on one card
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
    # one K1 a block a step and no other launch: 10 fast steps and 3
    # closing ones
    assert la == lb and sum(la.values()) == 13 * 4
    one = make_mesh((2, 2), ["cuda:0"] * 4)
    c, mc = run_blocks(p, leaves, one, [7, 5, 1], store_dev, stepwise=False, plain=False)
    torch.cuda.synchronize(0)
    for k in ("f", "f_post", "rho", "u"):
        assert torch.equal(a.gather(k).cpu(), c.gather(k).cpu()), k
    assert torch.equal(ma["max_v"].cpu(), mc["max_v"].cpu())
