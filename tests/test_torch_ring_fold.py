"""K1 with the boundary ring folded in: one launch a step, the ring written
by ring threads of the same launch, each from its inward neighbour's
collide output (``csrc/k1_step.cu`` ``k1_ring``, ``lbm_cell.cuh``
``lbm_ring_values``), checked on the CPU through the plain version
(``cuda_step.k1_step_plain``: the interior step, then the ring from the
interior's collide output).

Against the JAX package's in-kernel-BC form of ``_step_kernel``, the form
the fold mirrors (``_apply_bc_band`` on f_post before the obstacle
overwrite), run as its own tests run it, in interpret mode:

- the chunk runner on one device against ``run_chunk_pallas(
  interpret=True, split_bc=False)``, 32x64, 8 steps, f32, with solids on
  columns 1 / W-2, rows 1 / H-2 and the ring itself: within 1e-6 absolute
  on f, rho, u and f_post, the limit of ``test_torch_dfg_pallas.py``.
  Read on a CPU: f 1.6e-7, rho and u 2.4e-7, f_post 1.5e-7 in each of the
  five cases, a few f32 ulps of O(1) values;
- the sharded plain runner on a (2, 2) mesh against
  ``run_chunk_sharded_pallas(interpret=True)``, whose 64-wide shards take
  its in-kernel-BC path, 64x128, 8 steps: the same limit (read f and
  f_post 1.5e-7, rho and u 2.4e-7).

The obstacle force is held within 5e-6 absolute: it sums one momentum
term per boundary link, and this mask's solids on the ring and the strips
add links whose terms do not cancel. Read: 1.4e-6 (``eq-3010``, forces
~0.1) and 2.3e-6 on the 2x2 mesh, where the JAX package's own sharded
force and its single-device force of the same f_post differ by 7.2e-7
(the sums' order).

Within the port: every cell of a step's output is written exactly once (a
write counter on f_out), a ring poisoned with NaN comes out finite and
equal to the eager step bitwise, on the whole grid and on each block of a
2x2 mesh, f32 and deviation storage.
"""

import jax
import numpy as np
import pytest
import torch

from lbm2d_tpu.core import solver as js
from lbm2d_tpu.ops.pallas_step import run_chunk_pallas
from lbm2d_tpu.parallel import sharded as jsh
from lbm2d_tpu.parallel.topology import make_mesh as jax_mesh
from lbm2d_tpu.parallel.topology import shard_state as jax_shard_state
from lbm2d_tpu_torch.core import solver as ts
from lbm2d_tpu_torch.core.lattice import f_eq
from lbm2d_tpu_torch.ops import cuda_step as cs
from lbm2d_tpu_torch.parallel import sharded as sh
from lbm2d_tpu_torch.parallel.topology import make_mesh
import torch_threads  # noqa: F401  (the test processes' torch thread budget)

H, W = 32, 64
STEPS = 8
VS_JAX_F32 = 1e-6
FORCE_TOL = 5e-6
CASES = [((0, 2, 1, 2), "equilibrium"), ((0, 2, 1, 2), "bounce_back"),
         ((0, 2, 1, 2), "bounce_back_halfway"), ((3, 0, 1, 0), "equilibrium"),
         ((4, 0, 1, 0), "bounce_back_bouzidi")]
CASE_IDS = ["eq-0212", "full-0212", "half-0212", "eq-3010", "bouzidi-4010"]


def make_config(bc_type=(0, 2, 1, 2), obstacle="equilibrium", ny=H, nx=W):
    return {
        "simulation": {
            "nx": nx, "ny": ny, "nu": 0.02, "ghost_moments_s": 1.2,
            "rho_in": 1.02, "rho_out": 1.0, "warmup_steps": 6,
            "smagorinsky_constant": 0.1,
        },
        "domain_zones": {
            "sponge_in": 4, "sponge_out": 6, "sponge_top": 3, "sponge_bot": 3,
            "sponge_strength": 3.0,
        },
        "boundary_condition": {
            "type": list(bc_type),
            "value": [[0.06, 0.0], [0.02, 0.01], [0.03, -0.01], [0.01, 0.02]],
            "obstacle": obstacle,
        },
    }


def edge_mask(ny=H, nx=W, seed=0):
    """A seeded mask: a disc in the middle, solids on the strips every BC
    reads (columns 1 / W-2, rows 1 / H-2, next to the corners too) and on
    the ring itself."""
    rng = np.random.default_rng(seed)
    yy, xx = np.mgrid[0:ny, 0:nx]
    mask = ((yy - (ny / 2 - 0.4)) ** 2 + (xx - (nx / 2 + 0.3)) ** 2 < 20).astype(np.float32)
    for col in (1, nx - 2):
        mask[rng.choice(np.arange(2, ny - 2), 3, replace=False), col] = 1.0
    for row in (1, ny - 2):
        mask[row, rng.choice(np.arange(2, nx - 2), 3, replace=False)] = 1.0
    mask[1, 1] = mask[ny - 2, nx - 2] = 1.0
    mask[0, nx // 3] = mask[ny // 2, 0] = mask[ny - 1, nx - 1] = 1.0
    return mask


def seeded_state(seed=0, ny=H, nx=W):
    rng = np.random.default_rng(seed)
    rho = torch.tensor(1.0 + 0.01 * rng.standard_normal((ny, nx)), dtype=torch.float32)
    u = torch.tensor(0.03 * rng.standard_normal((2, ny, nx)), dtype=torch.float32)
    f = f_eq(rho, u[0], u[1])
    return ts.LBMState(f=f, f_post=f.clone(), rho=rho, u=u, step=0)


def jax_state(st):
    return js.LBMState(f=st.f.numpy(), f_post=st.f_post.numpy(), rho=st.rho.numpy(),
                       u=st.u.numpy(), step=np.int32(st.step))


def max_abs(a, b, keys=("f", "rho", "u", "f_post")):
    return max(float(np.abs(np.asarray(getattr(a, k)) - np.asarray(getattr(b, k))).max())
               for k in keys)


@pytest.mark.parametrize("bc_type, obstacle", CASES, ids=CASE_IDS)
def test_folded_chunk_matches_jax_in_kernel_bc(bc_type, obstacle):
    cfg, mask = make_config(bc_type, obstacle), edge_mask()
    pt = ts.make_params(cfg, mask)
    pj = js.make_params(cfg, mask)
    s0 = seeded_state(1)
    st, mt = cs.run_chunk_plain(s0, pt, STEPS)
    sj, mj = run_chunk_pallas(jax_state(s0), pj, n_steps=STEPS, interpret=True,
                              split_bc=False)
    assert max_abs(st, sj) <= VS_JAX_F32
    np.testing.assert_allclose(mt["force"].numpy(), np.asarray(mj["force"]), rtol=0,
                               atol=FORCE_TOL)
    # and the plain chunk is the eager step's, bitwise
    se, _ = ts.run_chunk(s0, pt, STEPS)
    for k in ("f", "f_post", "rho", "u"):
        assert torch.equal(getattr(st, k), getattr(se, k)), k


def test_sharded_folded_chunk_matches_jax_2x2():
    assert len(jax.devices()) >= 4, "needs the root conftest's host devices"
    ny, nx = 64, 128
    cfg, mask = make_config(ny=ny, nx=nx), edge_mask(ny, nx, seed=2)
    pt = ts.make_params(cfg, mask)
    s0 = seeded_state(3, ny, nx)
    mesh = make_mesh((2, 2), ["cpu"] * 4)
    st, mt = sh.run_chunk_sharded_plain(s0, pt, STEPS, mesh)
    jmesh = jax_mesh(shape=(2, 2), devices=jax.devices()[:4])
    sj0, pj = jax_shard_state(jax_state(s0), js.make_params(cfg, mask), jmesh)
    sj, mj = jsh.run_chunk_sharded_pallas(sj0, pj, n_steps=STEPS, mesh=jmesh, ny=ny, nx=nx,
                                          interpret=True)
    assert max_abs(st, sj) <= VS_JAX_F32
    np.testing.assert_allclose(mt["force"].numpy(), np.asarray(mj["force"]), rtol=0,
                               atol=FORCE_TOL)
    ref, _ = cs.run_chunk_plain(s0, pt, STEPS)
    for k in ("f", "f_post", "rho", "u"):
        assert torch.equal(getattr(st, k), getattr(ref, k)), k


class WriteCounter(torch.Tensor):
    """A tensor that counts, per element, the assignments made into it."""

    def __setitem__(self, key, value):
        self.counts[key] += 1
        super().__setitem__(key, value)


def counted(t: torch.Tensor) -> torch.Tensor:
    out = t.as_subclass(WriteCounter)
    out.counts = torch.zeros(t.shape, dtype=torch.int32)
    return out


def ring_of(shape):
    ring = torch.ones(shape, dtype=torch.bool)
    ring[1:-1, 1:-1] = False
    return ring


# deviation storage runs equilibrium and full-way bounce-back only
WRITE_CASES = [(c, m) for c in zip(CASES, CASE_IDS) for m in ("fast", "full", "dev")
               if m != "dev" or c[0][1] in ("equilibrium", "bounce_back")]


@pytest.mark.parametrize("case, mode", WRITE_CASES, ids=[f"{m}-{c[1]}" for c, m in WRITE_CASES])
def test_each_cell_written_once(case, mode):
    (bc_type, obstacle), _ = case
    p = ts.make_params(make_config(bc_type, obstacle), edge_mask())
    s = seeded_state(4)
    ring = ring_of((H, W))
    aux = cs.pack_aux(p.damping, p.mask)
    scal = cs.scalar_row(p, 1)
    eager = ts.step(s, p)
    obst = cs.obstacle_scheme(p)
    q = p.bouzidi_q if obst == cs.OBSTACLE_BOUZIDI else None
    prof = p.inlet_profile if bc_type[0] in (3, 4) else None
    f_in = cs.quantize(s.f) if mode == "dev" else s.f
    out = torch.zeros_like(f_in)
    out[:, ring] = float("nan")  # a ring cell left unwritten stays NaN
    out = counted(out)
    if mode == "dev":
        cs.k1_step_dev(f_in, out, aux, scal, p.use_les, p.bc_type, obst, prof)
        ref = torch.empty_like(s.f)
        cs.k1_step(cs.dequantize(f_in), ref, aux, scal, p.use_les, p.bc_type, obstacle=obst,
                   prof=prof)
        assert torch.equal(out.as_subclass(torch.Tensor), cs.quantize(ref))
    else:
        full = mode == "full"
        rho = counted(torch.full((H, W), float("nan"))) if full else None
        u = counted(torch.full((2, H, W), float("nan"))) if full else None
        f_post = s.f_post.clone() if full else None
        cs.k1_step(s.f, out, aux, scal, p.use_les, p.bc_type, rho, u, f_post, obstacle=obst,
                   q=q, prof=prof)
        assert torch.equal(out.as_subclass(torch.Tensor), eager.f)
        if full:
            assert torch.equal(rho.as_subclass(torch.Tensor), eager.rho)
            assert torch.equal(u.as_subclass(torch.Tensor), eager.u)
            assert torch.equal(f_post, eager.f_post)
            assert (rho.counts == 1).all() and (u.counts == 1).all()
    assert torch.isfinite(out.as_subclass(torch.Tensor).float()).all()
    assert (out.counts == 1).all(), out.counts[0]


@pytest.mark.parametrize("dev_store", [False, True], ids=["f32", "dev"])
def test_each_ring_cell_written_once_on_blocks(dev_store):
    # every block of a 2x2 mesh, its halo filled from the seeded state (NaN
    # beyond the global edge): a block writes its interior cells and the
    # global ring cells it holds, once each, and nothing else
    p = ts.make_params(make_config((4, 2, 1, 0), "bounce_back"), edge_mask())
    s = seeded_state(5)
    mesh = make_mesh((2, 2), ["cpu"] * 4)
    case = sh.ShardedCase(p, mesh)
    f = cs.quantize(s.f) if dev_store else s.f
    src = sh.halo_blocks(f, mesh, sh.NAN, case.pitch)
    outs = []
    for iy in range(2):
        row = []
        for ix in range(2):
            g = case.geoms[iy][ix]
            out = counted(torch.full_like(src[iy][ix], float("nan")))
            args = (src[iy][ix], out, case.aux[iy][ix], cs.scalar_row(p, 1), p.use_les,
                    p.bc_type)
            prof = sh._at(case.prof, iy, ix)
            if dev_store:
                cs.k1_step_dev(*args, case.obstacle, prof, geom=g)
            else:
                cs.k1_step(*args, obstacle=case.obstacle, prof=prof, geom=g)
            own = out.counts[0, 1:g.hl + 1, 1:g.wl + 1]
            assert (own == 1).all(), (iy, ix, own)
            assert out.counts[0].sum() == g.hl * g.wl  # no halo cell written
            row.append(out.as_subclass(torch.Tensor))
        outs.append(row)
    got = sh.gather_halo_blocks(outs, case.hl, case.wl, "cpu")
    assert torch.isfinite(got.float()).all()
    ref = torch.empty_like(s.f)
    cs.k1_step_plain(cs.dequantize(f) if dev_store else f, ref, cs.pack_aux(p.damping, p.mask),
                     cs.scalar_row(p, 1), p.use_les, p.bc_type, prof=p.inlet_profile,
                     obstacle=case.obstacle)
    assert torch.equal(got, cs.quantize(ref) if dev_store else ref)
    if not dev_store:
        assert torch.equal(got, ts.step(s, p).f)
