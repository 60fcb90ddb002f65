"""The port's spatially sharded runners (``lbm2d_tpu_torch/parallel``) on
the CPU.

Within the port, bitwise: the eager ``run_chunk_sharded`` equals the
single-device ``run_chunk``, and ``run_chunk_sharded_plain`` (the sharded
K1/K2 through their plain versions) equals ``run_chunk_plain``, in f32 and
in 16-bit deviation storage, on meshes (2, 4), (2, 2), (4, 1) and (1, 4)
with a solid across the seams, for every obstacle scheme and left types 0
and 3/4. Both sides round the same f32 operations on every cell.

Against the JAX package, on the root conftest's 8 host devices and the
same seeded inputs; limits, each set from a reading on the CPU (PERF.md):

- the eager sharded step against the JAX ``run_chunk_sharded`` in float64,
  20 steps on (2, 4): 1e-12 absolute (read 4.4e-16, force 4.4e-16);
- the plain sharded runner against ``run_chunk_sharded_pallas(
  interpret=True)``, on (4, 1) at 64x128 (its split-BC path) and on (2, 4)
  with ``tiles=(16, 8, 32, 128)`` (its in-kernel-BC path), 12 steps: 1e-6
  absolute on f, rho, u and f_post, f32 (read 2.4e-7 on both), the force
  2e-6 (read 6.6e-7);
- deviation storage against the JAX sharded ``store_dev`` chunk on (4, 1),
  12 steps from rest: 5e-5 absolute, the single-device pair's limit
  (test_torch_store_dev.py; read 8.8e-6, and 7.2e-6 from the exact chunk).
"""

import jax

jax.config.update("jax_enable_x64", True)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
import pytest  # noqa: E402
import torch  # noqa: E402

from lbm2d_tpu.core import solver as js  # noqa: E402
from lbm2d_tpu.parallel import sharded as jsh  # noqa: E402
from lbm2d_tpu.parallel.topology import make_mesh as jax_mesh  # noqa: E402
from lbm2d_tpu.parallel.topology import shard_state as jax_shard_state  # noqa: E402
from lbm2d_tpu_torch.core import solver as ts  # noqa: E402
from lbm2d_tpu_torch.core.lattice import f_eq  # noqa: E402
from lbm2d_tpu_torch.ops import cuda_step as cs  # noqa: E402
from lbm2d_tpu_torch.parallel import sharded as sh  # noqa: E402
from lbm2d_tpu_torch.parallel.topology import (  # noqa: E402
    block_shape,
    gather_state,
    make_mesh,
    mesh_refusal,
    shard_state,
)

H, W = 32, 64
MESHES = [(2, 4), (2, 2), (4, 1), (1, 4)]
SCHEMES = [((0, 2, 1, 2), "equilibrium"), ((0, 2, 1, 2), "bounce_back"),
           ((3, 0, 1, 0), "bounce_back_halfway"), ((4, 2, 1, 2), "bounce_back_bouzidi")]
SCHEME_IDS = ["eq-0212", "full-0212", "half-3010", "bouzidi-4212"]
STEPS = 10
VS_JAX_F32 = 1e-6
VS_JAX_DEV = 5e-5


def make_config(bc_type=(0, 2, 1, 2), obstacle="equilibrium", ny=H, nx=W, rho_in=1.02,
                warmup=12):
    return {
        "simulation": {
            "nx": nx, "ny": ny, "nu": 0.02, "ghost_moments_s": 1.2,
            "rho_in": rho_in, "rho_out": 1.0, "warmup_steps": warmup,
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


def seam_mask(ny=H, nx=W, edge_solids=True):
    """A disc across the seams of every mesh above (row ny/2, column nx/2),
    plus solids on the strips the BCs read (left out against the JAX
    split-BC path, which feeds them to the BCs overwritten: ROADMAP.md,
    queue 3)."""
    yy, xx = np.mgrid[0:ny, 0:nx]
    mask = ((yy - (ny / 2 - 0.4)) ** 2 + (xx - (nx / 2 + 0.3)) ** 2 < 30).astype(np.float32)
    if edge_solids:
        mask[3:5, 1] = 1.0  # column 1, read by the left BC
        mask[ny - 2, 9] = 1.0  # row H-2, read by the top BC
    return mask


def seeded_state(seed=0, ny=H, nx=W):
    rng = np.random.default_rng(seed)
    rho = torch.tensor(1.0 + 0.01 * rng.standard_normal((ny, nx)), dtype=torch.float32)
    u = torch.tensor(0.03 * rng.standard_normal((2, ny, nx)), dtype=torch.float32)
    f = f_eq(rho, u[0], u[1])
    return ts.LBMState(f=f, f_post=f.clone(), rho=rho, u=u, step=0)


def cpu_mesh(shape):
    return make_mesh(shape, ["cpu"] * (shape[0] * shape[1]))


def assert_same(a, b):
    for k in ("f", "f_post", "rho", "u"):
        assert torch.equal(getattr(a, k), getattr(b, k)), k
    assert a.step == b.step


@pytest.mark.parametrize("bc_type, obstacle", SCHEMES, ids=SCHEME_IDS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_eager_sharded_equals_run_chunk(shape, bc_type, obstacle):
    p = ts.make_params(make_config(bc_type, obstacle), seam_mask())
    s0 = seeded_state()
    a, ma = sh.run_chunk_sharded(s0, p, 6, cpu_mesh(shape))
    a, ma = sh.run_chunk_sharded(a, p, STEPS - 6, cpu_mesh(shape))  # mid-warmup restart
    b, mb = ts.run_chunk(s0, p, STEPS)
    assert_same(a, b)
    assert torch.equal(ma["force"], mb["force"]) and torch.equal(ma["max_v"], mb["max_v"])


@pytest.mark.parametrize("bc_type, obstacle", SCHEMES, ids=SCHEME_IDS)
@pytest.mark.parametrize("shape", MESHES, ids=lambda s: f"{s[0]}x{s[1]}")
def test_plain_sharded_equals_run_chunk_plain(shape, bc_type, obstacle):
    p = ts.make_params(make_config(bc_type, obstacle), seam_mask())
    s0 = seeded_state(1)
    mesh = cpu_mesh(shape)
    before = dict(cs.LAUNCHES)
    a, ma = sh.run_chunk_sharded_plain(s0, p, STEPS, mesh)
    b, mb = cs.run_chunk_plain(s0, p, STEPS)
    assert_same(a, b)
    assert torch.equal(ma["force"], mb["force"])
    # the wrappers take their plain versions on CPU tensors, uncounted
    c, _ = sh.run_chunk_sharded_cuda(s0, p, STEPS, mesh)
    assert_same(c, b)
    assert cs.LAUNCHES == before
    # deviation storage: engaged for equilibrium and full-way, exact f32
    # otherwise (the JAX rule), equal to the single-device split either way
    a, _ = sh.run_chunk_sharded_plain(s0, p, STEPS, mesh, store_dev=True)
    b, _ = cs.run_chunk_plain(s0, p, STEPS, store_dev=True)
    assert_same(a, b)
    engaged = cs.obstacle_scheme(p) in cs.DEV_OBSTACLES
    assert (not torch.equal(a.f, sh.run_chunk_sharded_plain(s0, p, STEPS, mesh)[0].f)) == engaged


def test_global_edge_halos_are_never_read():
    # the runners fill the halo beyond the global edge with NaN, in f, aux
    # and q; a read would reach the state
    p = ts.make_params(make_config((4, 2, 1, 2), "bounce_back_bouzidi"), seam_mask())
    mesh = cpu_mesh((2, 2))
    blocks = sh.halo_blocks(seeded_state(2).f, mesh, sh.NAN, 40)
    assert torch.isnan(blocks[0][0][:, 0]).all() and torch.isnan(blocks[0][0][:, :, 0]).all()
    assert not torch.isnan(blocks[0][0][:, 1:-1, 1:33]).any()
    case = sh.ShardedCase(p, mesh)
    assert torch.isnan(case.aux[1][1][-1]).all() and torch.isnan(case.q[1][1][:, :, 33]).all()
    a, _ = sh.run_chunk_sharded_plain(seeded_state(2), p, STEPS, mesh, case=case)
    b, _ = cs.run_chunk_plain(seeded_state(2), p, STEPS)
    assert torch.isfinite(a.f).all()
    assert_same(a, b)


def test_corner_transport():
    # a bump in the NE population at the cell just SW of a 2x2 mesh's corner
    # point crosses the corner diagonally (the two-hop halo)
    cfg = make_config(rho_in=1.0)
    cfg["simulation"]["smagorinsky_constant"] = 0.0
    p = ts.make_params(cfg, np.zeros((H, W), np.float32))
    s0 = ts.init_state(H, W)
    cy, cx = H // 2 - 1, W // 2 - 1
    s0.f[5, cy, cx] += 0.01
    ref, _ = ts.run_chunk(s0, p, 3)
    for run in (sh.run_chunk_sharded, sh.run_chunk_sharded_plain):
        a, _ = run(s0, p, 3, cpu_mesh((2, 2)))
        assert_same(a, ref)
    d = (ref.f[5] - ts.init_state(H, W).f[5]).abs()
    assert d[cy + 1:, cx + 1:].max() > 1e-4


def test_shard_and_gather_round_trip():
    p = ts.make_params(make_config((4, 2, 1, 2), "bounce_back_bouzidi"), seam_mask())
    s0 = seeded_state(3)
    states, params = shard_state(s0, p, cpu_mesh((2, 4)))
    assert states[1][2].f.shape == (9, 16, 16)
    assert torch.equal(params[1][2].bouzidi_q, p.bouzidi_q[:, 16:, 32:48])
    assert torch.equal(params[1][0].inlet_profile, p.inlet_profile[16:])
    assert torch.equal(params[0][3].mask, p.mask[:16, 48:])
    assert params[0][0].bc_type == p.bc_type and params[0][0].bouzidi_obstacle
    back = gather_state(states, "cpu")
    assert_same(back, s0)


def test_mesh_refusals():
    p = ts.make_params(make_config(), seam_mask())
    assert mesh_refusal(p.shape, (2, 4)) is None and cs.unsupported(p) is None
    assert "not divisible by spatial_mesh 3x1" in mesh_refusal(p.shape, (3, 1))
    assert "smaller than 3x3" in mesh_refusal(p.shape, (16, 1))
    with pytest.raises(ValueError, match="not divisible by spatial_mesh 3x1"):
        block_shape(p.shape, cpu_mesh((3, 1)))
    for run in (sh.run_chunk_sharded, sh.run_chunk_sharded_plain, sh.run_chunk_sharded_cuda):
        with pytest.raises(ValueError, match="spatial_mesh 1x32"):
            run(seeded_state(), p, 2, cpu_mesh((1, 32)))
    with pytest.raises(ValueError, match="n_steps"):
        sh.run_chunk_sharded_plain(seeded_state(), p, 0, cpu_mesh((2, 2)))


def test_single_step_and_geometry():
    p = ts.make_params(make_config(), seam_mask())
    a, _ = sh.run_chunk_sharded_plain(seeded_state(4), p, 1, cpu_mesh((2, 2)), store_dev=True)
    b, _ = ts.run_chunk(seeded_state(4), p, 1)
    assert_same(a, b)
    g = cs.BlockGeom.shard(16, 32, 16, 32, H, W)
    assert g.pitch == 64 and g.plane == (18, 64)
    assert g.interior() == (0, 14, 0, 30)
    assert cs.BlockGeom.whole(H, W).interior() == (1, H - 2, 1, W - 2)


# ---------------------------------------------------------------------------
# Against the JAX package's sharded runners
# ---------------------------------------------------------------------------


def jax_state(st, dtype=np.float32):
    f = st.f.numpy().astype(dtype)
    return js.LBMState(f=f, f_post=st.f_post.numpy().astype(dtype),
                       rho=st.rho.numpy().astype(dtype), u=st.u.numpy().astype(dtype),
                       step=np.int32(st.step))


def max_abs(a, b, keys=("f", "rho", "u", "f_post")):
    return max(float(np.abs(np.asarray(getattr(a, k)) - np.asarray(getattr(b, k))).max())
               for k in keys)


def _on_jax_mesh(state, p, shape):
    mesh = jax_mesh(shape=shape, devices=jax.devices()[:shape[0] * shape[1]])
    st, pj = jax_shard_state(state, p, mesh)
    return st, pj, mesh


@pytest.mark.parametrize("bc_type, obstacle", [((0, 2, 1, 2), "equilibrium"),
                                               ((4, 2, 1, 2), "bounce_back_bouzidi")],
                         ids=["eq-0212", "bouzidi-4212"])
def test_eager_sharded_matches_jax_f64(bc_type, obstacle):
    assert len(jax.devices()) >= 8, "needs the root conftest's 8 host devices"
    cfg, mask = make_config(bc_type, obstacle), seam_mask(edge_solids=False)
    s0 = seeded_state(5)
    pt = ts.make_params(cfg, mask, dtype=torch.float64)
    s64 = ts.LBMState(f=s0.f.double(), f_post=s0.f_post.double(), rho=s0.rho.double(),
                      u=s0.u.double(), step=0)
    st, mt = sh.run_chunk_sharded(s64, pt, 20, cpu_mesh((2, 4)))
    sj0, pj, mesh = _on_jax_mesh(jax_state(s0, np.float64),
                                 js.make_params(cfg, mask, dtype=jnp.float64), (2, 4))
    sj, mj = jsh.run_chunk_sharded(sj0, pj, n_steps=20, mesh=mesh, ny=H, nx=W)
    assert st.f.dtype == torch.float64 and np.asarray(sj.f).dtype == np.float64
    assert max_abs(st, sj) <= 1e-12
    np.testing.assert_allclose(mt["force"].numpy(), np.asarray(mj["force"]), rtol=0, atol=1e-12)


@pytest.mark.parametrize("shape, ny, nx, tiles", [((4, 1), 64, 128, None),
                                                  ((2, 4), 64, 128, (16, 8, 32, 128))],
                         ids=["4x1-split", "2x4-tiles"])
def test_plain_sharded_matches_jax_pallas(shape, ny, nx, tiles):
    cfg, mask = make_config(ny=ny, nx=nx), seam_mask(ny, nx, edge_solids=False)
    s0 = seeded_state(6, ny, nx)
    pt = ts.make_params(cfg, mask)
    st, mt = sh.run_chunk_sharded_plain(s0, pt, 12, cpu_mesh(shape))
    sj0, pj, mesh = _on_jax_mesh(jax_state(s0), js.make_params(cfg, mask), shape)
    sj, mj = jsh.run_chunk_sharded_pallas(sj0, pj, n_steps=12, mesh=mesh, ny=ny, nx=nx,
                                          interpret=True, tiles=tiles)
    assert max_abs(st, sj) <= VS_JAX_F32
    np.testing.assert_allclose(mt["force"].numpy(), np.asarray(mj["force"]), rtol=0, atol=2e-6)


def test_store_dev_sharded_matches_jax_pallas():
    ny, nx = 64, 128
    cfg = make_config(ny=ny, nx=nx, warmup=30)  # the store_dev budget test's ramp
    mask = seam_mask(ny, nx, edge_solids=False)
    pt = ts.make_params(cfg, mask)
    s0 = ts.init_state(ny, nx)
    st, _ = sh.run_chunk_sharded_plain(s0, pt, 12, cpu_mesh((4, 1)), store_dev=True)
    exact, _ = sh.run_chunk_sharded_plain(s0, pt, 12, cpu_mesh((4, 1)))
    sj0, pj, mesh = _on_jax_mesh(jax_state(s0), js.make_params(cfg, mask), (4, 1))
    sj, _ = jsh.run_chunk_sharded_pallas(sj0, pj, n_steps=12, mesh=mesh, ny=ny, nx=nx,
                                         interpret=True, store_dev=True)
    assert max_abs(st, sj, ("f", "rho", "u")) <= VS_JAX_DEV
    assert 0 < max_abs(st, exact, ("f", "rho", "u")) <= 5e-4  # engaged, within the budget
