// K1: one D2Q9 MRT-LES lattice update of the interior cells.
//
// Replaces the TPU kernel _step_kernel (lbm2d_tpu/ops/pallas_step.py:824,
// launched by _pallas_step :1180) in its split-BC mode: pull streaming,
// butterfly MRT-LES collision with the sponge from the packed aux plane,
// the obstacle rule, and the export of the edge strips that K2
// (k2_edge_bc.cu) builds the boundary ring from. The full variant
// (full != 0) closes a chunk and also writes rho, u (zero on solids) and
// f_post on the interior.
//
// The per-cell body is lbm_cell_update (lbm_cell.cuh), shared with K3
// (k3_fused.cu). The obstacle scheme is a template parameter (LBM_OBST_*,
// the JAX kernel's branches at :967-1024 and :1139/:1157):
//   EQ       solid cells store f = w rho after the collision;
//   BOUNCE   full-way bounce-back: a solid cell's collision output is
//            replaced by its streamed populations reversed, f_k = fs[opp k],
//            and stored as is (no w rho overwrite);
//   HALFWAY  a pull whose source c - e_k is solid returns the cell's own
//            f_in[opp k](c); solids then take the w rho overwrite;
//   BOUZIDI  the same links interpolate with the wall fraction
//            q = q[opp k - 1](c) (solver.collide_stream_full):
//              q < 1/2:  2q f_in[ko](c) + (1 - 2q) f_in[ko](c + e_k)
//              q >= 1/2: f_in[ko](c) / (2q) + (2q - 1) / (2q) f_in[k](c)
//            with ko = opp k, in the eager step's operation order.
// The link predicate is the sign bit of aux at the pull source, not the
// JAX kernel's precomputed int32 bit plane: for interior cells the two are
// the same predicate, and the aux row above and below is already in L1/L2
// for the pull, so it costs no extra HBM bytes. The c + e_k read of a cell
// next to the ring lands on the ring itself, a real neighbour here: the
// port has no lane-roll wrap.
//
// The fast variant also comes in 16-bit deviation storage (k1_step_dev,
// the JAX kernel's store_dev branch, :865-870 and _to_store :1114-1120),
// for the EQ and BOUNCE schemes only (the JAX rule, :1815-1819): f_in and
// f_out hold bf16 f_k - w_k, each loaded population is dequantized as
// float(dev) + w_k, the collision runs in f32 exactly as in the f32
// variant, and f is quantized once on the way out. The edge export stays
// f32 (pre-overwrite f_post and rho/ux/uy): quantized macros would flip
// the BCs' data-dependent branches.
//
// Bound on an H100: memory. A fast step moves 76 B/cell (f 36 in + 36 out,
// aux 4) for 120 f32 operations (mrt_collide counted term by term, a sqrt
// or a division one each; chip_smoke.K1_OPS_PER_CELL), plus 32 B/cell of
// dense q planes under BOUZIDI,
// and 40 B/cell in deviation storage (f 18 + 18, aux 4), far below the
// card's ~20 flop/B balance point, so the design aims only at full-width
// coalesced traffic: one thread per interior cell, neighbouring threads on
// neighbouring x, each population pulled straight from global memory (the
// 3-row reuse of the pull stencil is left to L1/L2). The TPU kernel's row
// padding, lane rolls, band heights and two-slot DMA pipeline are TPU
// schedules and have no counterpart here; the state is an unpadded
// [9, H, W] tensor and the caller ping-pongs two buffers, since pull
// streaming cannot run in place.
//
// The edge export carries the pre-overwrite f_post as well as rho/ux/uy:
// the boundary conditions read the neighbour strip before the obstacle
// overwrite (solver.apply_bc), so K2 must not read K1's stored f there,
// and recomputing the macros from f would flip the backflow guard.
//
// The sharded form (k1_step_shard*, the JAX kernel on a shard of
// run_chunk_sharded_pallas, its interior and BCs gated by the shard's global
// origin ``offs``, :320-379) is the same body on another BlockGeom
// (lbm_common.cuh): the shard's [hl, wl] cells sit inside a 1-cell halo
// ring that the runner (parallel/sharded.py) refreshes from the neighbours
// after every step, so the pull, the link predicate (aux has the same
// halo) and Bouzidi's f(c + e_k) read across a seam exactly as the whole
// grid reads its own cells. Only cells interior in the global grid are
// updated; the halo of a block side on the global edge is never read. The
// row pitch is rounded up to 32 floats, so a block's rows start aligned as
// the whole grid's do. Bound and design as above: 76 B/cell (40 in
// deviation storage) plus the halo ring, one thread a cell.
#include <algorithm>

#include "lbm_cell.cuh"

// One thread per cell of the block whose global coordinates are interior;
// the whole grid (SHARD false) has no halo and its rows 1 .. H-2 and
// columns 1 .. W-2, a shard reads its neighbours through the halo.
template <typename S, int OBST, bool SHARD>
__global__ void __launch_bounds__(256)
k1_step_kernel(const typename S::T* __restrict__ f_in,
               typename S::T* __restrict__ f_out,
               const float* __restrict__ aux, const float* __restrict__ q,
               float* __restrict__ edge, float* __restrict__ rho_out,
               float* __restrict__ u_out, float* __restrict__ fpost_out,
               const Scalars s, const BlockGeom geom, const int use_les,
               const int full) {
  const BlockGeom g = fold_geom<SHARD>(geom);
  const int i0 = max(0, 1 - g.y_off);
  const int j0 = max(0, 1 - g.x_off), j1 = min(g.wl - 1, g.Wg - 2 - g.x_off);
  const int x = j0 + blockIdx.x * blockDim.x + threadIdx.x;
  const int y = i0 + blockIdx.y;
  if (x > j1) return;
  const size_t plane = geom_plane(g);
  const size_t c = geom_at(g, y, x);
  const long pitch = g.pitch;

  auto f_at = [&](int k, int dy, int dx) {
    return S::load(f_in, k * plane + c + dy * pitch + dx, k);
  };
  auto solid_at = [&](int dy, int dx) {
    return __float_as_int(aux[c + dy * pitch + dx]) < 0;
  };
  auto q_at = [&](int j) { return q[j * plane + c]; };

  // aux packs the sponge damping with the solid flag in the sign bit
  const float a = aux[c];
  const bool solid = __float_as_int(a) < 0;
  const float damp = fabsf(a);

  float fp[9], rho, ux, uy;
  lbm_cell_update<OBST>(f_at, solid_at, q_at, damp, solid, s, use_les, fp, &rho, &ux,
                        &uy);
  for (int k = 0; k < 9; ++k)
    S::store(f_out, k * plane + c, k, lbm_stored<OBST>(k, fp, rho, solid));

  const int gx = g.x_off + x, gy = g.y_off + y;
  if (gx == 1 || gx == g.Wg - 2) {
    float* col = edge + (size_t)(gx == 1 ? 0 : LBM_EDGE_C) * g.hl;
    for (int k = 0; k < 9; ++k) col[(size_t)k * g.hl + y] = fp[k];
    col[(size_t)9 * g.hl + y] = rho;
    col[(size_t)10 * g.hl + y] = ux;
    col[(size_t)11 * g.hl + y] = uy;
  }
  if (gy == 1 || gy == g.Hg - 2) {
    float* row = edge + (size_t)2 * LBM_EDGE_C * g.hl +
                 (size_t)(gy == 1 ? 0 : LBM_EDGE_C) * g.wl;
    for (int k = 0; k < 9; ++k) row[(size_t)k * g.wl + x] = fp[k];
    row[(size_t)9 * g.wl + x] = rho;
    row[(size_t)10 * g.wl + x] = ux;
    row[(size_t)11 * g.wl + x] = uy;
  }

  if (full) {
    rho_out[c] = rho;
    u_out[c] = solid ? 0.0f : ux;
    u_out[plane + c] = solid ? 0.0f : uy;
    for (int k = 0; k < 9; ++k) fpost_out[k * plane + c] = fp[k];
  }
}

template <typename S, int OBST, bool SHARD>
static void launch(const void* f_in, void* f_out, const void* aux,
                   const void* q, void* edge, void* rho, void* u, void* f_post,
                   const Scalars& s, const BlockGeom& g, int use_les, int full,
                   cudaStream_t stream) {
  // the block's cells that are interior in the global grid
  const int i0 = std::max(0, 1 - g.y_off);
  const int i1 = std::min(g.hl - 1, g.Hg - 2 - g.y_off);
  const int j0 = std::max(0, 1 - g.x_off);
  const int j1 = std::min(g.wl - 1, g.Wg - 2 - g.x_off);
  if (i1 < i0 || j1 < j0) return;
  const dim3 block(256, 1, 1);
  const dim3 grid((j1 - j0 + 256) / 256, i1 - i0 + 1, 1);
  k1_step_kernel<S, OBST, SHARD><<<grid, block, 0, stream>>>(
      static_cast<const typename S::T*>(f_in),
      static_cast<typename S::T*>(f_out), static_cast<const float*>(aux),
      static_cast<const float*>(q), static_cast<float*>(edge),
      static_cast<float*>(rho), static_cast<float*>(u),
      static_cast<float*>(f_post), s, g, use_les, full);
}

template <bool SHARD>
static int dispatch(const void* f_in, void* f_out, const void* aux,
                    const void* q, void* edge, void* rho, void* u, void* f_post,
                    const void* scal, const BlockGeom& g, int use_les, int full,
                    int obst, void* stream) {
  const Scalars s = load_scalars(static_cast<const float*>(scal));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (obst) {
    case LBM_OBST_EQ:
      launch<F32Store, LBM_OBST_EQ, SHARD>(f_in, f_out, aux, q, edge, rho, u,
                                           f_post, s, g, use_les, full, st);
      break;
    case LBM_OBST_BOUNCE:
      launch<F32Store, LBM_OBST_BOUNCE, SHARD>(f_in, f_out, aux, q, edge, rho,
                                               u, f_post, s, g, use_les, full,
                                               st);
      break;
    case LBM_OBST_HALFWAY:
      launch<F32Store, LBM_OBST_HALFWAY, SHARD>(f_in, f_out, aux, q, edge, rho,
                                                u, f_post, s, g, use_les, full,
                                                st);
      break;
    case LBM_OBST_BOUZIDI:
      launch<F32Store, LBM_OBST_BOUZIDI, SHARD>(f_in, f_out, aux, q, edge, rho,
                                                u, f_post, s, g, use_les, full,
                                                st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// Launches K1 on ``stream``; returns cudaGetLastError() as an int, or
// cudaErrorInvalidValue for an unknown scheme. ``scal`` is a host pointer
// to the 14-float scalar row (copied into the kernel's parameters at
// launch), ``geom`` one to the block's 8 ints (load_geom): the whole
// [H, W] grid (halo 0, the single-device step) or one shard of a spatial
// mesh (the JAX kernel's sharded form, launched by run_chunk_sharded_pallas
// through _pallas_step(offs, h_lo, h_hi)), whose [hl + 2, pitch] planes hold
// the 1-cell halo ring its neighbours' cells were copied into; only cells
// interior in the Hg x Wg grid are updated, and only a block on the global
// edge exports a strip. ``obst`` is LBM_OBST_*; ``q`` ([8] planes of the
// block) is read only under BOUZIDI, rho/u/f_post only when full; all share
// the block's geometry.
extern "C" int k1_step_launch(const void* f_in, void* f_out, const void* aux,
                              const void* q, void* edge, void* rho, void* u,
                              void* f_post, const void* scal, const int* geom,
                              int use_les, int full, int obst, void* stream) {
  const BlockGeom g = load_geom(geom);
  return g.halo ? dispatch<true>(f_in, f_out, aux, q, edge, rho, u, f_post,
                                 scal, g, use_les, full, obst, stream)
                : dispatch<false>(f_in, f_out, aux, q, edge, rho, u, f_post,
                                  scal, g, use_les, full, obst, stream);
}

// The fast step in 16-bit deviation storage (EQ and BOUNCE only).
template <bool SHARD>
static int dispatch_dev(const void* f_in, void* f_out, const void* aux,
                        void* edge, const void* scal, const BlockGeom& g,
                        int use_les, int obst, void* stream) {
  const Scalars s = load_scalars(static_cast<const float*>(scal));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (obst) {
    case LBM_OBST_EQ:
      launch<DevStore, LBM_OBST_EQ, SHARD>(f_in, f_out, aux, nullptr, edge,
                                           nullptr, nullptr, nullptr, s, g,
                                           use_les, 0, st);
      break;
    case LBM_OBST_BOUNCE:
      launch<DevStore, LBM_OBST_BOUNCE, SHARD>(f_in, f_out, aux, nullptr, edge,
                                               nullptr, nullptr, nullptr, s, g,
                                               use_les, 0, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The fast step in 16-bit deviation storage: f_in and f_out are bf16
// planes of f - w in the block's geometry (halos included on a shard); the
// edge export is f32 as above. Schemes EQ and BOUNCE only.
extern "C" int k1_step_dev_launch(const void* f_in, void* f_out,
                                  const void* aux, void* edge,
                                  const void* scal, const int* geom,
                                  int use_les, int obst, void* stream) {
  const BlockGeom g = load_geom(geom);
  return g.halo ? dispatch_dev<true>(f_in, f_out, aux, edge, scal, g, use_les,
                                     obst, stream)
                : dispatch_dev<false>(f_in, f_out, aux, edge, scal, g, use_les,
                                      obst, stream);
}
