// K1: one D2Q9 MRT-LES lattice update, the boundary ring included.
//
// Replaces the TPU kernel _step_kernel (lbm2d_tpu/ops/pallas_step.py:824,
// launched by _pallas_step :1180) in its in-kernel-BC form (apply_bc=True,
// _apply_bc_band on f_post before the obstacle overwrite, :1028-1034):
// pull streaming, butterfly MRT-LES collision with the sponge from the
// packed aux plane, the boundary conditions of the ring and the obstacle
// rule, in solver.apply_bc order. The full variant (its own instance,
// FULL) closes a chunk and also writes rho, u (zero on solids) on every
// cell and f_post on the interior. One launch is one lattice step. The TPU's split form
// (_step_kernel with an edge export, then _edge_bc_kernel :1379 rebuilding
// the ring) is folded in: the ring is written by ring threads of the same
// launch.
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
// The ring: a ring cell's BC values depend only on the collide output of
// its inward neighbour before the obstacle overwrite (f_post, rho, ux,
// uy). Before the interior's rows of blocks the launch has a few rows of
// ring blocks, one thread a ring cell (K2's layout, the job of the TPU's
// _edge_bc_kernel): the thread computes its neighbour's collide output
// itself -- the update's arithmetic on the same read-only f_in, so the same
// bits as the neighbour's own thread -- and stores the cell's BC values
// (lbm_ring_values, in apply_bc's order: at a corner the side BC first).
// Each ring cell has one writer and no thread reads another's output, so
// there is no grid-wide sync, no export buffer, no shared memory and no
// second launch. Left types 0 (Zou-He pressure inlet), 2 (free-slip), 3/4
// (the profiled velocity inlets, read from the case's [H] inlet_profile
// tensor, never recomputed); right 0 (velocity inlet), 1 (Zou-He pressure
// outlet with the backflow guard) or 2; top/bottom 0 or 2.
// Why not the neighbour's own thread, which holds these values in
// registers: ptxas gives a kernel the register count of its hungriest
// path, and the ring's branches inlined after the update took several
// times the update's registers a thread, cutting the blocks a SM holds,
// or, capped by launch bounds, spilled the update's own values on every
// thread; either way K1 ran slower than K1 + K2 had (PERF.md). The ring
// threads' path is one update and one BC chain, in a branch of its own.
//
// The fast variant also comes in 16-bit deviation storage (k1_step_dev,
// the JAX kernel's store_dev branch, :865-870 and _to_store :1114-1120),
// for the EQ and BOUNCE schemes only (the JAX rule, :1815-1819): f_in and
// f_out hold bf16 f_k - w_k, each loaded population is dequantized as
// float(dev) + w_k, the collision and the ring's BCs run in f32 exactly as
// in the f32 variant (the BCs read the f32 collide output, never the
// quantized neighbour), and f is quantized once on the way out.
//
// Bound on an H100: memory. A fast step moves 76 B/cell (f 36 in + 36 out,
// aux 4) for 120 f32 operations (mrt_collide counted term by term, a sqrt
// or a division one each; chip_smoke.K1_OPS_PER_CELL), plus 32 B/cell of
// dense q planes under BOUZIDI, and 40 B/cell in deviation storage (f 18 +
// 18, aux 4); the ring adds 2 (H + W) threads that each repeat one
// neighbour's update and one BC.
// All far below the card's ~20 flop/B balance point, so the design aims
// only at full-width coalesced traffic: one thread per interior cell,
// neighbouring threads on neighbouring x, each warp's stores on whole
// sectors (a warp starts on a 128-byte line), each population pulled straight
// from global memory (the 3-row reuse of the pull stencil is left to
// L1/L2). The TPU kernel's row padding, lane rolls, band heights and
// two-slot DMA pipeline are TPU schedules and have no counterpart here;
// the state is an unpadded [9, H, W] tensor and the caller ping-pongs two
// buffers, since pull streaming cannot run in place.
//
// The sharded form (k1_step_shard*, the JAX kernel on a shard of
// run_chunk_sharded_pallas, its interior and BCs gated by the shard's global
// origin ``offs``, :320-379) is the same body on another BlockGeom
// (lbm_common.cuh): the shard's [hl, wl] cells sit inside a 1-cell halo
// ring that the runner (parallel/sharded.py) refreshes from the neighbours
// after every step, so the pull, the link predicate (aux has the same
// halo) and Bouzidi's f(c + e_k) read across a seam exactly as the whole
// grid reads its own cells. Only cells interior in the global grid are
// updated, and only a block on the global edge writes ring cells; the halo
// of a block side on the global edge is never read. The row pitch is
// rounded up to 32 floats, so a block's rows start aligned as the whole
// grid's do. Bound and design as above, plus the halo ring.
#include <algorithm>

#include "lbm_cell.cuh"

// The update of local cell ``c`` through global memory: its collide
// output (before the obstacle overwrite) into ``n``; returns its solid flag.
template <typename S, int OBST>
__device__ __forceinline__ bool k1_collide(const typename S::T* __restrict__ f_in,
                                           const float* __restrict__ aux,
                                           const float* __restrict__ q, size_t plane,
                                           size_t c, long pitch, const Scalars& s,
                                           int use_les, Cell* n) {
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
  lbm_cell_update<OBST>(f_at, solid_at, q_at, fabsf(a), solid, s, use_les, n->f, &n->rho,
                        &n->ux, &n->uy);
  return solid;
}

// A ring cell's BC chain and stores, from its inward neighbour's collide
// output ``n``: out of line, so its registers stay out of the update's
// budget (inlined, ptxas spilled a few of the update's values in some fast
// instances; the ring threads are 0.3% of a step's cells).
template <typename S, int OBST, bool FULL>
__device__ __noinline__ void k1_ring_store(const Cell* n, bool column, bool far, int gx,
                                           int Wg, const Scalars s, const BcTypes bc,
                                           float u_prof, typename S::T* f_out,
                                           const float* aux, float* rho_out, float* u_out,
                                           size_t plane, size_t c) {
  lbm_store_ring<S, OBST, FULL>(f_out, aux, rho_out, u_out, plane, c,
                                lbm_ring_values(*n, column, far, gx, Wg, s, bc, u_prof));
}

// Ring thread ``t`` of block ``g``: threads 0 .. 2 hl - 1 take the block's
// left and right columns, the next 2 wl its bottom and top rows; a thread
// whose cell is not on the global ring (or whose side column is not on a
// global inner row) returns. It computes the collide output of the cell's
// inward neighbour (k1_collide: the update's own arithmetic on the same
// read-only inputs, so the same bits as the neighbour's thread), then the
// cell's BC values (lbm_ring_values) and stores them.
template <typename S, int OBST, bool FULL>
__device__ __forceinline__ void k1_ring(const typename S::T* __restrict__ f_in,
                                        typename S::T* __restrict__ f_out,
                                        const float* __restrict__ aux,
                                        const float* __restrict__ q,
                                        const float* __restrict__ prof,
                                        float* __restrict__ rho_out, float* __restrict__ u_out,
                                        const Scalars& s, const BlockGeom& g, const BcTypes& bc,
                                        int use_les, int t) {
  const int hl = g.hl, wl = g.wl;
  bool column, far;
  int y, x, yn, xn;
  if (t < 2 * hl) {
    column = true;
    far = t >= hl;
    y = yn = far ? t - hl : t;
    const int gy = g.y_off + y;
    if (gy < 1 || gy > g.Hg - 2) return;
    if (far ? g.x_off + wl != g.Wg : g.x_off != 0) return;
    x = far ? wl - 1 : 0;
    xn = far ? wl - 2 : 1;
  } else if (t < 2 * hl + 2 * wl) {
    column = false;
    const int r = t - 2 * hl;
    far = r >= wl;
    if (far ? g.y_off + hl != g.Hg : g.y_off != 0) return;
    x = far ? r - wl : r;
    y = far ? hl - 1 : 0;
    yn = far ? hl - 2 : 1;
    const int gx = g.x_off + x;
    xn = gx == 0 ? x + 1 : (gx == g.Wg - 1 ? x - 1 : x);
  } else {
    return;
  }
  const size_t plane = geom_plane(g);
  Cell n;
  k1_collide<S, OBST>(f_in, aux, q, plane, geom_at(g, yn, xn), g.pitch, s, use_les, &n);
  const bool vel = bc.left == LBM_BC_VEL_INLET || bc.left == LBM_BC_VEL_INLET_NEBB;
  k1_ring_store<S, OBST, FULL>(&n, column, far, g.x_off + x, g.Wg, s, bc,
                               vel ? prof[yn] : 0.0f, f_out, aux, rho_out, u_out, plane,
                               geom_at(g, y, x));
}

// Blocks a SM the launch bounds keep. The fast step: what the update alone
// needs (40 registers a thread, 56 under Bouzidi, by ptxas) fits 6 blocks
// of 256, 4 under Bouzidi; the ring threads' path needs a few more and
// spills instead, in those few threads only. The full step (FULL, once a
// chunk) is its own instance with its own budget (46-64 registers by
// ptxas, no spills): holding it to the fast step's 6 blocks made it slower
// (PERF.md).
template <int OBST, bool FULL>
constexpr int k1_min_blocks() {
  return FULL ? (OBST == LBM_OBST_BOUZIDI ? 3 : 4) : (OBST == LBM_OBST_BOUZIDI ? 4 : 6);
}

// The first ``nr`` rows of blocks take the ring, one thread a ring cell
// (k1_ring): first, so their longer chains (a neighbour's update, then a
// BC) overlap the interior's blocks instead of trailing them. The rows
// after them take the block's cells whose global coordinates are
// interior, one thread a cell: the whole grid (SHARD false) has no halo
// and its rows 1 .. H-2 and columns 1 .. W-2, a shard reads its neighbours
// through the halo. Both roles read only f_in, so they need no order.
// The interior's threads sit on the stored rows' 128-byte lines: thread t
// of a row of blocks takes stored column t (local column t - halo), and the
// threads on columns outside the interior return, so each warp's stores
// of a plane fill whole 32-byte sectors. Shifted one column (the first
// interior column on lane 0), every warp store split two sectors with its
// neighbour, and the card took partial-sector writes at about half the
// rate of whole ones: the full step, 21 store planes a cell, ran at half
// its bound (PERF.md). FULL also writes rho, u and f_post.
template <typename S, int OBST, bool SHARD, bool FULL>
__global__ void __launch_bounds__(256, k1_min_blocks<OBST, FULL>())
k1_step_kernel(const typename S::T* __restrict__ f_in,
               typename S::T* __restrict__ f_out,
               const float* __restrict__ aux, const float* __restrict__ q,
               const float* __restrict__ prof, float* __restrict__ rho_out,
               float* __restrict__ u_out, float* __restrict__ fpost_out,
               const Scalars s, const BlockGeom geom, const BcTypes bc,
               const int use_les, const int nr) {
  const BlockGeom g = fold_geom<SHARD>(geom);
  if ((int)blockIdx.y < nr) {
    k1_ring<S, OBST, FULL>(f_in, f_out, aux, q, prof, rho_out, u_out, s, g, bc, use_les,
                           (blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x + threadIdx.x);
    return;
  }
  const int i0 = max(0, 1 - g.y_off);
  const int j0 = max(0, 1 - g.x_off), j1 = min(g.wl - 1, g.Wg - 2 - g.x_off);
  const int x = blockIdx.x * blockDim.x + threadIdx.x - g.halo;
  const int y = i0 + blockIdx.y - nr;
  if (x < j0 || x > j1) return;
  const size_t plane = geom_plane(g);
  const size_t c = geom_at(g, y, x);

  Cell n;
  const bool solid = k1_collide<S, OBST>(f_in, aux, q, plane, c, g.pitch, s, use_les, &n);
  for (int k = 0; k < 9; ++k)
    S::store(f_out, k * plane + c, k, lbm_stored<OBST>(k, n.f, n.rho, solid));

  if (FULL) {
    rho_out[c] = n.rho;
    u_out[c] = solid ? 0.0f : n.ux;
    u_out[plane + c] = solid ? 0.0f : n.uy;
    for (int k = 0; k < 9; ++k) fpost_out[k * plane + c] = n.f[k];
  }
}

template <typename S, int OBST, bool SHARD, bool FULL>
static void launch(const void* f_in, void* f_out, const void* aux,
                   const void* q, const void* prof, void* rho, void* u,
                   void* f_post, const Scalars& s, const BlockGeom& g,
                   const BcTypes& bc, int use_les, cudaStream_t stream) {
  // the block's cells that are interior in the global grid
  const int i0 = std::max(0, 1 - g.y_off);
  const int i1 = std::min(g.hl - 1, g.Hg - 2 - g.y_off);
  const int j0 = std::max(0, 1 - g.x_off);
  const int j1 = std::min(g.wl - 1, g.Wg - 2 - g.x_off);
  if (i1 < i0 || j1 < j0) return;
  // enough rows of blocks for 2 (hl + wl) ring threads (K2's count: those
  // off the global ring return), then the interior's rows, one thread a
  // stored column up to the last interior one
  const int bx = (j1 + g.halo + 256) / 256;
  const int nr = (2 * (g.hl + g.wl) + 256 * bx - 1) / (256 * bx);
  const dim3 block(256, 1, 1);
  const dim3 grid(bx, nr + i1 - i0 + 1, 1);
  k1_step_kernel<S, OBST, SHARD, FULL><<<grid, block, 0, stream>>>(
      static_cast<const typename S::T*>(f_in),
      static_cast<typename S::T*>(f_out), static_cast<const float*>(aux),
      static_cast<const float*>(q), static_cast<const float*>(prof),
      static_cast<float*>(rho), static_cast<float*>(u),
      static_cast<float*>(f_post), s, g, bc, use_les, nr);
}

// The f32 step of one scheme: the full instance closes a chunk, the fast
// one runs every other step.
template <int OBST, bool SHARD>
static void launch_f32(const void* f_in, void* f_out, const void* aux, const void* q,
                       const void* prof, void* rho, void* u, void* f_post, const Scalars& s,
                       const BlockGeom& g, const BcTypes& bc, int use_les, int full,
                       cudaStream_t st) {
  if (full)
    launch<F32Store, OBST, SHARD, true>(f_in, f_out, aux, q, prof, rho, u, f_post, s, g, bc,
                                        use_les, st);
  else
    launch<F32Store, OBST, SHARD, false>(f_in, f_out, aux, q, prof, rho, u, f_post, s, g, bc,
                                         use_les, st);
}

template <bool SHARD>
static int dispatch(const void* f_in, void* f_out, const void* aux,
                    const void* q, const void* prof, void* rho, void* u,
                    void* f_post, const void* scal, const BlockGeom& g,
                    const BcTypes& bc, int use_les, int full, int obst,
                    void* stream) {
  const Scalars s = load_scalars(static_cast<const float*>(scal));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (obst) {
    case LBM_OBST_EQ:
      launch_f32<LBM_OBST_EQ, SHARD>(f_in, f_out, aux, q, prof, rho, u, f_post, s, g, bc,
                                     use_les, full, st);
      break;
    case LBM_OBST_BOUNCE:
      launch_f32<LBM_OBST_BOUNCE, SHARD>(f_in, f_out, aux, q, prof, rho, u, f_post, s, g, bc,
                                         use_les, full, st);
      break;
    case LBM_OBST_HALFWAY:
      launch_f32<LBM_OBST_HALFWAY, SHARD>(f_in, f_out, aux, q, prof, rho, u, f_post, s, g,
                                          bc, use_les, full, st);
      break;
    case LBM_OBST_BOUZIDI:
      launch_f32<LBM_OBST_BOUZIDI, SHARD>(f_in, f_out, aux, q, prof, rho, u, f_post, s, g,
                                          bc, use_les, full, st);
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
// interior in the Hg x Wg grid are updated, and only the global ring cells
// the block holds are written as ring. ``bc_*`` are the four sides' BC
// types, ``obst`` is LBM_OBST_*; ``q`` ([8] planes of the block) is read
// only under BOUZIDI, ``prof`` (the block's [hl] rows of the inlet
// profile) only for left types 3/4, rho/u/f_post written only when full;
// all share the block's geometry.
extern "C" int k1_step_launch(const void* f_in, void* f_out, const void* aux,
                              const void* q, const void* prof, void* rho,
                              void* u, void* f_post, const void* scal,
                              const int* geom, int bc_left, int bc_top,
                              int bc_right, int bc_bottom, int use_les,
                              int full, int obst, void* stream) {
  const BlockGeom g = load_geom(geom);
  const BcTypes bc{bc_left, bc_top, bc_right, bc_bottom};
  return g.halo ? dispatch<true>(f_in, f_out, aux, q, prof, rho, u, f_post,
                                 scal, g, bc, use_les, full, obst, stream)
                : dispatch<false>(f_in, f_out, aux, q, prof, rho, u, f_post,
                                  scal, g, bc, use_les, full, obst, stream);
}

// The fast step in 16-bit deviation storage (EQ and BOUNCE only).
template <bool SHARD>
static int dispatch_dev(const void* f_in, void* f_out, const void* aux,
                        const void* prof, const void* scal, const BlockGeom& g,
                        const BcTypes& bc, int use_les, int obst,
                        void* stream) {
  const Scalars s = load_scalars(static_cast<const float*>(scal));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (obst) {
    case LBM_OBST_EQ:
      launch<DevStore, LBM_OBST_EQ, SHARD, false>(f_in, f_out, aux, nullptr, prof,
                                                  nullptr, nullptr, nullptr, s, g, bc,
                                                  use_les, st);
      break;
    case LBM_OBST_BOUNCE:
      launch<DevStore, LBM_OBST_BOUNCE, SHARD, false>(f_in, f_out, aux, nullptr, prof,
                                                      nullptr, nullptr, nullptr, s, g,
                                                      bc, use_les, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The fast step in 16-bit deviation storage: f_in and f_out are bf16
// planes of f - w in the block's geometry (halos included on a shard), the
// ring quantized as the interior is. Schemes EQ and BOUNCE only.
extern "C" int k1_step_dev_launch(const void* f_in, void* f_out,
                                  const void* aux, const void* prof,
                                  const void* scal, const int* geom,
                                  int bc_left, int bc_top, int bc_right,
                                  int bc_bottom, int use_les, int obst,
                                  void* stream) {
  const BlockGeom g = load_geom(geom);
  const BcTypes bc{bc_left, bc_top, bc_right, bc_bottom};
  return g.halo ? dispatch_dev<true>(f_in, f_out, aux, prof, scal, g, bc,
                                     use_les, obst, stream)
                : dispatch_dev<false>(f_in, f_out, aux, prof, scal, g, bc,
                                      use_les, obst, stream);
}
