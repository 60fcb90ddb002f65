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
// outlet with the backflow guard) or 2; top/bottom 0 or 2. Any other type
// is a no-op in apply_bc (solver.py :706, :748, :768): the side's ring
// threads store their cells' previous values (lbm_ring_from), f from f_in
// and rho, u from the state's planes at the start of the chunk (RingPrev),
// through the obstacle pass; a corner of an active top or bottom row reads
// the no-op side's cell the same way. These layouts never reach the TPU
// kernel (pallas_step.supports); the JAX package runs them on its jnp step,
// which this branch matches.
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
// or a division one each; chip_smoke.K1_OPS_PER_CELL), and 40 B/cell in
// deviation storage (f 18 + 18, aux 4). Under BOUZIDI a thread reads
// q[opp k - 1](c) only on a link whose pull source is solid
// (lbm_cell_update), never the dense [8, H, W] planes whole: 4 B a
// boundary link, at most one 32-byte sector each. The ring adds 2 (H + W)
// threads that each repeat one neighbour's update and one BC.
// All far below the card's ~20 flop/B balance point, so the design aims
// only at full-width coalesced traffic: one thread per interior cell,
// neighbouring threads on neighbouring x, each warp's stores on whole
// sectors (a warp starts on a 128-byte line), each population pulled straight
// from global memory (the 3-row reuse of the pull stencil is left to
// L1/L2). The TPU kernel's row padding, lane rolls, band heights and
// two-slot DMA pipeline are TPU schedules and have no counterpart here;
// the state is an unpadded [9, H, W] tensor and two buffers ping-pong,
// since pull streaming cannot run in place: a chunk's fast steps do so
// inside one call (k1_steps_launch, below), as the JAX package's chunk is
// one program, so the host issues a step without Python.
//
// The sharded form (k1_step_shard*, the JAX kernel on a shard of
// run_chunk_sharded_pallas, its interior and BCs gated by the shard's global
// origin ``offs``, :320-379) is the same body on another BlockGeom
// (lbm_common.cuh): the shard's [hl, wl] cells sit inside a 1-cell halo
// ring of its neighbours' cells, so the pull, the link predicate (aux has
// the same halo) and Bouzidi's f(c + e_k) read across a seam exactly as the
// whole grid reads its own cells. Only cells interior in the global grid
// are updated, and only a block on the global edge writes ring cells; the
// halo of a block side on the global edge is never read. The row pitch is
// rounded up to 32 floats, so a block's rows start aligned as the whole
// grid's do. Bound and design as above, plus the halo ring.
// The halo is not refreshed by a launch of its own: each thread that stores
// an own cell on the block's edge (local row 0 or hl - 1, column 0 or
// wl - 1; interior and ring threads alike) also stores the same bits into
// the halo slot of each neighbour that reads it (k1_push; the map and why
// the writes never meet are in halo.cuh), into the neighbours' f_out given
// as a ShardNbrs argument. So a sharded step is one launch a block, and a
// launch given no neighbours (every pointer null: the per-step loop of
// parallel/sharded.py, which refreshes the halos by copies, and the
// multi-process path) writes what it always wrote. A sharded chunk's steps
// run in one call (k1_shard_steps_launch), on a mesh whose blocks live on
// the cards of one process (one card each, or several on one): each step
// every block's K1 with its neighbours' next buffers, on its card's stream,
// each card's step after its neighbours' previous one (MeshDevs, halo.cuh),
// as run_chunk_sharded_pallas's jit over shard_map and lax.scan issues
// them. The pushes across cards are peer stores over NVLink; they retire
// before the kernel completes, so ahead of the card's event.
//
// A lockstep group's chunk (k1_group_steps_launch, k1_group_full_launch):
// the JAX BatchEngine advances its B cases in one program (the vmap
// lockstep, or its fused kernels one case after another inside one jit,
// lbm2d_tpu/parallel/batch.py:77-176). Here one launch a step covers the
// group's alive cases: k1_group_kernel, the whole-grid body (k1_body) on
// case blockIdx.z's planes of the [B, ...] group buffers, each case with
// its scalar row from a device table, the alive cases' indices a device
// table read from global memory (a dead case launches nothing). Its own
// instances with their own launch bounds, so the single block's keep their
// registers; the same bits as k1_step_kernel on each case alone.
#include <algorithm>

#include "halo.cuh"
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

// What the ring threads of a no-op side read besides f_in: the state's rho
// and u planes (the block's geometry) at the start of the chunk. Over a
// chunk a no-op cell keeps its rho, and the obstacle pass of every step
// zeroes u on a solid one; so ``fresh`` says whether rho and u are those
// of the step before f_in (the chunk's first step), else a solid cell's u
// reads as 0. Null and unread where every side is active. The last kernel
// parameter, after ``nb``, so the production instances keep their register
// allocation.
struct RingPrev {
  const float* rho;
  const float* u;
  int fresh;
};

// Cell ``c`` as the previous step left it: f from f_in, rho and u from
// ``pv`` (RingPrev).
template <typename S>
__device__ __forceinline__ void k1_prev(const typename S::T* __restrict__ f_in,
                                        const float* __restrict__ aux, const RingPrev& pv,
                                        size_t plane, size_t c, Cell* n) {
#pragma unroll
  for (int k = 0; k < 9; ++k) n->f[k] = S::load(f_in, k * plane + c, k);
  const bool zero = !pv.fresh && __float_as_int(aux[c]) < 0;
  n->rho = pv.rho[c];
  n->ux = zero ? 0.0f : pv.u[c];
  n->uy = zero ? 0.0f : pv.u[plane + c];
}

// A ring cell's BC chain and stores, from ``n``: its inward neighbour's
// collide output, or the previous values lbm_ring_from names (``from``).
// Out of line, so its registers stay out of the update's budget (inlined,
// ptxas spilled a few of the update's values in some fast instances; the
// ring threads are 0.3% of a step's cells).
template <typename S, int OBST, bool FULL>
__device__ __noinline__ void k1_ring_store(const Cell* n, bool column, bool far, int gx,
                                           int Wg, const Scalars s, const BcTypes bc,
                                           float u_prof, int from, typename S::T* f_out,
                                           const float* aux, float* rho_out, float* u_out,
                                           size_t plane, size_t c) {
  lbm_store_ring<S, OBST, FULL>(f_out, aux, rho_out, u_out, plane, c,
                                lbm_ring_values(*n, column, far, gx, Wg, s, bc, u_prof, from));
}

// The halo slots that hold a copy of own cell (y, x) of a shard (halo.cuh):
// ``put(base, i, k)`` stores population k of the cell at element i of the
// neighbour's f buffer ``base``, with the bits it stored in its own f_out.
// Nothing for a cell off the block's edge or a neighbour slot that is null.
// Every index is a constant (the loops unrolled, the neighbour picked by
// branches): a runtime index into the caller's values (the update's Cell)
// or into ``nb`` would move them to local memory for every thread of the
// instance.
template <typename S, class Put>
__device__ __forceinline__ void k1_push(const ShardNbrs& nb, const BlockGeom& g, int y, int x,
                                        const Put& put) {
  const int dy = y == g.hl - 1 ? 1 : (y == 0 ? -1 : 0);
  const int dx = x == g.wl - 1 ? 1 : (x == 0 ? -1 : 0);
  if (dy == 0 && dx == 0) return;
  const size_t plane = geom_plane(g);
  // the halo row a push along y lands on, the halo column one along x does
  const size_t hy = dy > 0 ? 0 : g.hl + 1, hx = dx > 0 ? 0 : g.wl + 1;
  auto to = [&](void* base, size_t at) {
    if (base == nullptr) return;
#pragma unroll
    for (int k = 0; k < 9; ++k) put(static_cast<typename S::T*>(base), k * plane + at, k);
  };
  auto at = [&](int sy, int sx) { return nb.p[shard_nbr_slot(sy, sx)]; };
  if (dy) to(dy > 0 ? at(1, 0) : at(-1, 0), hy * g.pitch + x + 1);
  if (dx) to(dx > 0 ? at(0, 1) : at(0, -1), (size_t)(y + 1) * g.pitch + hx);
  if (dy && dx)
    to(dy > 0 ? (dx > 0 ? at(1, 1) : at(1, -1)) : (dx > 0 ? at(-1, 1) : at(-1, -1)),
       hy * g.pitch + hx);
}

// Ring thread ``t`` of block ``g``: threads 0 .. 2 hl - 1 take the block's
// left and right columns, the next 2 wl its bottom and top rows; a thread
// whose cell is not on the global ring (or whose side column is not on a
// global inner row) returns. It computes the collide output of the cell's
// inward neighbour (k1_collide: the update's own arithmetic on the same
// read-only inputs, so the same bits as the neighbour's thread), then the
// cell's BC values (lbm_ring_values) and stores them; where a side is a
// no-op it reads previous values instead (lbm_ring_from, k1_prev), every
// step, into either ping-pong buffer. A shard's thread then pushes what it
// stored into the neighbours' halos (k1_push), read back from its own
// f_out.
template <typename S, int OBST, bool SHARD, bool FULL>
__device__ __forceinline__ void k1_ring(const typename S::T* __restrict__ f_in,
                                        typename S::T* __restrict__ f_out,
                                        const float* __restrict__ aux,
                                        const float* __restrict__ q,
                                        const float* __restrict__ prof,
                                        float* __restrict__ rho_out, float* __restrict__ u_out,
                                        const Scalars& s, const BlockGeom& g, const BcTypes& bc,
                                        const ShardNbrs& nb, const RingPrev& pv, int use_les,
                                        int t) {
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
  const int from = lbm_ring_from(column, far, g.x_off + x, g.Wg, bc);
  Cell n;
  if (from == LBM_RING_NEIGHBOUR)
    k1_collide<S, OBST>(f_in, aux, q, plane, geom_at(g, yn, xn), g.pitch, s, use_les, &n);
  else  // the cell itself, or at a corner the no-op side's cell one row in
    k1_prev<S>(f_in, aux, pv, plane, from == LBM_RING_OWN ? geom_at(g, y, x) : geom_at(g, yn, x),
               &n);
  const bool vel = bc.left == LBM_BC_VEL_INLET || bc.left == LBM_BC_VEL_INLET_NEBB;
  k1_ring_store<S, OBST, FULL>(&n, column, far, g.x_off + x, g.Wg, s, bc,
                               vel ? prof[yn] : 0.0f, from, f_out, aux, rho_out, u_out, plane,
                               geom_at(g, y, x));
  if constexpr (SHARD) {
    const size_t c = geom_at(g, y, x);
    k1_push<S>(nb, g, y, x, [&](typename S::T* p, size_t i, int k) {
      p[i] = f_out[k * plane + c];
    });
  }
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
// its bound (PERF.md). FULL also writes rho, u and f_post. A shard's
// threads on the block's edge push what they stored (k1_push), from the
// values they hold; the ring threads read theirs back, since their values
// stay in the out-of-line k1_ring_store. With the push inline no _shard
// instance spills or keeps more in local memory than its whole-grid twin,
// and none needs a register more than fits the blocks a SM its launch
// bounds ask for (phase 1 of chip_smoke.py prints them). ``nb`` and ``pv``
// are the last parameters: ``nb`` placed before ``use_les`` moved ptxas's
// allocation of the whole-grid deviation-storage instance into 8 bytes of
// spills.
// One K1 launch's work on block ``g`` (already folded), the body of every
// K1 kernel: the single block's (k1_step_kernel) and each case's of a
// lockstep group (k1_group_kernel, the same code on the case's planes).
template <typename S, int OBST, bool SHARD, bool FULL>
__device__ __forceinline__ void k1_body(const typename S::T* __restrict__ f_in,
                                        typename S::T* __restrict__ f_out,
                                        const float* __restrict__ aux,
                                        const float* __restrict__ q,
                                        const float* __restrict__ prof,
                                        float* __restrict__ rho_out, float* __restrict__ u_out,
                                        float* __restrict__ fpost_out, const Scalars& s,
                                        const BlockGeom& g, const BcTypes& bc, int use_les, int nr,
                                        const ShardNbrs& nb, const RingPrev& pv) {
  if ((int)blockIdx.y < nr) {
    k1_ring<S, OBST, SHARD, FULL>(f_in, f_out, aux, q, prof, rho_out, u_out, s, g, bc, nb, pv,
                                  use_les,
                                  (blockIdx.y * gridDim.x + blockIdx.x) * blockDim.x +
                                      threadIdx.x);
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
  if constexpr (SHARD)
    k1_push<S>(nb, g, y, x, [&](typename S::T* p, size_t i, int k) {
      S::store(p, i, k, lbm_stored<OBST>(k, n.f, n.rho, solid));
    });

  if (FULL) {
    rho_out[c] = n.rho;
    u_out[c] = solid ? 0.0f : n.ux;
    u_out[plane + c] = solid ? 0.0f : n.uy;
    for (int k = 0; k < 9; ++k) fpost_out[k * plane + c] = n.f[k];
  }
}

template <typename S, int OBST, bool SHARD, bool FULL>
__global__ void __launch_bounds__(256, k1_min_blocks<OBST, FULL>())
k1_step_kernel(const typename S::T* __restrict__ f_in,
               typename S::T* __restrict__ f_out,
               const float* __restrict__ aux, const float* __restrict__ q,
               const float* __restrict__ prof, float* __restrict__ rho_out,
               float* __restrict__ u_out, float* __restrict__ fpost_out,
               const Scalars s, const BlockGeom geom, const BcTypes bc,
               const int use_les, const int nr, const ShardNbrs nb, const RingPrev pv) {
  k1_body<S, OBST, SHARD, FULL>(f_in, f_out, aux, q, prof, rho_out, u_out, fpost_out, s,
                                fold_geom<SHARD>(geom), bc, use_les, nr, nb, pv);
}

// A lockstep group's step (k1_group_kernel): blockIdx.z is a slot of the
// device table ``slots`` of the alive cases' indices, read from global
// memory, so a dead case launches nothing and keeps every bit; case c's
// planes start c times their per-case size into each group buffer ([B, 9,
// H, W] f, [B, H, W] aux and rho, [B, 8, H, W] q, [B, H] prof, [B, 2, H, W]
// u), and its scalar row at ``rows`` + c ``row_stride`` floats of the
// device table [B, n, 14] (the cases differ in nu, rho_in, ...). The last
// kernel parameter, as RingPrev is.
struct GroupArgs {
  const int* slots;
  const float* rows;
  int row_stride;
};

// A scalar row read from device memory (the group's table): all of it
// (``ring``, what a ring thread's BCs read), or the collision's three and
// zeros, so an interior thread holds no BC value in its registers.
__device__ __forceinline__ Scalars k1_row(const float* __restrict__ row, bool ring) {
  Scalars s{};
  s.tau0 = __ldg(row + 0);
  s.cs_factor = __ldg(row + 1);
  s.s_ghost = __ldg(row + 2);
  if (ring) {
    s.ramp = __ldg(row + 3);
    s.rho_in = __ldg(row + 4);
    s.rho_out = __ldg(row + 5);
#pragma unroll
    for (int i = 0; i < 8; ++i) s.bcv[i] = __ldg(row + 6 + i);
  }
  return s;
}

// Blocks a SM the group instances' launch bounds keep. The case offsets
// and the scalar row read from memory cost the fast step a few registers:
// held to the single block's 6 blocks (40 registers) it spilled 12-32 B a
// thread, at 5 it takes 48 and spills nothing; Bouzidi's fast step, at 64
// registers a thread alone, takes 3 (80 registers). The full step keeps the
// single block's bounds (56-80 registers, no spills; ptxas, phase 1).
template <int OBST, bool FULL>
constexpr int k1_group_min_blocks() {
  return FULL ? k1_min_blocks<OBST, FULL>() : (OBST == LBM_OBST_BOUZIDI ? 3 : 5);
}

// One step of every alive case of a lockstep group (whole grids, no halo),
// one launch: the single-block body on the case's planes, so the same bits
// as k1_step_kernel on that case alone. Its own instances, so the single
// block's keep their registers.
template <typename S, int OBST, bool FULL>
__global__ void __launch_bounds__(256, k1_group_min_blocks<OBST, FULL>())
k1_group_kernel(const typename S::T* __restrict__ f_in, typename S::T* __restrict__ f_out,
                const float* __restrict__ aux, const float* __restrict__ q,
                const float* __restrict__ prof, float* __restrict__ rho_out,
                float* __restrict__ u_out, float* __restrict__ fpost_out,
                const BlockGeom geom, const BcTypes bc, const int use_les, const int nr,
                const RingPrev pv, const GroupArgs ga) {
  const BlockGeom g = fold_geom<false>(geom);
  const size_t plane = geom_plane(g);
  const size_t c = (size_t)__ldg(ga.slots + blockIdx.z);
  const RingPrev pc{pv.rho == nullptr ? nullptr : pv.rho + c * plane,
                    pv.u == nullptr ? nullptr : pv.u + c * 2 * plane, pv.fresh};
  k1_body<S, OBST, false, FULL>(
      f_in + c * 9 * plane, f_out + c * 9 * plane, aux + c * plane,
      OBST == LBM_OBST_BOUZIDI ? q + c * 8 * plane : nullptr,
      prof == nullptr ? nullptr : prof + c * g.hl, FULL ? rho_out + c * plane : nullptr,
      FULL ? u_out + c * 2 * plane : nullptr, FULL ? fpost_out + c * 9 * plane : nullptr,
      k1_row(ga.rows + c * ga.row_stride, (int)blockIdx.y < nr), g, bc, use_les, nr,
      ShardNbrs{}, pc);
}

// The launch shape of block ``g``: false where it has no cell interior in
// the global grid; else ``grid`` (x, y) and ``nr``, the rows of ring blocks:
// enough for 2 (hl + wl) ring threads (K2's count: those off the global ring
// return), then the interior's rows, one thread a stored column up to the
// last interior one.
static bool k1_shape(const BlockGeom& g, dim3* grid, int* nr) {
  const int i0 = std::max(0, 1 - g.y_off);
  const int i1 = std::min(g.hl - 1, g.Hg - 2 - g.y_off);
  const int j0 = std::max(0, 1 - g.x_off);
  const int j1 = std::min(g.wl - 1, g.Wg - 2 - g.x_off);
  if (i1 < i0 || j1 < j0) return false;
  const int bx = (j1 + g.halo + 256) / 256;
  *nr = (2 * (g.hl + g.wl) + 256 * bx - 1) / (256 * bx);
  *grid = dim3(bx, *nr + i1 - i0 + 1, 1);
  return true;
}

template <typename S, int OBST, bool SHARD, bool FULL>
static void launch(const void* f_in, void* f_out, const void* aux,
                   const void* q, const void* prof, void* rho, void* u,
                   void* f_post, const Scalars& s, const BlockGeom& g,
                   const BcTypes& bc, int use_les, cudaStream_t stream,
                   const ShardNbrs& nb = ShardNbrs{}, const RingPrev& pv = RingPrev{}) {
  dim3 grid;
  int nr;
  if (!k1_shape(g, &grid, &nr)) return;
  k1_step_kernel<S, OBST, SHARD, FULL><<<grid, dim3(256, 1, 1), 0, stream>>>(
      static_cast<const typename S::T*>(f_in),
      static_cast<typename S::T*>(f_out), static_cast<const float*>(aux),
      static_cast<const float*>(q), static_cast<const float*>(prof),
      static_cast<float*>(rho), static_cast<float*>(u),
      static_cast<float*>(f_post), s, g, bc, use_les, nr, nb, pv);
}

// The f32 step of one scheme: the full instance closes a chunk, the fast
// one runs every other step.
template <int OBST, bool SHARD>
static void launch_f32(const void* f_in, void* f_out, const void* aux, const void* q,
                       const void* prof, void* rho, void* u, void* f_post, const Scalars& s,
                       const BlockGeom& g, const BcTypes& bc, int use_les, int full,
                       cudaStream_t st, const ShardNbrs& nb, const RingPrev& pv) {
  if (full)
    launch<F32Store, OBST, SHARD, true>(f_in, f_out, aux, q, prof, rho, u, f_post, s, g, bc,
                                        use_les, st, nb, pv);
  else
    launch<F32Store, OBST, SHARD, false>(f_in, f_out, aux, q, prof, rho, u, f_post, s, g, bc,
                                         use_les, st, nb, pv);
}

template <bool SHARD>
static int dispatch(const void* f_in, void* f_out, const void* aux,
                    const void* q, const void* prof, void* rho, void* u,
                    void* f_post, const void* scal, const BlockGeom& g,
                    const BcTypes& bc, int use_les, int full, int obst,
                    void* stream, const RingPrev& pv, const ShardNbrs& nb = ShardNbrs{}) {
  const Scalars s = load_scalars(static_cast<const float*>(scal));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (obst) {
    case LBM_OBST_EQ:
      launch_f32<LBM_OBST_EQ, SHARD>(f_in, f_out, aux, q, prof, rho, u, f_post, s, g, bc,
                                     use_les, full, st, nb, pv);
      break;
    case LBM_OBST_BOUNCE:
      launch_f32<LBM_OBST_BOUNCE, SHARD>(f_in, f_out, aux, q, prof, rho, u, f_post, s, g, bc,
                                         use_les, full, st, nb, pv);
      break;
    case LBM_OBST_HALFWAY:
      launch_f32<LBM_OBST_HALFWAY, SHARD>(f_in, f_out, aux, q, prof, rho, u, f_post, s, g,
                                          bc, use_les, full, st, nb, pv);
      break;
    case LBM_OBST_BOUZIDI:
      launch_f32<LBM_OBST_BOUZIDI, SHARD>(f_in, f_out, aux, q, prof, rho, u, f_post, s, g,
                                          bc, use_les, full, st, nb, pv);
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
// ``rho_prev`` / ``u_prev`` (the state's rho [plane] and u [2] planes,
// ``fresh`` as RingPrev says) only where a side is a no-op, else null;
// all share the block's geometry.
extern "C" int k1_step_launch(const void* f_in, void* f_out, const void* aux,
                              const void* q, const void* prof, void* rho,
                              void* u, void* f_post, const void* scal,
                              const int* geom, int bc_left, int bc_top,
                              int bc_right, int bc_bottom, int use_les,
                              int full, int obst, void* stream, const void* rho_prev,
                              const void* u_prev, int fresh) {
  const BlockGeom g = load_geom(geom);
  const BcTypes bc{bc_left, bc_top, bc_right, bc_bottom};
  const RingPrev pv{static_cast<const float*>(rho_prev), static_cast<const float*>(u_prev),
                    fresh};
  return g.halo ? dispatch<true>(f_in, f_out, aux, q, prof, rho, u, f_post,
                                 scal, g, bc, use_les, full, obst, stream, pv)
                : dispatch<false>(f_in, f_out, aux, q, prof, rho, u, f_post,
                                  scal, g, bc, use_les, full, obst, stream, pv);
}

// The fast step in 16-bit deviation storage (EQ and BOUNCE only).
template <bool SHARD>
static int dispatch_dev(const void* f_in, void* f_out, const void* aux,
                        const void* prof, const void* scal, const BlockGeom& g,
                        const BcTypes& bc, int use_les, int obst,
                        void* stream, const RingPrev& pv) {
  const Scalars s = load_scalars(static_cast<const float*>(scal));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (obst) {
    case LBM_OBST_EQ:
      launch<DevStore, LBM_OBST_EQ, SHARD, false>(f_in, f_out, aux, nullptr, prof,
                                                  nullptr, nullptr, nullptr, s, g, bc,
                                                  use_les, st, ShardNbrs{}, pv);
      break;
    case LBM_OBST_BOUNCE:
      launch<DevStore, LBM_OBST_BOUNCE, SHARD, false>(f_in, f_out, aux, nullptr, prof,
                                                      nullptr, nullptr, nullptr, s, g,
                                                      bc, use_les, st, ShardNbrs{}, pv);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The fast step in 16-bit deviation storage: f_in and f_out are bf16
// planes of f - w in the block's geometry (halos included on a shard), the
// ring quantized as the interior is. Schemes EQ and BOUNCE only.
// ``rho_prev`` / ``u_prev`` / ``fresh`` as for k1_step_launch.
extern "C" int k1_step_dev_launch(const void* f_in, void* f_out,
                                  const void* aux, const void* prof,
                                  const void* scal, const int* geom,
                                  int bc_left, int bc_top, int bc_right,
                                  int bc_bottom, int use_les, int obst,
                                  void* stream, const void* rho_prev, const void* u_prev,
                                  int fresh) {
  const BlockGeom g = load_geom(geom);
  const BcTypes bc{bc_left, bc_top, bc_right, bc_bottom};
  const RingPrev pv{static_cast<const float*>(rho_prev), static_cast<const float*>(u_prev),
                    fresh};
  return g.halo ? dispatch_dev<true>(f_in, f_out, aux, prof, scal, g, bc,
                                     use_les, obst, stream, pv)
                : dispatch_dev<false>(f_in, f_out, aux, prof, scal, g, bc,
                                      use_les, obst, stream, pv);
}

// n fast steps of the whole grid, one launch each, as the single-step
// entries launch them: step i takes row i of ``rows`` by value, reads f_in
// (step 0) or the previous step's output, and writes f_a (even i) or f_b
// (odd i). f_b may be f_in, which only step 0 reads. ``pv`` is step 0's
// RingPrev; the later steps read the same planes, not fresh. After each
// launch cudaGetLastError(); on a failure ``*failed`` is the step's index
// and the rest are not launched.
template <typename S, int OBST>
static int steps_loop(const void* f_in, void* f_a, void* f_b, const void* aux, const void* q,
                      const void* prof, const float* rows, int n, const BlockGeom& g,
                      const BcTypes& bc, int use_les, cudaStream_t st, const RingPrev& pv,
                      int* failed) {
  const void* src = f_in;
  for (int i = 0; i < n; ++i) {
    void* dst = (i & 1) ? f_b : f_a;
    launch<S, OBST, false, false>(src, dst, aux, q, prof, nullptr, nullptr, nullptr,
                                  load_scalars(rows + 14 * i), g, bc, use_les, st, ShardNbrs{},
                                  RingPrev{pv.rho, pv.u, i == 0 ? pv.fresh : 0});
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
      *failed = i;
      return static_cast<int>(err);
    }
    src = dst;
  }
  return 0;
}

// The fast steps of a chunk in one call, the counterpart of the step loop
// that run_chunk_pallas runs inside one program (jax.jit over lax.scan,
// lbm2d_tpu/ops/pallas_step.py:1936-1945): the arguments of
// k1_step_launch for the whole grid (``geom`` without a halo), with the
// host table ``rows`` [n, 14] in place of the scalar row, the two
// ping-pong buffers f_a and f_b (steps_loop) in place of f_out, and
// ``dev`` choosing 16-bit deviation storage (bf16 f_in, f_a, f_b; EQ and
// BOUNCE only, no q) over f32, and ``rho_prev`` / ``u_prev`` / ``fresh`` as
// for k1_step_launch, ``fresh`` for step 0. Returns the CUDA error code
// (``*failed`` the failing step, -1 for refused arguments) or 0.
extern "C" int k1_steps_launch(const void* f_in, void* f_a, void* f_b, const void* aux,
                               const void* q, const void* prof, const void* rows, int n,
                               const int* geom, int bc_left, int bc_top, int bc_right,
                               int bc_bottom, int use_les, int dev, int obst, void* stream,
                               int* failed, const void* rho_prev, const void* u_prev,
                               int fresh) {
  *failed = -1;
  const BlockGeom g = load_geom(geom);
  if (g.halo != 0 || n < 0) return static_cast<int>(cudaErrorInvalidValue);
  const BcTypes bc{bc_left, bc_top, bc_right, bc_bottom};
  const RingPrev pv{static_cast<const float*>(rho_prev), static_cast<const float*>(u_prev),
                    fresh};
  const float* r = static_cast<const float*>(rows);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dev) {
    switch (obst) {
      case LBM_OBST_EQ:
        return steps_loop<DevStore, LBM_OBST_EQ>(f_in, f_a, f_b, aux, nullptr, prof, r, n, g,
                                                 bc, use_les, st, pv, failed);
      case LBM_OBST_BOUNCE:
        return steps_loop<DevStore, LBM_OBST_BOUNCE>(f_in, f_a, f_b, aux, nullptr, prof, r, n,
                                                     g, bc, use_les, st, pv, failed);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (obst) {
    case LBM_OBST_EQ:
      return steps_loop<F32Store, LBM_OBST_EQ>(f_in, f_a, f_b, aux, q, prof, r, n, g, bc,
                                               use_les, st, pv, failed);
    case LBM_OBST_BOUNCE:
      return steps_loop<F32Store, LBM_OBST_BOUNCE>(f_in, f_a, f_b, aux, q, prof, r, n, g, bc,
                                                   use_les, st, pv, failed);
    case LBM_OBST_HALFWAY:
      return steps_loop<F32Store, LBM_OBST_HALFWAY>(f_in, f_a, f_b, aux, q, prof, r, n, g, bc,
                                                    use_les, st, pv, failed);
    case LBM_OBST_BOUZIDI:
      return steps_loop<F32Store, LBM_OBST_BOUZIDI>(f_in, f_a, f_b, aux, q, prof, r, n, g, bc,
                                                    use_les, st, pv, failed);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// ---------------------------------------------------------------------------
// A lockstep group's chunk: one launch a step over the group's alive cases
// ---------------------------------------------------------------------------

// Launches K1's group instance over the ``n_slots`` alive cases of
// ``ga.slots`` (blockIdx.z); nothing when n_slots is 0.
template <typename S, int OBST, bool FULL>
static void launch_group(const void* f_in, void* f_out, const void* aux, const void* q,
                         const void* prof, void* rho, void* u, void* f_post, const BlockGeom& g,
                         const BcTypes& bc, int use_les, cudaStream_t stream, const RingPrev& pv,
                         const GroupArgs& ga, int n_slots) {
  dim3 grid;
  int nr;
  if (n_slots < 1 || !k1_shape(g, &grid, &nr)) return;
  grid.z = n_slots;
  k1_group_kernel<S, OBST, FULL><<<grid, dim3(256, 1, 1), 0, stream>>>(
      static_cast<const typename S::T*>(f_in), static_cast<typename S::T*>(f_out),
      static_cast<const float*>(aux), static_cast<const float*>(q),
      static_cast<const float*>(prof), static_cast<float*>(rho), static_cast<float*>(u),
      static_cast<float*>(f_post), g, bc, use_les, nr, pv, ga);
}

// n fast steps of the group, one launch each: step i takes column i of the
// row table (``rows`` + 14 i for case 0), reads f_in (step 0) or the
// previous step's output and writes f_a (even i) or f_b (odd i), as
// steps_loop does for one case; ``pv`` is step 0's RingPrev.
template <typename S, int OBST>
static int group_steps_loop(const void* f_in, void* f_a, void* f_b, const void* aux,
                            const void* q, const void* prof, const float* rows, int n,
                            int row_stride, const int* slots, int n_slots, const BlockGeom& g,
                            const BcTypes& bc, int use_les, cudaStream_t st, const RingPrev& pv,
                            int* failed) {
  const void* src = f_in;
  for (int i = 0; i < n; ++i) {
    void* dst = (i & 1) ? f_b : f_a;
    launch_group<S, OBST, false>(src, dst, aux, q, prof, nullptr, nullptr, nullptr, g, bc,
                                 use_les, st, RingPrev{pv.rho, pv.u, i == 0 ? pv.fresh : 0},
                                 GroupArgs{slots, rows + 14 * i, row_stride}, n_slots);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
      *failed = i;
      return static_cast<int>(err);
    }
    src = dst;
  }
  return 0;
}

// The fast steps of a lockstep group's chunk in one call, the counterpart of
// the JAX BatchEngine's chunk program (run_chunk_batched's vmap over
// lax.scan, _chunk_sequential's fused kernels inside one jit,
// lbm2d_tpu/parallel/batch.py:77-176): n steps, each one launch over the
// ``n_slots`` alive cases whose indices the device table ``slots`` holds.
// The group buffers are [B, 9, H, W] (f_in, f_a, f_b: f32, or bf16
// deviations with ``dev``, EQ and BOUNCE only), aux [B, H, W], q [B, 8, H,
// W] (Bouzidi only, else null), prof [B, H] (left types 3/4 only, else
// null), ``rows`` the device table [B, R, 14] of the cases' scalar rows
// (``row_stride`` = 14 R floats; step i reads column i), ``rho_prev`` /
// ``u_prev`` the state's [B, H, W] / [B, 2, H, W] where a side is a no-op
// (``fresh`` for step 0), else null. A dead case's slices are never read or
// written. Returns the CUDA error code (``*failed`` the failing step, -1 for
// refused arguments) or 0; on the current stream, no sync.
extern "C" int k1_group_steps_launch(const void* f_in, void* f_a, void* f_b, const void* aux,
                                     const void* q, const void* prof, const void* rows, int n,
                                     int row_stride, const void* slots, int n_slots, int H, int W,
                                     int bc_left, int bc_top, int bc_right, int bc_bottom,
                                     int use_les, int dev, int obst, void* stream, int* failed,
                                     const void* rho_prev, const void* u_prev, int fresh) {
  *failed = -1;
  if (n < 0 || n_slots < 0 || H < 3 || W < 3 || row_stride < 14 * n)
    return static_cast<int>(cudaErrorInvalidValue);
  const BlockGeom g{H, W, W, 0, 0, 0, H, W};
  const BcTypes bc{bc_left, bc_top, bc_right, bc_bottom};
  const RingPrev pv{static_cast<const float*>(rho_prev), static_cast<const float*>(u_prev),
                    fresh};
  const float* r = static_cast<const float*>(rows);
  const int* sl = static_cast<const int*>(slots);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dev) {
    switch (obst) {
      case LBM_OBST_EQ:
        return group_steps_loop<DevStore, LBM_OBST_EQ>(f_in, f_a, f_b, aux, nullptr, prof, r, n,
                                                       row_stride, sl, n_slots, g, bc, use_les,
                                                       st, pv, failed);
      case LBM_OBST_BOUNCE:
        return group_steps_loop<DevStore, LBM_OBST_BOUNCE>(f_in, f_a, f_b, aux, nullptr, prof, r,
                                                           n, row_stride, sl, n_slots, g, bc,
                                                           use_les, st, pv, failed);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (obst) {
    case LBM_OBST_EQ:
      return group_steps_loop<F32Store, LBM_OBST_EQ>(f_in, f_a, f_b, aux, q, prof, r, n,
                                                     row_stride, sl, n_slots, g, bc, use_les, st,
                                                     pv, failed);
    case LBM_OBST_BOUNCE:
      return group_steps_loop<F32Store, LBM_OBST_BOUNCE>(f_in, f_a, f_b, aux, q, prof, r, n,
                                                         row_stride, sl, n_slots, g, bc, use_les,
                                                         st, pv, failed);
    case LBM_OBST_HALFWAY:
      return group_steps_loop<F32Store, LBM_OBST_HALFWAY>(f_in, f_a, f_b, aux, q, prof, r, n,
                                                          row_stride, sl, n_slots, g, bc, use_les,
                                                          st, pv, failed);
    case LBM_OBST_BOUZIDI:
      return group_steps_loop<F32Store, LBM_OBST_BOUZIDI>(f_in, f_a, f_b, aux, q, prof, r, n,
                                                          row_stride, sl, n_slots, g, bc, use_les,
                                                          st, pv, failed);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The closing full step of a lockstep group's chunk: one launch of K1's full
// group instance over the alive cases (f32 f_in -> f_out, writing their rho
// [B, H, W], u [B, 2, H, W] and f_post [B, 9, H, W] slices); ``rows`` points
// at case 0's row of this step in the device table, the other arguments as
// for k1_group_steps_launch. Returns the CUDA error code or 0.
extern "C" int k1_group_full_launch(const void* f_in, void* f_out, const void* aux,
                                    const void* q, const void* prof, void* rho, void* u,
                                    void* f_post, const void* rows, int row_stride,
                                    const void* slots, int n_slots, int H, int W, int bc_left,
                                    int bc_top, int bc_right, int bc_bottom, int use_les, int obst,
                                    void* stream, const void* rho_prev, const void* u_prev,
                                    int fresh) {
  if (n_slots < 0 || H < 3 || W < 3 || row_stride < 14)
    return static_cast<int>(cudaErrorInvalidValue);
  const BlockGeom g{H, W, W, 0, 0, 0, H, W};
  const BcTypes bc{bc_left, bc_top, bc_right, bc_bottom};
  const RingPrev pv{static_cast<const float*>(rho_prev), static_cast<const float*>(u_prev),
                    fresh};
  const GroupArgs ga{static_cast<const int*>(slots), static_cast<const float*>(rows),
                     row_stride};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (obst) {
    case LBM_OBST_EQ:
      launch_group<F32Store, LBM_OBST_EQ, true>(f_in, f_out, aux, q, prof, rho, u, f_post, g, bc,
                                                use_les, st, pv, ga, n_slots);
      break;
    case LBM_OBST_BOUNCE:
      launch_group<F32Store, LBM_OBST_BOUNCE, true>(f_in, f_out, aux, q, prof, rho, u, f_post, g,
                                                    bc, use_les, st, pv, ga, n_slots);
      break;
    case LBM_OBST_HALFWAY:
      launch_group<F32Store, LBM_OBST_HALFWAY, true>(f_in, f_out, aux, q, prof, rho, u, f_post,
                                                     g, bc, use_les, st, pv, ga, n_slots);
      break;
    case LBM_OBST_BOUZIDI:
      launch_group<F32Store, LBM_OBST_BOUZIDI, true>(f_in, f_out, aux, q, prof, rho, u, f_post,
                                                     g, bc, use_les, st, pv, ga, n_slots);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// A sharded chunk on a mesh whose blocks live on the devices of one process
// ---------------------------------------------------------------------------

// The blocks' geometries from the host table ``geoms`` [ry * rx][8] (row
// major): false unless every block is a 1-cell-halo shard of one [hl, wl]
// shape and pitch, at origin (iy hl, ix wl) of the (ry hl) x (rx wl) grid.
static bool mesh_geoms(const int* geoms, int ry, int rx, BlockGeom* g) {
  if (ry < 1 || rx < 1 || ry * rx > LBM_HALO_MAX_BLOCKS) return false;
  for (int b = 0; b < ry * rx; ++b) {
    g[b] = load_geom(geoms + 8 * b);
    const BlockGeom& h = g[b];
    if (h.halo != 1 || h.hl != g[0].hl || h.wl != g[0].wl || h.pitch != g[0].pitch ||
        h.pitch < h.wl + 2 || h.y_off != (b / rx) * h.hl || h.x_off != (b % rx) * h.wl ||
        h.Hg != ry * h.hl || h.Wg != rx * h.wl)
      return false;
  }
  return true;
}

static const void* table_at(const void* const* table, int b) {
  return table == nullptr ? nullptr : table[b];
}

// n fast steps of every block: step i launches K1's _shard instance on each
// block (device by device, on its stream) with row i of ``rows``, reading
// f_in (step 0) or the previous step's output and writing f_a (even i) or
// f_b (odd i), its edge cells pushed into its neighbours' halos of the
// same buffer (``na`` / ``nb``: each block's neighbours in f_a / f_b) --
// parallel/sharded.py fast_step's result, with no second launch. Across
// devices each device's step waits for its neighbours' previous step
// (MeshDevs). ``rp`` / ``up`` are each block's RingPrev planes (null
// tables where every side is active), ``fresh`` step 0's. After each step
// cudaGetLastError(); on a failure ``*failed`` is the step's index and the
// rest are not launched.
template <typename S, int OBST>
static int shard_steps_loop(const void* const* f_in, void* const* f_a, void* const* f_b,
                            const void* const* aux, const void* const* q,
                            const void* const* prof, const BlockGeom* g, const ShardNbrs* na,
                            const ShardNbrs* nb, const float* rows, int n, const BcTypes& bc,
                            int use_les, MeshDevs& md, const void* const* rp,
                            const void* const* up, int fresh, int* failed) {
  md.open();
  for (int i = 0; i < n; ++i) {
    const Scalars s = load_scalars(rows + 14 * i);
    void* const* dst = (i & 1) ? f_b : f_a;
    const ShardNbrs* nbrs = (i & 1) ? nb : na;
    const void* const* src =
        i == 0 ? f_in : reinterpret_cast<const void* const*>((i & 1) ? f_a : f_b);
    for (int d = 0; d < md.nd; ++d) {
      const cudaStream_t st = md.enter(d, i);
      for (int k = 0; k < md.nblk[d]; ++k) {
        const int b = md.blk[d][k];
        const RingPrev pv{static_cast<const float*>(table_at(rp, b)),
                          static_cast<const float*>(table_at(up, b)), i == 0 ? fresh : 0};
        launch<S, OBST, true, false>(src[b], dst[b], aux[b], table_at(q, b),
                                     table_at(prof, b), nullptr, nullptr, nullptr, s, g[b], bc,
                                     use_les, st, nbrs[b], pv);
      }
      md.leave(d, i);
    }
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) {
      *failed = i;
      return static_cast<int>(err);
    }
  }
  return 0;
}

// The neighbour tables of the ry x rx blocks ``blocks`` (shard_nbrs);
// false if a block is null.
static bool mesh_nbrs(void* const* blocks, int ry, int rx, ShardNbrs* out) {
  for (int b = 0; b < ry * rx; ++b)
    if (blocks[b] == nullptr) return false;
  for (int b = 0; b < ry * rx; ++b) out[b] = shard_nbrs(blocks, ry, rx, b);
  return true;
}

// The fast steps of a sharded chunk in one call, the counterpart of the
// step loop run_chunk_sharded_pallas runs inside one program
// (lbm2d_tpu/parallel/sharded.py:496-537: lax.scan over the shard_map'd
// step and its collective-permute halo update), for a mesh whose ry x rx
// blocks live on the CUDA devices of this process. Host tables of ry * rx
// entries, row major: f_in, f_a, f_b, aux, q (Bouzidi only, else null),
// prof (left types 3/4 only, else null) hold each block's device pointers
// ([9, hl + 2, pitch] planes, aux [hl + 2, pitch], q [8, hl + 2, pitch],
// prof [hl]), ``geoms`` each block's 8 ints (cuda_step.BlockGeom.shard),
// ``devs`` its device's ordinal and ``streams`` that device's stream (one
// a device; peer access between the devices, mesh_peers_launch). ``rows``
// [n, 14] is the chunk's host table of scalar rows, ``dev`` picks 16-bit
// deviation storage (bf16 f; EQ and BOUNCE only) over f32. f_b may be f_in,
// which only step 0 reads. ``rho_prev`` / ``u_prev`` are tables of each
// block's RingPrev planes ([hl + 2, pitch] and [2, ...]; null where every
// side is active), ``fresh`` step 0's. Each step's output carries its halos
// (the pushes), as the halo refresh left them. Returns the CUDA error code
// (``*failed`` the failing step, -1 for refused arguments) or 0; the
// caller's device stays current.
extern "C" int k1_shard_steps_launch(const void* f_in, const void* f_a, const void* f_b,
                                     const void* aux, const void* q, const void* prof,
                                     const int* geoms, int ry, int rx, const void* rows, int n,
                                     int bc_left, int bc_top, int bc_right, int bc_bottom,
                                     int use_les, int dev, int obst, const int* devs,
                                     const void* streams, int* failed, const void* rho_prev,
                                     const void* u_prev, int fresh) {
  *failed = -1;
  BlockGeom g[LBM_HALO_MAX_BLOCKS];
  if (n < 0 || !mesh_geoms(geoms, ry, rx, g)) return static_cast<int>(cudaErrorInvalidValue);
  auto fi = static_cast<const void* const*>(f_in);
  auto fa = static_cast<void* const*>(const_cast<void*>(f_a));
  auto fb = static_cast<void* const*>(const_cast<void*>(f_b));
  auto ax = static_cast<const void* const*>(aux);
  auto qt = static_cast<const void* const*>(q);
  auto pt = static_cast<const void* const*>(prof);
  ShardNbrs na[LBM_HALO_MAX_BLOCKS], nb[LBM_HALO_MAX_BLOCKS];
  if (!mesh_nbrs(fa, ry, rx, na) || !mesh_nbrs(fb, ry, rx, nb))
    return static_cast<int>(cudaErrorInvalidValue);
  MeshDevs md;
  if (!md.init(devs, static_cast<void* const*>(const_cast<void*>(streams)), ry, rx))
    return static_cast<int>(cudaErrorInvalidValue);
  const BcTypes bc{bc_left, bc_top, bc_right, bc_bottom};
  const float* r = static_cast<const float*>(rows);
  auto rp = static_cast<const void* const*>(rho_prev);
  auto up = static_cast<const void* const*>(u_prev);
  if (dev) {
    switch (obst) {
      case LBM_OBST_EQ:
        return shard_steps_loop<DevStore, LBM_OBST_EQ>(fi, fa, fb, ax, nullptr, pt, g, na, nb,
                                                       r, n, bc, use_les, md, rp, up, fresh,
                                                       failed);
      case LBM_OBST_BOUNCE:
        return shard_steps_loop<DevStore, LBM_OBST_BOUNCE>(fi, fa, fb, ax, nullptr, pt, g, na,
                                                           nb, r, n, bc, use_les, md, rp, up,
                                                           fresh, failed);
      default:
        return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  switch (obst) {
    case LBM_OBST_EQ:
      return shard_steps_loop<F32Store, LBM_OBST_EQ>(fi, fa, fb, ax, qt, pt, g, na, nb, r, n,
                                                     bc, use_les, md, rp, up, fresh, failed);
    case LBM_OBST_BOUNCE:
      return shard_steps_loop<F32Store, LBM_OBST_BOUNCE>(fi, fa, fb, ax, qt, pt, g, na, nb, r,
                                                         n, bc, use_les, md, rp, up, fresh,
                                                         failed);
    case LBM_OBST_HALFWAY:
      return shard_steps_loop<F32Store, LBM_OBST_HALFWAY>(fi, fa, fb, ax, qt, pt, g, na, nb, r,
                                                          n, bc, use_les, md, rp, up, fresh,
                                                          failed);
    case LBM_OBST_BOUZIDI:
      return shard_steps_loop<F32Store, LBM_OBST_BOUZIDI>(fi, fa, fb, ax, qt, pt, g, na, nb, r,
                                                          n, bc, use_les, md, rp, up, fresh,
                                                          failed);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The closing full step of a sharded chunk in one call: K1's full _shard
// instance on every block (f32 f_in -> f_out, writing rho, u and f_post),
// its edge cells pushed into the neighbours' halos of f_out, which the next
// chunk reads. Tables as for k1_shard_steps_launch, plus rho [hl + 2,
// pitch], u [2, ...] and f_post [9, ...] of each block and the host scalar
// row ``scal``, and ``rho_prev`` / ``u_prev`` / ``fresh`` as for
// k1_shard_steps_launch. Returns the CUDA error code (cudaErrorInvalidValue
// for refused arguments) or 0.
extern "C" int k1_shard_full_launch(const void* f_in, const void* f_out, const void* aux,
                                    const void* q, const void* prof, const void* rho,
                                    const void* u, const void* f_post, const void* scal,
                                    const int* geoms, int ry, int rx, int bc_left, int bc_top,
                                    int bc_right, int bc_bottom, int use_les, int obst,
                                    const int* devs, const void* streams, const void* rho_prev,
                                    const void* u_prev, int fresh) {
  BlockGeom g[LBM_HALO_MAX_BLOCKS];
  if (!mesh_geoms(geoms, ry, rx, g) || obst < LBM_OBST_EQ || obst > LBM_OBST_BOUZIDI)
    return static_cast<int>(cudaErrorInvalidValue);
  auto fo = static_cast<void* const*>(const_cast<void*>(f_out));
  ShardNbrs no[LBM_HALO_MAX_BLOCKS];
  if (!mesh_nbrs(fo, ry, rx, no)) return static_cast<int>(cudaErrorInvalidValue);
  MeshDevs md;
  if (!md.init(devs, static_cast<void* const*>(const_cast<void*>(streams)), ry, rx))
    return static_cast<int>(cudaErrorInvalidValue);
  auto fi = static_cast<const void* const*>(f_in);
  auto ax = static_cast<const void* const*>(aux);
  auto qt = static_cast<const void* const*>(q);
  auto pt = static_cast<const void* const*>(prof);
  auto rt = static_cast<void* const*>(const_cast<void*>(rho));
  auto ut = static_cast<void* const*>(const_cast<void*>(u));
  auto ft = static_cast<void* const*>(const_cast<void*>(f_post));
  auto rp = static_cast<const void* const*>(rho_prev);
  auto up = static_cast<const void* const*>(u_prev);
  const BcTypes bc{bc_left, bc_top, bc_right, bc_bottom};
  md.open();
  for (int d = 0; d < md.nd; ++d) {
    const cudaStream_t st = md.enter(d, 0);
    for (int k = 0; k < md.nblk[d]; ++k) {
      const int b = md.blk[d][k];
      const RingPrev pv{static_cast<const float*>(table_at(rp, b)),
                        static_cast<const float*>(table_at(up, b)), fresh};
      const int rc = dispatch<true>(fi[b], fo[b], ax[b], table_at(qt, b), table_at(pt, b),
                                    rt[b], ut[b], ft[b], scal, g[b], bc, use_les, 1, obst, st,
                                    pv, no[b]);
      if (rc != 0) return rc;
    }
    md.leave(d, 0);
  }
  return static_cast<int>(cudaGetLastError());
}

// Peer access between the n devices ``devs`` (mesh_peers, halo.cuh): 0, or
// the CUDA error of a pair without it.
extern "C" int mesh_peers_launch(const int* devs, int n) { return mesh_peers(devs, n); }
