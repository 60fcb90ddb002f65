// K2: the boundary ring of one step, rebuilt after K1.
//
// Replaces the TPU kernel _edge_bc_kernel (lbm2d_tpu/ops/pallas_step.py:1379,
// launched by _edge_bc_step :1673). One thread per ring cell writes, in the
// reference apply_bc order: the left/right columns on the inner rows, the
// bottom/top rows including the corners, then the obstacle overwrite
// f = w rho (and u = 0) on solid ring cells. Types: left 0 (Zou-He
// pressure inlet), 2 (free-slip), 3 or 4 (the profiled velocity inlets,
// equilibrium and NEBB, from the case's inlet_profile); right 0 (velocity
// inlet), 1 (Zou-He pressure outlet with the backflow guard) or 2;
// top/bottom 0 or 2. Under full-way bounce-back (``bounce``, the JAX
// kernel's :1543 and :1625) the f overwrite is skipped and solids keep
// their BC values; u = 0 on solids still holds in the full variant.
//
// The inlet profile is read from the [H] f32 tensor make_params built, one
// value per row, never recomputed: the JAX kernel recomputes the parabola
// in-kernel (:1511-1518) and has to match make_params' f32 operation order;
// reading the same tensor the eager step reads removes that trap.
//
// The 16-bit deviation-storage variant (k2_edge_bc_dev, the JAX kernel's
// store_dev branch) computes the same f32 ring and stores it into the bf16
// f - w buffer, quantized once per cell. Its inputs stay K1's f32 edge
// export: the JAX kernel instead dequantizes the stored neighbour strip,
// so the two differ by one bf16 rounding of that strip.
//
// Bound on an H100: launch latency. It touches 2 (H + W) cells, ~14 KB of
// reads and ~40 KB of writes at 2432x1152, a microsecond of memory time.
//
// Design: every input comes from K1's edge export (collide f_post, rho,
// ux, uy of the strips next to the ring, before the obstacle overwrite),
// never from K1's stored f, so a solid cell on column 1 / W-2 or row 1 /
// H-2 feeds the BCs exactly as in solver.apply_bc. The TPU kernel can let
// the row programs read corner macros that the column programs stored,
// because TPU grid programs run in order; GPU blocks do not, so a row
// thread at x = 0 or x = W-1 recomputes the side BC of its inward
// neighbour (row 1 or H-2) itself, which costs a handful of flops and
// needs no second launch.
//
// The sharded form (k2_edge_bc_shard*, the JAX kernel's _edge_bc_step(offs=)
// at :1673-1713, ownership masks :1440-1445) runs the same body on a
// shard's BlockGeom (lbm_common.cuh): a side column is written only by the
// blocks with x_off == 0 or x_off + wl == Wg, on global inner rows, a row
// only by the blocks with y_off == 0 or y_off + hl == Hg. Every input stays
// on the block: with hl, wl >= 2 the block that holds a ring cell also
// holds the exported strip next to it and, at a corner, row 1 / Hg-2 of
// the side column (parallel/topology.mesh_refusal asks for 3x3 blocks).
#include "lbm_cell.cuh"

__device__ __forceinline__ Cell load_col(const float* edge, int side, int y,
                                         int H) {
  const float* col = edge + (size_t)side * LBM_EDGE_C * H;
  Cell n;
  for (int k = 0; k < 9; ++k) n.f[k] = col[(size_t)k * H + y];
  n.rho = col[(size_t)9 * H + y];
  n.ux = col[(size_t)10 * H + y];
  n.uy = col[(size_t)11 * H + y];
  return n;
}

__device__ __forceinline__ Cell load_row(const float* edge, int side, int x,
                                         int H, int W) {
  const float* row =
      edge + (size_t)2 * LBM_EDGE_C * H + (size_t)side * LBM_EDGE_C * W;
  Cell n;
  for (int k = 0; k < 9; ++k) n.f[k] = row[(size_t)k * W + x];
  n.rho = row[(size_t)9 * W + x];
  n.ux = row[(size_t)10 * W + x];
  n.uy = row[(size_t)11 * W + x];
  return n;
}

// Threads 0 .. 2 hl - 1 take the block's left and right columns, the next
// 2 wl its bottom and top rows; a thread whose cell is not on the global
// ring (or whose side column is not on a global inner row) returns. The
// local (y, x) and the export are the block's, the tests global.
template <typename S, bool SHARD>
__global__ void __launch_bounds__(256)
k2_edge_bc_kernel(typename S::T* __restrict__ f, const float* __restrict__ aux,
                  const float* __restrict__ edge,
                  const float* __restrict__ prof, float* __restrict__ rho_out,
                  float* __restrict__ u_out, const Scalars s,
                  const BlockGeom geom, const int bc_left_t, const int bc_top_t,
                  const int bc_right_t, const int bc_bottom_t,
                  const int bounce, const int full) {
  const BlockGeom g = fold_geom<SHARD>(geom);
  // the profile (the block's rows) is read only for left types 3/4 (prof
  // may be null else)
  const bool vel = bc_left_t == LBM_BC_VEL_INLET ||
                   bc_left_t == LBM_BC_VEL_INLET_NEBB;
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int hl = g.hl, wl = g.wl;
  int x, y;
  Cell b;
  if (t < 2 * hl) {
    const bool right = t >= hl;
    y = right ? t - hl : t;
    const int gy = g.y_off + y;
    if (gy < 1 || gy > g.Hg - 2) return;
    if (right) {
      if (g.x_off + wl != g.Wg) return;
      x = wl - 1;
      b = bc_right(load_col(edge, 1, y, hl), s, bc_right_t);
    } else {
      if (g.x_off != 0) return;
      x = 0;
      b = bc_left(load_col(edge, 0, y, hl), s, bc_left_t, vel ? prof[y] : 0.0f);
    }
  } else if (t < 2 * hl + 2 * wl) {
    const int r = t - 2 * hl;
    const bool top = r >= wl;
    if (top ? g.y_off + hl != g.Hg : g.y_off != 0) return;
    x = top ? r - wl : r;
    y = top ? hl - 1 : 0;
    const int nb_y = top ? hl - 2 : 1;
    const int gx = g.x_off + x;
    // the inward neighbour: a ring cell of the side BC at the corners
    Cell n;
    if (gx == 0)
      n = bc_left(load_col(edge, 0, nb_y, hl), s, bc_left_t,
                  vel ? prof[nb_y] : 0.0f);
    else if (gx == g.Wg - 1)
      n = bc_right(load_col(edge, 1, nb_y, hl), s, bc_right_t);
    else
      n = load_row(edge, top ? 1 : 0, x, hl, wl);
    b = top ? bc_horizontal(n, s, bc_top_t, 1)
            : bc_horizontal(n, s, bc_bottom_t, 3);
  } else {
    return;
  }

  const size_t plane = geom_plane(g);
  const size_t c = geom_at(g, y, x);
  const bool solid = __float_as_int(aux[c]) < 0;
  const bool overwrite = solid && !bounce;
  for (int k = 0; k < 9; ++k)
    S::store(f, k * plane + c, k, overwrite ? lbm_w(k) * b.rho : b.f[k]);
  if (full) {
    rho_out[c] = b.rho;
    u_out[c] = solid ? 0.0f : b.ux;
    u_out[plane + c] = solid ? 0.0f : b.uy;
  }
}

template <typename S, bool SHARD>
static int launch(void* f, const void* aux, const void* edge, const void* prof,
                  void* rho, void* u, const void* scal, const BlockGeom& g,
                  int bc_left_t, int bc_top_t, int bc_right_t, int bc_bottom_t,
                  int bounce, int full, void* stream) {
  const Scalars s = load_scalars(static_cast<const float*>(scal));
  const int n = 2 * g.hl + 2 * g.wl;
  k2_edge_bc_kernel<S, SHARD><<<(n + 255) / 256, 256, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<typename S::T*>(f), static_cast<const float*>(aux),
      static_cast<const float*>(edge), static_cast<const float*>(prof),
      static_cast<float*>(rho), static_cast<float*>(u), s, g, bc_left_t,
      bc_top_t, bc_right_t, bc_bottom_t, bounce, full);
  return static_cast<int>(cudaGetLastError());
}

// Launches K2 on ``stream``; returns cudaGetLastError() as an int.
// ``geom`` is a host pointer to the block's 8 ints (load_geom): the whole
// [H, W] grid (halo 0) or one shard of a spatial mesh (the JAX kernel's
// sharded form, _edge_bc_step(offs=)) with its 1-cell halo, of which only
// the ring cells of the Hg x Wg grid that the block holds are written, from
// the block's own export. ``prof`` (the block's [hl] rows of the inlet
// profile) is read only for left types 3/4; rho/u, in the block's
// geometry, are written only when full.
extern "C" int k2_edge_bc_launch(void* f, const void* aux, const void* edge,
                                 const void* prof, void* rho, void* u,
                                 const void* scal, const int* geom,
                                 int bc_left_t, int bc_top_t, int bc_right_t,
                                 int bc_bottom_t, int bounce, int full,
                                 void* stream) {
  const BlockGeom g = load_geom(geom);
  return g.halo ? launch<F32Store, true>(f, aux, edge, prof, rho, u, scal, g,
                                         bc_left_t, bc_top_t, bc_right_t,
                                         bc_bottom_t, bounce, full, stream)
                : launch<F32Store, false>(f, aux, edge, prof, rho, u, scal, g,
                                          bc_left_t, bc_top_t, bc_right_t,
                                          bc_bottom_t, bounce, full, stream);
}

// The ring in 16-bit deviation storage: ``f`` is the bf16 buffer of f - w
// that k1_step_dev wrote, in the block's geometry; no rho/u (never the
// full variant).
extern "C" int k2_edge_bc_dev_launch(void* f, const void* aux,
                                     const void* edge, const void* prof,
                                     const void* scal, const int* geom,
                                     int bc_left_t, int bc_top_t,
                                     int bc_right_t, int bc_bottom_t,
                                     int bounce, void* stream) {
  const BlockGeom g = load_geom(geom);
  return g.halo ? launch<DevStore, true>(f, aux, edge, prof, nullptr, nullptr,
                                         scal, g, bc_left_t, bc_top_t,
                                         bc_right_t, bc_bottom_t, bounce, 0,
                                         stream)
                : launch<DevStore, false>(f, aux, edge, prof, nullptr, nullptr,
                                          scal, g, bc_left_t, bc_top_t,
                                          bc_right_t, bc_bottom_t, bounce, 0,
                                          stream);
}
