// Device functions of one lattice cell shared by the kernels that update
// whole cells: K1 (k1_step.cu) and K3 (k3_fused.cu) call the interior
// update and the boundary conditions of the ring; K1's ring threads pick a
// ring cell's BCs with lbm_ring_values and store it with lbm_store_ring. K1
// also runs the layouts with a no-op side (lbm_ring_from); K3 is never
// given one (cuda_step.fuse_refusal).
//
// Each function reads its inputs through the caller's accessors or
// arguments, so the same arithmetic runs on global memory (K1) and on a
// shared-memory window (K3), in the eager step's operation order (see
// lbm_common.cuh).
#pragma once

#include "lbm_common.cuh"

// The velocity set as constant expressions (core/lattice.py E and OPP), so
// unrolled loops fold the offsets into immediates.
__host__ __device__ constexpr int lbm_ex(int k) {
  return (k == 1 || k == 5 || k == 8) ? 1 : ((k == 3 || k == 6 || k == 7) ? -1 : 0);
}
__host__ __device__ constexpr int lbm_ey(int k) {
  return (k == 2 || k == 5 || k == 6) ? 1 : ((k == 4 || k == 7 || k == 8) ? -1 : 0);
}
__host__ __device__ constexpr int lbm_opp(int k) {
  return k == 0 ? 0 : (k < 5 ? (k + 1) % 4 + 1 : (k - 3) % 4 + 5);
}

// One interior cell's update (solver.collide_stream_full): pull streaming
// f_k(c) <- f_k(c - e_k), the half-way or Bouzidi link rule, the MRT-LES
// collision and full-way bounce-back. Accessors:
//   f_at(k, dy, dx)  f_k of the previous field at (y + dy, x + dx);
//   solid_at(dy, dx) the solid flag there (sign bit of aux);
//   q_at(j)          Bouzidi wall-fraction plane j at the cell (BOUZIDI only).
// Returns in fp the collide output after the full-way bounce, before the
// obstacle overwrite (what the boundary conditions read), and the macros.
// The links are the ones whose pull source c - e_k is solid:
//   HALFWAY  f_k <- f_opp k(c);
//   BOUZIDI  q = q[opp k - 1](c), with ko = opp k:
//              q < 1/2:  2q f_ko(c) + (1 - 2q) f_ko(c + e_k)
//              q >= 1/2: f_ko(c) / (2q) + (2q - 1) / (2q) f_k(c).
template <int OBST, class FAt, class SolidAt, class QAt>
__device__ __forceinline__ void lbm_cell_update(const FAt& f_at, const SolidAt& solid_at,
                                                const QAt& q_at, float damp, bool solid,
                                                const Scalars& s, int use_les,
                                                float fp[9], float* rho, float* ux,
                                                float* uy) {
  float fs[9];
#pragma unroll
  for (int k = 0; k < 9; ++k) fs[k] = f_at(k, -lbm_ey(k), -lbm_ex(k));

  if (OBST == LBM_OBST_HALFWAY || OBST == LBM_OBST_BOUZIDI) {
#pragma unroll
    for (int k = 1; k < 9; ++k) {
      const int ex = lbm_ex(k), ey = lbm_ey(k);
      if (!solid_at(-ey, -ex)) continue;  // pull source fluid
      const int ko = lbm_opp(k);
      const float f_o = f_at(ko, 0, 0);
      if (OBST == LBM_OBST_HALFWAY) {
        fs[k] = f_o;
      } else {
        const float qv = q_at(ko - 1);
        const float q2 = 2.0f * qv;
        if (qv < 0.5f) {
          fs[k] = q2 * f_o + (1.0f - q2) * f_at(ko, ey, ex);
        } else {
          fs[k] = f_o / q2 + ((q2 - 1.0f) / q2) * f_at(k, 0, 0);
        }
      }
    }
  }

  mrt_collide(fs, damp, s, use_les, fp, rho, ux, uy);
  if (OBST == LBM_OBST_BOUNCE && solid) {
#pragma unroll
    for (int k = 0; k < 9; ++k) fp[k] = fs[lbm_opp(k)];
  }
}

// The population k a cell stores: the obstacle overwrite f = w rho on
// solids, except under full-way bounce-back, which keeps its reversed
// populations.
template <int OBST>
__device__ __forceinline__ float lbm_stored(int k, const float fp[9], float rho,
                                            bool solid) {
  return (OBST != LBM_OBST_BOUNCE && solid) ? lbm_w(k) * rho : fp[k];
}

// The collide output of one cell, or the BC values of a ring cell.
struct Cell {
  float f[9];
  float rho, ux, uy;
};

// fb = rho_nb (g_b - g(u_nb)) + f_nb, the non-equilibrium extrapolation
// shared by free-slip and the non-west velocity inlets.
__device__ __forceinline__ void nebb(const Cell& n, const float gb[9], Cell* b) {
  float g[9];
  feq_unit(n.ux, n.uy, g);
  for (int k = 0; k < 9; ++k) b->f[k] = n.rho * (gb[k] - g[k]) + n.f[k];
}

// solver.bc_left_values for types 0 (pressure inlet), 2 (free-slip) and
// 3/4 (profiled velocity inlets; ``u_prof`` is the row's profile value).
__device__ __forceinline__ Cell bc_left(const Cell& n, const Scalars& s, int t,
                                        float u_prof) {
  Cell b;
  if (t == LBM_BC_VEL_INLET || t == LBM_BC_VEL_INLET_NEBB) {
    bc_vel_inlet(t, u_prof, s.ramp, n.f, n.rho, n.ux, n.uy, b.f, &b.rho, &b.ux, &b.uy);
  } else if (t == 0) {
    const float* fn = n.f;
    const float rho_c = 1.0f + (s.rho_in - 1.0f) * s.ramp;
    const float ux =
        1.0f - (((fn[0] + fn[2]) + fn[4]) + 2.0f * ((fn[3] + fn[6]) + fn[7])) / rho_c;
    float g[9];
    feq_unit_x(ux, g);
    for (int k = 0; k < 9; ++k) b.f[k] = rho_c * g[k];
    b.f[1] = fn[3] + ((float)(2.0 / 3.0) * rho_c) * ux;
    b.f[5] = (fn[7] - 0.5f * (fn[2] - fn[4])) + ((float)(1.0 / 6.0) * rho_c) * ux;
    b.f[8] = (fn[6] + 0.5f * (fn[2] - fn[4])) + ((float)(1.0 / 6.0) * rho_c) * ux;
    b.rho = rho_c;
    b.ux = ux;
    b.uy = 0.0f;
  } else {  // free-slip: normal (x) velocity zeroed, tangential kept
    float gb[9];
    feq_unit_y(n.uy, gb);
    nebb(n, gb, &b);
    b.rho = n.rho;
    b.ux = 0.0f;
    b.uy = n.uy;
  }
  return b;
}

// solver.bc_right_values for types 0 (velocity inlet), 1 (pressure outlet)
// and 2 (free-slip).
__device__ __forceinline__ Cell bc_right(const Cell& n, const Scalars& s, int t) {
  Cell b;
  if (t == 1) {
    const float* fn = n.f;
    const float rho_o = s.rho_out;
    const float ux =
        -1.0f + (((fn[0] + fn[2]) + fn[4]) + 2.0f * ((fn[1] + fn[5]) + fn[8])) / rho_o;
    if (ux < 0.0f) {  // backflow guard: zero-gradient extrapolation
      float g[9];
      feq_unit(n.ux, n.uy, g);
      for (int k = 0; k < 9; ++k) b.f[k] = (rho_o - n.rho) * g[k] + fn[k];
      b.ux = n.ux;
      b.uy = n.uy;
    } else {
      float g[9];
      feq_unit_x(ux, g);
      for (int k = 0; k < 9; ++k) b.f[k] = rho_o * g[k];
      b.f[3] = fn[1] - ((float)(2.0 / 3.0) * rho_o) * ux;
      b.f[6] = (fn[8] - 0.5f * (fn[2] - fn[4])) - ((float)(1.0 / 6.0) * rho_o) * ux;
      b.f[7] = (fn[5] + 0.5f * (fn[2] - fn[4])) - ((float)(1.0 / 6.0) * rho_o) * ux;
      b.ux = ux;
      b.uy = 0.0f;
    }
    b.rho = rho_o;
  } else if (t == 0) {
    const float vx = s.bcv[4] * s.ramp;
    const float vy = s.bcv[5] * s.ramp;
    float gb[9];
    feq_unit(vx, vy, gb);
    nebb(n, gb, &b);
    b.rho = n.rho;
    b.ux = vx;
    b.uy = vy;
  } else {
    float gb[9];
    feq_unit_y(n.uy, gb);
    nebb(n, gb, &b);
    b.rho = n.rho;
    b.ux = 0.0f;
    b.uy = n.uy;
  }
  return b;
}

// solver.bc_horizontal_values for types 0 (velocity inlet) and 2
// (free-slip); ``side`` is 1 (top) or 3 (bottom), the bc_value row.
__device__ __forceinline__ Cell bc_horizontal(const Cell& n, const Scalars& s, int t,
                                              int side) {
  Cell b;
  float gb[9];
  if (t == 2) {  // tangential (x) kept, normal (y) zeroed
    feq_unit_x(n.ux, gb);
    b.ux = n.ux;
    b.uy = 0.0f;
  } else {
    const float vx = s.bcv[2 * side] * s.ramp;
    const float vy = s.bcv[2 * side + 1] * s.ramp;
    feq_unit(vx, vy, gb);
    b.ux = vx;
    b.uy = vy;
  }
  nebb(n, gb, &b);
  b.rho = n.rho;
  return b;
}

// The four sides' BC types, in solver.bc_type order.
struct BcTypes {
  int left, top, right, bottom;
};

// Whether apply_bc has a rule for a side's BC type: the types above, for
// which solver.bc_left_values, bc_right_values and bc_horizontal_values
// return values. Any other type (left 1, right 3/4, top/bottom 1/3/4) is a
// no-op: apply_bc leaves the side's cells as the previous step left them,
// and only the obstacle pass acts on them.
__host__ __device__ constexpr bool bc_left_active(int t) {
  return t == 0 || t == 2 || t == LBM_BC_VEL_INLET || t == LBM_BC_VEL_INLET_NEBB;
}
__host__ __device__ constexpr bool bc_right_active(int t) { return t == 0 || t == 1 || t == 2; }
__host__ __device__ constexpr bool bc_horizontal_active(int t) { return t == 0 || t == 2; }

// Which values a ring cell's BCs start from (lbm_ring_from):
//   LBM_RING_NEIGHBOUR  the collide output of its inward neighbour;
//   LBM_RING_OWN        its own previous values: its side is a no-op (a
//                       whole top or bottom row, corners included);
//   LBM_RING_SIDE       a corner of an active top or bottom row next to a
//                       no-op side: the previous values of the side cell one
//                       row in, as apply_bc left that side before the rows.
enum { LBM_RING_NEIGHBOUR = 0, LBM_RING_OWN = 1, LBM_RING_SIDE = 2 };

// The source of ring cell (``column``, ``far``, global column ``gx``) of
// lbm_ring_values, from the sides' types.
__device__ __forceinline__ int lbm_ring_from(bool column, bool far, int gx, int Wg,
                                             const BcTypes& bc) {
  if (column)
    return (far ? bc_right_active(bc.right) : bc_left_active(bc.left)) ? LBM_RING_NEIGHBOUR
                                                                        : LBM_RING_OWN;
  if (!bc_horizontal_active(far ? bc.top : bc.bottom)) return LBM_RING_OWN;
  if ((gx == 0 && !bc_left_active(bc.left)) || (gx == Wg - 1 && !bc_right_active(bc.right)))
    return LBM_RING_SIDE;
  return LBM_RING_NEIGHBOUR;
}

// Stores ring cell ``c`` from its BC values ``b``, as solver.apply_bc's
// obstacle pass leaves it: f in S's format, w rho on a solid cell unless
// under full-way bounce-back (which keeps the BC values); with FULL, rho
// and u (zero on solids).
template <typename S, int OBST, bool FULL>
__device__ __forceinline__ void lbm_store_ring(typename S::T* f, const float* aux,
                                               float* rho_out, float* u_out, size_t plane,
                                               size_t c, const Cell& b) {
  const bool solid = __float_as_int(aux[c]) < 0;
  const bool overwrite = solid && OBST != LBM_OBST_BOUNCE;
  for (int k = 0; k < 9; ++k)
    S::store(f, k * plane + c, k, overwrite ? lbm_w(k) * b.rho : b.f[k]);
  if (FULL) {
    rho_out[c] = b.rho;
    u_out[c] = solid ? 0.0f : b.ux;
    u_out[plane + c] = solid ? 0.0f : b.uy;
  }
}

// The BC values of one ring cell from ``n``, the collide output of its
// inward neighbour before the obstacle overwrite (what solver.apply_bc
// reads), in apply_bc's order: a side column cell (``column``) takes
// bc_left or bc_right (``far``: the right one); a bottom or top row cell
// (``far``: the top one) takes bc_horizontal of its neighbour in row 1 /
// H-2, except at the corners (global column ``gx`` 0 or ``Wg`` - 1), where
// that neighbour is a side cell and its side BC comes first, as apply_bc
// reads the side column it has just written. ``u_prof`` is the neighbour
// row's inlet profile (left types 3/4). ``from`` (lbm_ring_from) says what
// ``n`` holds instead where a side is a no-op: the cell's own previous
// values, returned as they are (LBM_RING_OWN), or the previous values of
// the side cell a corner reads, which take no side BC (LBM_RING_SIDE).
__device__ __forceinline__ Cell lbm_ring_values(const Cell& n, bool column, bool far, int gx,
                                                int Wg, const Scalars& s, const BcTypes& bc,
                                                float u_prof, int from = LBM_RING_NEIGHBOUR) {
  if (from == LBM_RING_OWN) return n;
  if (column) return far ? bc_right(n, s, bc.right) : bc_left(n, s, bc.left, u_prof);
  Cell m;
  if (from == LBM_RING_SIDE)
    m = n;
  else if (gx == 0)
    m = bc_left(n, s, bc.left, u_prof);
  else if (gx == Wg - 1)
    m = bc_right(n, s, bc.right);
  else
    m = n;
  return far ? bc_horizontal(m, s, bc.top, 1) : bc_horizontal(m, s, bc.bottom, 3);
}
