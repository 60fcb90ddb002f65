// Per-cell D2Q9 MRT-LES arithmetic and the f storage formats shared by the
// step kernel (K1) and the temporal-blocking kernel (K3).
//
// Every expression keeps the evaluation order of the plain PyTorch step
// (lbm2d_tpu_torch/core/solver.py and core/lattice.py), term by term, and
// the kernels are built with -fmad=false: with no contraction to FMA each
// operation rounds exactly as the plain version's does, so data-dependent
// branches (the outlet backflow guard, the rho > 0 guard) take the same side
// on both paths.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>

// The per-step scalar row, in the order of ops/cuda_step.py SCALAR_FIELDS
// (the JAX package's (1, 14) SMEM row): tau0, cs_factor, s_ghost, ramp,
// rho_in, rho_out, bc_value[4][2] flattened.
struct Scalars {
  float tau0, cs_factor, s_ghost, ramp, rho_in, rho_out;
  float bcv[8];
};

static inline Scalars load_scalars(const float* row) {
  Scalars s;
  s.tau0 = row[0];
  s.cs_factor = row[1];
  s.s_ghost = row[2];
  s.ramp = row[3];
  s.rho_in = row[4];
  s.rho_out = row[5];
  for (int i = 0; i < 8; ++i) s.bcv[i] = row[6 + i];
  return s;
}

// Where K1 finds a block of the lattice (ops/cuda_step.py
// BlockGeom). Local cell (i, j), i in [0, hl), j in [0, wl), is element
// (i + halo) * pitch + (j + halo) of each [hl + 2 halo, pitch] plane and is
// cell (y_off + i, x_off + j) of the Hg x Wg grid. The single-device step
// is the whole grid with no halo (hl = Hg, wl = Wg = pitch); a shard of a
// spatial mesh keeps a 1-cell halo ring of its neighbours' cells
// (halo = 1), and its columns past wl + 1 are padding, never read.
struct BlockGeom {
  int hl, wl, pitch, halo;
  int y_off, x_off, Hg, Wg;
};

// A launch's block from the host row (hl, wl, pitch, halo, y_off, x_off,
// Hg, Wg) of ops/cuda_step.BlockGeom; halo 0 is the whole grid.
static inline BlockGeom load_geom(const int* g) {
  return BlockGeom{g[0], g[1], g[2], g[3], g[4], g[5], g[6], g[7]};
}

// The geometry a kernel indexes with: a shard's as given; the whole
// grid's rebuilt from its extent, so that the compiler folds the halo, the
// origin and the pitch into the single-device kernels' indexing.
template <bool SHARD>
__device__ __forceinline__ BlockGeom fold_geom(const BlockGeom& g) {
  return SHARD ? g : BlockGeom{g.hl, g.wl, g.wl, 0, 0, 0, g.hl, g.wl};
}

__host__ __device__ __forceinline__ size_t geom_plane(const BlockGeom& g) {
  return (size_t)(g.hl + 2 * g.halo) * g.pitch;
}

__host__ __device__ __forceinline__ size_t geom_at(const BlockGeom& g, int i,
                                                   int j) {
  return (size_t)(i + g.halo) * g.pitch + (j + g.halo);
}

// Lattice weights, rounded once from the f64 values (W in core/lattice.py).
#define LBM_W0 ((float)(4.0 / 9.0))
#define LBM_W1 ((float)(1.0 / 9.0))
#define LBM_W5 ((float)(1.0 / 36.0))

__device__ __forceinline__ float lbm_w(int k) {
  return k == 0 ? LBM_W0 : (k < 5 ? LBM_W1 : LBM_W5);
}

// How f is kept in device memory. F32Store: the populations themselves.
// DevStore (16-bit deviation storage, the JAX package's store_dev): bf16
// f_k - w_k, dequantized on load as float(dev) + w_k and quantized on store
// as bf16_rn(f_k - w_k) -- the order of ops/cuda_step.py quantize /
// dequantize, so a kernel and its plain version round alike. All arithmetic
// between load and store stays f32.
struct F32Store {
  typedef float T;
  static __device__ __forceinline__ float load(const float* p, size_t i, int) {
    return p[i];
  }
  static __device__ __forceinline__ void store(float* p, size_t i, int,
                                               float v) {
    p[i] = v;
  }
};

struct DevStore {
  typedef __nv_bfloat16 T;
  static __device__ __forceinline__ float load(const __nv_bfloat16* p,
                                               size_t i, int k) {
    return __bfloat162float(p[i]) + lbm_w(k);
  }
  static __device__ __forceinline__ void store(__nv_bfloat16* p, size_t i,
                                               int k, float v) {
    p[i] = __float2bfloat16_rn(v - lbm_w(k));
  }
};

// Velocity set (core/lattice.py E): 0 rest, 1 E, 2 N, 3 W, 4 S, 5 NE, 6 NW,
// 7 SW, 8 SE; LBM_OPP[k] is the direction with e = -e_k (lattice.OPP).
__device__ __constant__ int LBM_EX[9] = {0, 1, 0, -1, 0, 1, -1, -1, 1};
__device__ __constant__ int LBM_EY[9] = {0, 0, 1, 0, -1, 1, 1, -1, -1};
__device__ __constant__ int LBM_OPP[9] = {0, 3, 4, 1, 2, 7, 8, 5, 6};

// Obstacle schemes (ops/cuda_step.py OBSTACLE_*): the equilibrium overwrite
// f = w rho, full-way bounce-back, half-way bounce-back and Bouzidi
// interpolated bounce-back.
#define LBM_OBST_EQ 0
#define LBM_OBST_BOUNCE 1
#define LBM_OBST_HALFWAY 2
#define LBM_OBST_BOUZIDI 3

// Left-BC types of the profiled velocity inlets (solver.BC_VEL_INLET*).
#define LBM_BC_VEL_INLET 3
#define LBM_BC_VEL_INLET_NEBB 4

// MRT-LES collision of the streamed populations fs (solver.mrt_collide_arrays).
__device__ __forceinline__ void mrt_collide(const float fs[9], float damp,
                                            const Scalars& s, int use_les,
                                            float fp[9], float* rho_o,
                                            float* ux_o, float* uy_o) {
  const float f0 = fs[0], f1 = fs[1], f2 = fs[2], f3 = fs[3], f4 = fs[4];
  const float f5 = fs[5], f6 = fs[6], f7 = fs[7], f8 = fs[8];
  const float s13 = f1 + f3;
  const float s24 = f2 + f4;
  const float d13 = f1 - f3;
  const float d24 = f2 - f4;
  const float s56 = f5 + f6;
  const float s78 = f7 + f8;
  const float d56 = f5 - f6;
  const float d78 = f7 - f8;
  const float s1324 = s13 + s24;
  const float s5678 = s56 + s78;
  const float rho = (f0 + s1324) + s5678;
  const float m1 = (2.0f * s5678 - s1324) - 4.0f * f0;
  const float m2 = (4.0f * f0 - 2.0f * s1324) + s5678;
  const float a_d = d56 - d78;
  const float b_s = s56 - s78;
  const float m3 = d13 + a_d;
  const float m4 = a_d - 2.0f * d13;
  const float m5 = d24 + b_s;
  const float m6 = b_s - 2.0f * d24;
  const float m7 = s13 - s24;
  const float m8 = d56 + d78;

  const float inv_rho = rho > 0.0f ? 1.0f / rho : 0.0f;
  const float ux = m3 * inv_rho;
  const float uy = m5 * inv_rho;

  const float uxx = ux * ux;
  const float uyy = uy * uy;
  const float u2 = uxx + uyy;
  const float rux = rho * ux;
  const float ruy = rho * uy;
  const float d1 = m1 - rho * (-2.0f + 3.0f * u2);
  const float d2 = m2 - rho * (1.0f - 3.0f * u2);
  const float d4 = m4 + rux;
  const float d6 = m6 + ruy;
  const float d7 = m7 - rho * (uxx - uyy);
  const float d8 = m8 - rux * uy;

  float tau_eff;
  if (use_les) {
    const float neq_norm = sqrtf((2.0f * d7) * d7 + (2.0f * d8) * d8);
    const float term = s.tau0 * s.tau0 + (s.cs_factor * neq_norm) * inv_rho;
    tau_eff = s.tau0 + 0.5f * (sqrtf(term) - s.tau0);
  } else {
    tau_eff = s.tau0;
  }
  tau_eff = tau_eff + damp;
  const float s_eff = 1.0f / tau_eff;

  const float sd1 = s.s_ghost * d1;
  const float sd2 = s.s_ghost * d2;
  const float sd4 = s.s_ghost * d4;
  const float sd6 = s.s_ghost * d6;
  const float sd7 = s_eff * d7;
  const float sd8 = s_eff * d8;

  const float t0 = (sd2 - sd1) * (float)(4.0 / 36.0);
  const float ta = -(sd1 + 2.0f * sd2) * (float)(1.0 / 36.0);
  const float td = (2.0f * sd1 + sd2) * (float)(1.0 / 36.0);
  const float u4 = sd4 * (float)(6.0 / 36.0);
  const float u6 = sd6 * (float)(6.0 / 36.0);
  const float u7 = sd7 * (float)(9.0 / 36.0);
  const float u8 = sd8 * (float)(9.0 / 36.0);
  const float v4 = sd4 * (float)(3.0 / 36.0);
  const float v6 = sd6 * (float)(3.0 / 36.0);

  fp[0] = f0 - t0;
  fp[1] = f1 - ((ta - u4) + u7);
  fp[2] = f2 - ((ta - u6) - u7);
  fp[3] = f3 - ((ta + u4) + u7);
  fp[4] = f4 - ((ta + u6) - u7);
  fp[5] = f5 - (((td + v4) + v6) + u8);
  fp[6] = f6 - (((td - v4) + v6) - u8);
  fp[7] = f7 - (((td - v4) - v6) + u8);
  fp[8] = f8 - (((td + v4) - v6) - u8);
  *rho_o = rho;
  *ux_o = ux;
  *uy_o = uy;
}

// ((1 + 3 eu) + 4.5 eu eu) - 1.5 usq (lattice._inner).
__device__ __forceinline__ float feq_inner(float eu, float usq) {
  return ((1.0f + 3.0f * eu) + (4.5f * eu) * eu) - 1.5f * usq;
}

// g_k(ux, uy) = f_eq / rho (lattice.f_eq_unit).
__device__ __forceinline__ void feq_unit(float ux, float uy, float g[9]) {
  const float usq = ux * ux + uy * uy;
  g[0] = LBM_W0 * (1.0f - 1.5f * usq);
  g[1] = LBM_W1 * feq_inner(ux, usq);
  g[2] = LBM_W1 * feq_inner(uy, usq);
  g[3] = LBM_W1 * feq_inner(-ux, usq);
  g[4] = LBM_W1 * feq_inner(-uy, usq);
  g[5] = LBM_W5 * feq_inner(ux + uy, usq);
  g[6] = LBM_W5 * feq_inner(-ux + uy, usq);
  g[7] = LBM_W5 * feq_inner(-ux + -uy, usq);
  g[8] = LBM_W5 * feq_inner(ux + -uy, usq);
}

// g_k along one axis with the other velocity 0 (lattice.f_eq_unit_x/_y):
// by_e[0] for e = 0, by_e[1] for e = +1, by_e[2] for e = -1.
__device__ __forceinline__ void feq_axis(float v, float by_e[3]) {
  const float usq = v * v;
  by_e[0] = 1.0f - 1.5f * usq;
  by_e[1] = feq_inner(v, usq);
  by_e[2] = feq_inner(-v, usq);
}

__device__ __forceinline__ void feq_unit_x(float ux, float g[9]) {
  float b[3];
  feq_axis(ux, b);
  for (int k = 0; k < 9; ++k) {
    const int ex = LBM_EX[k];
    g[k] = lbm_w(k) * (ex == 0 ? b[0] : (ex > 0 ? b[1] : b[2]));
  }
}

__device__ __forceinline__ void feq_unit_y(float uy, float g[9]) {
  float b[3];
  feq_axis(uy, b);
  for (int k = 0; k < 9; ++k) {
    const int ey = LBM_EY[k];
    g[k] = lbm_w(k) * (ey == 0 ? b[0] : (ey > 0 ? b[1] : b[2]));
  }
}

// The profiled velocity inlets of the left edge (solver.bc_left_values,
// types 3 and 4) for one row: ``u_prof`` is that row of the case's
// inlet_profile, (fn, rho_nb, uxn, uyn) the neighbour cell's collide
// output. ux = u_prof ramp, uy = 0, and
//   type 3: rho = 1, f = f_eq(1, ux, 0);
//   type 4 (NEBB): rho = rho_nb, f = rho_nb (f_eq_x(ux) - f_eq(u_nb)) + f_nb.
__device__ __forceinline__ void bc_vel_inlet(int t, float u_prof, float ramp,
                                             const float fn[9], float rho_nb,
                                             float uxn, float uyn, float fb[9],
                                             float* rho_b, float* ux_b,
                                             float* uy_b) {
  const float ux = u_prof * ramp;
  feq_unit_x(ux, fb);
  if (t == LBM_BC_VEL_INLET_NEBB) {
    float g[9];
    feq_unit(uxn, uyn, g);
    for (int k = 0; k < 9; ++k) fb[k] = rho_nb * (fb[k] - g[k]) + fn[k];
    *rho_b = rho_nb;
  } else {
    *rho_b = 1.0f;
  }
  *ux_b = ux;
  *uy_b = 0.0f;
}
