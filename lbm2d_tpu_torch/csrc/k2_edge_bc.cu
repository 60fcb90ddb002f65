// K2: the boundary ring of one step, rebuilt after K1.
//
// Replaces the TPU kernel _edge_bc_kernel (lbm2d_tpu/ops/pallas_step.py:1379,
// launched by _edge_bc_step :1673). One thread per ring cell writes, in the
// reference apply_bc order: the left/right columns on the inner rows, the
// bottom/top rows including the corners, then the obstacle overwrite
// f = w rho (and u = 0) on solid ring cells. Types: left 0 (Zou-He
// pressure inlet) or 2 (free-slip); right 0 (velocity inlet), 1 (Zou-He
// pressure outlet with the backflow guard) or 2; top/bottom 0 or 2.
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
#include "lbm_common.cuh"

struct Cell {
  float f[9];
  float rho, ux, uy;
};

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

// fb = rho_nb (g_b - g(u_nb)) + f_nb, the non-equilibrium extrapolation
// shared by free-slip and the non-west velocity inlets.
__device__ __forceinline__ void nebb(const Cell& n, const float gb[9],
                                     Cell* b) {
  float g[9];
  feq_unit(n.ux, n.uy, g);
  for (int k = 0; k < 9; ++k) b->f[k] = n.rho * (gb[k] - g[k]) + n.f[k];
}

// solver.bc_left_values for types 0 (pressure inlet) and 2 (free-slip).
__device__ __forceinline__ Cell bc_left(const Cell& n, const Scalars& s,
                                        int t) {
  Cell b;
  if (t == 0) {
    const float* fn = n.f;
    const float rho_c = 1.0f + (s.rho_in - 1.0f) * s.ramp;
    const float ux =
        1.0f - (((fn[0] + fn[2]) + fn[4]) + 2.0f * ((fn[3] + fn[6]) + fn[7])) /
                   rho_c;
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
__device__ __forceinline__ Cell bc_right(const Cell& n, const Scalars& s,
                                         int t) {
  Cell b;
  if (t == 1) {
    const float* fn = n.f;
    const float rho_o = s.rho_out;
    const float ux =
        -1.0f + (((fn[0] + fn[2]) + fn[4]) + 2.0f * ((fn[1] + fn[5]) + fn[8])) /
                    rho_o;
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
__device__ __forceinline__ Cell bc_horizontal(const Cell& n, const Scalars& s,
                                              int t, int side) {
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

template <typename S>
__global__ void __launch_bounds__(256)
k2_edge_bc_kernel(typename S::T* __restrict__ f, const float* __restrict__ aux,
                  const float* __restrict__ edge, float* __restrict__ rho_out,
                  float* __restrict__ u_out, const Scalars s, const int H,
                  const int W, const int bc_left_t, const int bc_top_t,
                  const int bc_right_t, const int bc_bottom_t,
                  const int full) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  const int n_in = H - 2;
  int x, y;
  Cell b;
  if (t < n_in) {
    y = t + 1;
    x = 0;
    b = bc_left(load_col(edge, 0, y, H), s, bc_left_t);
  } else if (t < 2 * n_in) {
    y = t - n_in + 1;
    x = W - 1;
    b = bc_right(load_col(edge, 1, y, H), s, bc_right_t);
  } else if (t < 2 * n_in + 2 * W) {
    const int r = t - 2 * n_in;
    const bool top = r >= W;
    x = top ? r - W : r;
    y = top ? H - 1 : 0;
    const int nb_y = top ? H - 2 : 1;
    // the inward neighbour: a ring cell of the side BC at the corners
    Cell n;
    if (x == 0)
      n = bc_left(load_col(edge, 0, nb_y, H), s, bc_left_t);
    else if (x == W - 1)
      n = bc_right(load_col(edge, 1, nb_y, H), s, bc_right_t);
    else
      n = load_row(edge, top ? 1 : 0, x, H, W);
    b = top ? bc_horizontal(n, s, bc_top_t, 1)
            : bc_horizontal(n, s, bc_bottom_t, 3);
  } else {
    return;
  }

  const size_t plane = (size_t)H * W;
  const size_t c = (size_t)y * W + x;
  const bool solid = __float_as_int(aux[c]) < 0;
  for (int k = 0; k < 9; ++k)
    S::store(f, k * plane + c, k, solid ? lbm_w(k) * b.rho : b.f[k]);
  if (full) {
    rho_out[c] = b.rho;
    u_out[c] = solid ? 0.0f : b.ux;
    u_out[plane + c] = solid ? 0.0f : b.uy;
  }
}

// Launches K2 on ``stream``; returns cudaGetLastError() as an int.
// rho/u are written only when full.
extern "C" int k2_edge_bc_launch(void* f, const void* aux, const void* edge,
                                 void* rho, void* u, const void* scal, int H,
                                 int W, int bc_left_t, int bc_top_t,
                                 int bc_right_t, int bc_bottom_t, int full,
                                 void* stream) {
  const Scalars s = load_scalars(static_cast<const float*>(scal));
  const int n = 2 * (H - 2) + 2 * W;
  k2_edge_bc_kernel<F32Store><<<(n + 255) / 256, 256, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<float*>(f), static_cast<const float*>(aux),
      static_cast<const float*>(edge), static_cast<float*>(rho),
      static_cast<float*>(u), s, H, W, bc_left_t, bc_top_t, bc_right_t,
      bc_bottom_t, full);
  return static_cast<int>(cudaGetLastError());
}

// The ring in 16-bit deviation storage: ``f`` is the bf16 [9, H, W] buffer
// of f - w that k1_step_dev wrote; no rho/u (never the full variant).
extern "C" int k2_edge_bc_dev_launch(void* f, const void* aux,
                                     const void* edge, const void* scal,
                                     int H, int W, int bc_left_t,
                                     int bc_top_t, int bc_right_t,
                                     int bc_bottom_t, void* stream) {
  const Scalars s = load_scalars(static_cast<const float*>(scal));
  const int n = 2 * (H - 2) + 2 * W;
  k2_edge_bc_kernel<DevStore><<<(n + 255) / 256, 256, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<__nv_bfloat16*>(f), static_cast<const float*>(aux),
      static_cast<const float*>(edge), nullptr, nullptr, s, H, W, bc_left_t,
      bc_top_t, bc_right_t, bc_bottom_t, 0);
  return static_cast<int>(cudaGetLastError());
}
