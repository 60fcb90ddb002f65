// K3: temporal blocking, S <= 8 full lattice updates per pass over device
// memory.
//
// Replaces the TPU kernel _fused_kernel (lbm2d_tpu/ops/pallas_step.py:610,
// launched by _pallas_fused_steps :760, BCs in _fused_apply_bc :495). Each
// block owns one 2-D tile of TH x TW centre cells. It loads the window of
// the tile plus S halo cells on every side (clipped to the grid) into
// shared memory, advances it S lattice steps there, and stores the centre.
// Every sub-step is one K1 step: the interior update of lbm_cell.cuh
// (pull, link rule, MRT-LES collision, obstacle rule) and the boundary
// ring in solver.apply_bc order, so the stored centre equals S calls of K1
// bitwise.
//
// Trapezoid: sub-step s updates the window region R_s, the window shrunk
// by s + 1 cells per side and clipped to the grid. Its interior cells pull
// from R_{s-1} (R_{-1} is the loaded window), so after S sub-steps the
// centre is valid. A ring cell of the grid is updated in every window whose
// R_s holds it, halo or centre: each copy must stay valid (the 2-D form of
// the TPU kernel's owner_top). Its BC reads the collide output of its
// inward neighbour, which lies in R_s too as long as no tile starts on the
// last row or column: the wrapper shifts the last tile of each axis back to
// end on the grid's edge (y0 = min(ty TH, H - TH)), and the block stores
// only its unshifted share of the centre, so no cell is written twice.
//
// Order inside one sub-step, with a block barrier between phases:
//   1. interior cells of R_s: update, store into the other buffer, and keep
//      the collide output (pre-overwrite f_post, rho, ux, uy) of columns 1
//      and W-2 and rows 1 and H-2 in small shared strips: the BCs read the
//      collision's macros, never macros recomputed from f;
//   2. the left/right ring cells on inner rows, from the column strips; the
//      BC values of rows 1 and H-2 go into the row strips' end slots;
//   3. the bottom/top ring rows, corners included, from the row strips
//      (the corner neighbours as phase 2 left them).
// Ring cells take the obstacle overwrite f = w rho on solids (not under
// full-way bounce-back). The velocity inlets (left types 3/4) read the
// case's inlet_profile tensor, as K1 does. Global memory is read only
// inside [0, H) x [0, W): window cells outside the grid are never loaded
// nor read.
//
// Bound on an H100: device-memory bytes per cell-step drop from K1's 76 B
// to (window cells x 40 B read + centre cells x 36 B written) / (centre
// cells x S): 23.1 B at the default 32 x 64 centre with S = 4. The
// redundant halo work raises the f32 operations to 120 x (mean region /
// centre) per cell-step, and every sub-step moves ~72 B per cell through
// shared memory. Simple first design: two f32 window buffers (ping-pong, a
// sub-step reads one and writes the other, so no barrier is needed between
// the pull and the store), one block per SM at the default tile (the
// buffers fill ~224 KB), plain loads and stores, no TMA, wgmma or clusters.
#include "lbm_cell.cuh"

#define K3_THREADS 512
#define K3_MAX_STEPS 8

// One scalar row per sub-step, passed by value in the launch parameters.
struct ScalarRows {
  Scalars s[K3_MAX_STEPS];
};

// Shared floats of one window: two f buffers, aux, and the strips (12
// values per cell: f_post[0..8], rho, ux, uy), two columns and two rows.
static inline size_t k3_smem_floats(int WH, int WW) {
  const size_t wn = (size_t)WH * WW;
  return 19 * wn + 2 * LBM_EDGE_C * (size_t)(WH + WW);
}

__device__ __forceinline__ void put_cell(float* strip, int n, int i, const float fp[9],
                                         float rho, float ux, float uy) {
  for (int k = 0; k < 9; ++k) strip[k * n + i] = fp[k];
  strip[9 * n + i] = rho;
  strip[10 * n + i] = ux;
  strip[11 * n + i] = uy;
}

__device__ __forceinline__ Cell get_cell(const float* strip, int n, int i) {
  Cell c;
  for (int k = 0; k < 9; ++k) c.f[k] = strip[k * n + i];
  c.rho = strip[9 * n + i];
  c.ux = strip[10 * n + i];
  c.uy = strip[11 * n + i];
  return c;
}

template <int OBST>
__device__ __forceinline__ void store_ring(float* nxt, int wn, int i, const Cell& b,
                                           bool solid) {
  for (int k = 0; k < 9; ++k) nxt[k * wn + i] = lbm_stored<OBST>(k, b.f, b.rho, solid);
}

template <int OBST>
__global__ void __launch_bounds__(K3_THREADS)
k3_fused_kernel(const float* __restrict__ f_in, float* __restrict__ f_out,
                const float* __restrict__ aux, const float* __restrict__ prof,
                const ScalarRows rows, const int S, const int H, const int W,
                const int TH, const int TW, const int bc_left_t, const int bc_top_t,
                const int bc_right_t, const int bc_bottom_t, const int use_les) {
  extern __shared__ float smem[];
  const int WH = TH + 2 * S, WW = TW + 2 * S, WN = WH * WW;
  float* cur = smem;
  float* nxt = cur + 9 * WN;
  float* saux = nxt + 9 * WN;
  float* cols = saux + WN;                  // [2][12][WH]: x = 1, x = W-2
  float* rws = cols + 2 * LBM_EDGE_C * WH;  // [2][12][WW]: y = 1, y = H-2
  const bool vel = bc_left_t == LBM_BC_VEL_INLET || bc_left_t == LBM_BC_VEL_INLET_NEBB;

  // the tile: its unshifted centre origin, and the window origin of the
  // (possibly shifted) centre
  const int yn = blockIdx.y * TH, xn = blockIdx.x * TW;
  const int wy0 = min(yn, max(H - TH, 0)) - S;
  const int wx0 = min(xn, max(W - TW, 0)) - S;
  const size_t plane = (size_t)H * W;

  for (int i = threadIdx.x; i < WN; i += blockDim.x) {
    const int gy = wy0 + i / WW, gx = wx0 + i % WW;
    if (gy < 0 || gy >= H || gx < 0 || gx >= W) continue;
    const size_t g = (size_t)gy * W + gx;
    for (int k = 0; k < 9; ++k) cur[k * WN + i] = f_in[k * plane + g];
    saux[i] = aux[g];
  }
  __syncthreads();

  // window coordinates of the grid's ring and of the strips
  const int wy_bot = -wy0, wy_top = H - 1 - wy0;
  const int wx_left = -wx0, wx_right = W - 1 - wx0;

  for (int s = 0; s < S; ++s) {
    const Scalars& sc = rows.s[s];
    // R_s in window coordinates, clipped to the grid: [ylo, yhi) x [xlo, xhi)
    const int ylo = max(s + 1, wy_bot), yhi = min(WH - s - 1, wy_top + 1);
    const int xlo = max(s + 1, wx_left), xhi = min(WW - s - 1, wx_right + 1);
    const int rw = xhi - xlo;
    const int rn = (yhi > ylo && rw > 0) ? (yhi - ylo) * rw : 0;

    // 1. interior cells
    for (int t = threadIdx.x; t < rn; t += blockDim.x) {
      const int wy = ylo + t / rw, wx = xlo + t % rw;
      if (wy == wy_bot || wy == wy_top || wx == wx_left || wx == wx_right) continue;
      const int i = wy * WW + wx;
      auto f_at = [&](int k, int dy, int dx) { return cur[k * WN + i + dy * WW + dx]; };
      auto solid_at = [&](int dy, int dx) {
        return __float_as_int(saux[i + dy * WW + dx]) < 0;
      };
      auto q_at = [](int) { return 0.5f; };  // no Bouzidi in K3
      const float a = saux[i];
      const bool solid = __float_as_int(a) < 0;
      float fp[9], rho, ux, uy;
      lbm_cell_update<OBST>(f_at, solid_at, q_at, fabsf(a), solid, sc, use_les, fp, &rho,
                            &ux, &uy);
      for (int k = 0; k < 9; ++k) nxt[k * WN + i] = lbm_stored<OBST>(k, fp, rho, solid);
      if (wx == wx_left + 1) put_cell(cols, WH, wy, fp, rho, ux, uy);
      if (wx == wx_right - 1) put_cell(cols + LBM_EDGE_C * WH, WH, wy, fp, rho, ux, uy);
      if (wy == wy_bot + 1) put_cell(rws, WW, wx, fp, rho, ux, uy);
      if (wy == wy_top - 1) put_cell(rws + LBM_EDGE_C * WW, WW, wx, fp, rho, ux, uy);
    }
    __syncthreads();

    // 2. left and right columns on the inner rows of R_s
    const int iylo = max(ylo, wy_bot + 1), iyhi = min(yhi, wy_top);
    const int n_in = max(iyhi - iylo, 0);
    const bool has_l = xlo <= wx_left && wx_left < xhi;
    const bool has_r = xlo <= wx_right && wx_right < xhi;
    for (int t = threadIdx.x; t < 2 * n_in; t += blockDim.x) {
      const bool right = t >= n_in;
      if (right ? !has_r : !has_l) continue;
      const int wy = iylo + (right ? t - n_in : t);
      const int wx = right ? wx_right : wx_left;
      const Cell n = get_cell(cols + (right ? LBM_EDGE_C * WH : 0), WH, wy);
      const Cell b = right ? bc_right(n, sc, bc_right_t)
                           : bc_left(n, sc, bc_left_t, vel ? prof[wy0 + wy] : 0.0f);
      const int i = wy * WW + wx;
      store_ring<OBST>(nxt, WN, i, b, __float_as_int(saux[i]) < 0);
      if (wy == wy_bot + 1) put_cell(rws, WW, wx, b.f, b.rho, b.ux, b.uy);
      if (wy == wy_top - 1) put_cell(rws + LBM_EDGE_C * WW, WW, wx, b.f, b.rho, b.ux, b.uy);
    }
    __syncthreads();

    // 3. bottom and top rows of R_s, corners included
    const bool has_b = ylo <= wy_bot && wy_bot < yhi;
    const bool has_t = ylo <= wy_top && wy_top < yhi;
    for (int t = threadIdx.x; t < 2 * rw; t += blockDim.x) {
      const bool top = t >= rw;
      if (top ? !has_t : !has_b) continue;
      const int wx = xlo + (top ? t - rw : t);
      const int wy = top ? wy_top : wy_bot;
      const Cell n = get_cell(rws + (top ? LBM_EDGE_C * WW : 0), WW, wx);
      const Cell b = top ? bc_horizontal(n, sc, bc_top_t, 1)
                         : bc_horizontal(n, sc, bc_bottom_t, 3);
      const int i = wy * WW + wx;
      store_ring<OBST>(nxt, WN, i, b, __float_as_int(saux[i]) < 0);
    }
    __syncthreads();
    float* tmp = cur;
    cur = nxt;
    nxt = tmp;
  }

  // the unshifted share of the centre
  const int ny = min(TH, H - yn), nx = min(TW, W - xn);
  const int oy = yn - wy0, ox = xn - wx0;
  for (int t = threadIdx.x; t < ny * nx; t += blockDim.x) {
    const int cy = t / nx, cx = t % nx;
    const int i = (oy + cy) * WW + ox + cx;
    const size_t g = (size_t)(yn + cy) * W + xn + cx;
    for (int k = 0; k < 9; ++k) f_out[k * plane + g] = cur[k * WN + i];
  }
}

template <int OBST>
static int launch(const void* f_in, void* f_out, const void* aux, const void* prof,
                  const ScalarRows& rows, int S, int H, int W, int TH, int TW,
                  int bc_l, int bc_t, int bc_r, int bc_b, int use_les,
                  cudaStream_t stream) {
  const int smem = (int)(k3_smem_floats(TH + 2 * S, TW + 2 * S) * sizeof(float));
  // opt in above 48 KB once per size (not a stream operation: allowed
  // while a CUDA graph captures the launch)
  static int opted = 0;
  if (smem > opted) {
    const cudaError_t err = cudaFuncSetAttribute(
        k3_fused_kernel<OBST>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (err != cudaSuccess) return static_cast<int>(err);
    opted = smem;
  }
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, 1);
  k3_fused_kernel<OBST><<<grid, K3_THREADS, smem, stream>>>(
      static_cast<const float*>(f_in), static_cast<float*>(f_out),
      static_cast<const float*>(aux), static_cast<const float*>(prof), rows, S, H, W, TH,
      TW, bc_l, bc_t, bc_r, bc_b, use_les);
  return static_cast<int>(cudaGetLastError());
}

// Launches K3 on ``stream``: S sub-steps of f_in -> f_out (distinct f32
// [9, H, W] buffers; every cell of f_out is written). ``scal`` is a host
// pointer to S scalar rows of 14 floats, copied into the launch
// parameters. ``obst`` is LBM_OBST_EQ, _BOUNCE or _HALFWAY; ``prof`` ([H]
// f32) is read only for left types 3/4. Returns the CUDA error code, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int k3_fused_launch(const void* f_in, void* f_out, const void* aux,
                               const void* prof, const void* scal, int S, int H, int W,
                               int TH, int TW, int bc_left_t, int bc_top_t,
                               int bc_right_t, int bc_bottom_t, int use_les, int obst,
                               void* stream) {
  if (S < 1 || S > K3_MAX_STEPS || TH < 2 || TW < 2 || H < 3 || W < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  ScalarRows rows;
  for (int s = 0; s < S; ++s) rows.s[s] = load_scalars(static_cast<const float*>(scal) + 14 * s);
  for (int s = S; s < K3_MAX_STEPS; ++s) rows.s[s] = rows.s[0];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (obst) {
    case LBM_OBST_EQ:
      return launch<LBM_OBST_EQ>(f_in, f_out, aux, prof, rows, S, H, W, TH, TW, bc_left_t,
                                 bc_top_t, bc_right_t, bc_bottom_t, use_les, st);
    case LBM_OBST_BOUNCE:
      return launch<LBM_OBST_BOUNCE>(f_in, f_out, aux, prof, rows, S, H, W, TH, TW,
                                     bc_left_t, bc_top_t, bc_right_t, bc_bottom_t, use_les,
                                     st);
    case LBM_OBST_HALFWAY:
      return launch<LBM_OBST_HALFWAY>(f_in, f_out, aux, prof, rows, S, H, W, TH, TW,
                                      bc_left_t, bc_top_t, bc_right_t, bc_bottom_t,
                                      use_les, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
