// K1: one D2Q9 MRT-LES lattice update of the interior cells.
//
// Replaces the TPU kernel _step_kernel (lbm2d_tpu/ops/pallas_step.py:824,
// launched by _pallas_step :1180) in its split-BC mode: pull streaming,
// butterfly MRT-LES collision with the sponge from the packed aux plane,
// the equilibrium overwrite f = w rho on solid cells, and the export of the
// edge strips that K2 (k2_edge_bc.cu) builds the boundary ring from. The
// full variant (full != 0) closes a chunk and also writes rho, u (zero on
// solids) and f_post on the interior.
//
// The fast variant also comes in 16-bit deviation storage (k1_step_dev,
// the JAX kernel's store_dev branch, :865-870 and _to_store :1114-1120):
// f_in and f_out hold bf16 f_k - w_k, each pulled population is
// dequantized as float(dev) + w_k, the collision runs in f32 exactly as in
// the f32 variant, and f is quantized once on the way out, after the
// obstacle overwrite. The edge export stays f32 (pre-overwrite f_post and
// rho/ux/uy): quantized macros would flip the BCs' data-dependent branches.
//
// Bound on an H100: memory. A fast step moves 76 B/cell (f 36 in + 36 out,
// aux 4) for ~200 flops, 40 B/cell in deviation storage (f 18 + 18, aux 4),
// far below the card's ~20 flop/B balance point, so
// the design aims only at full-width coalesced traffic: one thread per
// interior cell, neighbouring threads on neighbouring x, each population
// pulled straight from global memory (the 3-row reuse of the pull stencil
// is left to L1/L2). The TPU kernel's row padding, lane rolls, band
// heights and two-slot DMA pipeline are TPU schedules and have no
// counterpart here; the state is an unpadded [9, H, W] f32 tensor and the
// caller ping-pongs two buffers, since pull streaming cannot run in place.
//
// The edge export carries the pre-overwrite f_post as well as rho/ux/uy:
// the boundary conditions read the neighbour strip before the obstacle
// overwrite (solver.apply_bc), so K2 must not read K1's stored f there,
// and recomputing the macros from f would flip the backflow guard.
#include "lbm_common.cuh"

template <typename S>
__global__ void __launch_bounds__(256)
k1_step_kernel(const typename S::T* __restrict__ f_in,
               typename S::T* __restrict__ f_out,
               const float* __restrict__ aux, float* __restrict__ edge,
               float* __restrict__ rho_out, float* __restrict__ u_out,
               float* __restrict__ fpost_out, const Scalars s, const int H,
               const int W, const int use_les, const int full) {
  const int x = blockIdx.x * blockDim.x + threadIdx.x + 1;
  const int y = blockIdx.y + 1;
  if (x > W - 2 || y > H - 2) return;
  const size_t plane = (size_t)H * W;
  const size_t c = (size_t)y * W + x;

  // pull: f_k(y, x) <- f_k(y - ey_k, x - ex_k)
  float fs[9];
  fs[0] = S::load(f_in, c, 0);
  fs[1] = S::load(f_in, 1 * plane + c - 1, 1);
  fs[2] = S::load(f_in, 2 * plane + c - W, 2);
  fs[3] = S::load(f_in, 3 * plane + c + 1, 3);
  fs[4] = S::load(f_in, 4 * plane + c + W, 4);
  fs[5] = S::load(f_in, 5 * plane + c - W - 1, 5);
  fs[6] = S::load(f_in, 6 * plane + c - W + 1, 6);
  fs[7] = S::load(f_in, 7 * plane + c + W + 1, 7);
  fs[8] = S::load(f_in, 8 * plane + c + W - 1, 8);

  // aux packs the sponge damping with the solid flag in the sign bit
  const float a = aux[c];
  const bool solid = __float_as_int(a) < 0;
  const float damp = fabsf(a);

  float fp[9], rho, ux, uy;
  mrt_collide(fs, damp, s, use_les, fp, &rho, &ux, &uy);

  for (int k = 0; k < 9; ++k)
    S::store(f_out, k * plane + c, k, solid ? lbm_w(k) * rho : fp[k]);

  if (x == 1 || x == W - 2) {
    float* col = edge + (size_t)(x == 1 ? 0 : LBM_EDGE_C) * H;
    for (int k = 0; k < 9; ++k) col[(size_t)k * H + y] = fp[k];
    col[(size_t)9 * H + y] = rho;
    col[(size_t)10 * H + y] = ux;
    col[(size_t)11 * H + y] = uy;
  }
  if (y == 1 || y == H - 2) {
    float* row = edge + (size_t)2 * LBM_EDGE_C * H +
                 (size_t)(y == 1 ? 0 : LBM_EDGE_C) * W;
    for (int k = 0; k < 9; ++k) row[(size_t)k * W + x] = fp[k];
    row[(size_t)9 * W + x] = rho;
    row[(size_t)10 * W + x] = ux;
    row[(size_t)11 * W + x] = uy;
  }

  if (full) {
    rho_out[c] = rho;
    u_out[c] = solid ? 0.0f : ux;
    u_out[plane + c] = solid ? 0.0f : uy;
    for (int k = 0; k < 9; ++k) fpost_out[k * plane + c] = fp[k];
  }
}

// Launches K1 on ``stream``; returns cudaGetLastError() as an int.
// ``scal`` is a host pointer to the 14-float scalar row (copied into the
// kernel's parameters at launch). rho/u/f_post are read only when full.
extern "C" int k1_step_launch(const void* f_in, void* f_out, const void* aux,
                              void* edge, void* rho, void* u, void* f_post,
                              const void* scal, int H, int W, int use_les,
                              int full, void* stream) {
  const Scalars s = load_scalars(static_cast<const float*>(scal));
  const dim3 block(256, 1, 1);
  const dim3 grid((W - 2 + 255) / 256, H - 2, 1);
  k1_step_kernel<F32Store><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(f_in), static_cast<float*>(f_out),
      static_cast<const float*>(aux), static_cast<float*>(edge),
      static_cast<float*>(rho), static_cast<float*>(u),
      static_cast<float*>(f_post), s, H, W, use_les, full);
  return static_cast<int>(cudaGetLastError());
}

// The fast step in 16-bit deviation storage: f_in and f_out are bf16
// [9, H, W] buffers of f - w; the edge export is f32 as above.
extern "C" int k1_step_dev_launch(const void* f_in, void* f_out,
                                  const void* aux, void* edge,
                                  const void* scal, int H, int W,
                                  int use_les, void* stream) {
  const Scalars s = load_scalars(static_cast<const float*>(scal));
  const dim3 block(256, 1, 1);
  const dim3 grid((W - 2 + 255) / 256, H - 2, 1);
  k1_step_kernel<DevStore><<<grid, block, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const __nv_bfloat16*>(f_in),
      static_cast<__nv_bfloat16*>(f_out), static_cast<const float*>(aux),
      static_cast<float*>(edge), nullptr, nullptr, nullptr, s, H, W, use_les,
      0);
  return static_cast<int>(cudaGetLastError());
}
