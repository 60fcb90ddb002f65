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
// The obstacle scheme is a template parameter (LBM_OBST_*, the JAX
// kernel's branches at :967-1024 and :1139/:1157):
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
// aux 4) for ~200 flops, plus 32 B/cell of dense q planes under BOUZIDI,
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
#include "lbm_common.cuh"

template <typename S, int OBST>
__global__ void __launch_bounds__(256)
k1_step_kernel(const typename S::T* __restrict__ f_in,
               typename S::T* __restrict__ f_out,
               const float* __restrict__ aux, const float* __restrict__ q,
               float* __restrict__ edge, float* __restrict__ rho_out,
               float* __restrict__ u_out, float* __restrict__ fpost_out,
               const Scalars s, const int H, const int W, const int use_les,
               const int full) {
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

  if (OBST == LBM_OBST_HALFWAY || OBST == LBM_OBST_BOUZIDI) {
#pragma unroll
    for (int k = 1; k < 9; ++k) {
      const long off = (long)LBM_EY[k] * W + LBM_EX[k];
      if (__float_as_int(aux[c - off]) >= 0) continue;  // pull source fluid
      const int ko = LBM_OPP[k];
      const float f_o = S::load(f_in, ko * plane + c, ko);
      if (OBST == LBM_OBST_HALFWAY) {
        fs[k] = f_o;
      } else {
        const float qv = q[(ko - 1) * plane + c];
        const float q2 = 2.0f * qv;
        if (qv < 0.5f) {
          const float f_o_up = S::load(f_in, ko * plane + c + off, ko);
          fs[k] = q2 * f_o + (1.0f - q2) * f_o_up;
        } else {
          const float f_c = S::load(f_in, k * plane + c, k);
          fs[k] = f_o / q2 + ((q2 - 1.0f) / q2) * f_c;
        }
      }
    }
  }

  // aux packs the sponge damping with the solid flag in the sign bit
  const float a = aux[c];
  const bool solid = __float_as_int(a) < 0;
  const float damp = fabsf(a);

  float fp[9], rho, ux, uy;
  mrt_collide(fs, damp, s, use_les, fp, &rho, &ux, &uy);
  if (OBST == LBM_OBST_BOUNCE && solid) {
#pragma unroll
    for (int k = 0; k < 9; ++k) fp[k] = fs[LBM_OPP[k]];
  }

  for (int k = 0; k < 9; ++k) {
    const bool overwrite = OBST != LBM_OBST_BOUNCE && solid;
    S::store(f_out, k * plane + c, k, overwrite ? lbm_w(k) * rho : fp[k]);
  }

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

template <typename S, int OBST>
static void launch(const void* f_in, void* f_out, const void* aux,
                   const void* q, void* edge, void* rho, void* u, void* f_post,
                   const Scalars& s, int H, int W, int use_les, int full,
                   cudaStream_t stream) {
  const dim3 block(256, 1, 1);
  const dim3 grid((W - 2 + 255) / 256, H - 2, 1);
  k1_step_kernel<S, OBST><<<grid, block, 0, stream>>>(
      static_cast<const typename S::T*>(f_in),
      static_cast<typename S::T*>(f_out), static_cast<const float*>(aux),
      static_cast<const float*>(q), static_cast<float*>(edge),
      static_cast<float*>(rho), static_cast<float*>(u),
      static_cast<float*>(f_post), s, H, W, use_les, full);
}

// Launches K1 on ``stream``; returns cudaGetLastError() as an int, or
// cudaErrorInvalidValue for an unknown scheme. ``scal`` is a host pointer
// to the 14-float scalar row (copied into the kernel's parameters at
// launch). ``obst`` is LBM_OBST_*; ``q`` ([8, H, W] f32) is read only under
// BOUZIDI, rho/u/f_post only when full.
extern "C" int k1_step_launch(const void* f_in, void* f_out, const void* aux,
                              const void* q, void* edge, void* rho, void* u,
                              void* f_post, const void* scal, int H, int W,
                              int use_les, int full, int obst, void* stream) {
  const Scalars s = load_scalars(static_cast<const float*>(scal));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (obst) {
    case LBM_OBST_EQ:
      launch<F32Store, LBM_OBST_EQ>(f_in, f_out, aux, q, edge, rho, u, f_post,
                                    s, H, W, use_les, full, st);
      break;
    case LBM_OBST_BOUNCE:
      launch<F32Store, LBM_OBST_BOUNCE>(f_in, f_out, aux, q, edge, rho, u,
                                        f_post, s, H, W, use_les, full, st);
      break;
    case LBM_OBST_HALFWAY:
      launch<F32Store, LBM_OBST_HALFWAY>(f_in, f_out, aux, q, edge, rho, u,
                                         f_post, s, H, W, use_les, full, st);
      break;
    case LBM_OBST_BOUZIDI:
      launch<F32Store, LBM_OBST_BOUZIDI>(f_in, f_out, aux, q, edge, rho, u,
                                         f_post, s, H, W, use_les, full, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The fast step in 16-bit deviation storage: f_in and f_out are bf16
// [9, H, W] buffers of f - w; the edge export is f32 as above. Schemes EQ
// and BOUNCE only.
extern "C" int k1_step_dev_launch(const void* f_in, void* f_out,
                                  const void* aux, void* edge,
                                  const void* scal, int H, int W,
                                  int use_les, int obst, void* stream) {
  const Scalars s = load_scalars(static_cast<const float*>(scal));
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (obst) {
    case LBM_OBST_EQ:
      launch<DevStore, LBM_OBST_EQ>(f_in, f_out, aux, nullptr, edge, nullptr,
                                    nullptr, nullptr, s, H, W, use_les, 0, st);
      break;
    case LBM_OBST_BOUNCE:
      launch<DevStore, LBM_OBST_BOUNCE>(f_in, f_out, aux, nullptr, edge,
                                        nullptr, nullptr, nullptr, s, H, W,
                                        use_les, 0, st);
      break;
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
