// The monitors of a lockstep group's chunk in one launch: for each case the
// momentum-exchange force on its obstacle, its max |u| and its stability
// flag, written straight into the packed array the engine fetches,
// [Fx, Fy a case | max_v a case | stable a case] (f32).
//
// Replaces no pallas_call: the JAX BatchEngine computes these with vmapped
// jnp ops that XLA fuses into its chunk program (run_chunk_batched,
// lbm2d_tpu/parallel/batch.py:71-115; _chunk_sequential :118-176), and the
// port issued them as ~60 eager torch ops a case a chunk. Per case c:
//   force   the sum over its boundary links (fluid cell x, solid x + e_j)
//           of term e_j, with term = 2 f_post[j](x) (solver.force_on_obstacle
//           for equilibrium and full-way, force_on_obstacle_halfway; the two
//           are the same sum) or, under Bouzidi (force_on_obstacle_bouzidi),
//           f_j + f_ret with the streaming step's interpolation at the
//           link's wall fraction q = q[j - 1](x), each term in the eager
//           step's f32 operation order (-fmad=false), summed in f64;
//   max_v   max over cells of sqrtf(ux ux + uy uy) (solver.max_velocity:
//           the same products, sum and correctly rounded sqrt, so the same
//           bits; a NaN anywhere makes it NaN, as torch.max does: fmaxf
//           would drop it and keep a blown-up case alive);
//   stable  stability.is_stable_device on the rounded force and max_v:
//           finite force within F_THRESHOLD, finite max_v, and max_v <=
//           V_THRESHOLD once the case is past its warmup (``later``).
// The links are a host-built list a case (cuda_step.boundary_links: per
// link (x << 5) | (x - e_j in the grid) << 4 | j), cut once a group into
// CSR form (``offsets`` [B + 1]); the smoke mask has 15,178 at 2432x1152,
// so the sum reads a few hundred kB where the eager ops read the dense
// f_post planes.
//
// Deterministic, and repeated bit for bit by its plain version
// (cuda_step.group_monitors_plain): block b of a case's ``nb`` blocks,
// thread t of MON_THREADS, sums links b T + t + k nb T, k = 0, 1, ... in
// order, from +0.0; the block then halves its threads' sums (thread t adds
// t + h, h = T / 2 .. 1); the last block of the case to finish (a ticket on
// ``counter``, reset for the next launch) adds the blocks' sums in block
// order from +0.0 and writes the case's entries. The same blocks take a
// grid-stride share of the cells for max_v (a max needs no order).
//
// Bound on an H100: memory. u read once (8 B a cell) and, a link, its index
// and the populations it reads (4 + 4 B; Bouzidi 4 + 16 B); the operations
// are a few a cell. Design: coalesced grid-stride loads of u, ``nb`` blocks
// a case (MON_MAX_BLOCKS at production size) so every SM has work.
#include <cuda_runtime.h>
#include <math.h>

#include "lbm_common.cuh"

#define MON_THREADS 256

// stability.V_THRESHOLD and F_THRESHOLD
#define MON_V_THRESHOLD 0.25f
#define MON_F_THRESHOLD 1e6f

// max that keeps a NaN: NaN if either is NaN, else the larger
__device__ __forceinline__ float mon_max(float a, float b) {
  return a != a ? a : ((b > a || b != b) ? b : a);
}

// The momentum carried by link ``l`` of a case: its term (see above) and
// the direction j.
template <bool BOUZIDI>
__device__ __forceinline__ float mon_term(const float* __restrict__ fp,
                                          const float* __restrict__ q, int l, size_t plane,
                                          int W, int* j_out) {
  const int j = l & 15;
  const size_t x = (size_t)(l >> 5);
  *j_out = j;
  const float fj = fp[j * plane + x];
  if (!BOUZIDI) return 2.0f * fj;
  const float qv = q[(j - 1) * plane + x];
  const float fk = fp[LBM_OPP[j] * plane + x];
  // f_j at x - e_j, 0 off the grid (shift2d's fill)
  const float up = (l & 16) ? fp[j * plane + x - (LBM_EY[j] * W + LBM_EX[j])] : 0.0f;
  const float two_q = 2.0f * qv;
  const float lo = two_q * fj + (1.0f - two_q) * up;
  const float hi = fj / two_q + (two_q - 1.0f) / two_q * fk;
  return fj + (qv < 0.5f ? lo : hi);
}

// grid (nb, B): blockIdx.y is the case. ``f_post`` [B, 9, H, W], ``u`` [B,
// 2, H, W], ``q`` [B, 8, H, W] (Bouzidi only), ``links`` / ``offsets`` the
// CSR link lists, ``table`` the group's int32 case table [alive B | later
// B | ...], ``partial`` [B, nb, 3] f64 scratch, ``counter`` [B] zeros
// (left zero), ``out`` [4 B] (the packed monitors), ``alive_out`` [B] (the
// case's alive flag and its stable flag).
template <bool BOUZIDI>
__global__ void __launch_bounds__(MON_THREADS)
group_monitors_kernel(const float* __restrict__ f_post, const float* __restrict__ u,
                      const float* __restrict__ q, const int* __restrict__ links,
                      const int* __restrict__ offsets, const int* __restrict__ table,
                      double* __restrict__ partial, unsigned* __restrict__ counter,
                      float* __restrict__ out, unsigned char* __restrict__ alive_out, int B,
                      int H, int W) {
  __shared__ double sx[MON_THREADS], sy[MON_THREADS];
  __shared__ float sm[MON_THREADS];
  __shared__ bool last;
  const int t = threadIdx.x, b = blockIdx.x, nb = gridDim.x, c = blockIdx.y;
  const size_t plane = (size_t)H * W;
  const float* fp = f_post + (size_t)c * 9 * plane;
  const float* ux = u + (size_t)c * 2 * plane;
  const float* uy = ux + plane;
  const float* qc = BOUZIDI ? q + (size_t)c * 8 * plane : nullptr;

  float m = 0.0f;
  for (size_t i = (size_t)b * MON_THREADS + t; i < plane; i += (size_t)nb * MON_THREADS) {
    const float a = ux[i], v = uy[i];
    m = mon_max(m, sqrtf(a * a + v * v));
  }
  double fx = 0.0, fy = 0.0;
  const int l0 = offsets[c], nl = offsets[c + 1] - l0;
  for (int k = b * MON_THREADS + t; k < nl; k += nb * MON_THREADS) {
    int j;
    const float term = mon_term<BOUZIDI>(fp, qc, links[l0 + k], plane, W, &j);
    fx = fx + (double)term * (double)LBM_EX[j];
    fy = fy + (double)term * (double)LBM_EY[j];
  }
  sx[t] = fx;
  sy[t] = fy;
  sm[t] = m;
  __syncthreads();
  for (int h = MON_THREADS / 2; h > 0; h >>= 1) {
    if (t < h) {
      sx[t] = sx[t] + sx[t + h];
      sy[t] = sy[t] + sy[t + h];
      sm[t] = mon_max(sm[t], sm[t + h]);
    }
    __syncthreads();
  }
  double* pc = partial + (size_t)c * nb * 3;
  if (t == 0) {
    pc[3 * b] = sx[0];
    pc[3 * b + 1] = sy[0];
    pc[3 * b + 2] = (double)sm[0];
    __threadfence();
    last = atomicAdd(counter + c, 1u) == (unsigned)(nb - 1);
  }
  __syncthreads();
  if (!last || t != 0) return;
  __threadfence();
  double sfx = 0.0, sfy = 0.0;
  float mx = 0.0f;
  for (int k = 0; k < nb; ++k) {
    sfx = sfx + __ldcg(pc + 3 * k);
    sfy = sfy + __ldcg(pc + 3 * k + 1);
    mx = mon_max(mx, (float)__ldcg(pc + 3 * k + 2));
  }
  counter[c] = 0u;
  const float Fx = (float)sfx, Fy = (float)sfy;
  const bool f_ok = isfinite(Fx) && isfinite(Fy) && fabsf(Fx) <= MON_F_THRESHOLD &&
                    fabsf(Fy) <= MON_F_THRESHOLD;
  const bool v_ok = isfinite(mx) && (!table[B + c] || mx <= MON_V_THRESHOLD);
  const bool stable = f_ok && v_ok;
  out[2 * c] = Fx;
  out[2 * c + 1] = Fy;
  out[2 * B + c] = mx;
  out[3 * B + c] = stable ? 1.0f : 0.0f;
  alive_out[c] = (table[c] != 0 && stable) ? 1 : 0;
}

// Launches the monitors of the B cases of a group (``nb`` blocks a case, the
// scheme's instance) on ``stream``; returns cudaGetLastError() as an int, or
// cudaErrorInvalidValue for refused arguments. No sync.
extern "C" int group_monitors_launch(const void* f_post, const void* u, const void* q,
                                     const void* links, const void* offsets, const void* table,
                                     void* partial, void* counter, void* out, void* alive_out,
                                     int B, int H, int W, int nb, int bouzidi, void* stream) {
  if (B < 1 || B > 65535 || H < 1 || W < 1 || nb < 1 || (bouzidi && q == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nb, B, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, MON_THREADS, 0, st>>>(
        static_cast<const float*>(f_post), static_cast<const float*>(u),
        static_cast<const float*>(q), static_cast<const int*>(links),
        static_cast<const int*>(offsets), static_cast<const int*>(table),
        static_cast<double*>(partial), static_cast<unsigned*>(counter),
        static_cast<float*>(out), static_cast<unsigned char*>(alive_out), B, H, W);
  };
  if (bouzidi)
    args(group_monitors_kernel<true>);
  else
    args(group_monitors_kernel<false>);
  return static_cast<int>(cudaGetLastError());
}
