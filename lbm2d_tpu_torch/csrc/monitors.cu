// The monitors of a chunk in one launch: for each item -- a case of a
// lockstep group, the one case of a serial chunk, or a block of a spatial
// mesh -- the momentum-exchange force on its obstacle over its boundary
// links and its max |u| over its own cells; for a group's case also its
// stability flag, written straight into the packed array the engine
// fetches, [Fx, Fy an item | max_v an item | stable an item] (f32).
//
// Replaces no pallas_call: the JAX package computes these with jnp ops that
// XLA fuses into its chunk programs (run_chunk_batched,
// lbm2d_tpu/parallel/batch.py:71-115; run_chunk_pallas,
// lbm2d_tpu/ops/pallas_step.py:1985-1988; the sharded runners,
// lbm2d_tpu/parallel/sharded.py:566-568, :599-601), where the port issued
// ~60 eager torch ops a case a chunk. Per item c:
//   force   the sum over its boundary links (fluid cell x, solid x + e_j)
//           of term e_j, with term = 2 f_post[j](x) (solver.force_on_obstacle
//           for equilibrium and full-way, force_on_obstacle_halfway; the two
//           are the same sum) or, under Bouzidi (force_on_obstacle_bouzidi),
//           f_j + f_ret with the streaming step's interpolation at the
//           link's wall fraction q = q[j - 1](x), each term in the eager
//           step's f32 operation order (-fmad=false), summed in f64;
//   max_v   max over its cells of sqrtf(ux ux + uy uy) (solver.max_velocity:
//           the same products, sum and correctly rounded sqrt, so the same
//           bits; a NaN anywhere makes it NaN, as torch.max does);
//   stable  stability.is_stable_device on the rounded force and max_v:
//           finite force within F_THRESHOLD, finite max_v, and max_v <=
//           V_THRESHOLD once the case is past its warmup (``later``).
// The links are a host-built list an item (cuda_step.boundary_links: per
// link (x << 5) | (x - e_j in the grid) << 4 | j, x in the item's f_post
// layout), cut once a case into CSR form (``offsets`` [I + 1]); the smoke
// mask has 15,178 at 2432x1152, so the sum reads a few hundred kB where
// the eager ops read the dense f_post planes.
//
// An item is a MonItem: its f_post, q and u planes [C, rows, pitch] (a
// plane of ``plane`` floats; u's of ``uplane``), the row pitch the
// Bouzidi term's upstream offset takes, and the region of u it reads:
// ``urows`` rows of ``ustride`` floats from ``u``, columns ucol0 ..
// ucol0 + ucols - 1 of each (a whole grid is one row of H W cells; a
// halo'd block its own cells). Items come from a device table (a mesh's
// blocks, fixed while the blocks are resident) or, where the launch passes
// none, from ``base`` and the item strides (a group's stacked cases, a
// serial chunk's one case).
//
// Deterministic, and repeated bit for bit by its plain version
// (cuda_step.monitor_sum_plain), whatever the grid: the force of an item
// is summed by MON_LINK_WARPS link warps of 32 lanes; lane g = 32 w + i
// adds links g + k MON_LINK_LANES, k = 0, 1, ... in order, from +0.0; each
// link warp adds its lanes by the tree h = 16, 8, .., 1 (lane i adds lane
// i + h) into its partial; the last of the item's link blocks to finish (a
// ticket, reset for the next launch) loads the partials with its first
// warp, lane i the partials i, i + 32, i + 64, i + 96 added in that order
// from +0.0, and adds the lanes by the same tree. The item's last block of
// all (a second ticket) writes its outputs. With ``total`` the last item to
// finish adds the items' f64 sums in item order, starting from the first
// item's (the eager block sum's order), and takes the max over them. A max
// needs no order.
//
// Bound on an H100: memory. u read once (8 B a cell) and, a link, its index
// and the populations it reads (4 + 4 B; Bouzidi 4 + 16 B); the operations
// are a few a cell. Design (each against what held the first design, a block
// tree per item and a serial combine, at 46-50% of that bound): one wave,
// sized from the SM count, the items and the blocks a SM the launch bounds
// hold (cuda_step.monitor_blocks: a block past the wave would run alone at
// its end), not a fixed 128 blocks an item; u streams as 16-byte loads,
// MON_UNROLL of ux and of uy in flight a thread (a scalar path where an
// item's planes are not 16-byte aligned, e.g. an odd H W); the link warps
// live in MON_LINK_BLOCKS blocks of their own beside the u blocks, so no u
// block waits on a gather, and each lane issues MON_LINK_UNROLL links'
// gathers at once; a block reduces its max by warp shuffles and one
// shared-memory atomic a warp, the force only in the link warps, by
// shuffles; the force's final combine runs in the last link block while u
// still streams, with a whole warp, not one thread walking 3 x 128 f64
// partials from L2 at the launch's end.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#include "lbm_common.cuh"

#define MON_THREADS 256
#define MON_WARPS (MON_THREADS / 32)
#define MON_LINK_WARPS 128
#define MON_LINK_LANES (MON_LINK_WARPS * 32)
#define MON_LINK_BLOCKS (MON_LINK_WARPS / MON_WARPS)
// the blocks a SM the launch bounds hold (64 registers a thread), which
// cuda_step.monitor_blocks sizes one wave with
#define MON_BLOCKS_A_SM 4
#define MON_UNROLL 4
#define MON_LINK_UNROLL 4
// items a ``total`` combine takes (lane i holds items i, i + 32, i + 64)
#define MON_MAX_TOTAL_ITEMS 96

// stability.V_THRESHOLD and F_THRESHOLD
#define MON_V_THRESHOLD 0.25f
#define MON_F_THRESHOLD 1e6f

// One item, as 10 64-bit words (cuda_step.monitor_item lays them out).
struct MonItem {
  const float* fp;
  const float* q;
  const float* u;
  long long plane, uplane, pitch, urows, ustride, ucol0, ucols;
};

// |u| of a cell as ordered bits: every |u| is +0 or more, or NaN, and the
// bits of such floats with the sign cleared order as the floats do with
// every NaN above +inf, so an unsigned max keeps a NaN.
__device__ __forceinline__ unsigned mon_speed_bits(float a, float v) {
  return __float_as_uint(sqrtf(a * a + v * v)) & 0x7fffffffu;
}

__device__ __forceinline__ unsigned mon_speed4(float4 a, float4 v, long long c0, long long lo,
                                               long long hi, unsigned m) {
  if (c0 >= lo && c0 < hi) m = max(m, mon_speed_bits(a.x, v.x));
  if (c0 + 1 >= lo && c0 + 1 < hi) m = max(m, mon_speed_bits(a.y, v.y));
  if (c0 + 2 >= lo && c0 + 2 < hi) m = max(m, mon_speed_bits(a.z, v.z));
  if (c0 + 3 >= lo && c0 + 3 < hi) m = max(m, mon_speed_bits(a.w, v.w));
  return m;
}

// The momentum carried by link ``l`` of an item: its term (see above) and
// the direction j.
template <bool BOUZIDI>
__device__ __forceinline__ float mon_term(const float* __restrict__ fp,
                                          const float* __restrict__ q, int l, long long plane,
                                          long long pitch, int* j_out) {
  const int j = l & 15;
  const long long x = (long long)(l >> 5);
  *j_out = j;
  const float fj = fp[j * plane + x];
  if (!BOUZIDI) return 2.0f * fj;
  const float qv = q[(j - 1) * plane + x];
  const float fk = fp[LBM_OPP[j] * plane + x];
  // f_j at x - e_j, 0 off the grid (shift2d's fill)
  const float up = (l & 16) ? fp[j * plane + x - (LBM_EY[j] * pitch + LBM_EX[j])] : 0.0f;
  const float two_q = 2.0f * qv;
  const float lo = two_q * fj + (1.0f - two_q) * up;
  const float hi = fj / two_q + (two_q - 1.0f) / two_q * fk;
  return fj + (qv < 0.5f ? lo : hi);
}

// The force tree of a warp: lane 0 ends with s[0] + s[16] ... in the order
// lane i adds lane i + h, h = 16 .. 1.
__device__ __forceinline__ double mon_warp_tree(double s) {
#pragma unroll
  for (int h = 16; h > 0; h >>= 1) s = s + __shfl_down_sync(0xffffffffu, s, h);
  return s;
}

// Link warp w of item c: lanes sum their strided links, the warp its lanes.
template <bool BOUZIDI>
__device__ __forceinline__ void mon_link_warp(const MonItem& it, const int* __restrict__ links,
                                              int nl, int w, int lane, double* fx_out,
                                              double* fy_out) {
  double fx = 0.0, fy = 0.0;
  for (int k0 = w * 32 + lane; k0 < nl; k0 += MON_LINK_UNROLL * MON_LINK_LANES) {
    float term[MON_LINK_UNROLL];
    int jj[MON_LINK_UNROLL];
#pragma unroll
    for (int r = 0; r < MON_LINK_UNROLL; ++r) {
      const int k = k0 + r * MON_LINK_LANES;
      term[r] = 0.0f;
      jj[r] = 0;
      if (k < nl) term[r] = mon_term<BOUZIDI>(it.fp, it.q, __ldg(links + k), it.plane, it.pitch,
                                              &jj[r]);
    }
#pragma unroll
    for (int r = 0; r < MON_LINK_UNROLL; ++r) {
      if (k0 + r * MON_LINK_LANES < nl) {
        fx = fx + (double)term[r] * (double)LBM_EX[jj[r]];
        fy = fy + (double)term[r] * (double)LBM_EY[jj[r]];
      }
    }
  }
  *fx_out = mon_warp_tree(fx);
  *fy_out = mon_warp_tree(fy);
}

// This thread's share of item c's u region: chunks of 4 cells (16-byte
// loads) where the planes allow, else single cells; grid-stride over the
// item's ``nb`` blocks.
__device__ __forceinline__ unsigned mon_u_stream(const MonItem& it, int b, int nb, int t) {
  unsigned m = 0u;
  if (it.urows <= 0 || it.ucols <= 0) return m;
  const float* __restrict__ ux = it.u;
  const float* __restrict__ uy = it.u + it.uplane;
  const long long lo = it.ucol0, hi = it.ucol0 + it.ucols;
  const unsigned step = (unsigned)nb * MON_THREADS;
  const bool vec = ((reinterpret_cast<uintptr_t>(ux) & 15) == 0) && (it.uplane % 4 == 0) &&
                   (it.urows == 1 || it.ustride % 4 == 0);
  if (vec) {
    const long long a0 = lo & ~3LL;
    const unsigned cpr = (unsigned)(((hi + 3) & ~3LL) - a0) / 4u;
    const unsigned nch = cpr * (unsigned)it.urows;
    for (unsigned k0 = (unsigned)b * MON_THREADS + t; k0 < nch; k0 += MON_UNROLL * step) {
      float4 A[MON_UNROLL], V[MON_UNROLL];
      long long col[MON_UNROLL];
#pragma unroll
      for (int r = 0; r < MON_UNROLL; ++r) {
        const unsigned k = k0 + r * step;
        col[r] = hi;  // no cell of a chunk past the end
        if (k < nch) {
          const unsigned row = it.urows == 1 ? 0u : k / cpr;
          col[r] = a0 + 4LL * (k - row * cpr);
          const long long off = (long long)row * it.ustride + col[r];
          A[r] = __ldcs(reinterpret_cast<const float4*>(ux + off));
          V[r] = __ldcs(reinterpret_cast<const float4*>(uy + off));
        }
      }
#pragma unroll
      for (int r = 0; r < MON_UNROLL; ++r)
        if (col[r] < hi) m = mon_speed4(A[r], V[r], col[r], lo, hi, m);
    }
  } else {
    const unsigned n = (unsigned)it.ucols * (unsigned)it.urows;
    for (unsigned k0 = (unsigned)b * MON_THREADS + t; k0 < n; k0 += MON_UNROLL * step) {
      float a[MON_UNROLL], v[MON_UNROLL];
#pragma unroll
      for (int r = 0; r < MON_UNROLL; ++r) {
        const unsigned k = k0 + r * step;
        a[r] = v[r] = 0.0f;
        if (k < n) {
          const unsigned row = it.urows == 1 ? 0u : k / (unsigned)it.ucols;
          const long long off =
              (long long)row * it.ustride + lo + (long long)(k - row * (unsigned)it.ucols);
          a[r] = __ldcs(ux + off);
          v[r] = __ldcs(uy + off);
        }
      }
#pragma unroll
      for (int r = 0; r < MON_UNROLL; ++r)
        if (k0 + r * step < n) m = max(m, mon_speed_bits(a[r], v[r]));
    }
  }
  return m;
}

// grid (nbu + MON_LINK_BLOCKS, I): blockIdx.y is the item; its first nbu
// blocks stream u, its last MON_LINK_BLOCKS blocks are its link warps.
// ``links`` / ``offsets`` the CSR link lists, ``case_table`` the group's
// int32 [alive I | later I] (none: alive, not later), ``partial`` [I,
// MON_LINK_WARPS, 2] f64 scratch, ``slots`` [I max bits | I link tickets |
// I tickets | 1] zeros (left zero), ``part`` [I, 3] f64 (Fx, Fy, max_v an
// item), ``packed`` [4 I] and ``alive_out`` [I] (the case's alive flag and
// its stable flag) or none, ``total`` [3] f32 or none (the items' sum in
// item order, their max).
template <bool BOUZIDI>
__global__ void __launch_bounds__(MON_THREADS, MON_BLOCKS_A_SM)
monitors_kernel(MonItem base, long long fs, long long qs, long long us,
                const MonItem* __restrict__ table, const int* __restrict__ links,
                const int* __restrict__ offsets, const int* __restrict__ case_table,
                double* __restrict__ partial, unsigned* __restrict__ slots,
                double* __restrict__ part, float* __restrict__ packed,
                unsigned char* __restrict__ alive_out, float* __restrict__ total, int I) {
  __shared__ unsigned s_max;
  __shared__ bool s_link_last, s_last;
  const int t = threadIdx.x, lane = t & 31, wb = t >> 5;
  const int b = blockIdx.x, c = blockIdx.y;
  const int nbu = (int)gridDim.x - MON_LINK_BLOCKS;
  MonItem it;
  if (table != nullptr) {
    it = table[c];
  } else {
    it = base;
    it.fp = base.fp + c * fs;
    it.q = BOUZIDI ? base.q + c * qs : nullptr;
    it.u = base.u + c * us;
  }
  unsigned* link_tickets = slots + I;
  unsigned* tickets = slots + 2 * I;
  if (t == 0) s_max = 0u;
  __syncthreads();
  const int l0 = offsets[c], nl = offsets[c + 1] - l0;
  if (b >= nbu) {
    // a link block: its warps are link warps, beside the u stream
    double* pc = partial + (size_t)c * MON_LINK_WARPS * 2;
    if (nl > 0) {
      const int w = (b - nbu) * MON_WARPS + wb;
      double fx, fy;
      mon_link_warp<BOUZIDI>(it, links + l0, nl, w, lane, &fx, &fy);
      if (lane == 0) {
        pc[2 * w] = fx;
        pc[2 * w + 1] = fy;
        __threadfence();
      }
    }
    __syncthreads();
    if (t == 0) s_link_last = atomicAdd(link_tickets + c, 1u) == (unsigned)(MON_LINK_BLOCKS - 1);
    __syncthreads();
    if (s_link_last && wb == 0) {
      // the item's force from its link warps' partials, while u streams
      __threadfence();
      double sx = 0.0, sy = 0.0;
      if (nl > 0) {
#pragma unroll
        for (int k = 0; k < MON_LINK_WARPS / 32; ++k) {
          sx = sx + __ldcg(pc + 2 * (lane + 32 * k));
          sy = sy + __ldcg(pc + 2 * (lane + 32 * k) + 1);
        }
        sx = mon_warp_tree(sx);
        sy = mon_warp_tree(sy);
      }
      if (lane == 0) {
        part[3 * c] = sx;
        part[3 * c + 1] = sy;
        link_tickets[c] = 0u;
        __threadfence();
      }
    }
  } else {
    unsigned m = mon_u_stream(it, b, nbu, t);
    m = __reduce_max_sync(0xffffffffu, m);
    if (lane == 0) atomicMax(&s_max, m);
  }
  __syncthreads();
  if (t == 0) {
    if (b < nbu) atomicMax(slots + c, s_max);
    __threadfence();
    s_last = atomicAdd(tickets + c, 1u) == gridDim.x - 1;
  }
  __syncthreads();
  if (!s_last || wb != 0) return;
  __threadfence();
  bool last_item = false;
  if (lane == 0) {
    const double sx = __ldcg(part + 3 * c), sy = __ldcg(part + 3 * c + 1);
    const unsigned mbits = atomicExch(slots + c, 0u);
    tickets[c] = 0u;
    const float mx = __uint_as_float(mbits);
    part[3 * c + 2] = (double)mx;
    if (packed != nullptr) {
      const float Fx = (float)sx, Fy = (float)sy;
      const bool later = case_table != nullptr && case_table[I + c] != 0;
      const bool alive = case_table == nullptr || case_table[c] != 0;
      const bool f_ok = isfinite(Fx) && isfinite(Fy) && fabsf(Fx) <= MON_F_THRESHOLD &&
                        fabsf(Fy) <= MON_F_THRESHOLD;
      const bool v_ok = isfinite(mx) && (!later || mx <= MON_V_THRESHOLD);
      const bool stable = f_ok && v_ok;
      packed[2 * c] = Fx;
      packed[2 * c + 1] = Fy;
      packed[2 * I + c] = mx;
      packed[3 * I + c] = stable ? 1.0f : 0.0f;
      alive_out[c] = (alive && stable) ? 1 : 0;
    }
    if (total != nullptr) {
      __threadfence();
      last_item = atomicAdd(tickets + I, 1u) == (unsigned)(I - 1);
    }
  }
  if (!__shfl_sync(0xffffffffu, last_item, 0)) return;
  // the last item: the items' sums in item order, from the first's
  __threadfence();
  double ix[3], iy[3];
  unsigned mm = 0u;
#pragma unroll
  for (int r = 0; r < 3; ++r) {
    const int k = lane + 32 * r;
    ix[r] = iy[r] = 0.0;
    if (k < I) {
      ix[r] = __ldcg(part + 3 * k);
      iy[r] = __ldcg(part + 3 * k + 1);
      mm = max(mm, __float_as_uint((float)__ldcg(part + 3 * k + 2)) & 0x7fffffffu);
    }
  }
  mm = __reduce_max_sync(0xffffffffu, mm);
  double tx = 0.0, ty = 0.0;
  for (int k = 0; k < I; ++k) {
    const double vx = __shfl_sync(0xffffffffu, k < 32 ? ix[0] : k < 64 ? ix[1] : ix[2], k & 31);
    const double vy = __shfl_sync(0xffffffffu, k < 32 ? iy[0] : k < 64 ? iy[1] : iy[2], k & 31);
    tx = k == 0 ? vx : tx + vx;
    ty = k == 0 ? vy : ty + vy;
  }
  if (lane == 0) {
    tickets[I] = 0u;
    total[0] = (float)tx;
    total[1] = (float)ty;
    total[2] = __uint_as_float(mm);
  }
}

// Launches the monitors of I items (``nb`` u blocks and MON_LINK_BLOCKS
// link blocks an item, the scheme's instance) on ``stream``: ``base`` is
// a host array of the first item's 10 words then the three item strides
// (f_post, q, u; in floats), used where
// ``table`` (a device array of I items) is null. Returns cudaGetLastError()
// as an int, or cudaErrorInvalidValue for refused arguments. No sync.
extern "C" int monitors_launch(const long long* base, const void* table, const void* links,
                               const void* offsets, const void* case_table, void* partial,
                               void* slots, void* part, void* packed, void* alive_out,
                               void* total, int I, int nb, int bouzidi, void* stream) {
  if (I < 1 || I > 65535 || nb < 1 || base == nullptr || (packed != nullptr) !=
      (alive_out != nullptr) || (total != nullptr && I > MON_MAX_TOTAL_ITEMS))
    return static_cast<int>(cudaErrorInvalidValue);
  MonItem it;
  it.fp = reinterpret_cast<const float*>(base[0]);
  it.q = reinterpret_cast<const float*>(base[1]);
  it.u = reinterpret_cast<const float*>(base[2]);
  it.plane = base[3];
  it.uplane = base[4];
  it.pitch = base[5];
  it.urows = base[6];
  it.ustride = base[7];
  it.ucol0 = base[8];
  it.ucols = base[9];
  if (table == nullptr && bouzidi && it.q == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(nb + MON_LINK_BLOCKS, I, 1);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  auto args = [&](auto kernel) {
    kernel<<<grid, MON_THREADS, 0, st>>>(
        it, base[10], base[11], base[12], static_cast<const MonItem*>(table),
        static_cast<const int*>(links), static_cast<const int*>(offsets),
        static_cast<const int*>(case_table), static_cast<double*>(partial),
        static_cast<unsigned*>(slots), static_cast<double*>(part), static_cast<float*>(packed),
        static_cast<unsigned char*>(alive_out), static_cast<float*>(total), I);
  };
  if (bouzidi)
    args(monitors_kernel<true>);
  else
    args(monitors_kernel<false>);
  return static_cast<int>(cudaGetLastError());
}
