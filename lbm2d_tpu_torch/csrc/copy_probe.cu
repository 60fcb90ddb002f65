// Copy probe: the bandwidth control of the roofline tool
// (lbm2d_tpu_torch/tools/roofline.py).
//
// Replaces the TPU kernel copy_kernel / make_copy of tools_roofline_4096.py
// (:95-116): out = f for a [9, H, W] f32 field, and with ``aux`` the aux
// plane [H, W] is read too and folded into the store as
// out[0] = f[0] + 0 aux, so the read cannot be dropped. It does no lattice
// arithmetic: its time is the least a step that moves the same bytes could
// take on this card.
//
// Bound on an H100: device-memory bytes only, 72 B/cell (76 with aux).
//
// Design for Hopper: an unrolled vector loop. Each thread issues
// COPY_UNROLL independent 16-byte loads (ld.global.nc, no L1 allocation)
// before its streaming stores (st.global.cs), neighbouring threads on
// neighbouring addresses, and the grid covers the array once. Against a
// TMA design (a persistent grid of two blocks a SM running cp.async.bulk
// through a 4 x 16 KB shared-memory ring, one thread issuing, completion
// on an mbarrier) it was 3.5% faster at 4096^2 (chip_smoke.py phase 7;
// PERF.md). A field whose plane is not a multiple of four floats, or a
// pointer that is not 16-byte aligned, takes a scalar grid-stride loop.
#include <cuda_runtime.h>

#include <cstdint>

#define COPY_THREADS 256
#define COPY_UNROLL 2

__device__ __forceinline__ float4 ld_stream(const float4* p) {
  float4 v;
  asm("ld.global.nc.L1::no_allocate.v4.f32 {%0, %1, %2, %3}, [%4];"
      : "=f"(v.x), "=f"(v.y), "=f"(v.z), "=f"(v.w)
      : "l"(p));
  return v;
}

__device__ __forceinline__ void st_stream(float4* p, const float4& v) {
  asm volatile("st.global.cs.v4.f32 [%0], {%1, %2, %3, %4};" ::"l"(p), "f"(v.x),
               "f"(v.y), "f"(v.z), "f"(v.w)
               : "memory");
}

// v + 0 a, lane by lane: the plain version's out[0] += 0 aux
__device__ __forceinline__ float4 fold0(float4 v, const float4& a) {
  v.x = v.x + 0.0f * a.x;
  v.y = v.y + 0.0f * a.y;
  v.z = v.z + 0.0f * a.z;
  v.w = v.w + 0.0f * a.w;
  return v;
}

template <bool AUX>
__global__ void __launch_bounds__(COPY_THREADS)
copy_vec_kernel(const float4* __restrict__ in, float4* __restrict__ out,
                const float4* __restrict__ aux, const size_t n4, const size_t plane4) {
  const size_t base = (size_t)blockIdx.x * (COPY_THREADS * COPY_UNROLL) + threadIdx.x;
  float4 v[COPY_UNROLL];
#pragma unroll
  for (int u = 0; u < COPY_UNROLL; ++u) {
    const size_t i = base + (size_t)u * COPY_THREADS;
    if (i < n4) v[u] = ld_stream(in + i);
  }
  if (AUX && base < plane4) {
#pragma unroll
    for (int u = 0; u < COPY_UNROLL; ++u) {
      const size_t i = base + (size_t)u * COPY_THREADS;
      if (i < plane4) v[u] = fold0(v[u], ld_stream(aux + i));
    }
  }
#pragma unroll
  for (int u = 0; u < COPY_UNROLL; ++u) {
    const size_t i = base + (size_t)u * COPY_THREADS;
    if (i < n4) st_stream(out + i, v[u]);
  }
}

template <bool AUX>
__global__ void __launch_bounds__(COPY_THREADS)
copy1_kernel(const float* __restrict__ in, float* __restrict__ out,
             const float* __restrict__ aux, const size_t n, const size_t plane) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = in[i];
    if (AUX && i < plane) v = v + 0.0f * aux[i];
    out[i] = v;
  }
}

template <bool AUX>
static void launch_vec(const void* in, void* out, const void* aux, size_t n4, size_t plane4,
                       cudaStream_t st) {
  const size_t per_block = (size_t)COPY_THREADS * COPY_UNROLL;
  copy_vec_kernel<AUX><<<(unsigned)((n4 + per_block - 1) / per_block), COPY_THREADS, 0, st>>>(
      static_cast<const float4*>(in), static_cast<float4*>(out),
      static_cast<const float4*>(aux), n4, plane4);
}

// Launches the probe on ``stream``: out = in over 9 H W floats, plus
// 0 aux on plane 0 when ``aux`` is not null. Returns the CUDA error code.
extern "C" int copy_probe_launch(const void* in, void* out, const void* aux, int H, int W,
                                 void* stream) {
  const size_t plane = (size_t)H * W;
  const size_t n = 9 * plane;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uintptr_t align = reinterpret_cast<uintptr_t>(in) | reinterpret_cast<uintptr_t>(out) |
                          reinterpret_cast<uintptr_t>(aux);
  if (plane % 4 != 0 || align % 16 != 0) {
    const size_t want = (n + COPY_THREADS - 1) / COPY_THREADS;
    const unsigned blocks = (unsigned)(want < 132 * 8 ? want : 132 * 8);
    const float* i1 = static_cast<const float*>(in);
    float* o1 = static_cast<float*>(out);
    if (aux)
      copy1_kernel<true><<<blocks, COPY_THREADS, 0, st>>>(
          i1, o1, static_cast<const float*>(aux), n, plane);
    else
      copy1_kernel<false><<<blocks, COPY_THREADS, 0, st>>>(i1, o1, nullptr, n, plane);
  } else {
    if (aux)
      launch_vec<true>(in, out, aux, n / 4, plane / 4, st);
    else
      launch_vec<false>(in, out, nullptr, n / 4, plane / 4, st);
  }
  return static_cast<int>(cudaGetLastError());
}
