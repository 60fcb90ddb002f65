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
// Design: a grid-stride loop of 16-byte loads and stores (float4) with
// neighbouring threads on neighbouring addresses; the scalar form runs when
// a plane is not a multiple of four floats.
#include <cuda_runtime.h>

template <bool AUX>
__global__ void __launch_bounds__(256)
copy4_kernel(const float4* __restrict__ in, float4* __restrict__ out,
             const float4* __restrict__ aux, const size_t n4, const size_t plane4) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n4;
       i += (size_t)gridDim.x * blockDim.x) {
    float4 v = in[i];
    if (AUX && i < plane4) {
      const float4 a = aux[i];
      v.x = v.x + 0.0f * a.x;
      v.y = v.y + 0.0f * a.y;
      v.z = v.z + 0.0f * a.z;
      v.w = v.w + 0.0f * a.w;
    }
    out[i] = v;
  }
}

template <bool AUX>
__global__ void __launch_bounds__(256)
copy1_kernel(const float* __restrict__ in, float* __restrict__ out,
             const float* __restrict__ aux, const size_t n, const size_t plane) {
  for (size_t i = (size_t)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += (size_t)gridDim.x * blockDim.x) {
    float v = in[i];
    if (AUX && i < plane) v = v + 0.0f * aux[i];
    out[i] = v;
  }
}

// Launches the probe on ``stream``: out = in over 9 H W floats, plus
// 0 aux on plane 0 when ``aux`` is not null. Returns the CUDA error code.
extern "C" int copy_probe_launch(const void* in, void* out, const void* aux, int H, int W,
                                 void* stream) {
  const size_t plane = (size_t)H * W;
  const size_t n = 9 * plane;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = 256;
  // 132 SMs x 8 resident blocks of 256 threads: enough loads in flight
  const size_t work = plane % 4 == 0 ? n / 4 : n;
  const int blocks = (int)((work + threads - 1) / threads < 132 * 8
                               ? (work + threads - 1) / threads : 132 * 8);
  if (plane % 4 == 0) {
    const float4* i4 = static_cast<const float4*>(in);
    float4* o4 = static_cast<float4*>(out);
    if (aux)
      copy4_kernel<true><<<blocks, threads, 0, st>>>(
          i4, o4, static_cast<const float4*>(aux), n / 4, plane / 4);
    else
      copy4_kernel<false><<<blocks, threads, 0, st>>>(i4, o4, nullptr, n / 4, plane / 4);
  } else {
    const float* i1 = static_cast<const float*>(in);
    float* o1 = static_cast<float*>(out);
    if (aux)
      copy1_kernel<true><<<blocks, threads, 0, st>>>(i1, o1, static_cast<const float*>(aux),
                                                     n, plane);
    else
      copy1_kernel<false><<<blocks, threads, 0, st>>>(i1, o1, nullptr, n, plane);
  }
  return static_cast<int>(cudaGetLastError());
}
