// The device video frame of a saving chunk in one launch over all B cases
// of the call: ops/render.make_device_frame_renderer's frame, bitwise its
// plain torch version on the card (the same file).
//
// Replaces no pallas_call: the JAX package leaves its renderer
// (lbm2d_tpu/ops/render.py) to XLA, which fuses it; the port ran it as ~180
// eager torch ops a case, with 10 blocking host-to-device index uploads a
// case that each waited on the stream, so the lockstep loop could only
// render once the chunk was done. This kernel reads its tables from device
// buffers made once a shape (render._kernel_tables): no host sync, no copy.
//
// Per case b, with u [B, 2, H, W] and the mask [B, H, W] (any strides), in
// the eager order and its f32 roundings (-fmad=false; each product and sum
// rounded on its own, as the eager ops are separate kernels):
//   1. the separable gaussian of ux and uy: rows, then columns, each output
//      summed tap by tap from 0 over numpy's 'symmetric' padding (the
//      padding index tables pad_h [H + 2r], pad_w [W + 2r]);
//   2. |u| = sqrtf(ux ux + uy uy), correctly rounded;
//   3. the vorticity d(ux)/dy - d(uy)/dx, np.gradient's central differences
//      0.5 (a[i+1] - a[i-1]), one-sided a[1] - a[0] and a[n-1] - a[n-2] at
//      the edges;
//   4. the 256-entry LUT: (v - vmin) times 1 / (vmax - vmin) (torch's CUDA
//      division by a host scalar multiplies by its reciprocal, taken in
//      double and rounded to f32), floor of 256 times that, clamped to
//      0..255; solid cells (mask > 0.5) grey 0.5;
//   5. the two panels stacked, |u| above the vorticity: stacked row r is grid
//      row r mod H of panel r / H;
//   6. cv2's INTER_LINEAR along the stacked rows, then along the columns:
//      a_lo (1 - w) + a_hi w from the host-built tables (lo, hi, w, 1 - w),
//      the seam rows blending the two panels as the eager op does; an axis
//      whose size is kept is not touched;
//   7. floorf(clamp(x, 0, 1) 255);
//   8. RGB u8 [B, gui_h, gui_w, 3], or I420: Y [B, He, We] and UV [B, He/2,
//      We/2, 2] over the even crop He x We, BT.601 limited range with the
//      eager constants (double literals rounded to f32, as torch rounds a
//      Python float), round half to even, chroma from each 2x2 block's
//      top-left pixel.
//
// Bound on an H100: memory. u read once (8 B a cell) and the mask (4 B a
// cell), the frame written once (3 B a pixel, 1.5 in I420); ~35 MB a
// 2432x1152 case, ~10.5 us at 3.35 TB/s. Design: one block an output tile
// (tile_h x tile_w pixels, chosen on the host so that the largest tile's
// footprint fits the shared memory, render._tile_plan). The block works out
// the tile's source footprint from the resize tables -- stacked rows and
// columns, with one more on each side for the gradient -- and in shared
// memory: (a) the row pass of the gaussian at the footprint's rows over its
// columns and the column halo, reading u through L1 (each u row serves the
// 2r + 1 rows around it), (b) the column pass into the smoothed footprint,
// (c) each output pixel colours its (up to) four source pixels from it and
// blends them. The tiles of the two frame halves run interleaved, so the
// velocity tile and the vorticity tile that read the same grid rows run
// together and u comes from L2 the second time.
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

#define RENDER_THREADS 256
#define LUT_FLOATS (256 * 3)

struct RenderArgs {
  const float* u;
  const float* mask;
  uint8_t* out0;  // RGB, or Y
  uint8_t* out1;  // UV (I420)
  const int* itab;
  const float* ftab;
  long long su_b, su_c, su_y, su_x, sm_b, sm_y, sm_x;
  int H, W, gui_h, gui_w, radius, tile_h, tile_w;
  float vmin0, inv0, vmin1, inv1;
};

struct Rgb {
  float r, g, b;
};

__device__ __forceinline__ Rgb mix(const Rgb& lo, const Rgb& hi, float om, float w) {
  return {__fadd_rn(__fmul_rn(lo.r, om), __fmul_rn(hi.r, w)),
          __fadd_rn(__fmul_rn(lo.g, om), __fmul_rn(hi.g, w)),
          __fadd_rn(__fmul_rn(lo.b, om), __fmul_rn(hi.b, w))};
}

__device__ __forceinline__ float to8(float x) {
  return floorf(__fmul_rn(fminf(fmaxf(x, 0.f), 1.f), 255.f));
}

__device__ __forceinline__ uint8_t quant(float x) {
  return (uint8_t)fminf(fmaxf(rintf(x), 0.f), 255.f);
}

// np.gradient at index i of a line of n values read by at(k)
template <typename F>
__device__ __forceinline__ float gradient(int i, int n, F at) {
  if (i == 0) return __fsub_rn(at(1), at(0));
  if (i == n - 1) return __fsub_rn(at(n - 1), at(n - 2));
  return __fmul_rn(0.5f, __fsub_rn(at(i + 1), at(i - 1)));
}

template <bool SMOOTH, bool YUV>
__global__ void __launch_bounds__(RENDER_THREADS) render_kernel(const RenderArgs a) {
  extern __shared__ float smem[];
  const int H = a.H, W = a.W, r = a.radius, taps = 2 * r + 1;
  const int gui_h = a.gui_h, gui_w = a.gui_w;
  // the tables (render._kernel_tables): ints pad_h, pad_w (SMOOTH), ylo,
  // yhi, xlo, xhi; floats the taps (SMOOTH), wy, 1 - wy, wx, 1 - wx, the
  // plasma LUT, the vorticity LUT
  const int* pad_h = a.itab;
  const int* pad_w = pad_h + (SMOOTH ? H + 2 * r : 0);
  const int* ylo = pad_w + (SMOOTH ? W + 2 * r : 0);
  const int* yhi = ylo + gui_h;
  const int* xlo = yhi + gui_h;
  const int* xhi = xlo + gui_w;
  const float* kern = a.ftab;
  const float* wy = kern + (SMOOTH ? taps : 0);
  const float* omy = wy + gui_h;
  const float* wx = omy + gui_h;
  const float* omx = wx + gui_w;
  const float* plasma = omx + gui_w;
  const float* vort = plasma + LUT_FLOATS;
  const bool row_res = 2 * H != gui_h, col_res = W != gui_w;

  // the block's output tile: the two halves' tile rows interleaved
  const int hh = (gui_h + 1) / 2;
  const int nt_top = (hh + a.tile_h - 1) / a.tile_h;
  const int nt_bot = (gui_h - hh + a.tile_h - 1) / a.tile_h;
  const int both = 2 * min(nt_top, nt_bot);
  const int k = blockIdx.y;
  const int half = k < both ? (k & 1) : (nt_top > nt_bot ? 0 : 1);
  const int t = k < both ? (k >> 1) : both / 2 + (k - both);
  const int oy0 = (half ? hh : 0) + t * a.tile_h;
  const int oy1 = min(oy0 + a.tile_h, half ? gui_h : hh) - 1;
  const int ox0 = blockIdx.x * a.tile_w;
  const int ox1 = min(ox0 + a.tile_w, gui_w) - 1;

  // its footprint in stacked rows and grid columns, with the gradient's
  // neighbours
  const int sr0 = max((row_res ? ylo[oy0] : oy0) - 1, 0);
  const int sr1 = min((row_res ? yhi[oy1] : oy1) + 1, 2 * H - 1);
  const int sc0 = max((col_res ? xlo[ox0] : ox0) - 1, 0);
  const int sc1 = min((col_res ? xhi[ox1] : ox1) + 1, W - 1);
  const int nsr = sr1 - sr0 + 1, nsc = sc1 - sc0 + 1;
  float* sx = smem;
  float* sy = sx + nsr * nsc;

  const long long b = blockIdx.z;
  const float* ux = a.u + b * a.su_b;
  const float* uy = ux + a.su_c;
  const float* mk = a.mask + b * a.sm_b;

  if (SMOOTH) {
    const int npc = nsc + 2 * r;  // the column pass's padded columns
    float* ks = sy + nsr * nsc;
    float* ax = ks + taps;
    float* ay = ax + nsr * npc;
    for (int i = threadIdx.x; i < taps; i += blockDim.x) ks[i] = kern[i];
    __syncthreads();
    // (a) the row pass at the footprint's rows, on padded columns
    // sc0 .. sc1 + 2r (grid columns pad_w[.])
    for (int e = threadIdx.x; e < nsr * npc; e += blockDim.x) {
      const int i = e / npc, p = e - i * npc;
      const int sr = sr0 + i;
      const int g = sr >= H ? sr - H : sr;
      const long long col = (long long)pad_w[sc0 + p] * a.su_x;
      float accx = 0.f, accy = 0.f;
      for (int s = 0; s < taps; ++s) {
        const long long off = (long long)pad_h[g + s] * a.su_y + col;
        accx = __fadd_rn(accx, __fmul_rn(ks[s], __ldg(ux + off)));
        accy = __fadd_rn(accy, __fmul_rn(ks[s], __ldg(uy + off)));
      }
      ax[e] = accx;
      ay[e] = accy;
    }
    __syncthreads();
    // (b) the column pass
    for (int e = threadIdx.x; e < nsr * nsc; e += blockDim.x) {
      const int i = e / nsc, j = e - i * nsc;
      const float* rx = ax + i * npc + j;
      const float* ry = ay + i * npc + j;
      float accx = 0.f, accy = 0.f;
      for (int s = 0; s < taps; ++s) {
        accx = __fadd_rn(accx, __fmul_rn(ks[s], rx[s]));
        accy = __fadd_rn(accy, __fmul_rn(ks[s], ry[s]));
      }
      sx[e] = accx;
      sy[e] = accy;
    }
  } else {
    for (int e = threadIdx.x; e < nsr * nsc; e += blockDim.x) {
      const int i = e / nsc, j = e - i * nsc;
      const int sr = sr0 + i;
      const int g = sr >= H ? sr - H : sr;
      const long long off = (long long)g * a.su_y + (long long)(sc0 + j) * a.su_x;
      sx[e] = __ldg(ux + off);
      sy[e] = __ldg(uy + off);
    }
  }
  __syncthreads();

  // (c) the colour of stacked pixel (sr, c), then each output pixel
  auto colour = [&](int sr, int c) -> Rgb {
    const bool lower = sr >= H;  // the vorticity panel
    const int g = lower ? sr - H : sr;
    const float* px = sx + (sr - sr0) * nsc + (c - sc0);
    const float* py = sy + (sr - sr0) * nsc + (c - sc0);
    float v, vmin, inv;
    const float* lut;
    if (!lower) {
      v = __fsqrt_rn(__fadd_rn(__fmul_rn(*px, *px), __fmul_rn(*py, *py)));
      vmin = a.vmin0;
      inv = a.inv0;
      lut = plasma;
    } else {
      const float gx = gradient(g, H, [&](int q) { return px[(q - g) * nsc]; });
      const float gy = gradient(c, W, [&](int q) { return py[q - c]; });
      v = __fsub_rn(gx, gy);
      vmin = a.vmin1;
      inv = a.inv1;
      lut = vort;
    }
    if (__ldg(mk + g * a.sm_y + c * a.sm_x) > 0.5f) return {0.5f, 0.5f, 0.5f};
    float f = floorf(__fmul_rn(__fmul_rn(__fsub_rn(v, vmin), inv), 256.f));
    f = f != f ? 0.f : fminf(fmaxf(f, 0.f), 255.f);  // a NaN: any entry, no fault
    const float* e = lut + 3 * (int)f;
    return {__ldg(e), __ldg(e + 1), __ldg(e + 2)};
  };

  const int rec_h = gui_h - gui_h % 2, rec_w = gui_w - gui_w % 2;
  const float inv255 = (float)(1.0 / 255.0);
  for (int e = threadIdx.x; e < a.tile_h * a.tile_w; e += blockDim.x) {
    const int oy = oy0 + e / a.tile_w, ox = ox0 + e % a.tile_w;
    if (oy > oy1 || ox > ox1) continue;
    if (YUV && (oy >= rec_h || ox >= rec_w)) continue;
    const int y0 = row_res ? ylo[oy] : oy, x0 = col_res ? xlo[ox] : ox;
    Rgb p = colour(y0, x0);
    if (row_res) p = mix(p, colour(yhi[oy], x0), omy[oy], wy[oy]);
    if (col_res) {
      const int x1 = xhi[ox];
      Rgb q = colour(y0, x1);
      if (row_res) q = mix(q, colour(yhi[oy], x1), omy[oy], wy[oy]);
      p = mix(p, q, omx[ox], wx[ox]);
    }
    const float R = to8(p.r), G = to8(p.g), B = to8(p.b);
    if (!YUV) {
      uint8_t* o = a.out0 + (((size_t)b * gui_h + oy) * gui_w + ox) * 3;
      o[0] = (uint8_t)R;
      o[1] = (uint8_t)G;
      o[2] = (uint8_t)B;
      continue;
    }
    const float y = __fadd_rn(
        16.f, __fmul_rn(__fadd_rn(__fadd_rn(__fmul_rn((float)65.481, R), __fmul_rn((float)128.553, G)),
                                  __fmul_rn((float)24.966, B)),
                        inv255));
    a.out0[((size_t)b * rec_h + oy) * rec_w + ox] = quant(y);
    if ((oy | ox) & 1) continue;
    const float cu = __fadd_rn(
        __fmul_rn(__fadd_rn(__fsub_rn(__fmul_rn((float)-37.797, R), __fmul_rn((float)74.203, G)),
                            __fmul_rn(112.f, B)),
                  inv255),
        128.f);
    const float cv = __fadd_rn(
        __fmul_rn(__fsub_rn(__fsub_rn(__fmul_rn(112.f, R), __fmul_rn((float)93.786, G)),
                            __fmul_rn((float)18.214, B)),
                  inv255),
        128.f);
    uint8_t* o = a.out1 + (((size_t)b * (rec_h / 2) + oy / 2) * (rec_w / 2) + ox / 2) * 2;
    o[0] = quant(cu);
    o[1] = quant(cv);
  }
}

template <bool SMOOTH, bool YUV>
static int launch(const RenderArgs& a, int B, int smem, cudaStream_t st) {
  const int hh = (a.gui_h + 1) / 2;
  const int rows = (hh + a.tile_h - 1) / a.tile_h + (a.gui_h - hh + a.tile_h - 1) / a.tile_h;
  const dim3 grid((a.gui_w + a.tile_w - 1) / a.tile_w, rows, B);
  cudaError_t err = cudaFuncSetAttribute(render_kernel<SMOOTH, YUV>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  render_kernel<SMOOTH, YUV><<<grid, RENDER_THREADS, smem, st>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// strides: u's (b, component, row, column) and the mask's (b, row, column),
// in elements; ranges: vmin and 1 / (vmax - vmin) of |u|, then of the
// vorticity. The caller makes the device current and checks the shapes.
extern "C" int render_launch(const void* u, const void* mask, void* out0, void* out1,
                             const void* itab, const void* ftab, const long long* strides,
                             const float* ranges, int B, int H, int W, int gui_h, int gui_w,
                             int radius, int smooth, int yuv, int tile_h, int tile_w, int smem,
                             void* stream) {
  RenderArgs a;
  a.u = static_cast<const float*>(u);
  a.mask = static_cast<const float*>(mask);
  a.out0 = static_cast<uint8_t*>(out0);
  a.out1 = static_cast<uint8_t*>(out1);
  a.itab = static_cast<const int*>(itab);
  a.ftab = static_cast<const float*>(ftab);
  a.su_b = strides[0];
  a.su_c = strides[1];
  a.su_y = strides[2];
  a.su_x = strides[3];
  a.sm_b = strides[4];
  a.sm_y = strides[5];
  a.sm_x = strides[6];
  a.H = H;
  a.W = W;
  a.gui_h = gui_h;
  a.gui_w = gui_w;
  a.radius = radius;
  a.tile_h = tile_h;
  a.tile_w = tile_w;
  a.vmin0 = ranges[0];
  a.inv0 = ranges[1];
  a.vmin1 = ranges[2];
  a.inv1 = ranges[3];
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (smooth)
    return yuv ? launch<true, true>(a, B, smem, st) : launch<true, false>(a, B, smem, st);
  return yuv ? launch<false, true>(a, B, smem, st) : launch<false, false>(a, B, smem, st);
}
