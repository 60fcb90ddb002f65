// K3: temporal blocking, S <= 8 full lattice updates per pass over device
// memory.
//
// Replaces the TPU kernel _fused_kernel (lbm2d_tpu/ops/pallas_step.py:610,
// launched by _pallas_fused_steps :760, BCs in _fused_apply_bc :495). Each
// block owns one tile of TH x TW centre cells and advances the tile's
// window (the centre plus S halo cells a side, clipped to the grid) S
// lattice steps on the chip, then stores the centre. Every sub-step is one
// K1 step: the interior update of lbm_cell.cuh (pull, link rule, MRT-LES
// collision, obstacle rule) and the boundary ring in solver.apply_bc order,
// so the stored centre equals S calls of K1 bitwise.
//
// Trapezoid: level s (the window after s sub-steps) is valid on the window
// shrunk by s cells a side and clipped to the grid; its interior cells pull
// from level s - 1, so after S sub-steps the centre is valid. A ring cell
// of the grid is updated in every window whose level holds it, halo or
// centre: each copy must stay valid (the 2-D form of the TPU kernel's
// owner_top). Its BC reads the collide output of its inward neighbour at
// the same level, which lies in the level too as long as no tile starts on
// the last row or column: the wrapper shifts the last tile of each axis
// back to end on the grid's edge (y0 = min(ty TH, H - TH)), and the block
// stores only its unshifted share of the centre, so no cell is written
// twice. The result does not depend on the tile.
//
// Schedule: a sweep up the tile's rows with the levels skewed, so a block
// holds a few rows of each level instead of the whole window. The block
// has S x WW threads: thread (x, s - 1) owns window column x of level s
// (whole warps a level, no per-cell division). In iteration t level s
// updates window row t - 2 s from rows t - 2 s - 1 .. t - 2 s + 1 of level
// s - 1, which level s - 1 finished in earlier iterations; one barrier ends
// each iteration. Level 0 is the input: its rows (and aux's, which every
// level reads) arrive by cp.async, 16 bytes a thread where the rows allow
// it, issued K3_AHEAD iterations before they must be in, into rings of 8
// (32 for aux) rows, so the loads of later rows overlap the levels'
// arithmetic; levels 1 .. S - 1 keep 4-row rings in shared memory; level S
// goes from registers straight to device memory, the unshifted centre
// only. tests/test_torch_k3_tiles.py models this schedule.
//   The ring: a ring cell takes the BC values of its inward neighbour's
// collide output (lbm_ring_values, apply_bc's order: at a corner the side
// BC first). Its thread runs the same collide call as its warp's other
// lanes, on the neighbour's inputs (so the same bits as the neighbour's
// own update), then the BC chain out of line. A bottom-row cell needs
// level s - 1's rows 0 .. 2, which exist one iteration after its own turn,
// so the thread that updates row 1 also writes row 0; a top-row cell reads
// rows H - 3 .. H - 1, which level s - 1 has finished, and level s - 1
// writes no row above H - 1 to overwrite them. The sweep has two bodies,
// chosen once a block: only blocks whose window reaches the grid's edge
// run the one with ring code. Both keep the loop's bookkeeping out of the
// iterations (the load offsets, the level's iteration range): the cell
// update is ~200 instructions, and per-iteration index arithmetic had cost
// a fifth of the time (PERF.md). Ring cells take the obstacle overwrite
// f = w rho on solids (not under full-way bounce-back). The velocity inlets
// (left types 3/4) read the case's inlet_profile tensor, as K1 does. Global
// memory is read only inside [0, H) x [0, W): window cells outside the
// grid are never loaded nor read.
//
// Bound on an H100: the function moves 76 B a cell a pass (f and aux read
// once, f written once) for 120 f32 operations a cell-step; the cell
// update is ~200 instructions under -fmad=false (IEEE division and square
// roots, the eager step's order). The design keeps the redundant halo
// updates few (a tile's levels update ~1.17 cells a cell-step) and the
// SMs busy (two blocks a SM, no block waits for its own loads); the
// timing probes below show where a pass's time goes (PERF.md). The
// window is WW = 128
// columns (64 where the tile's TW + 2 S fits them) and its rows start
// 32-byte aligned in device memory where the tile allows it (TW a multiple
// of 8 and the window 8 columns left of the centre; only the last tile of
// a row may start unaligned). Shared memory: (8 + 4 (S - 1)) x 9 + 32 rows
// of WW floats, 108,544 B at S = 4 with WW = 128 and 91,136 B at S = 8 with
// WW = 64 (the default tiles), so two blocks share an SM and one block's
// loads and barriers overlap the other's arithmetic. The update's 64
// registers a thread cap the SM at 1,024 threads either way.
#include "lbm_cell.cuh"

#define K3_MAX_STEPS 8
#define K3_RING0 8      // level 0's rows in flight (a power of two)
#define K3_RING 4       // rows of each level 1 .. S - 1
#define K3_AHEAD 3      // iterations a level-0 row is issued before it must be in
#define K3_RING_AUX 32  // rows of aux (read by every level: 2 S + 6 rows in use)

// Timing probes, 0 in every build the port launches: tools/kernel_ab.py
// --k3-breakdown builds this file with -DK3_PROBE=bits to see where a
// pass's time goes (1: the collision left out, the pull's shared reads and
// the stores kept; 2: no barrier a sweep iteration; 4: no cell update, the
// loads alone; 8: level S computed but not stored to device memory). A
// probe's output is wrong; only its time is read.
#ifndef K3_PROBE
#define K3_PROBE 0
#endif

// One scalar row per sub-step, passed by value in the launch parameters.
struct ScalarRows {
  Scalars s[K3_MAX_STEPS];
};

// Shared floats of one block at S sub-steps and WW window columns.
static inline size_t k3_smem_floats(int S, int WW) {
  return (size_t)(K3_RING0 + K3_RING * (S - 1)) * 9 * WW + (size_t)K3_RING_AUX * WW;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned d = (unsigned)__cvta_generic_to_shared(dst);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(d), "l"(src) : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Where a level's rows live: a ring of (mask + 1) rows of [P][WW] floats
// (P = 9 populations, or 1 for aux).
template <int WW, int P = 9>
struct Ring {
  float* base;
  int mask;
  __device__ __forceinline__ float* row(int wr) const { return base + (wr & mask) * (P * WW); }
};

// The collide output (before the obstacle overwrite) of window cell
// (wr, x) from level ``src``; returns its solid flag.
template <int OBST, int WW>
__device__ __forceinline__ bool k3_collide(const Ring<WW>& src, const Ring<WW, 1>& aux,
                                           int wr, int x, const Scalars& sc, int use_les,
                                           Cell* n) {
  const float* rows[3] = {src.row(wr - 1) + x, src.row(wr) + x, src.row(wr + 1) + x};
  auto f_at = [&](int k, int dy, int dx) { return rows[dy + 1][k * WW + dx]; };
  auto solid_at = [&](int dy, int dx) {
    return __float_as_int(aux.row(wr + dy)[x + dx]) < 0;
  };
  auto q_at = [](int) { return 0.5f; };  // no Bouzidi in K3
  const float a = aux.row(wr)[x];
  const bool solid = __float_as_int(a) < 0;
  if constexpr ((K3_PROBE & 1) != 0) {
#pragma unroll
    for (int k = 0; k < 9; ++k) n->f[k] = f_at(k, -lbm_ey(k), -lbm_ex(k));
    n->rho = n->f[0];
    n->ux = n->uy = 0.0f;
  } else {
    lbm_cell_update<OBST>(f_at, solid_at, q_at, fabsf(a), solid, sc, use_les, n->f, &n->rho,
                          &n->ux, &n->uy);
  }
  return solid;
}

// Where a ring cell (gy, gx) finds its inward neighbour, (dy, dx) away,
// and which BC chain it takes (lbm_ring_values: ``column`` for the side
// columns' inner rows, ``far`` for the right column or the top row).
struct RingPos {
  bool column, far;
  int dy, dx;
};

__device__ __forceinline__ RingPos k3_ring_pos(int gy, int gx, int H, int W) {
  RingPos r;
  r.column = gy >= 1 && gy <= H - 2;
  if (r.column) {
    r.far = gx == W - 1;
    r.dy = 0;
    r.dx = r.far ? -1 : 1;
  } else {
    r.far = gy == H - 1;
    r.dy = r.far ? -1 : 1;
    r.dx = gx == 0 ? 1 : (gx == W - 1 ? -1 : 0);
  }
  return r;
}

// The BC values of ring cell column ``gx`` from its inward neighbour's
// collide output ``n`` (in place): the ring threads' branch, kept out of
// line so its registers stay out of the update's.
__device__ __noinline__ void k3_ring_bc(Cell* n, RingPos r, int gx, int W, const Scalars& sc,
                                        const BcTypes& bc, float u_prof) {
  *n = lbm_ring_values(*n, r.column, r.far, gx, W, sc, bc, u_prof);
}

// A compile-time flag for the sweep's two bodies.
template <bool B>
struct Flag {
  static constexpr bool value = B;
};

// WW = 128 takes 1,024 threads (S = 8) in 65,536 registers, WW = 64 two
// blocks of 512: 64 registers a thread either way.
template <int OBST, int WW>
__global__ void __launch_bounds__(WW * K3_MAX_STEPS, 128 / WW)
k3_fused_kernel(const float* __restrict__ f_in, float* __restrict__ f_out,
                const float* __restrict__ aux, const float* __restrict__ prof,
                const ScalarRows rows, const int S, const int H, const int W,
                const int TH, const int TW, const BcTypes bc, const int use_les) {
  extern __shared__ float smem[];
  __shared__ Scalars ssc[K3_MAX_STEPS];
  const int x = threadIdx.x, s = threadIdx.y + 1;
  const int tid = threadIdx.y * WW + x, nthreads = WW * S;
#pragma unroll
  for (int i = 0; i < K3_MAX_STEPS; ++i)
    if (tid == i) ssc[i] = rows.s[i];

  // the tile: its unshifted centre origin (yn, xn), the shifted centre
  // origin (yc, xc), the window's first row and column (xw0 32-byte
  // aligned where the window still covers the tile)
  const int yn = blockIdx.y * TH, xn = blockIdx.x * TW;
  const int yc = min(yn, max(H - TH, 0)), xc = min(xn, max(W - TW, 0));
  const int wy0 = yc - S;
  const int xa = (xc - S) & ~7;
  const int xw0 = xa + WW >= min(W, xc + TW + S) ? xa : xc - S;
  const size_t plane = (size_t)H * W;
  const int nrows = TH + 2 * S;  // window rows

  const Ring<WW> ring0{smem, K3_RING0 - 1};
  const Ring<WW> src =
      s == 1 ? ring0 : Ring<WW>{smem + (K3_RING0 + K3_RING * (s - 2)) * 9 * WW, K3_RING - 1};
  const Ring<WW> dst{smem + (K3_RING0 + K3_RING * (s - 1)) * 9 * WW, K3_RING - 1};
  const Ring<WW, 1> raux{smem + (K3_RING0 + K3_RING * (S - 1)) * 9 * WW, K3_RING_AUX - 1};

  // level 0's window rows inside the grid, [ld_lo, ld_hi), and this
  // thread's share of each with its aux row: one 16-byte copy (planes 0 ..
  // 8 f, 9 aux; fixed for the sweep) where the rows allow it, else single
  // floats
  const int ld_lo = max(0, -wy0), ld_hi = min(nrows, H - wy0);
  const bool vec = W % 4 == 0 && xw0 % 4 == 0 && 10 * WW / 4 <= nthreads;
  const int vk = tid / (WW / 4), vc = tid % (WW / 4) * 4;
  const bool v_in = vec && tid < 10 * WW / 4 && xw0 + vc >= 0 && xw0 + vc < W;
  float* const v_dst = vk < 9 ? ring0.base + vk * WW + vc : raux.base + vc;
  const int v_row = vk < 9 ? 9 * WW : WW, v_mask = vk < 9 ? K3_RING0 - 1 : K3_RING_AUX - 1;
  const float* const v_src = (vk < 9 ? f_in + vk * plane : aux) + xw0 + vc;
  auto load_row = [&](int wr) {
    if (wr >= ld_lo && wr < ld_hi) {
      if (vec) {
        if (v_in) cp_async16(v_dst + (wr & v_mask) * v_row, v_src + (size_t)(wy0 + wr) * W);
      } else {
        const float* g = f_in + (size_t)(wy0 + wr) * W + xw0;
        const float* ga = aux + (size_t)(wy0 + wr) * W + xw0;
        for (int e = tid; e < 10 * WW; e += nthreads) {
          const int k = e / WW, c = e % WW;
          if (xw0 + c >= 0 && xw0 + c < W)
            cp_async4(k < 9 ? ring0.row(wr) + e : raux.row(wr) + c,
                      k < 9 ? g + k * plane + c : ga + c);
        }
      }
    }
    cp_async_commit();
  };

  // this thread's column of level s, inside the level and the grid; the
  // iterations [t_lo, t_hi) in which the level has a row inside the level
  // and the grid
  const int gx = xw0 + x;
  const bool col_in = gx >= max(xc - S + s, 0) && gx < min(xc + TW + S - s, W);
  const bool col_inner = gx >= 1 && gx <= W - 2;
  const int t_lo = max(s, -wy0) + 2 * s, t_hi = min(nrows - s, H - wy0) + 2 * s;
  // level S's stores: the unshifted centre, window rows [store_lo, store_hi)
  const bool store_col = gx >= xn && gx < min(xn + TW, W);
  const int store_lo = yn - wy0, store_hi = min(yn + TH, H) - wy0;
  // the block's window reaches the grid's edge: only then can it hold ring cells
  const bool edge = wy0 + 1 <= 0 || wy0 + nrows >= H || xc - S <= 0 || xc + TW + S >= W;
  __syncthreads();  // the scalar rows
  const Scalars& sc = ssc[s - 1];

  // level s's cell in window row wr, iteration t: the update, or (EDGE
  // only) at a ring cell the BC values of its inward neighbour's collide
  // output, the same collide code on the neighbour's inputs. Level s < S
  // stores into its ring, level S the unshifted centre into device memory.
  auto update = [&](auto edge_c, int wr) {
    const int gy = wy0 + wr;
    bool ring = false;
    RingPos rp{false, false, 0, 0};
    if (decltype(edge_c)::value) {
      ring = !(gy >= 1 && gy <= H - 2 && col_inner);
      if (ring) rp = k3_ring_pos(gy, gx, H, W);
    }
    Cell n;
    bool solid = k3_collide<OBST, WW>(src, raux, wr + rp.dy, x + rp.dx, sc, use_les, &n);
    if (decltype(edge_c)::value && ring) {
      Cell b = n;
      const bool vel = bc.left == LBM_BC_VEL_INLET || bc.left == LBM_BC_VEL_INLET_NEBB;
      k3_ring_bc(&b, rp, gx, W, sc, bc, vel ? prof[gy + rp.dy] : 0.0f);
      n = b;
      solid = __float_as_int(raux.row(wr)[x]) < 0;
    }
    if (s < S) {
      float* d = dst.row(wr) + x;
#pragma unroll
      for (int k = 0; k < 9; ++k) d[k * WW] = lbm_stored<OBST>(k, n.f, n.rho, solid);
    } else if ((K3_PROBE & 8) ? isnan(n.f[0]) : store_col && wr >= store_lo && wr < store_hi) {
      float* d = f_out + (size_t)gy * W + gx;
#pragma unroll
      for (int k = 0; k < 9; ++k) d[k * plane] = lbm_stored<OBST>(k, n.f, n.rho, solid);
    }
  };

  // the sweep; only blocks whose window reaches the grid's edge take the
  // ring's branches (a block-uniform choice)
  auto sweep = [&](auto edge_c) {
    for (int r = 0; r < K3_AHEAD; ++r) load_row(r);
    const int nt = TH + 3 * S;
    for (int t = 0; t < nt; ++t) {
      load_row(t + K3_AHEAD);
      if ((K3_PROBE & 4) == 0 && col_in && t >= t_lo && t < t_hi) {
        const int wr = t - 2 * s;
        if (!decltype(edge_c)::value || wy0 + wr != 0) update(edge_c, wr);
        // the bottom row, once level s - 1's rows 0 .. 2 are in
        if (decltype(edge_c)::value && wy0 + wr == 1 && wr - 1 >= s) update(edge_c, wr - 1);
      }
      cp_async_wait<K3_AHEAD>();
      if ((K3_PROBE & 2) == 0) __syncthreads();
    }
  };
  if (edge)
    sweep(Flag<true>{});
  else
    sweep(Flag<false>{});
}

// The window width a tile needs: 64 columns where TW + 2 S fits them, else 128.
static inline int k3_window_w(int S, int TW) { return TW + 2 * S <= 64 ? 64 : 128; }

// Opts the kernel into ``smem`` bytes of dynamic shared memory (above
// 48 KB), once per size: not a stream operation, so allowed while a CUDA
// graph captures the launch.
template <int OBST, int WW>
static cudaError_t opt_in(int smem) {
  static int opted = 0;
  if (smem <= opted) return cudaSuccess;
  const cudaError_t err = cudaFuncSetAttribute(
      k3_fused_kernel<OBST, WW>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err == cudaSuccess) opted = smem;
  return err;
}

template <int OBST, int WW>
static int launch(const void* f_in, void* f_out, const void* aux, const void* prof,
                  const ScalarRows& rows, int S, int H, int W, int TH, int TW,
                  const BcTypes& bc, int use_les, cudaStream_t stream) {
  const int smem = (int)(k3_smem_floats(S, WW) * sizeof(float));
  const cudaError_t err = opt_in<OBST, WW>(smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((W + TW - 1) / TW, (H + TH - 1) / TH, 1);
  const dim3 block(WW, S, 1);
  k3_fused_kernel<OBST, WW><<<grid, block, smem, stream>>>(
      static_cast<const float*>(f_in), static_cast<float*>(f_out),
      static_cast<const float*>(aux), static_cast<const float*>(prof), rows, S, H, W, TH,
      TW, bc, use_les);
  return static_cast<int>(cudaGetLastError());
}

template <int OBST>
static int launch_ww(const void* f_in, void* f_out, const void* aux, const void* prof,
                     const ScalarRows& rows, int S, int H, int W, int TH, int TW,
                     const BcTypes& bc, int use_les, cudaStream_t stream) {
  return k3_window_w(S, TW) == 64
             ? launch<OBST, 64>(f_in, f_out, aux, prof, rows, S, H, W, TH, TW, bc, use_les,
                                stream)
             : launch<OBST, 128>(f_in, f_out, aux, prof, rows, S, H, W, TH, TW, bc, use_les,
                                 stream);
}

// Launches K3 on ``stream``: S sub-steps of f_in -> f_out (distinct f32
// [9, H, W] buffers; every cell of f_out is written). ``scal`` is a host
// pointer to S scalar rows of 14 floats, copied into the launch
// parameters. The tile is TH x TW centre cells, TW + 2 S <= 128 (a window
// of 64 columns where TW + 2 S fits them, else 128).
// ``obst`` is LBM_OBST_EQ, _BOUNCE or _HALFWAY; ``prof`` ([H] f32) is read
// only for left types 3/4. Returns the CUDA error code, or
// cudaErrorInvalidValue for arguments the kernel does not take.
extern "C" int k3_fused_launch(const void* f_in, void* f_out, const void* aux,
                               const void* prof, const void* scal, int S, int H, int W,
                               int TH, int TW, int bc_left_t, int bc_top_t,
                               int bc_right_t, int bc_bottom_t, int use_les, int obst,
                               void* stream) {
  if (S < 1 || S > K3_MAX_STEPS || TH < 2 || TW < 2 || TW + 2 * S > 128 || H < 3 || W < 3)
    return static_cast<int>(cudaErrorInvalidValue);
  ScalarRows rows;
  for (int s = 0; s < S; ++s) rows.s[s] = load_scalars(static_cast<const float*>(scal) + 14 * s);
  for (int s = S; s < K3_MAX_STEPS; ++s) rows.s[s] = rows.s[0];
  const BcTypes bc{bc_left_t, bc_top_t, bc_right_t, bc_bottom_t};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (obst) {
    case LBM_OBST_EQ:
      return launch_ww<LBM_OBST_EQ>(f_in, f_out, aux, prof, rows, S, H, W, TH, TW, bc, use_les,
                                 st);
    case LBM_OBST_BOUNCE:
      return launch_ww<LBM_OBST_BOUNCE>(f_in, f_out, aux, prof, rows, S, H, W, TH, TW, bc,
                                     use_les, st);
    case LBM_OBST_HALFWAY:
      return launch_ww<LBM_OBST_HALFWAY>(f_in, f_out, aux, prof, rows, S, H, W, TH, TW, bc,
                                      use_les, st);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
