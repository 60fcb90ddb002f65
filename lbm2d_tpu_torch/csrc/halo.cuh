// The halo refresh of a spatial mesh whose blocks live on the CUDA devices
// of one process: the port's counterpart of the collective-permute that XLA
// runs for the JAX package's _halo_update_padded
// (lbm2d_tpu/parallel/sharded.py:229-280, two lax.ppermute phases a step
// inside run_chunk_sharded_pallas). Not a pallas_call: the JAX package
// leaves the halo rows to XLA.
//
// It writes exactly what parallel/sharded.py exchange_halos writes (its
// plain version), in one launch a device over that device's blocks and
// every plane of the ry x rx mesh, each block a [planes, hl + 2, pitch]
// buffer with a 1-cell halo ring:
//   x halos  rows 1 .. hl of column 0 (wl + 1) from the left (right)
//            neighbour's own column wl (1);
//   y halos  columns 0 .. wl + 1 of row 0 (hl + 1) from the lower (upper)
//            neighbour's row hl (1): its own cells, and at the two corner
//            columns what that neighbour's x halo holds once exchange_halos
//            has run its x phase -- the diagonal block's own cell where
//            there is one, else the neighbour's halo cell on the global
//            edge, which no phase writes;
//   nothing on a block side on the global edge.
// Every read is of a block's own cell or of a halo cell on the global edge,
// and every write is of a halo cell off it, so no thread reads what another
// writes: the two phases of exchange_halos need no order here. Elements move
// as raw 4-byte (f32) or 2-byte (bf16 deviations) words, NaN payloads
// included. A block pulls its halos: the launch on a device writes only its
// own blocks and reads its neighbours' edges where they live, over peer
// access when that is another card (NVLink on a host whose cards are joined
// all to all). MeshDevs orders the launches across devices with one event a
// device: a device's refresh waits for its neighbours' K1 of the step.
//
// Bound on an H100: a step moves 2 * planes * (2 hl + 2 (wl + 2)) elements
// a block (read and written), about 1.2 MB a step for f32 f at 4096^2 on a
// 2x2 mesh: well under a microsecond at the card's memory rate, so the
// launch itself bounds it. The x halos are strided (one element a row), so
// a warp's reads and writes of them touch 32 sectors; the y halos run along
// a row and coalesce. One launch a device replaces the
// 2 (ry (rx - 1) + rx (ry - 1)) strided copies exchange_halos issues a
// refresh.
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

// the blocks a mesh may have (the kernel's argument holds their pointers)
#define LBM_HALO_MAX_BLOCKS 64

struct HaloMesh {
  void* b[LBM_HALO_MAX_BLOCKS];                // block (iy, ix) at iy * rx + ix
  unsigned char sel[LBM_HALO_MAX_BLOCKS];      // the blocks a launch refreshes
  int ry, rx, hl, wl, pitch, planes, nsel;
};

// Thread t of block (iy, ix) = sel[blockIdx.z], plane blockIdx.y: halo
// cells 0 .. 2 hl - 1 are the left then right x halos, the next 2 (wl + 2)
// the bottom (row 0) then top (row hl + 1) y halos.
template <typename T>
__global__ void halo_kernel(const HaloMesh m) {
  const int blk = m.sel[blockIdx.z];
  const int iy = blk / m.rx, ix = blk % m.rx;
  const int hl = m.hl, wl = m.wl;
  int t = blockIdx.x * blockDim.x + threadIdx.x;
  int r, c, sb, sr, sc;  // destination row and column; source block, row, column
  if (t < 2 * hl) {
    const bool far = t >= hl;
    r = sr = (far ? t - hl : t) + 1;
    if (far) {
      if (ix + 1 >= m.rx) return;
      c = wl + 1;
      sb = blk + 1;
      sc = 1;
    } else {
      if (ix == 0) return;
      c = 0;
      sb = blk - 1;
      sc = wl;
    }
  } else {
    t -= 2 * hl;
    if (t >= 2 * (wl + 2)) return;
    const bool far = t >= wl + 2;
    c = sc = far ? t - (wl + 2) : t;
    int ny;
    if (far) {
      if (iy + 1 >= m.ry) return;
      r = hl + 1;
      ny = iy + 1;
      sr = 1;
    } else {
      if (iy == 0) return;
      r = 0;
      ny = iy - 1;
      sr = hl;
    }
    int nx = ix;
    if (c == 0 && ix > 0) {
      nx = ix - 1;
      sc = wl;
    } else if (c == wl + 1 && ix + 1 < m.rx) {
      nx = ix + 1;
      sc = 1;
    }
    sb = ny * m.rx + nx;
  }
  const size_t plane = (size_t)(hl + 2) * m.pitch * blockIdx.y;
  const T* src = static_cast<const T*>(m.b[sb]);
  T* dst = static_cast<T*>(m.b[blk]);
  dst[plane + (size_t)r * m.pitch + c] = src[plane + (size_t)sr * m.pitch + sc];
}

// The mesh of ``blocks`` (a host array of ry * rx device pointers, row
// major), every block selected; false for a shape the kernel does not take.
static inline bool halo_mesh(void* const* blocks, int ry, int rx, int hl, int wl, int pitch,
                             int planes, HaloMesh* m) {
  if (ry < 1 || rx < 1 || ry * rx > LBM_HALO_MAX_BLOCKS || hl < 1 || wl < 1 ||
      pitch < wl + 2 || planes < 1 || planes > 65535)
    return false;
  for (int i = 0; i < ry * rx; ++i) {
    if (blocks[i] == nullptr) return false;
    m->b[i] = blocks[i];
    m->sel[i] = static_cast<unsigned char>(i);
  }
  m->nsel = ry * rx;
  m->ry = ry;
  m->rx = rx;
  m->hl = hl;
  m->wl = wl;
  m->pitch = pitch;
  m->planes = planes;
  return true;
}

// One launch on ``stream`` (of the current device) refreshing the selected
// blocks; none on a 1x1 mesh. ``elem_bytes`` is 4 (f32) or 2 (bf16).
static inline void halo_launch(const HaloMesh& m, int elem_bytes, cudaStream_t stream) {
  if (m.ry * m.rx < 2 || m.nsel < 1) return;
  const int cells = 2 * m.hl + 2 * (m.wl + 2);
  const dim3 grid((cells + 255) / 256, m.planes, m.nsel);
  if (elem_bytes == 4)
    halo_kernel<uint32_t><<<grid, 256, 0, stream>>>(m);
  else
    halo_kernel<uint16_t><<<grid, 256, 0, stream>>>(m);
}

// The devices of a mesh's blocks and their streams, from host tables of one
// entry a block: ``devs`` the CUDA ordinals, ``streams`` each block's
// stream (one stream a device). On one device a step's launches queue on
// its stream in order. Across devices a step issues each device's K1
// launches and then record(d), its event; then, device by device, wait(d)
// makes its stream wait for the events of its neighbouring devices
// (8-neighbourhood of their blocks, a symmetric relation) before its halo
// launch reads the step's edges. Symmetry keeps every later write of a
// block's buffer behind its neighbours' reads of it, step after step.
// close() makes each device's stream wait for its neighbours' last
// refresh, so the work torch queues next on a stream never overwrites a
// buffer a neighbour is still reading.
struct MeshDevs {
  int nd = 0;                                           // distinct devices
  int ord[LBM_HALO_MAX_BLOCKS];                         // CUDA ordinal of device d
  cudaStream_t st[LBM_HALO_MAX_BLOCKS];                 // its stream
  int nblk[LBM_HALO_MAX_BLOCKS];                        // its blocks' count
  unsigned char blk[LBM_HALO_MAX_BLOCKS][LBM_HALO_MAX_BLOCKS];  // and indices
  unsigned long long nbr[LBM_HALO_MAX_BLOCKS];          // neighbour devices, a bit each
  cudaEvent_t ev[LBM_HALO_MAX_BLOCKS];
  int home = -1;  // the caller's current device, across devices

  // false for tables the mesh cannot take (a device with two streams)
  bool init(const int* devs, void* const* streams, int ry, int rx) {
    int of[LBM_HALO_MAX_BLOCKS];
    for (int b = 0; b < ry * rx; ++b) {
      const cudaStream_t s = static_cast<cudaStream_t>(streams[b]);
      int d = 0;
      while (d < nd && ord[d] != devs[b]) ++d;
      if (d == nd) {
        ord[nd] = devs[b];
        st[nd] = s;
        nblk[nd] = 0;
        nbr[nd] = 0;
        ev[nd] = nullptr;
        ++nd;
      } else if (st[d] != s) {
        return false;
      }
      of[b] = d;
      blk[d][nblk[d]++] = static_cast<unsigned char>(b);
    }
    for (int b = 0; b < ry * rx; ++b)
      for (int dy = -1; dy <= 1; ++dy)
        for (int dx = -1; dx <= 1; ++dx) {
          const int iy = b / rx + dy, ix = b % rx + dx;
          if (iy < 0 || iy >= ry || ix < 0 || ix >= rx) continue;
          const int e = of[iy * rx + ix];
          if (e != of[b]) nbr[of[b]] |= 1ull << e;
        }
    if (nd > 1) {  // one device makes no runtime call here (stream capture)
      cudaGetDevice(&home);
      for (int d = 0; d < nd; ++d) {
        cudaSetDevice(ord[d]);
        cudaEventCreateWithFlags(&ev[d], cudaEventDisableTiming);
      }
    }
    return true;
  }

  // device d current (across devices); its stream
  cudaStream_t use(int d) const {
    if (nd > 1) cudaSetDevice(ord[d]);
    return st[d];
  }

  // after device d's launches of a step, device d current
  void record(int d) const {
    if (nd > 1) cudaEventRecord(ev[d], st[d]);
  }

  // device d's stream waits for its neighbours' last records, device d current
  void wait(int d) const {
    if (nd < 2) return;
    for (int e = 0; e < nd; ++e)
      if (nbr[d] >> e & 1) cudaStreamWaitEvent(st[d], ev[e], 0);
  }

  // The part of ``m`` that device d refreshes: its own blocks.
  HaloMesh part(const HaloMesh& m, int d) const {
    HaloMesh p = m;
    p.nsel = nblk[d];
    for (int k = 0; k < nblk[d]; ++k) p.sel[k] = blk[d][k];
    return p;
  }

  // One refresh of ``m``'s blocks, each device's stream after its
  // neighbours' queued work: a launch a device.
  void refresh(const HaloMesh& m, int elem_bytes) const {
    for (int d = 0; d < nd; ++d) {
      use(d);
      record(d);
    }
    for (int d = 0; d < nd; ++d) {
      const cudaStream_t s = use(d);
      wait(d);
      halo_launch(part(m, d), elem_bytes, s);
    }
  }

  // the closing waits, the events released (once their records complete),
  // the caller's device current again
  void close() {
    if (nd > 1 && ev[0] != nullptr) {
      for (int d = 0; d < nd; ++d) {
        use(d);
        record(d);
      }
      for (int d = 0; d < nd; ++d) {
        use(d);
        wait(d);
      }
      for (int d = 0; d < nd; ++d) cudaEventDestroy(ev[d]);
    }
    nd = 0;
    if (home >= 0) cudaSetDevice(home);
  }
  ~MeshDevs() { close(); }
};

// Peer access from every device in ``devs`` (n CUDA ordinals) to every
// other: 0, or the CUDA error of a pair that has none (cudaErrorPeerAccessUnsupported).
// Access already enabled counts as enabled. The caller's device stays current.
static inline int mesh_peers(const int* devs, int n) {
  int home = 0;
  cudaGetDevice(&home);
  int rc = 0;
  for (int i = 0; i < n && rc == 0; ++i)
    for (int j = 0; j < n && rc == 0; ++j) {
      if (devs[i] == devs[j]) continue;
      int can = 0;
      cudaDeviceCanAccessPeer(&can, devs[i], devs[j]);
      if (!can) {
        rc = static_cast<int>(cudaErrorPeerAccessUnsupported);
        break;
      }
      cudaSetDevice(devs[i]);
      const cudaError_t e = cudaDeviceEnablePeerAccess(devs[j], 0);
      if (e != cudaSuccess && e != cudaErrorPeerAccessAlreadyEnabled) rc = static_cast<int>(e);
      cudaGetLastError();  // clear AlreadyEnabled
    }
  cudaSetDevice(home);
  return rc;
}
