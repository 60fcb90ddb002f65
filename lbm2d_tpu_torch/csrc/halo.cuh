// The halo of a spatial mesh whose blocks live on the CUDA devices of one
// process: the port's counterpart of the collective-permute that XLA runs
// for the JAX package's _halo_update_padded
// (lbm2d_tpu/parallel/sharded.py:229-280, two lax.ppermute phases a step
// inside run_chunk_sharded_pallas). Not a pallas_call: the JAX package
// leaves the halo rows to XLA, and here there is no kernel of its own
// either: K1's _shard instances push each edge cell they store into the
// halo slots of the neighbours that read it (k1_step.cu k1_push), so a
// sharded step is one K1 launch a block.
//
// The push writes exactly what parallel/sharded.py exchange_halos writes
// after the step (its plain version, cuda_step.halo_exchange_plain: the x
// edges, then the y edges carrying the x halos just written), each block a
// [planes, hl + 2, pitch] buffer with a 1-cell halo ring. The map is the
// inverse of that pull: own cell (y, x), local row y in [0, hl) and column
// x in [0, wl), goes
//   on column wl - 1   to the right neighbour's column 0,
//   on column 0        to the left neighbour's column wl + 1,
//   on row hl - 1      to the block above's (iy + 1) row 0,
//   on row 0           to the block below's (iy - 1) row hl + 1,
//   on a corner        also to the diagonal block's corner halo slot,
// each at the same row (x pushes) or column (y pushes) of the stored plane,
// only where that neighbour exists. Every halo slot off the global edge has
// exactly one writer. A corner halo slot of a block side on the global edge
// -- the one exchange_halos' second hop copies from the neighbour's halo on
// the global edge -- has none, and keeps what the runner placed there (NaN,
// as in every halo on the global edge; no interior cell reads it).
//
// Ordering across devices (MeshDevs): a push of step i writes the buffer
// the neighbour read as its source at step i - 1 (a write after a read),
// and the neighbour's step i + 1 reads what it pushed (a read after a
// write), so each device's step i waits for its neighbours' step i - 1 and
// nothing else. Two events a device, picked by the step's parity: with one,
// a later device's wait could catch an earlier device's record of the same
// step and serialise the cards.
#pragma once

#include <cuda_runtime.h>

// the blocks a mesh may have (the host tables hold their pointers)
#define LBM_HALO_MAX_BLOCKS 64

// The f buffers of a block's eight neighbours, where a _shard launch pushes
// its edge cells: the block at (iy + dy, ix + dx) in slot shard_nbr_slot(dy,
// dx), null where there is none (past the global edge, or a launch that
// pushes nothing). Passed to the kernel by value.
struct ShardNbrs {
  void* p[8];
};

__host__ __device__ constexpr int shard_nbr_slot(int dy, int dx) {
  return (dy + 1) * 3 + (dx + 1) - ((dy + 1) * 3 + (dx + 1) > 4);
}

// Block b's neighbours in ``blocks`` (a host array of ry * rx pointers, row
// major).
static inline ShardNbrs shard_nbrs(void* const* blocks, int ry, int rx, int b) {
  ShardNbrs n{};
  const int iy = b / rx, ix = b % rx;
  for (int dy = -1; dy <= 1; ++dy)
    for (int dx = -1; dx <= 1; ++dx) {
      if (dy == 0 && dx == 0) continue;
      const int y = iy + dy, x = ix + dx;
      n.p[shard_nbr_slot(dy, dx)] =
          (y < 0 || y >= ry || x < 0 || x >= rx) ? nullptr : blocks[y * rx + x];
    }
  return n;
}

// The devices of a mesh's blocks and their streams, from host tables of one
// entry a block: ``devs`` the CUDA ordinals, ``streams`` each block's
// stream (one stream a device). On one device a step's launches queue on
// its stream in order and no runtime call is made. Across devices, step i
// on device d is enter(d, i) (d current, its stream waiting for its
// neighbouring devices' step i - 1: the 8-neighbourhood of their blocks, a
// symmetric relation), d's launches, leave(d, i) (its record of step i).
// open() records every device's queued work as step -1, so the first
// step's pushes land after whatever the caller queued on the neighbour's
// stream; close() makes each device's stream wait for its neighbours' last
// step, so the work torch queues next never races a push into its buffers.
struct MeshDevs {
  int nd = 0;                                           // distinct devices
  int ord[LBM_HALO_MAX_BLOCKS];                         // CUDA ordinal of device d
  cudaStream_t st[LBM_HALO_MAX_BLOCKS];                 // its stream
  int nblk[LBM_HALO_MAX_BLOCKS];                        // its blocks' count
  unsigned char blk[LBM_HALO_MAX_BLOCKS][LBM_HALO_MAX_BLOCKS];  // and indices
  unsigned long long nbr[LBM_HALO_MAX_BLOCKS];          // neighbour devices, a bit each
  cudaEvent_t ev[LBM_HALO_MAX_BLOCKS][2];               // its records, by step parity
  int home = -1;  // the caller's current device, across devices
  int last = -1;  // the last step recorded

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
        ev[nd][0] = ev[nd][1] = nullptr;
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
        cudaEventCreateWithFlags(&ev[d][0], cudaEventDisableTiming);
        cudaEventCreateWithFlags(&ev[d][1], cudaEventDisableTiming);
      }
    }
    return true;
  }

  // device d current (across devices); its stream
  cudaStream_t use(int d) const {
    if (nd > 1) cudaSetDevice(ord[d]);
    return st[d];
  }

  // device d's stream waits for its neighbours' records of step i
  void wait(int d, int i) const {
    for (int e = 0; e < nd; ++e)
      if (nbr[d] >> e & 1) cudaStreamWaitEvent(st[d], ev[e][i & 1], 0);
  }

  // every device's queued work recorded as step -1
  void open() {
    if (nd < 2) return;
    for (int d = 0; d < nd; ++d) {
      use(d);
      cudaEventRecord(ev[d][1], st[d]);
    }
    last = -1;
  }

  // step i on device d: d current, its stream after its neighbours' step i - 1
  cudaStream_t enter(int d, int i) const {
    const cudaStream_t s = use(d);
    if (nd > 1) wait(d, i - 1);
    return s;
  }

  // after device d's launches of step i
  void leave(int d, int i) {
    if (nd < 2) return;
    cudaEventRecord(ev[d][i & 1], st[d]);
    last = i;
  }

  // the closing waits, the events released (once their records complete),
  // the caller's device current again
  void close() {
    if (nd > 1 && ev[0][0] != nullptr) {
      for (int d = 0; d < nd; ++d) {
        use(d);
        wait(d, last);
      }
      for (int d = 0; d < nd; ++d) {
        cudaEventDestroy(ev[d][0]);
        cudaEventDestroy(ev[d][1]);
      }
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
