// Bucketed packed-key segment-min for Hopper (sm_90a):
//
//     out[b * block_rows + r] = min{ keys[b, e] : rows[b, e] == r },
//
// 0xFFFFFFFF at empty rows, over edges pre-grouped by output row block
// (host-side layout: kernels/ops.py::bucket_edges_by_row_block, NB buckets
// of BE entries each, padded with identity keys).
//
// Replaces the TPU kernel segment_min_bucketed_pallas (_kernel) in
// src/repro/kernels/segment_min_bucketed.py. Having no vector scatter, the
// TPU kernel compares every entry of its bucket with every row of the block,
// a (block_rows, BE) compare-broadcast-min per grid step. Hopper has
// shared-memory atomics, so each entry is one write instead.
//
// Bound on the card: bytes. Every entry's 8-byte key is read once, padding
// included (NB * BE * 8 B); a 4-byte row is needed only where the key is not
// the identity (E * 4 B), since an identity key changes no slot; the output
// is written once (NB * block_rows * 8 B). On the 1024 x 1024 grid
// (NB = 8,192, BE = 512, E = 4,190,208, 99.9% filled) that is 58.7 MB,
// 0.0175 ms at 3.35 TB/s; on R-MAT scale 14, edge factor 8 (NB = 128,
// BE = 27,264, E = 228,456, 6.5% filled) 29.0 MB, 0.0086 ms.
//
// Design. A block holds the output slots of its buckets as 64-bit words in
// dynamic shared memory, set to the identity; its threads stride over the
// block's entries, kUnroll independent key loads at a time, read an entry's
// row only under a live key, and do a shared-memory 64-bit atomicMin on the
// row's slot. Rows outside [0, block_rows), negative ones included, are
// dropped, as the reference's compare drops them. How the layout is cut
// into blocks is chosen by the wrapper (kernels/ops.py::bucketed_split) and
// passed in:
//  - buckets_per_block >= 1, chunks = 1 (narrow buckets, as on the grid):
//    one block reduces that many whole buckets, so that the fixed cost of
//    setting and writing its slots is spread over about 4K entries, and
//    stores its slots straight to out, which it alone owns.
//  - chunks > 1, one bucket per block (a few wide buckets, as on R-MAT,
//    where one block per bucket leaves SMs idle and streams each bucket
//    alone): the bucket's entries are cut into `chunks` ranges, one block
//    each, launched as one thread-block cluster of at most 8 blocks. After
//    a cluster barrier each block takes the minimum over the cluster's slot
//    arrays (read through distributed shared memory) for its share of the
//    rows and stores them; a second barrier keeps every block's slots alive
//    until the others have read them. No fill of out and no global atomics.
// Measured with chip_smoke.py on an H100 80GB HBM3 at 700 W: 0.0230 ms on
// the grid (76% of the bound; one block per bucket took 0.0278) and 0.0201
// ms on R-MAT s14 (43%; 0.0310 before). R-MAT's layout streams at about
// half the card's rate: reading the slot before the atomic, loading the
// next step's keys before this step's rows, more or fewer keys in flight
// per thread, and clusters of 16 blocks were all tried on the card and
// none was faster.
// A launch whose slots exceed the card's opt-in shared memory per block is
// refused with cudaErrorInvalidValue; above 48 KB the launch opts in first.
//
// Keys are int64 tensors holding uint32 pack32 values (torch on the CPU has
// no uint32 min-reduction); read as unsigned 64-bit they order the same way.
//
// The kernel launches on the caller's stream; the C entry point returns
// cudaGetLastError() (or the launch's own error) so that a refused launch is
// reported.

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr unsigned long long kIdentity = 0xFFFFFFFFull;
constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kMaxCluster = 8;  // the portable cluster size
constexpr int kDefaultSharedBytes = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
segment_min_bucketed_kernel(const unsigned long long* __restrict__ keys,
                            const int32_t* __restrict__ rows, unsigned long long* __restrict__ out,
                            long long nb, long long be, int block_rows, int chunks,
                            int buckets_per_block) {
  extern __shared__ unsigned long long slot[];
  // This block's entries [lo, hi) of the flattened layout, and the first
  // bucket they belong to.
  long long bucket0, lo, hi;
  int nbuckets;
  if (chunks > 1) {
    bucket0 = blockIdx.x / chunks;
    const long long c = blockIdx.x % chunks;
    const long long width = (be + chunks - 1) / chunks;
    const long long e0 = c * width < be ? c * width : be;
    const long long e1 = e0 + width < be ? e0 + width : be;
    lo = bucket0 * be + e0;
    hi = bucket0 * be + e1;
    nbuckets = 1;
  } else {
    bucket0 = static_cast<long long>(blockIdx.x) * buckets_per_block;
    nbuckets = static_cast<int>(nb - bucket0 < buckets_per_block ? nb - bucket0
                                                                  : buckets_per_block);
    lo = bucket0 * be;
    hi = lo + nbuckets * be;
  }
  const int nslots = nbuckets * block_rows;
  for (int r = threadIdx.x; r < nslots; r += kThreads) slot[r] = kIdentity;
  __syncthreads();

  const long long base = bucket0 * be;  // where the block's first bucket starts
  for (long long f0 = lo + threadIdx.x; f0 < hi; f0 += static_cast<long long>(kThreads) * kUnroll) {
    unsigned long long k[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long f = f0 + u * kThreads;
      k[u] = f < hi ? __ldcs(keys + f) : kIdentity;
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      if (k[u] >= kIdentity) continue;
      const long long f = f0 + u * kThreads;
      const int r = __ldcs(rows + f);
      if (r < 0 || r >= block_rows) continue;
      // The bucket within the block (a 32-bit division: the wrapper keeps a
      // block of several buckets below 2^31 entries).
      const int j =
          buckets_per_block > 1
              ? static_cast<int>(static_cast<unsigned>(f - base) / static_cast<unsigned>(be))
              : 0;
      atomicMin(slot + j * block_rows + r, k[u]);
    }
  }

  if (chunks > 1) {
    cg::cluster_group cluster = cg::this_cluster();
    cluster.sync();
    const int rank = static_cast<int>(cluster.block_rank());
    unsigned long long* o = out + bucket0 * block_rows;
    for (int r = rank * kThreads + threadIdx.x; r < block_rows; r += chunks * kThreads) {
      unsigned long long v = kIdentity;
      for (int q = 0; q < chunks; ++q) {
        const unsigned long long w = cluster.map_shared_rank(slot, q)[r];
        v = w < v ? w : v;
      }
      o[r] = v;
    }
    cluster.sync();  // keep this block's slots alive until the cluster has read them
  } else {
    __syncthreads();
    unsigned long long* o = out + bucket0 * block_rows;
    for (int r = threadIdx.x; r < nslots; r += kThreads) o[r] = slot[r];
  }
}

}  // namespace

extern "C" int segment_min_bucketed_launch(const void* keys, const void* rows, void* out,
                                           long long nb, long long be, long long block_rows,
                                           long long chunks, long long buckets_per_block,
                                           void* stream) {
  if (nb <= 0 || be <= 0 || block_rows <= 0 || block_rows > 0x7FFFFFFFLL || chunks < 1 ||
      chunks > kMaxCluster || buckets_per_block < 1 || (chunks > 1 && buckets_per_block > 1) ||
      (buckets_per_block > 1 && buckets_per_block * be > 0x7FFFFFFFLL)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const long long blocks =
      chunks > 1 ? nb * chunks : (nb + buckets_per_block - 1) / buckets_per_block;
  if (blocks > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = (buckets_per_block < nb ? buckets_per_block : nb) * block_rows *
                         static_cast<long long>(sizeof(unsigned long long));
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSharedBytes) {
    err = cudaFuncSetAttribute(segment_min_bucketed_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  cudaLaunchConfig_t config = {};
  config.gridDim = dim3(static_cast<unsigned int>(blocks), 1, 1);
  config.blockDim = dim3(kThreads, 1, 1);
  config.dynamicSmemBytes = static_cast<size_t>(smem);
  config.stream = static_cast<cudaStream_t>(stream);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = static_cast<unsigned int>(chunks);
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  config.attrs = attr;
  config.numAttrs = 1;
  err = cudaLaunchKernelEx(&config, segment_min_bucketed_kernel,
                           static_cast<const unsigned long long*>(keys),
                           static_cast<const int32_t*>(rows),
                           static_cast<unsigned long long*>(out), nb, be,
                           static_cast<int>(block_rows), static_cast<int>(chunks),
                           static_cast<int>(buckets_per_block));
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_min_bucketed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
