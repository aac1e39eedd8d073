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
// Design. One block per bucket. The block holds its block_rows output slots
// as 64-bit words in dynamic shared memory, set to the identity; its threads
// stride over the bucket's BE entries with coalesced loads, and every entry
// whose key is not the identity and whose row lies in [0, block_rows) does a
// shared-memory 64-bit atomicMin on its row's slot. Rows outside the block,
// negative ones included, are dropped, as the reference's compare drops
// them. Then the block writes its block_rows slots out. A block_rows whose
// slots exceed the card's opt-in shared memory per block is refused with
// cudaErrorInvalidValue; above 48 KB the launch opts in first.
//
// Bound on the card: bytes. Every entry's 8-byte key is read once, padding
// included (NB * BE * 8 B); a 4-byte row is needed only where the key is not
// the identity (E * 4 B), since an identity key changes no slot; the output
// is written once (NB * block_rows * 8 B). On the 1024 x 1024 grid
// (NB = 8,192, BE = 512, E = 4,190,208, 99.9% filled) that is 58.7 MB,
// 0.0175 ms at 3.35 TB/s; on R-MAT scale 14, edge factor 8 (NB = 128,
// BE = 27,264, E = 228,456, 6.5% filled) 29.0 MB, 0.0086 ms. This kernel
// reads every row, padding included (12 B per entry), so on R-MAT it moves
// 1.45x the bound's bytes. The layout pads every bucket to the widest one, so
// on R-MAT most of what the kernel reads is padding, and a hub row's entries
// all meet on one shared-memory slot; the atomics on that slot serialise.
//
// Keys are int64 tensors holding uint32 pack32 values (torch on the CPU has
// no uint32 min-reduction); read as unsigned 64-bit they order the same way.
//
// The kernel launches on the caller's stream; the C entry point returns
// cudaGetLastError() so that a refused launch is reported.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kIdentity = 0xFFFFFFFFull;
constexpr int kThreads = 512;
constexpr int kDefaultSharedBytes = 48 * 1024;

__global__ void __launch_bounds__(kThreads)
segment_min_bucketed_kernel(const unsigned long long* __restrict__ keys,
                            const int32_t* __restrict__ rows, unsigned long long* __restrict__ out,
                            long long be, int block_rows) {
  extern __shared__ unsigned long long slot[];
  for (int r = threadIdx.x; r < block_rows; r += kThreads) slot[r] = kIdentity;
  __syncthreads();
  const long long base = static_cast<long long>(blockIdx.x) * be;
#pragma unroll 4
  for (long long e = threadIdx.x; e < be; e += kThreads) {
    const unsigned long long k = keys[base + e];
    const int r = rows[base + e];
    if (k < kIdentity && r >= 0 && r < block_rows) atomicMin(slot + r, k);
  }
  __syncthreads();
  unsigned long long* o = out + static_cast<long long>(blockIdx.x) * block_rows;
  for (int r = threadIdx.x; r < block_rows; r += kThreads) o[r] = slot[r];
}

}  // namespace

extern "C" int segment_min_bucketed_launch(const void* keys, const void* rows, void* out,
                                           long long nb, long long be, long long block_rows,
                                           void* stream) {
  if (nb <= 0 || nb > 0x7FFFFFFFLL || be <= 0 || block_rows <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  int dev = 0;
  int optin = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long smem = block_rows * static_cast<long long>(sizeof(unsigned long long));
  if (smem > optin) return static_cast<int>(cudaErrorInvalidValue);
  if (smem > kDefaultSharedBytes) {
    err = cudaFuncSetAttribute(segment_min_bucketed_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  segment_min_bucketed_kernel<<<static_cast<unsigned int>(nb), kThreads, static_cast<size_t>(smem),
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const unsigned long long*>(keys), static_cast<const int32_t*>(rows),
      static_cast<unsigned long long*>(out), be, static_cast<int>(block_rows));
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_min_bucketed_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
