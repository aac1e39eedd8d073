// Flat packed-key segment-min for Hopper (sm_90a):
//
//     out[s] = min{ keys[e] : segs[e] == s },  0xFFFFFFFF at empty segments.
//
// Replaces the TPU kernel segment_min_flat_pallas (_flat_kernel) in
// src/repro/kernels/segment_min_bucketed.py. Having no vector scatter, the
// TPU kernel rescans every edge block for each 128-row output block,
// O(num_segments / 128 * E) compares, carrying the running minimum across
// its sequential grid. Hopper has atomics in L2, so this kernel makes one
// grid-stride pass over the edges instead: each edge whose key is not the
// identity and whose segment lies in [0, num_segments) does a 64-bit
// atomicMin on out[seg]. Ids out of range are dropped, as
// jax.ops.segment_min drops them.
//
// Bound on the card: bytes. Every edge reads an 8-byte key and a 4-byte
// segment id once (12 B per edge) and the output is written once (8 B per
// segment): about 201 MB, 60 us at 3.35 TB/s, at the R-MAT scale-20 main
// path shape (16,085,642 edges, 2^20 segments). The compares are
// negligible. The atomics resolve in L2 (the 8 MB output fits in the 50 MB
// L2), and a read of out[seg] through L2 before each atomic skips the edges
// that cannot lower the minimum: values only decrease, so a stale read is
// never too low. That keeps a heavily skewed segment from serialising
// every edge on one address.
//
// Keys are int64 tensors holding uint32 pack32 values (torch on the CPU
// has no uint32 min-reduction); read as unsigned 64-bit they order the
// same way. Narrowing them to 32 bits would cut the key bytes in half.
//
// Both kernels launch on the caller's stream; the C entry point returns
// cudaGetLastError() so that a refused launch is reported.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kIdentity = 0xFFFFFFFFull;
constexpr int kThreads = 256;
constexpr int kMaxThreadsPerSm = 2048;

__global__ void fill_identity_kernel(unsigned long long* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = kIdentity;
  }
}

__global__ void segment_min_flat_kernel(const unsigned long long* __restrict__ keys,
                                        const int32_t* __restrict__ segs,
                                        unsigned long long* out, long long num_edges,
                                        long long num_segments) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long e = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
       e < num_edges; e += stride) {
    const unsigned long long k = keys[e];
    const long long s = segs[e];
    if (k >= kIdentity || s < 0 || s >= num_segments) continue;
    if (k < __ldcg(out + s)) atomicMin(out + s, k);
  }
}

unsigned int blocks_for(long long work, long long max_blocks) {
  const long long b = (work + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(b < max_blocks ? b : max_blocks);
}

}  // namespace

extern "C" int segment_min_flat_launch(const void* keys, const void* segs, void* out,
                                       long long num_edges, long long num_segments,
                                       void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  // One resident wave: the grid-stride loops cover the rest.
  const long long max_blocks = static_cast<long long>(sms) * (kMaxThreadsPerSm / kThreads);
  auto* o = static_cast<unsigned long long*>(out);
  if (num_segments > 0) {
    fill_identity_kernel<<<blocks_for(num_segments, max_blocks), kThreads, 0, st>>>(
        o, num_segments);
    if (num_edges > 0) {
      segment_min_flat_kernel<<<blocks_for(num_edges, max_blocks), kThreads, 0, st>>>(
          static_cast<const unsigned long long*>(keys), static_cast<const int32_t*>(segs), o,
          num_edges, num_segments);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_min_flat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
