// Sorted packed-key segment-min for Hopper (sm_90a):
//
//     out[s] = min{ keys[e] : segs[e] == s },  0xFFFFFFFF at empty segments,
//
// for segment ids that are non-decreasing, so that every segment is one
// contiguous run of edges: the coarsening dedupe's segment ids, a prefix
// sum over boundary flags of the sorted pair keys (num_segments = E).
//
// Replaces the TPU kernel segment_min_sorted_pallas (_sorted_kernel, with
// its step maps from build_step_maps) in src/repro/kernels/segment_min_sorted.py.
// That kernel walks a staircase of (row block, edge block) pairs whose
// offsets are scalar-prefetched, and carries a VMEM output tile across
// consecutive steps of its sequential grid. Blocks on the card run in no
// order, so nothing is carried: each block reduces one tile of
// kItems * kThreads consecutive edges on its own.
//
// Design. Each thread reduces kItems consecutive edges in registers. A run
// that starts and ends inside the thread is written at once; the thread's
// last run is its carry. A warp then does a segmented min over the 32
// carries with shuffles (a lane takes the value of lane + d only when the
// two hold the same segment id), and the first lane of each group of equal
// ids writes the group's minimum. Every write is a 64-bit atomicMin after a
// read through L2 that skips writes which cannot lower the value. Runs are
// contiguous, so the kernel issues about one atomic per segment plus one
// per warp, and they hardly ever meet on one address. Identity keys and ids
// outside [0, num_segments) contribute nothing. Unsorted ids still give the
// exact minimum, with more atomics: a group of equal ids is combined only
// where it is contiguous, and every lane's value reaches the atomic of its
// own contiguous group.
//
// Bound on the card: bytes. Every edge reads an 8-byte key and a 4-byte
// segment id once (12 B per edge) and the output is written once (8 B per
// segment). At the dedupe of level 0 of the 1024 x 1024 grid (E = 2^21,
// num_segments = E) that is 41.9 MB, 12.5 us at 3.35 TB/s; on R-MAT scale
// 19, edge factor 8 (E = 2^22) 83.9 MB, 25 us.
//
// Keys are int64 tensors holding uint32 pack32 values (torch on the CPU
// has no uint32 min-reduction); read as unsigned 64-bit they order the
// same way.
//
// Both kernels launch on the caller's stream; the C entry point returns
// cudaGetLastError() so that a refused launch is reported.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kIdentity = 0xFFFFFFFFull;
constexpr int kThreads = 256;
constexpr int kItems = 4;
constexpr long long kTile = static_cast<long long>(kThreads) * kItems;
constexpr int kMaxThreadsPerSm = 2048;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

__global__ void fill_identity_kernel(unsigned long long* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = kIdentity;
  }
}

// A run's minimum into out[s]; identity values (which include every id out
// of range, see below) write nothing.
__device__ __forceinline__ void flush(unsigned long long* out, int s, unsigned long long v) {
  if (v < kIdentity && v < __ldcg(out + s)) atomicMin(out + s, v);
}

__global__ void __launch_bounds__(kThreads)
segment_min_sorted_kernel(const unsigned long long* __restrict__ keys,
                          const int32_t* __restrict__ segs, unsigned long long* out,
                          long long num_edges, long long num_segments) {
  const long long base = static_cast<long long>(blockIdx.x) * kTile +
                         static_cast<long long>(threadIdx.x) * kItems;
  int cur_seg = -1;
  unsigned long long cur_min = kIdentity;
#pragma unroll
  for (int i = 0; i < kItems; ++i) {
    const long long e = base + i;
    int s = -1;  // past the end: an empty run
    unsigned long long k = kIdentity;
    if (e < num_edges) {
      s = segs[e];
      k = keys[e];
      // An id out of range keeps its place in the run structure but
      // carries the identity, so it is never written.
      if (k > kIdentity || s < 0 || s >= num_segments) k = kIdentity;
    }
    if (i == 0 || s == cur_seg) {
      cur_seg = s;
      cur_min = k < cur_min ? k : cur_min;
    } else {
      flush(out, cur_seg, cur_min);  // a run that ended inside this thread
      cur_seg = s;
      cur_min = k;
    }
  }

  // Segmented min of the carries over the warp: after the loop, each lane
  // holds the minimum of its contiguous group of equal ids from itself on.
  const int lane = threadIdx.x & 31;
  unsigned long long v = cur_min;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const unsigned long long ov = __shfl_down_sync(kFullMask, v, d);
    const int os = __shfl_down_sync(kFullMask, cur_seg, d);
    if (lane + d < 32 && os == cur_seg && ov < v) v = ov;
  }
  const int prev_seg = __shfl_up_sync(kFullMask, cur_seg, 1);
  if (lane == 0 || prev_seg != cur_seg) flush(out, cur_seg, v);
}

unsigned int blocks_for(long long work, long long max_blocks) {
  const long long b = (work + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(b < max_blocks ? b : max_blocks);
}

}  // namespace

extern "C" int segment_min_sorted_launch(const void* keys, const void* segs, void* out,
                                         long long num_edges, long long num_segments,
                                         void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  auto* o = static_cast<unsigned long long*>(out);
  if (num_segments > 0) {
    // One resident wave for the fill: its grid-stride loop covers the rest.
    const long long max_blocks = static_cast<long long>(sms) * (kMaxThreadsPerSm / kThreads);
    fill_identity_kernel<<<blocks_for(num_segments, max_blocks), kThreads, 0, st>>>(
        o, num_segments);
    if (num_edges > 0) {
      const long long tiles = (num_edges + kTile - 1) / kTile;
      if (tiles > 0x7FFFFFFFLL) return static_cast<int>(cudaErrorInvalidValue);
      segment_min_sorted_kernel<<<static_cast<unsigned int>(tiles), kThreads, 0, st>>>(
          static_cast<const unsigned long long*>(keys), static_cast<const int32_t*>(segs), o,
          num_edges, num_segments);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_min_sorted_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
