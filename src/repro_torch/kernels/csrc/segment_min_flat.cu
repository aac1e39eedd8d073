// Flat packed-key segment-min for Hopper (sm_90a):
//
//     out[s] = min{ keys[e] : segs[e] == s },  0xFFFFFFFF at empty segments.
//
// Replaces the TPU kernel segment_min_flat_pallas (_flat_kernel) in
// src/repro/kernels/segment_min_bucketed.py. Having no vector scatter, the
// TPU kernel rescans every edge block for each 128-row output block,
// O(num_segments / 128 * E) compares, carrying the running minimum across
// its sequential grid. Hopper has atomics in L2, so this kernel makes one
// pass over the edges and merges into out with 64-bit atomicMin. Ids
// outside [0, num_segments) are dropped, as jax.ops.segment_min drops them.
//
// Bound on the card: bytes. Every edge's 8-byte key is read once; its
// 4-byte id is needed only under a live (non-identity) key, since an
// identity key changes no segment whatever its id; the output is written
// once (8 B per segment). On the R-MAT scale-20 flat main path (16,085,642
// edges a round, 2^20 segments) that is 41-60 us a round at 3.35 TB/s,
// from 60.1 us in round 1 (every key live) to 40.9 us in the last (none).
//
// What held the first design (one edge per thread per grid-stride step,
// each live edge a dependent L2 read of out[s] and then perhaps an
// atomicMin) back, and what this one does about it:
//  (a) Too little in flight. Each lane of a warp owns kVec = 4 consecutive
//      edges per slot and kSlots = 2 slots a step: two 16-byte key loads
//      and one 16-byte id load per slot, streamed past L1 and marked
//      evict-first in L2 so that they do not push out the output. The next
//      step's keys are loaded before this step's ids, reads and atomics.
//  (b) Random L2 traffic. An id is loaded only when one of its group's
//      keys is live (rounds late in a solve are almost all identity), and
//      fewer pieces reach L2: a lane hands its last edge to the next lane
//      when the next lane's first edge has the same id (runs of equal ids
//      cross lanes), and folds its own equal ids together.
//  (c) Contention on hot roots. From the second round on, most live edges
//      meet on a few thousand roots, one of them holding 2.1M edges,
//      scattered over the edge order. Each block (one per SM, 1,024
//      threads) keeps a direct-mapped cache in shared memory of (id, a
//      value that out[id] is known to reach): the least value it has sent
//      or read for that id. A piece not below its id's cached value is
//      dropped. Any other piece reads out[s] through L2 first and issues
//      the atomicMin only if its value is lower (values only decrease, so a
//      stale read is never too low); reads of one hot address are cheaper
//      than atomics on it.
// Tried on the card and dropped: grouping equal ids across the warp with
// __match_any_sync and __reduce_min_sync (tripled the grid's first round),
// and sending without the read on a cache miss (much slower on R-MAT's
// second round: the hot roots outnumber the cache and evict each other).
//
// Measured with chip_smoke.py on an H100 80GB HBM3 at 700 W, device time
// per R-MAT s20 round (bound in brackets): 0.141 (0.060), 0.110 (0.058),
// 0.075 (0.046), 0.053 (0.041), 0.049 (0.041) ms; mean 0.085 ms, 58% of
// the bound (the first design: 0.174 ms, 28%). Rounds 1-2 stay bound by
// their L2 reads and atomics. On the 1024 x 1024 grid's 11
// rounds, 0.018-0.041 ms: the first five up to 0.0075 ms slower than the
// first design (the read before the atomic seldom saves one there), the
// rest faster, 1.7% slower over the solve.
//
// Alignment. The warp body reads keys as ulonglong2 and ids as int4, so it
// starts at the first edge `head` (< 4, chosen by the wrapper: see
// kernels/ops.py::flat_layout) at which the key pointer is 16-byte aligned
// and, when the two pointers allow it, the id pointer too (vec_ids); where
// they cannot both be aligned (a view such as segs[1:] beside keys[0:]),
// the ids are read one by one. The head edges and the ragged tail (< 4
// edges) are handled one edge per lane by the first warp.
//
// Keys are int64 tensors holding uint32 pack32 values (torch on the CPU
// has no uint32 min-reduction); read as unsigned 64-bit they order the
// same way, and any value from 0xFFFFFFFF up contributes nothing.
//
// Both kernels launch on the caller's stream; the C entry point returns
// cudaGetLastError() so that a refused launch is reported.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kIdentity = 0xFFFFFFFFull;
constexpr unsigned kDead = 0xFFFFFFFFu;  // the identity as a 32-bit key
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kThreads = 1024;  // one block per SM shares one cache
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                          // consecutive edges per lane per slot
constexpr int kSlots = 2;                        // slots per warp step
constexpr int kGroupsPerStep = 32 * kSlots;      // 4-edge groups per warp step
constexpr int kMaxThreadsPerSm = 2048;
constexpr int kCacheBits = 12;  // 4,096 cached ids per block, 32 KB
constexpr int kCacheSlots = 1 << kCacheBits;
constexpr unsigned long long kEmptySlot = ~0ull;  // no id is 0xFFFFFFFF

__global__ void fill_identity_kernel(unsigned long long* __restrict__ out, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = kIdentity;
  }
}

// One edge on its own (the head and tail).
__device__ __forceinline__ void single_edge(const unsigned long long* __restrict__ keys,
                                            const int32_t* __restrict__ segs,
                                            unsigned long long* out, long long e,
                                            int num_segments) {
  const unsigned long long k = keys[e];
  if (k >= kIdentity) return;
  const int s = segs[e];
  if (s >= 0 && s < num_segments) atomicMin(out + s, k);
}

__device__ __forceinline__ unsigned cache_slot(int s) {
  return (static_cast<unsigned>(s) * 2654435761u) >> (32 - kCacheBits);
}

struct StepKeys {
  ulonglong2 k[kSlots][2];  // the lane's 4 keys of each slot
};

// The keys of warp step `step` for this lane; groups past the end read as
// the identity.
__device__ __forceinline__ void load_keys(const ulonglong2* __restrict__ kb, long long ngroups,
                                          long long step, int lane, StepKeys& out) {
#pragma unroll
  for (int j = 0; j < kSlots; ++j) {
    const long long g = step * kGroupsPerStep + j * 32 + lane;
    if (g < ngroups) {
      out.k[j][0] = __ldcs(kb + 2 * g);
      out.k[j][1] = __ldcs(kb + 2 * g + 1);
    } else {
      out.k[j][0] = make_ulonglong2(kIdentity, kIdentity);
      out.k[j][1] = make_ulonglong2(kIdentity, kIdentity);
    }
  }
}

__device__ __forceinline__ unsigned key32(unsigned long long k) {
  return k < kIdentity ? static_cast<unsigned>(k) : kDead;
}

template <bool kVecIds>
__global__ void __launch_bounds__(kThreads)
segment_min_flat_kernel(const unsigned long long* __restrict__ keys,
                        const int32_t* __restrict__ segs, unsigned long long* out,
                        long long num_edges, int num_segments, int head) {
  // cache[h]: (id << 32 | v) for the last id of slot h, v the least value
  // this block has sent or read for it; out[id] will end at or below v.
  __shared__ unsigned long long cache[kCacheSlots];
  for (int i = threadIdx.x; i < kCacheSlots; i += kThreads) cache[i] = kEmptySlot;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long ngroups = (num_edges - head) / kVec;
  const long long nsteps = (ngroups + kGroupsPerStep - 1) / kGroupsPerStep;
  const auto* kb = reinterpret_cast<const ulonglong2*>(keys + head);
  const int32_t* sb = segs + head;

  if (blockIdx.x == 0 && threadIdx.x < 32) {
    // The head edges (lanes 0..head-1) and the ragged tail (lanes 4..7).
    const long long tail0 = head + ngroups * kVec;
    if (lane < head) single_edge(keys, segs, out, lane, num_segments);
    if (lane >= 4 && lane < 8 && tail0 + (lane - 4) < num_edges)
      single_edge(keys, segs, out, tail0 + (lane - 4), num_segments);
  }

  const long long wstride = static_cast<long long>(gridDim.x) * kWarps;
  long long step = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  StepKeys cur;
  if (step < nsteps) load_keys(kb, ngroups, step, lane, cur);
  for (; step < nsteps; step += wstride) {
    StepKeys nxt;
    if (step + wstride < nsteps) load_keys(kb, ngroups, step + wstride, lane, nxt);

    // The lane's edges: position j * kVec + i is edge i of its group in slot j.
    constexpr int kEdges = kSlots * kVec;
    unsigned k[kEdges];
    int s[kEdges];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      unsigned* kj = k + j * kVec;
      int* sj = s + j * kVec;
      kj[0] = key32(cur.k[j][0].x);
      kj[1] = key32(cur.k[j][0].y);
      kj[2] = key32(cur.k[j][1].x);
      kj[3] = key32(cur.k[j][1].y);
      const long long g = step * kGroupsPerStep + j * 32 + lane;
      const bool any = (kj[0] & kj[1] & kj[2] & kj[3]) != kDead;
      if (kVecIds) {
        int4 v = make_int4(-1, -1, -1, -1);
        if (any) v = __ldcs(reinterpret_cast<const int4*>(sb) + g);
        sj[0] = v.x;
        sj[1] = v.y;
        sj[2] = v.z;
        sj[3] = v.w;
      } else {
#pragma unroll
        for (int i = 0; i < kVec; ++i) sj[i] = kj[i] != kDead ? __ldcs(sb + kVec * g + i) : -1;
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        if (sj[i] < 0 || sj[i] >= num_segments) {
          kj[i] = kDead;
          sj[i] = -1;
        }
      }
      // A run of equal ids that crosses from this lane into the next: the
      // next lane takes this lane's last edge into its first.
      const int prev_s = __shfl_up_sync(kFullMask, sj[kVec - 1], 1);
      const unsigned prev_k = __shfl_up_sync(kFullMask, kj[kVec - 1], 1);
      const int next_s = __shfl_down_sync(kFullMask, sj[0], 1);
      if (lane > 0 && prev_s == sj[0]) kj[0] = min(kj[0], prev_k);
      if (lane < 31 && next_s == sj[kVec - 1]) kj[kVec - 1] = kDead;
    }

    // Fold the lane's equal ids into the first edge that holds the id. An
    // edge with the identity key but a loaded id can take the fold: the
    // piece then sits at its position under the same id.
#pragma unroll
    for (int b = 1; b < kEdges; ++b) {
      bool done = k[b] == kDead;
#pragma unroll
      for (int a = 0; a < b; ++a) {
        if (!done && s[a] == s[b]) {
          k[a] = min(k[a], k[b]);
          k[b] = kDead;
          done = true;
        }
      }
    }

    // Each piece not below its id's cached value: read out[s], send if
    // lower, and cache the least of the two.
#pragma unroll
    for (int p = 0; p < kEdges; ++p) {
      if (k[p] == kDead) continue;
      const unsigned id = static_cast<unsigned>(s[p]);
      const unsigned h = cache_slot(s[p]);
      const unsigned long long c = cache[h];
      if (static_cast<unsigned>(c >> 32) == id && k[p] >= static_cast<unsigned>(c)) continue;
      unsigned v = k[p];
      const unsigned long long o = __ldcg(out + s[p]);
      if (k[p] < o) {
        atomicMin(out + s[p], static_cast<unsigned long long>(k[p]));
      } else {
        v = static_cast<unsigned>(o);
      }
      cache[h] = static_cast<unsigned long long>(id) << 32 | v;
    }
    cur = nxt;
  }
}

unsigned int blocks_for(long long work, long long max_blocks) {
  const long long b = (work + kThreads - 1) / kThreads;
  return static_cast<unsigned int>(b < max_blocks ? b : max_blocks);
}

// Resident blocks per SM of one variant, queried once per process.
template <bool kVecIds>
int resident_blocks() {
  static int cached = 0;
  if (cached == 0) {
    int b = 0;
    if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, segment_min_flat_kernel<kVecIds>,
                                                      kThreads, 0) != cudaSuccess || b < 1) {
      b = 1;
    }
    cached = b;
  }
  return cached;
}

}  // namespace

extern "C" int segment_min_flat_launch(const void* keys, const void* segs, void* out,
                                       long long num_edges, long long num_segments,
                                       long long head, long long vec_ids, void* stream) {
  // The warp body (from edge `head` on, when it holds a whole group) needs
  // 16-byte aligned keys, and ids too under vec_ids.
  const bool body = num_edges - head >= kVec;
  if (num_edges < 0 || num_segments < 0 || num_segments > 0x7FFFFFFFLL || head < 0 ||
      head >= kVec || head > num_edges ||
      (body && reinterpret_cast<uintptr_t>(static_cast<const unsigned long long*>(keys) + head) %
                   16) ||
      (body && vec_ids &&
       reinterpret_cast<uintptr_t>(static_cast<const int32_t*>(segs) + head) % 16)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
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
    fill_identity_kernel<<<blocks_for(num_segments,
                                      static_cast<long long>(sms) * (kMaxThreadsPerSm / kThreads)),
                           kThreads, 0, st>>>(o, num_segments);
    if (num_edges > 0) {
      const auto* k = static_cast<const unsigned long long*>(keys);
      const auto* s = static_cast<const int32_t*>(segs);
      const long long steps = ((num_edges - head) / kVec + kGroupsPerStep - 1) / kGroupsPerStep;
      // One resident wave of warps (at least one block for the head and
      // tail); each warp strides over the steps.
      auto kernel = vec_ids ? segment_min_flat_kernel<true> : segment_min_flat_kernel<false>;
      const long long wave =
          static_cast<long long>(sms) * (vec_ids ? resident_blocks<true>() : resident_blocks<false>());
      long long blocks = (steps + kWarps - 1) / kWarps;
      blocks = blocks < 1 ? 1 : (blocks < wave ? blocks : wave);
      kernel<<<static_cast<unsigned int>(blocks), kThreads, 0, st>>>(
          k, s, o, num_edges, static_cast<int>(num_segments), static_cast<int>(head));
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* segment_min_flat_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
