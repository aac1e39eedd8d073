// Minimum outgoing edge per root with 64-bit keys, for Hopper (sm_90a):
// the paper's multilinear kernel (section III-A) with the line-10
// projection fused, over a symmetric COO graph whose every tree is a star:
//
//     ps = p[src[e]], pd = p[dst[e]], outgoing(e) = valid[e] && ps != pd,
//     r[s] = MINWEIGHT{ (w[e], eid[e], pd) : outgoing(e), ps == s },
//
// the least (w, eid) pair per root with the p_dst of the edge that holds it,
// (inf, IMAX, IMAX) at roots with no outgoing edge. It is what
// core/semiring.py::segment_argmin gives on the same edges, except that a
// zero weight comes out as +0.0 (segment_argmin keeps the sign of whichever
// zero its scatter met first; the two compare equal). Weights must not be
// NaN. Ids p[src] outside [0, n) are dropped.
//
// The route it serves: min_outgoing_coo(segment="root") on a CUDA graph that
// the pack32 path cannot take (past 2^24 edges, or weights that are not
// integers in 0..255). There the plain route ran three scatter-mins over
// every edge (weight, eid, payload), each one sending all edges of a large
// component, with the identity when not outgoing, to one address.
//
// Key. ord(w) << 32 | (eid ^ 0x80000000) as an unsigned 64-bit value, where
// ord is the order-preserving map of float32 bits (set the sign bit of a
// non-negative float, flip every bit of a negative one) applied after -0.0
// is turned into +0.0, and the eid's sign bit is flipped so that int32 eids
// order as unsigned. Keys are unique per (w, eid); all ones is the identity,
// which no key reaches (it would be a NaN weight). A valid +inf weight
// orders below it, as in segment_argmin.
//
// Four kernels on the caller's stream:
//  1. fill: out[s] = identity, pay[s] = IMAX, the count = 0.
//  2. reduce: one pass over the edges. Each lane of a warp owns kVec = 4
//     consecutive edges per slot and kSlots = 2 slots a step: src, dst and
//     valid are streamed with 16- and 4-byte loads past L1 (the next step's
//     are loaded before this step's gathers), p[src] and p[dst] are gathered
//     in registers, and w and eid are loaded only for a group that holds an
//     outgoing edge. A dead edge (invalid or inside one component) sends
//     nothing: no key, no read of out, no atomic. The flat segment-min
//     kernel's hot-root design (segment_min_flat.cu) carries over: a run of
//     equal roots is handed across lanes and folded within a lane, and each
//     block keeps a direct-mapped cache in shared memory of a bound that
//     out[root] is known to reach; a piece not below it is dropped, any
//     other reads out[root] through L2 and issues the 64-bit atomicMin only
//     if it is lower. Each cache entry is one 64-bit word, so that a read
//     never pairs one root's tag with another's value: the slot and a 20-bit
//     tag are the two halves of an invertible hash of the root (a product by
//     an odd constant), and the other 44 bits hold the bound's top 44 bits
//     (rounded up, so the bound stays one that out[root] reaches). Pieces
//     that tie the bound on weight and on the eid's top 12 bits go on to the
//     read. With a count pointer, each block adds its outgoing edges to it:
//     a popcount per group, a warp sum, one atomic per block.
//  3. payload: the same pass; for every outgoing edge whose key equals
//     out[ps], pay[ps] = min(pay[ps], pd). Keys are unique per (w, eid) and
//     the two directions of an eid never leave one root, so a root has one
//     winner in a graph with one eid per undirected edge; the atomicMin
//     keeps segment_argmin's least payload where a multigraph repeats one.
//  4. decode: out[s] -> (w, eid) per root, (inf, IMAX) at the identity.
// One resident wave of blocks in each pass; no edge-sized buffer.
//
// Undirected mode (the launch's `und` flag, a template flag of the reduce
// and payload kernels: the directed instantiation is the code above). The
// arrays hold each undirected edge once as (lo, hi) in place of src and
// dst, and an edge is outgoing when valid && p[lo] != p[hi]. Its key goes
// as one piece to p[lo] and one to p[hi]: what the directed form sends
// over the edge's two directions, with the payload p[hi] at p[lo] and
// p[lo] at p[hi]. The lo pieces keep the run hand-over and lane folding
// (the coarsen levels' arrays are sorted by lo); the hi pieces go to the
// block's bound cache and the read of out one by one. A root outside
// [0, n) drops that side's piece. The count is of outgoing undirected
// edges. The payload pass compares the key with out[p[lo]] and with
// out[p[hi]].
//
// Bound on the card: bytes. Per round, each edge streams src, dst, valid
// (9 B) in each of the two passes and w, eid (8 B) where outgoing, and
// gathers p twice per pass; out is written once and read per outgoing edge.
//
// Alignment. The body reads a group's src, dst, w and eid as 16-byte
// vectors and its valid bytes as one 4-byte word, from the first edge
// `head` (< 4, chosen by the wrapper: kernels/ops.py::flat64_layout) at
// which all five pointers are so aligned (vec_loads). Where no such head
// exists (a view such as src[1:] beside w[0:]) the same body reads each
// edge on its own. The head edges and the ragged tail (< 4 edges) are
// handled one edge per lane by the first warp of block 0.

#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr unsigned long long kIdentity = ~0ull;
constexpr int kImax = 0x7FFFFFFF;
constexpr unsigned kFullMask = 0xFFFFFFFFu;
constexpr int kThreads = 1024;
constexpr int kWarps = kThreads / 32;
constexpr int kVec = 4;                      // consecutive edges per lane per slot
constexpr int kSlots = 2;                    // slots per warp step
constexpr int kGroupsPerStep = 32 * kSlots;  // 4-edge groups per warp step
constexpr int kEdges = kSlots * kVec;        // a lane's edges per step
constexpr int kCacheBits = 12;               // 4,096 entries per block, 32 KB
constexpr int kCacheSlots = 1 << kCacheBits;
constexpr int kTagBits = 32 - kCacheBits;    // the hash's other bits
constexpr int kBoundBits = 64 - kTagBits;    // the bound's top bits kept
constexpr unsigned kTagMask = (1u << kTagBits) - 1;
constexpr unsigned long long kBoundMask = (1ull << kBoundBits) - 1;
constexpr unsigned kHashMul = 2654435761u;   // odd: a bijection of 32-bit roots
constexpr int kFillThreads = 256;

// The five edge arrays, from some first edge on.
struct Edges {
  const int32_t* src;
  const int32_t* dst;
  const float* w;
  const int32_t* eid;
  const uint8_t* valid;

  __host__ __device__ Edges from(long long e) const {
    return Edges{src + e, dst + e, w + e, eid + e, valid + e};
  }
};

// The streamed fields of one 4-edge group; valid has edge i in byte i.
struct Group {
  int4 src, dst;
  unsigned valid;
};

__device__ __forceinline__ unsigned long long make_key(float w, int eid) {
  unsigned b = __float_as_uint(w);
  if (b == 0x80000000u) b = 0;  // -0.0 ties +0.0, as in segment_argmin
  const unsigned o = (b & 0x80000000u) ? ~b : (b | 0x80000000u);
  return static_cast<unsigned long long>(o) << 32 | (static_cast<unsigned>(eid) ^ 0x80000000u);
}

// Group g of the body; groups past the end read as invalid.
template <bool kVecLoads>
__device__ __forceinline__ Group load_group(const Edges& b, long long ngroups, long long g) {
  Group out{make_int4(0, 0, 0, 0), make_int4(0, 0, 0, 0), 0u};
  if (g >= ngroups) return out;
  if (kVecLoads) {
    out.src = __ldcs(reinterpret_cast<const int4*>(b.src) + g);
    out.dst = __ldcs(reinterpret_cast<const int4*>(b.dst) + g);
    out.valid = __ldcs(reinterpret_cast<const unsigned*>(b.valid) + g);
  } else {
    const long long e = kVec * g;
    out.src = make_int4(__ldcs(b.src + e), __ldcs(b.src + e + 1), __ldcs(b.src + e + 2),
                        __ldcs(b.src + e + 3));
    out.dst = make_int4(__ldcs(b.dst + e), __ldcs(b.dst + e + 1), __ldcs(b.dst + e + 2),
                        __ldcs(b.dst + e + 3));
#pragma unroll
    for (int i = 0; i < kVec; ++i)
      out.valid |= static_cast<unsigned>(__ldcs(reinterpret_cast<const char*>(b.valid) + e + i)
                                         & 0xFF) << (8 * i);
  }
  return out;
}

// The group's roots (-1 at invalid edges) and the mask of its outgoing edges.
__device__ __forceinline__ unsigned group_roots(const Group& g, const int32_t* __restrict__ p,
                                                int (&ps)[kVec], int (&pd)[kVec]) {
  const int sv[kVec] = {g.src.x, g.src.y, g.src.z, g.src.w};
  const int dv[kVec] = {g.dst.x, g.dst.y, g.dst.z, g.dst.w};
  unsigned mask = 0;
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const bool v = (g.valid >> (8 * i)) & 0xFFu;
    ps[i] = v ? __ldg(p + sv[i]) : -1;
    pd[i] = v ? __ldg(p + dv[i]) : -1;
    if (v && ps[i] != pd[i]) mask |= 1u << i;
  }
  return mask;
}

// The group's keys: a key at each outgoing edge whose root is in range, the
// identity elsewhere; w and eid are read only when the group has one. With
// kUnd, kh holds the same for the roots pd.
template <bool kVecLoads, bool kUnd>
__device__ __forceinline__ void group_keys(const Edges& b, long long g, unsigned mask,
                                           const int (&ps)[kVec], const int (&pd)[kVec], int n,
                                           unsigned long long (&k)[kVec],
                                           unsigned long long (&kh)[kVec]) {
  float w[kVec] = {0.f, 0.f, 0.f, 0.f};
  int id[kVec] = {0, 0, 0, 0};
  if (kVecLoads) {
    if (mask) {
      const float4 wv = __ldcs(reinterpret_cast<const float4*>(b.w) + g);
      const int4 iv = __ldcs(reinterpret_cast<const int4*>(b.eid) + g);
      w[0] = wv.x; w[1] = wv.y; w[2] = wv.z; w[3] = wv.w;
      id[0] = iv.x; id[1] = iv.y; id[2] = iv.z; id[3] = iv.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < kVec; ++i) {
      if (mask >> i & 1u) {
        w[i] = __ldcs(b.w + kVec * g + i);
        id[i] = __ldcs(b.eid + kVec * g + i);
      }
    }
  }
#pragma unroll
  for (int i = 0; i < kVec; ++i) {
    const bool live = (mask >> i & 1u) && static_cast<unsigned>(ps[i]) < static_cast<unsigned>(n);
    k[i] = live ? make_key(w[i], id[i]) : kIdentity;
    if constexpr (kUnd) {
      const bool live_h =
          (mask >> i & 1u) && static_cast<unsigned>(pd[i]) < static_cast<unsigned>(n);
      kh[i] = live_h ? make_key(w[i], id[i]) : kIdentity;
    }
  }
}

__global__ void fill_kernel(unsigned long long* __restrict__ out, int32_t* __restrict__ pay,
                            unsigned long long* count, long long n) {
  if (count != nullptr && blockIdx.x == 0 && threadIdx.x == 0) *count = 0;
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    out[i] = kIdentity;
    pay[i] = kImax;
  }
}

// One edge on its own (the head and tail): its atomicMin (with kUnd, one
// per side); 1 if outgoing.
template <bool kUnd>
__device__ __forceinline__ unsigned reduce_single(const Edges& e, const int32_t* __restrict__ p,
                                                  unsigned long long* out, long long i, int n) {
  if (!e.valid[i]) return 0;
  const int ps = p[e.src[i]];
  const int pd = p[e.dst[i]];
  if (ps == pd) return 0;
  if (static_cast<unsigned>(ps) < static_cast<unsigned>(n)) atomicMin(out + ps, make_key(e.w[i], e.eid[i]));
  if constexpr (kUnd) {
    if (static_cast<unsigned>(pd) < static_cast<unsigned>(n)) atomicMin(out + pd, make_key(e.w[i], e.eid[i]));
  }
  return 1;
}

// Sends piece (s, k): dropped when the block's cache holds a bound for s that
// k does not undercut; else out[s] is read and, if k is lower, lowered.
__device__ __forceinline__ void send(unsigned long long* cache, unsigned long long* out, int s,
                                     unsigned long long k) {
  const unsigned x = static_cast<unsigned>(s) * kHashMul;
  const unsigned h = x >> kTagBits;
  const unsigned long long tag = static_cast<unsigned long long>(x & kTagMask) << kBoundBits;
  const unsigned long long c = cache[h];
  if ((c & ~kBoundMask) == tag && k >= (c << kTagBits | kTagMask)) return;
  unsigned long long v = k;
  const unsigned long long o = __ldcg(out + s);
  if (k < o) {
    atomicMin(out + s, k);
  } else {
    v = o;
  }
  cache[h] = tag | v >> kTagBits;
}

template <bool kVecLoads, bool kUnd>
__global__ void __launch_bounds__(kThreads)
reduce_kernel(Edges e, const int32_t* __restrict__ p, unsigned long long* out,
              unsigned long long* count, long long num_edges, int n, int head) {
  // cache[h]: tag << kBoundBits | the top bits of a value out[root] reaches,
  // for the last root of slot h; all ones (empty) holds no bound.
  __shared__ unsigned long long cache[kCacheSlots];
  __shared__ unsigned long long block_count;
  for (int i = threadIdx.x; i < kCacheSlots; i += kThreads) cache[i] = kIdentity;
  if (threadIdx.x == 0) block_count = 0;
  __syncthreads();

  const int lane = threadIdx.x & 31;
  const long long ngroups = (num_edges - head) / kVec;
  const long long nsteps = (ngroups + kGroupsPerStep - 1) / kGroupsPerStep;
  const Edges b = e.from(head);
  unsigned counted = 0;

  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const long long tail0 = head + ngroups * kVec;
    if (lane < head) counted += reduce_single<kUnd>(e, p, out, lane, n);
    if (lane >= 4 && lane < 8 && tail0 + (lane - 4) < num_edges)
      counted += reduce_single<kUnd>(e, p, out, tail0 + (lane - 4), n);
  }

  const long long wstride = static_cast<long long>(gridDim.x) * kWarps;
  long long step = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  Group cur[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    cur[j] = load_group<kVecLoads>(b, step < nsteps ? ngroups : 0, step * kGroupsPerStep + j * 32 + lane);
  for (; step < nsteps; step += wstride) {
    Group nxt[kSlots];
    const long long nstep = step + wstride;
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      nxt[j] = load_group<kVecLoads>(b, nstep < nsteps ? ngroups : 0,
                                     nstep * kGroupsPerStep + j * 32 + lane);

    // The lane's pieces: position j * kVec + i is edge i of its group in slot j.
    unsigned long long k[kEdges];
    int s[kEdges];
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const long long g = step * kGroupsPerStep + j * 32 + lane;
      int ps[kVec], pd[kVec];
      unsigned long long kj[kVec], kh[kVec];
      const unsigned mask = group_roots(cur[j], p, ps, pd);
      counted += __popc(mask);
      group_keys<kVecLoads, kUnd>(b, g, mask, ps, pd, n, kj, kh);
      if constexpr (kUnd) {
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          if (kh[i] != kIdentity) send(cache, out, pd[i], kh[i]);
        }
      }
      int sj[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) sj[i] = kj[i] != kIdentity ? ps[i] : -1;
      // A run of equal roots that crosses from this lane into the next: the
      // next lane takes this lane's last piece into its first.
      const int prev_s = __shfl_up_sync(kFullMask, sj[kVec - 1], 1);
      const unsigned long long prev_k = __shfl_up_sync(kFullMask, kj[kVec - 1], 1);
      const int next_s = __shfl_down_sync(kFullMask, sj[0], 1);
      if (lane > 0 && prev_s == sj[0]) kj[0] = min(kj[0], prev_k);
      if (lane < 31 && next_s == sj[kVec - 1]) kj[kVec - 1] = kIdentity;
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        k[j * kVec + i] = kj[i];
        s[j * kVec + i] = sj[i];
      }
    }

    // Fold the lane's equal roots into the first piece that holds the root.
#pragma unroll
    for (int q = 1; q < kEdges; ++q) {
      bool done = k[q] == kIdentity;
#pragma unroll
      for (int a = 0; a < q; ++a) {
        if (!done && s[a] == s[q]) {
          k[a] = min(k[a], k[q]);
          k[q] = kIdentity;
          done = true;
        }
      }
    }

#pragma unroll
    for (int q = 0; q < kEdges; ++q) {
      if (k[q] != kIdentity) send(cache, out, s[q], k[q]);
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) cur[j] = nxt[j];
  }

  if (count != nullptr) {
    const unsigned warp_count = __reduce_add_sync(kFullMask, counted);
    if (lane == 0 && warp_count) atomicAdd(&block_count, static_cast<unsigned long long>(warp_count));
    __syncthreads();
    if (threadIdx.x == 0 && block_count) atomicAdd(count, block_count);
  }
}

// One edge on its own (the head and tail) of the payload pass.
template <bool kUnd>
__device__ __forceinline__ void payload_single(const Edges& e, const int32_t* __restrict__ p,
                                               const unsigned long long* __restrict__ out,
                                               int32_t* pay, long long i, int n) {
  if (!e.valid[i]) return;
  const int ps = p[e.src[i]];
  const int pd = p[e.dst[i]];
  if constexpr (kUnd) {
    if (ps == pd) return;
    const unsigned long long k = make_key(e.w[i], e.eid[i]);
    if (static_cast<unsigned>(ps) < static_cast<unsigned>(n) && k == out[ps]) atomicMin(pay + ps, pd);
    if (static_cast<unsigned>(pd) < static_cast<unsigned>(n) && k == out[pd]) atomicMin(pay + pd, ps);
  } else {
    if (ps == pd || static_cast<unsigned>(ps) >= static_cast<unsigned>(n)) return;
    if (make_key(e.w[i], e.eid[i]) == out[ps]) atomicMin(pay + ps, pd);
  }
}

template <bool kVecLoads, bool kUnd>
__global__ void __launch_bounds__(kThreads)
payload_kernel(Edges e, const int32_t* __restrict__ p, const unsigned long long* __restrict__ out,
               int32_t* pay, long long num_edges, int n, int head) {
  const int lane = threadIdx.x & 31;
  const long long ngroups = (num_edges - head) / kVec;
  const long long nsteps = (ngroups + kGroupsPerStep - 1) / kGroupsPerStep;
  const Edges b = e.from(head);

  if (blockIdx.x == 0 && threadIdx.x < 32) {
    const long long tail0 = head + ngroups * kVec;
    if (lane < head) payload_single<kUnd>(e, p, out, pay, lane, n);
    if (lane >= 4 && lane < 8 && tail0 + (lane - 4) < num_edges)
      payload_single<kUnd>(e, p, out, pay, tail0 + (lane - 4), n);
  }

  const long long wstride = static_cast<long long>(gridDim.x) * kWarps;
  long long step = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  Group cur[kSlots];
#pragma unroll
  for (int j = 0; j < kSlots; ++j)
    cur[j] = load_group<kVecLoads>(b, step < nsteps ? ngroups : 0, step * kGroupsPerStep + j * 32 + lane);
  for (; step < nsteps; step += wstride) {
    Group nxt[kSlots];
    const long long nstep = step + wstride;
#pragma unroll
    for (int j = 0; j < kSlots; ++j)
      nxt[j] = load_group<kVecLoads>(b, nstep < nsteps ? ngroups : 0,
                                     nstep * kGroupsPerStep + j * 32 + lane);
#pragma unroll
    for (int j = 0; j < kSlots; ++j) {
      const long long g = step * kGroupsPerStep + j * 32 + lane;
      int ps[kVec], pd[kVec];
      unsigned long long kj[kVec], kh[kVec];
      const unsigned mask = group_roots(cur[j], p, ps, pd);
      group_keys<kVecLoads, kUnd>(b, g, mask, ps, pd, n, kj, kh);
      unsigned long long o[kVec];
#pragma unroll
      for (int i = 0; i < kVec; ++i) o[i] = kj[i] != kIdentity ? __ldg(out + ps[i]) : 0ull;
      if constexpr (kUnd) {
        unsigned long long oh[kVec];
#pragma unroll
        for (int i = 0; i < kVec; ++i) oh[i] = kh[i] != kIdentity ? __ldg(out + pd[i]) : 0ull;
#pragma unroll
        for (int i = 0; i < kVec; ++i) {
          if (kh[i] != kIdentity && kh[i] == oh[i]) atomicMin(pay + pd[i], ps[i]);
        }
      }
#pragma unroll
      for (int i = 0; i < kVec; ++i) {
        if (kj[i] != kIdentity && kj[i] == o[i]) atomicMin(pay + ps[i], pd[i]);
      }
    }
#pragma unroll
    for (int j = 0; j < kSlots; ++j) cur[j] = nxt[j];
  }
}

__global__ void decode_kernel(const unsigned long long* __restrict__ out, float* __restrict__ minw,
                              int32_t* __restrict__ mineid, long long n) {
  const long long stride = static_cast<long long>(gridDim.x) * blockDim.x;
  for (long long i = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x; i < n;
       i += stride) {
    const unsigned long long o = out[i];
    if (o == kIdentity) {
      minw[i] = __int_as_float(0x7F800000);  // +inf
      mineid[i] = kImax;
    } else {
      const unsigned hi = static_cast<unsigned>(o >> 32);
      minw[i] = __uint_as_float((hi & 0x80000000u) ? (hi ^ 0x80000000u) : ~hi);
      mineid[i] = static_cast<int32_t>(static_cast<unsigned>(o) ^ 0x80000000u);
    }
  }
}

unsigned int clamp_blocks(long long want, long long wave) {
  const long long b = want < 1 ? 1 : (want < wave ? want : wave);
  return static_cast<unsigned int>(b);
}

// Resident blocks per SM of a kernel, at kThreads threads.
template <typename Kernel>
int resident_blocks(Kernel kernel) {
  int b = 0;
  if (cudaOccupancyMaxActiveBlocksPerMultiprocessor(&b, kernel, kThreads, 0) != cudaSuccess || b < 1)
    b = 1;
  return b;
}

template <bool kVecLoads, bool kUnd>
int reduce_wave_per_sm() {
  static const int cached = resident_blocks(reduce_kernel<kVecLoads, kUnd>);
  return cached;
}

template <bool kVecLoads, bool kUnd>
int payload_wave_per_sm() {
  static const int cached = resident_blocks(payload_kernel<kVecLoads, kUnd>);
  return cached;
}

// The reduce and payload passes of one instantiation.
template <bool kVecLoads, bool kUnd>
void launch_passes(const Edges& e, const int32_t* p, unsigned long long* out, int32_t* pay,
                   unsigned long long* count, long long num_edges, int n, int head, long long want,
                   int sms, cudaStream_t st) {
  reduce_kernel<kVecLoads, kUnd>
      <<<clamp_blocks(want, static_cast<long long>(sms) * reduce_wave_per_sm<kVecLoads, kUnd>()),
         kThreads, 0, st>>>(e, p, out, count, num_edges, n, head);
  payload_kernel<kVecLoads, kUnd>
      <<<clamp_blocks(want, static_cast<long long>(sms) * payload_wave_per_sm<kVecLoads, kUnd>()),
         kThreads, 0, st>>>(e, p, out, pay, num_edges, n, head);
}

}  // namespace

extern "C" int min_outgoing_flat64_launch(const void* p, const void* src, const void* dst,
                                          const void* w, const void* eid, const void* valid,
                                          void* out, void* minw, void* mineid, void* pay,
                                          void* count, long long num_edges, long long n,
                                          long long head, long long vec_loads, long long und,
                                          void* stream) {
  const Edges e{static_cast<const int32_t*>(src), static_cast<const int32_t*>(dst),
                static_cast<const float*>(w), static_cast<const int32_t*>(eid),
                static_cast<const uint8_t*>(valid)};
  // The vector body (from edge `head` on, when it holds a whole group) needs
  // 16-byte aligned src, dst, w, eid and 4-byte aligned valid.
  const bool body = vec_loads && num_edges - head >= kVec;
  const Edges b = e.from(head);
  if (num_edges < 0 || n < 0 || n > 0x7FFFFFFFLL || head < 0 || head >= kVec || head > num_edges ||
      (!vec_loads && head != 0) ||
      (body && ((reinterpret_cast<uintptr_t>(b.src) | reinterpret_cast<uintptr_t>(b.dst) |
                 reinterpret_cast<uintptr_t>(b.w) | reinterpret_cast<uintptr_t>(b.eid)) % 16 ||
                reinterpret_cast<uintptr_t>(b.valid) % 4))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int dev = 0;
  int sms = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);

  const auto* pp = static_cast<const int32_t*>(p);
  auto* o = static_cast<unsigned long long*>(out);
  auto* py = static_cast<int32_t*>(pay);
  auto* cnt = static_cast<unsigned long long*>(count);
  const long long fill_wave = static_cast<long long>(sms) * (2048 / kFillThreads);
  fill_kernel<<<clamp_blocks((n + kFillThreads - 1) / kFillThreads, fill_wave), kFillThreads, 0,
                st>>>(o, py, cnt, n);
  if (num_edges > 0 && n > 0) {
    const long long steps = ((num_edges - head) / kVec + kGroupsPerStep - 1) / kGroupsPerStep;
    const long long want = (steps + kWarps - 1) / kWarps;  // at least one block: head and tail
    const int ni = static_cast<int>(n);
    const int hi = static_cast<int>(head);
    const auto passes = und ? (vec_loads ? launch_passes<true, true> : launch_passes<false, true>)
                            : (vec_loads ? launch_passes<true, false> : launch_passes<false, false>);
    passes(e, pp, o, py, cnt, num_edges, ni, hi, want, sms, st);
  }
  decode_kernel<<<clamp_blocks((n + kFillThreads - 1) / kFillThreads, fill_wave), kFillThreads, 0,
                  st>>>(o, static_cast<float*>(minw), static_cast<int32_t*>(mineid), n);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* min_outgoing_flat64_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
