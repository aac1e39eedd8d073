// Dense-block multilinear MSF kernel for Hopper (sm_90a), paper §III-A:
//
//     (minw, mincol)_i = lexicographic argmin over j of (a_ij, j)
//                        subject to p_i != p_j and a_ij < inf,
//     minpay_i         = p[mincol_i],
//
// with the identity (inf, INT32_MAX, INT32_MAX) at rows with no valid entry.
//
// Replaces the TPU kernel multilinear_dense_pallas (_kernel) in
// src/repro/kernels/multilinear_dense.py. That kernel walks a grid of
// (row block, column block) tiles with the column dimension sequential,
// and keeps each row block's running (w, col, payload) in its output tile
// across the column steps. Blocks on the card run in no order, so nothing
// is carried between them: each warp owns one row and walks all of its
// columns itself.
//
// Design. One warp per row, 8 rows per block. Each lane strides over the
// row's columns with coalesced loads of a[i, :] (16-byte float4 loads when
// n is a multiple of 4, so that every row starts 16-byte aligned; 4-byte
// loads otherwise) and of p[:] (n * 4 B, which stays in L2 and L1). A lane
// visits its columns in increasing order and keeps a running best (w, col):
// an entry replaces it only when strictly lighter, so among equal weights
// the first, smallest column stays. Validity is a float compare, so a NaN
// entry is never valid and -inf is valid and wins. Then a butterfly of
// warp shuffles merges the 32 lanes lexicographically, (w, col), with
// weights compared as floats: -0.0 and +0.0 are equal and the smaller
// column wins, so minw carries the sign of a[i, mincol]. The payload is
// read once, p[mincol], after the reduction: the winner is unique, so no
// third reduction is needed. Offsets are 64-bit (n^2 passes 2^31 at
// n = 46,341).
//
// Bound on the card: bytes. The adjacency is read once, n^2 * 4 B; p and
// the three outputs add 16 B per row. At n = 16,384 (the dense adjacency
// of R-MAT scale 14, edge factor 8) that is 1.07 GB, 0.321 ms at
// 3.35 TB/s; at n = 4,096 (scale 12, edge factor 64) 67 MB, 0.020 ms.
// The compares (a few per entry) are far below the card's rate. The loop
// is unrolled so that each lane keeps several loads in flight.
//
// The kernel launches on the caller's stream; the C entry point returns
// cudaGetLastError() so that a refused launch is reported.

#include <climits>
#include <cstdint>
#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kWarps = 8;
constexpr int kThreads = kWarps * 32;
constexpr unsigned kFullMask = 0xFFFFFFFFu;

__device__ __forceinline__ void visit(float v, int pj, int pi, int j, float& bw, int& bcol) {
  // Columns arrive in increasing order, so a strict < keeps the smallest
  // column among equal weights. NaN fails both compares.
  if (pj != pi && v < CUDART_INF_F && v < bw) {
    bw = v;
    bcol = j;
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads)
multilinear_dense_kernel(const int32_t* __restrict__ p, const float* __restrict__ a, int n,
                         float* __restrict__ minw, int32_t* __restrict__ mincol,
                         int32_t* __restrict__ minpay) {
  const long long row = static_cast<long long>(blockIdx.x) * kWarps + (threadIdx.x >> 5);
  if (row >= n) return;  // the whole warp leaves together
  const int lane = threadIdx.x & 31;
  const int pi = p[row];
  const float* arow = a + row * static_cast<long long>(n);
  float bw = CUDART_INF_F;
  int bcol = INT_MAX;
  if (kVec) {
    const float4* a4 = reinterpret_cast<const float4*>(arow);
    const int4* p4 = reinterpret_cast<const int4*>(p);
    const int n4 = n >> 2;
#pragma unroll 4
    for (int q = lane; q < n4; q += 32) {
      const float4 v = __ldcs(a4 + q);  // read once: do not keep in cache
      const int4 pj = __ldg(p4 + q);
      const int j = q << 2;
      visit(v.x, pj.x, pi, j, bw, bcol);
      visit(v.y, pj.y, pi, j + 1, bw, bcol);
      visit(v.z, pj.z, pi, j + 2, bw, bcol);
      visit(v.w, pj.w, pi, j + 3, bw, bcol);
    }
  } else {
#pragma unroll 4
    for (int j = lane; j < n; j += 32) visit(__ldcs(arow + j), __ldg(p + j), pi, j, bw, bcol);
  }
  // Lexicographic (w, col) min over the warp; every lane ends with it.
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const float ow = __shfl_xor_sync(kFullMask, bw, d);
    const int oc = __shfl_xor_sync(kFullMask, bcol, d);
    if (ow < bw || (ow == bw && oc < bcol)) {
      bw = ow;
      bcol = oc;
    }
  }
  if (lane == 0) {
    minw[row] = bw;
    mincol[row] = bcol;
    minpay[row] = bcol == INT_MAX ? INT_MAX : p[bcol];
  }
}

}  // namespace

extern "C" int multilinear_dense_launch(const void* p, const void* a, long long n, void* minw,
                                        void* mincol, void* minpay, void* stream) {
  if (n < 0 || n > INT_MAX) return static_cast<int>(cudaErrorInvalidValue);
  if (n > 0) {
    cudaStream_t st = static_cast<cudaStream_t>(stream);
    const unsigned int blocks = static_cast<unsigned int>((n + kWarps - 1) / kWarps);
    const auto* pp = static_cast<const int32_t*>(p);
    const auto* aa = static_cast<const float*>(a);
    auto* w = static_cast<float*>(minw);
    auto* c = static_cast<int32_t*>(mincol);
    auto* y = static_cast<int32_t*>(minpay);
    // float4 rows need every row 16-byte aligned: n % 4 == 0 and a 16-byte
    // aligned base (torch's allocations are).
    const bool vec = (n % 4 == 0) && (reinterpret_cast<uintptr_t>(a) % 16 == 0) &&
                     (reinterpret_cast<uintptr_t>(p) % 16 == 0);
    if (vec) {
      multilinear_dense_kernel<true><<<blocks, kThreads, 0, st>>>(pp, aa, static_cast<int>(n),
                                                                  w, c, y);
    } else {
      multilinear_dense_kernel<false><<<blocks, kThreads, 0, st>>>(pp, aa, static_cast<int>(n),
                                                                   w, c, y);
    }
  }
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* multilinear_dense_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
