// What the differentiable-TE kernels share: te_softmin.cu (K14, K15) and
// te_flow.cu (K16, K17) include this header.
//
// The column layout of their row and pull blocks: a block owns one node and
// kCols columns, kQ a thread. Where a pass reduces over columns, the columns
// of a thread lie kThreads apart, so for each group q warp w holds 32
// consecutive columns, those that warp w of a one-column-a-thread block of
// 256 held; elsewhere they lie side by side where the rows allow 16-byte
// loads (kVec), else kThreads apart as well.
//
// The division by tau: a / tau is taken as q = a * r, r = tau's correctly
// rounded reciprocal, then q + (a - q * tau) * r with two fused
// multiply-adds (Markstein's correction), the correctly rounded quotient
// where it neither overflows nor is subnormal. It is taken only before an
// exp, whose exponent is <= 0, and the check kernel softmin_div_check holds
// exp of it against exp of __fdiv_rn over that domain. A quotient that is
// kept as it is (the gate backward's g * score / tau) stays __fdiv_rn: a
// guarded div_tau with __fdiv_rn below 2^-100 and past the largest float
// had the same bits at every float but was slower.

#pragma once

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kFInf = 1.0e9f;
constexpr int kThreads = 256;
constexpr int kMaxN = 65535;
constexpr int kQ = 4;  // columns a thread
constexpr int kCols = kQ * kThreads;  // columns a block
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 128;  // edges a block stages in shared memory
constexpr int kSub = 8;  // out-edges a rows block reduces at a time
static_assert(kSub * kQ * kWarps == kThreads, "a tree a thread");

// a / tau from r = __frcp_rn(tau): the correctly rounded quotient where it
// neither overflows nor is subnormal; a = -0 gives +0, whose exp is the
// same 1 (softmin_div_check holds exp of it against __fdiv_rn's)
__device__ __forceinline__ float div_tau(float a, float tau, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-q, tau, a), r, q);
}

// The sum a warp's xor butterfly (v += shfl_xor(v, 16), 8, 4, 2, 1) leaves
// in every lane, of the 32 values v[0..32) that its lanes held, added in
// the butterfly's own tree
__device__ __forceinline__ float butterfly_sum(const float* v) {
  float a[16];  // each level written out, so a stays in registers
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = v[j] + v[j + 16];
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = a[j] + a[j + 8];
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = a[j] + a[j + 4];
#pragma unroll
  for (int j = 0; j < 2; ++j) a[j] = a[j] + a[j + 2];
  return a[0] + a[1];
}

// Stage edges perm[k0:k0 + m]: e, the row offset of `node`[e], we[e] and,
// where `up` is given, up[e]. The leading barrier lets the block finish
// reading the previous stage.
__device__ __forceinline__ void stage_edges(
    const int32_t* __restrict__ perm, const int32_t* __restrict__ node,
    const float* __restrict__ we, int k0, int m, int n, int* s_e,
    long long* s_row, float* s_we, const bool* __restrict__ up = nullptr,
    bool* s_up = nullptr) {
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += kThreads) {
    const int e = perm[k0 + i];
    s_e[i] = e;
    s_row[i] = (long long)node[e] * n;
    s_we[i] = we[e];
    if (up != nullptr) s_up[i] = up[e];
  }
  __syncthreads();
}

// kQ columns of a row from c0: one 16-byte load (kVec), or columns kThreads
// apart; 0 past n. Plain pointers: K17 reads g_p again after its own write,
// so these are not read-only-cache loads.
template <bool kVec>
__device__ __forceinline__ void load4(const float* row, int c0, int n,
                                      float (&v)[kQ]) {
  if (kVec) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c0 < n) x = *reinterpret_cast<const float4*>(row + c0);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int t = c0 + q * kThreads;
      v[q] = t < n ? row[t] : 0.f;
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void store4(float* row, int c0, int n,
                                       const float (&v)[kQ]) {
  if (kVec) {
    if (c0 < n) {
      *reinterpret_cast<float4*>(row + c0) =
          make_float4(v[0], v[1], v[2], v[3]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int t = c0 + q * kThreads;
      if (t < n) row[t] = v[q];
    }
  }
}

// out[i] = the sum of partial[i, :] in order, one thread an edge
__global__ void __launch_bounds__(kThreads) sum_chunks_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int e,
    int nchunks) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= e) return;
  float acc = 0.f;
  for (int c = 0; c < nchunks; ++c) acc += partial[(long long)i * nchunks + c];
  out[i] = acc;
}

bool bad_n(int n) { return n < 1 || n > kMaxN; }

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

// a block per (node, kCols columns), the column chunks fastest
dim3 cols_grid(int n) { return dim3((n + kCols - 1) / kCols, n); }

}  // namespace
