// The (min,+) tile product of the blocked Floyd-Warshall re-close K13
// fw_reclose (K10 in the port's numbering: a device routine with no launch
// of its own, held against `_mp` through K13's comparisons with its plain
// version; K11 fw_close carries a register-blocked product of its own).
//
// Replaces: openr_tpu/apsp/kernels.py `_mp`, the tropical product of two
// [B, B] int32 tiles, as every blocked-FW update of the JAX package uses it:
//
//   out[i, j] = min(acc[i, j], min_m (maskA(a)[i, m] + b[m, j]))
//   maskA(a)[i, m] = a[i, m] if allow[i, m] else INF      (left mask only)
//
// with INF = 1 << 29. The reference clamps every sum with min(., INF); here
// the accumulator starts at INF (a pure product) or at an entry that is at
// most INF (an in-place update), so min(acc, a + b) is the clamped value:
// the clamp is only applied once, at the end, for inputs above INF. Both
// terms are at most INF, so a + b <= 2^30 never wraps in int32.
//
// Bound on the card: integer operations. An M x N x K product does M*N*K
// add-and-min steps (one DPX instruction each) over (M + N) * K + M * N
// loaded words; at B = 128 a tile does 128 steps per word it reads, far
// above the card's operations to bytes ratio for int32.
//
// Design against that bound (a simple tiled product, not yet tuned): a
// block of 256 threads (16 x 16) owns a TM x TN output tile in registers,
// each thread RM x RN = (TM / 16) x (TN / 16) entries at rows ty + 16 * i
// and columns tx + 16 * j. The K dimension is walked in slabs of 32: the
// left slab is stored transposed in shared memory (padded by one word so
// the transposing stores do not conflict) with the mask applied on load,
// the right slab as it is; the inner loop reads RM + RN words from shared
// memory for RM * RN add-and-min steps. On Hopper the step is one DPX
// instruction, __viaddmin_s32(a, b, c) = min(a + b, c). Loads past M, N or
// K read INF (which never lowers an entry) and stores past M or N are
// skipped, so any shape is taken.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace fw {

constexpr int kInf = 1 << 29;
constexpr int kThreads = 256;  // 16 x 16
constexpr int kDepth = 32;     // K slab

__device__ __forceinline__ int addmin(int a, int b, int c) {
#if defined(__CUDA_ARCH__) && (__CUDA_ARCH__ >= 900)
  return __viaddmin_s32(a, b, c);
#else
  return min(a + b, c);
#endif
}

template <int TM, int TN>
struct TileSmem {
  int32_t a[kDepth][TM + 1];  // left slab, transposed: a[m][i]
  int32_t b[kDepth][TN];      // right slab: b[m][j]
};

// acc[i][j] = min(acc[i][j], min_m maskA(A)[ty + 16 i, m] + B[m, tx + 16 j])
// over m < K. A points at row 0 of the tile's rows (row stride lda), mask
// (nullptr: none) at the same place of the [., ., ldm] allow matrix, B at
// column 0 of the tile's columns (row stride ldb). M, N: rows and columns
// of the tile that exist. Every thread of the block must call it.
template <int TM, int TN>
__device__ __forceinline__ void mp_tile(
    int (&acc)[TM / 16][TN / 16], const int32_t* __restrict__ A,
    long long lda, const uint8_t* __restrict__ mask, long long ldm,
    const int32_t* __restrict__ B, long long ldb, int M, int N, int K,
    TileSmem<TM, TN>& sm) {
  constexpr int RM = TM / 16;
  constexpr int RN = TN / 16;
  const int tid = threadIdx.x;
  const int tx = tid & 15;
  const int ty = tid >> 4;
  for (int k0 = 0; k0 < K; k0 += kDepth) {
    // left slab: TM rows x 32 columns, consecutive threads on consecutive m
#pragma unroll
    for (int s = 0; s < (TM * kDepth) / kThreads; ++s) {
      const int e = tid + s * kThreads;
      const int m = e & (kDepth - 1);
      const int r = e / kDepth;
      int v = kInf;
      if (r < M && k0 + m < K) {
        const long long off = (long long)r * lda + k0 + m;
        v = A[off];
        if (mask != nullptr && !mask[(long long)r * ldm + k0 + m]) v = kInf;
      }
      sm.a[m][r] = v;
    }
    // right slab: 32 rows x TN columns, consecutive threads on consecutive j
#pragma unroll
    for (int s = 0; s < (TN * kDepth) / kThreads; ++s) {
      const int e = tid + s * kThreads;
      const int c = e % TN;
      const int m = e / TN;
      sm.b[m][c] = (c < N && k0 + m < K)
                       ? B[(long long)(k0 + m) * ldb + c]
                       : kInf;
    }
    __syncthreads();
#pragma unroll 4
    for (int m = 0; m < kDepth; ++m) {
      int av[RM];
      int bv[RN];
#pragma unroll
      for (int i = 0; i < RM; ++i) av[i] = sm.a[m][ty + 16 * i];
#pragma unroll
      for (int j = 0; j < RN; ++j) bv[j] = sm.b[m][tx + 16 * j];
#pragma unroll
      for (int i = 0; i < RM; ++i)
#pragma unroll
        for (int j = 0; j < RN; ++j) acc[i][j] = addmin(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();
  }
}

// acc from the C tile (INF past M or N).
template <int TM, int TN>
__device__ __forceinline__ void load_tile(int (&acc)[TM / 16][TN / 16],
                                          const int32_t* __restrict__ C,
                                          long long ldc, int M, int N) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < TM / 16; ++i)
#pragma unroll
    for (int j = 0; j < TN / 16; ++j) {
      const int r = ty + 16 * i;
      const int c = tx + 16 * j;
      acc[i][j] = (r < M && c < N) ? C[(long long)r * ldc + c] : kInf;
    }
}

template <int TM, int TN>
__device__ __forceinline__ void fill_tile(int (&acc)[TM / 16][TN / 16],
                                          int v) {
#pragma unroll
  for (int i = 0; i < TM / 16; ++i)
#pragma unroll
    for (int j = 0; j < TN / 16; ++j) acc[i][j] = v;
}

// Writes min(acc, INF) into the C tile where it lies below the entry there
// (every update is a min, so only lowered entries need a store) and
// returns whether this thread lowered any entry. With `plain` set, writes
// every entry (an output that holds no earlier value).
template <int TM, int TN>
__device__ __forceinline__ bool store_tile(const int (&acc)[TM / 16][TN / 16],
                                           int32_t* __restrict__ C,
                                           long long ldc, int M, int N,
                                           bool plain) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  bool lowered = false;
#pragma unroll
  for (int i = 0; i < TM / 16; ++i)
#pragma unroll
    for (int j = 0; j < TN / 16; ++j) {
      const int r = ty + 16 * i;
      const int c = tx + 16 * j;
      if (r >= M || c >= N) continue;
      const int v = min(acc[i][j], kInf);
      int32_t* p = C + (long long)r * ldc + c;
      if (plain) {
        *p = v;
      } else if (v < *p) {
        *p = v;
        lowered = true;
      }
    }
  return lowered;
}

}  // namespace fw
