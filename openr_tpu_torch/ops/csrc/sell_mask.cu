// K8 sell_mask: the per-batch-column link-ignore masks of KSP's re-solves on
// the sliced-ELL layout. Two entry points, one thread per mask entry
// (row-in-bucket, slot, batch column) of one bucket's [M, 3] int32 list:
//
//   build  bits[r, j, c / 32] |= 1 << (c % 32) by atomicOr, into a
//          [nk, dk, W] uint32 bit mask (W = ceil(S / 32)) that K9 reads as
//          "the weight of slot (r, j) is INF for batch column c". An entry
//          with ANY index out of range is dropped (padding rows carry
//          1 << 30), as the reference's .at[m0, m1, m2].set(INF,
//          mode="drop") drops an update out of bounds in any dimension.
//   seed   the per-column warm seed: like the reference, valid = row
//          < 1 << 29 (the row only), then row and slot are CLIPPED into the
//          bucket and the column into [0, S) (not dropped, unlike build),
//          and
//            marks[c, v] |= valid && dp[c, v] < INF
//                           && min(dp[c, u] + w_base, INF) == dp[c, v]
//          with u = nbr[r, j], w_base = wg[r, j] (the unmasked weight that
//          produced dp), v = row0 + r. `*any` is set when a mark is set.
//
// Replaces: openr_tpu/ops/spf.py `_sell_solver_vw` (the [nk, dk, S]
// expansion `full.at[m[:, 0], m[:, 1], m[:, 2]].set(INF, mode="drop")`) and
// `_sell_solver_vw_warm` (its seed, `marks.at[v, c].max(cond)`). The marks
// then propagate by K5's round, the reset is K5's, the relaxation K9's.
//
// Layout: dp and marks are row-major [S, n] (marks one byte each); the bit
// mask is zero on entry. The host never sends a negative index.
//
// Bound on the card: device-memory bytes, and tiny: a KSP call masks the
// links of one or two traced paths per batch column, tens of entries. The
// build writes 4 bytes per entry (the bit mask is nk * dk * W * 4 bytes,
// zeroed by the caller); the seed reads two distances and one slot per
// entry. Both are bound by their launch, not by the card.
//
// Design: the expanded weights of the reference (nk * dk * S int32 a
// bucket) are never built; the bit mask is a 32nd of their size, and K9
// reads one word per slot for 32 columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr int kThreads = 256;

__global__ void sell_mask_build_kernel(const int32_t* __restrict__ m,
                                       uint32_t* __restrict__ bits, int M,
                                       int nk, int dk, int S, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int r = m[3 * i], j = m[3 * i + 1], c = m[3 * i + 2];
  if (r < 0 || r >= nk || j < 0 || j >= dk || c < 0 || c >= S) return;
  atomicOr(bits + ((long long)r * dk + j) * W + (c >> 5), 1u << (c & 31));
}

__global__ void sell_mask_seed_kernel(
    const int32_t* __restrict__ dp, uint8_t* __restrict__ marks,
    int32_t* __restrict__ any, const int32_t* __restrict__ nbr,
    const int32_t* __restrict__ wg, const int32_t* __restrict__ m, int M,
    int row0, int nk, int dk, int S, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= M) return;
  const int rows = m[3 * i];
  if (!(rows < (1 << 29))) return;  // padding rows carry 1 << 30
  const int r = min(max(rows, 0), nk - 1);
  const int j = min(max(m[3 * i + 1], 0), dk - 1);
  const int c = min(max(m[3 * i + 2], 0), S - 1);
  const int u = nbr[(long long)r * dk + j];
  const int w = wg[(long long)r * dk + j];
  const int v = row0 + r;
  const long long base = (long long)c * n;
  const int dv = dp[base + v];
  if (dv < kInf && min(dp[base + u] + w, kInf) == dv) {
    marks[base + v] = 1;
    *any = 1;
  }
}

unsigned blocks_for(int total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int sell_mask_build(const void* m, void* bits, int M, int nk,
                               int dk, int S, int W, void* stream) {
  if (M == 0) return 0;
  sell_mask_build_kernel<<<blocks_for(M), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const int32_t*)m, (uint32_t*)bits, M, nk, dk, S, W);
  return (int)cudaGetLastError();
}

extern "C" int sell_mask_seed(const void* dp, void* marks, void* any,
                              const void* nbr, const void* wg, const void* m,
                              int M, int row0, int nk, int dk, int S, int n,
                              void* stream) {
  if (M == 0) return 0;
  sell_mask_seed_kernel<<<blocks_for(M), kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)dp, (uint8_t*)marks, (int32_t*)any,
      (const int32_t*)nbr, (const int32_t*)wg, (const int32_t*)m, M, row0,
      nk, dk, S, n);
  return (int)cudaGetLastError();
}
