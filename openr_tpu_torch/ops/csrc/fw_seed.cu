// K12 fw_seed: the warm re-close seed of the resident all-pairs matrix.
//
// Replaces: openr_tpu/apsp/kernels.py `_fw_seed_solver` (d_prev [N, N],
// w_new [N, N], the increased pairs inc_u, inc_v, inc_w [p] -> d0 [N, N],
// dirty [nb] bool, num_dirty). Two entry points:
//
//   fw_seed_rows    one block per row i:
//                     aff[i] = exists valid p, j:
//                       min(min(D[i, u_p] + w_old_p, INF) + D[v_p, j], INF)
//                         == D[i, j] < INF
//                     d0[i, :] = min(aff[i] ? INF : D[i, :], w_new[i, :])
//                     row_dirty[i] = aff[i] or d0[i, :] != D[i, :]
//   fw_seed_blocks  dirty[b] = any row_dirty of block row b (B rows), and
//                   num_dirty = the count of dirty blocks, on the card
//
// A slot is valid when u_p < n (padding slots carry u = 1 << 30); u_p and
// v_p are clipped into [0, n), as the reference clips them. Row i's old
// shortest-path witness may cross an increased pair exactly when the
// triangle equality holds (over-marking is safe: the re-close rebuilds the
// row). When min(D[i, u] + w_old, INF) is INF the candidate is INF, which
// never equals an entry below INF, so such a pair is skipped for row i. The
// three-term sum stays below 2^31: w_old < INF and each D entry <= INF.
//
// Bound on the card: integer operations, an add, a min and a compare per
// entry of each pass a row makes (one per valid pair whose u it reaches,
// up to its first hit): at most 3 * p * N^2, 0.19 ms at p = 64, N = 4,096;
// the bytes (D and w_new read once, d0 written once) are 201 MB, 0.06 ms.
//
// Design against that bound: one pass over D, all p pairs per row, not p
// passes over the 64 MB matrix. A row's block holds D[i, :] in shared
// memory; the p rows D[v_p, :] (16 KB each, 1 MB at p = 64) are read by
// every row's block and stay in L2. A row stops testing at its first hit
// (a block-wide vote after each pair), so an affected row costs one pass.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr int kThreads = 256;

__global__ void __launch_bounds__(kThreads) fw_seed_rows_kernel(
    const int32_t* __restrict__ d_prev, const int32_t* __restrict__ w_new,
    const int32_t* __restrict__ inc_u, const int32_t* __restrict__ inc_v,
    const int32_t* __restrict__ inc_w, int32_t* __restrict__ d0,
    uint8_t* __restrict__ row_dirty, int p, int n) {
  extern __shared__ int32_t row[];  // D[i, :]
  const int i = blockIdx.x;
  const long long base = (long long)i * n;
  for (int j = threadIdx.x; j < n; j += kThreads) row[j] = d_prev[base + j];
  __syncthreads();
  bool aff = false;
  for (int q = 0; q < p; ++q) {
    const int u = inc_u[q];
    if (u >= n) continue;  // padding slot
    const int us = min(max(u, 0), n - 1);
    const int vs = min(max(inc_v[q], 0), n - 1);
    const int a = min(row[us] + inc_w[q], kInf);
    if (a >= kInf) continue;  // this row does not reach u
    const int32_t* dv = d_prev + (long long)vs * n;
    bool hit = false;
    for (int j = threadIdx.x; j < n; j += kThreads) {
      const int dij = row[j];
      hit |= dij < kInf && min(a + dv[j], kInf) == dij;
    }
    if (__syncthreads_or(hit)) {
      aff = true;
      break;
    }
  }
  bool dirty = aff;
  for (int j = threadIdx.x; j < n; j += kThreads) {
    const int old = row[j];
    const int v = min(aff ? kInf : old, w_new[base + j]);
    d0[base + j] = v;
    dirty |= v != old;
  }
  dirty = __syncthreads_or(dirty);
  if (threadIdx.x == 0) row_dirty[i] = dirty;
}

constexpr int kMaxBlocks = 1024;

__global__ void __launch_bounds__(kMaxBlocks) fw_seed_blocks_kernel(
    const uint8_t* __restrict__ row_dirty, uint8_t* __restrict__ dirty,
    int32_t* __restrict__ num_dirty, int nb, int bsz) {
  const int b = threadIdx.x;
  bool flag = false;
  if (b < nb) {
    for (int r = 0; r < bsz; ++r) flag |= row_dirty[(long long)b * bsz + r] != 0;
    dirty[b] = flag;
  }
  const int count = __syncthreads_count(flag);
  if (b == 0) *num_dirty = count;
}

}  // namespace

extern "C" int fw_seed_rows(const void* d_prev, const void* w_new,
                            const void* inc_u, const void* inc_v,
                            const void* inc_w, void* d0, void* row_dirty,
                            int p, int n, void* stream) {
  if (n == 0) return 0;
  const size_t shmem = (size_t)n * sizeof(int32_t);
  if (shmem > 48 * 1024) {
    cudaError_t err = cudaFuncSetAttribute(
        fw_seed_rows_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)shmem);
    if (err != cudaSuccess) return (int)err;
  }
  fw_seed_rows_kernel<<<n, kThreads, shmem, (cudaStream_t)stream>>>(
      (const int32_t*)d_prev, (const int32_t*)w_new, (const int32_t*)inc_u,
      (const int32_t*)inc_v, (const int32_t*)inc_w, (int32_t*)d0,
      (uint8_t*)row_dirty, p, n);
  return (int)cudaGetLastError();
}

extern "C" int fw_seed_blocks(const void* row_dirty, void* dirty,
                              void* num_dirty, int nb, int bsz, void* stream) {
  if (nb < 1 || nb > kMaxBlocks) return (int)cudaErrorInvalidValue;
  fw_seed_blocks_kernel<<<1, kMaxBlocks, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)row_dirty, (uint8_t*)dirty, (int32_t*)num_dirty, nb,
      bsz);
  return (int)cudaGetLastError();
}
