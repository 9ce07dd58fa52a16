// K7 delta_extract: the changed destination columns of a warm solve and
// their O(changes) copy-back.
//
// Replaces: openr_tpu/ops/spf.py `_delta_extract` and the `col_changed` /
// `num_changed` outputs of `_sell_solver_warm` and `_bf_warm_core`. Three
// entry points over the row-major [S, n] int32 distance matrices:
//
//   columns  one thread per column t: col_changed[t] = any_s d[s, t] !=
//            dp[s, t], and *count += 1 for each changed column (the host
//            reads that 4-byte count to size the extraction)
//   compact  one block: cols[0 .. cap) = the changed columns in ASCENDING
//            order, padded with n, exactly `jnp.nonzero(col_changed,
//            size=cap, fill_value=n)` (an atomic-counter compaction would
//            give another order)
//   gather   dcols[s, c] = d[s, clip(cols[c], 0, n - 1)] and
//            nh[l, c] = nh_ws[l] + dcols[nh_rows[l], c] == dcols[0, c]
//            (the reference's formula: unclamped, no reachability term,
//            int32 wrap-around; the host applies the overloaded-neighbour
//            rule as the reference's _finish_delta does)
//
// Bound on the card: device-memory bytes. `columns` reads both matrices
// once (2 x 4 x S x n bytes: 128 MB on the 100k-node WAN at S = 128); the
// compaction reads n flag bytes and `gather` moves O(cap x (S + L)) words.
//
// Design against that bound: in `columns` consecutive threads take
// consecutive columns and walk down the S rows, so every load of a warp is
// one coalesced 128-byte line of each matrix; a column stops at its first
// difference. `compact` gives each of its 1,024 threads one contiguous
// segment of flags: count, one block-wide prefix sum in shared memory,
// then each thread writes its segment's hits at its offset, which keeps the
// order. `gather` is one thread per output word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kScanThreads = 1024;

__global__ void delta_columns_kernel(const int32_t* __restrict__ d,
                                     const int32_t* __restrict__ dp,
                                     uint8_t* __restrict__ col_changed,
                                     int32_t* __restrict__ count, int S,
                                     int n) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n) return;
  uint8_t c = 0;
  for (int s = 0; s < S; ++s) {
    const long long i = (long long)s * n + t;
    if (d[i] != dp[i]) {
      c = 1;
      break;
    }
  }
  col_changed[t] = c;
  if (c) atomicAdd(count, 1);
}

__global__ void delta_compact_kernel(const uint8_t* __restrict__ flags,
                                     int32_t* __restrict__ cols, int n,
                                     int cap) {
  __shared__ int32_t scan[kScanThreads];
  const int tid = threadIdx.x;
  const int seg = (n + kScanThreads - 1) / kScanThreads;
  const int lo = min(tid * seg, n);
  const int hi = min(lo + seg, n);
  int cnt = 0;
  for (int t = lo; t < hi; ++t) cnt += flags[t] != 0;
  scan[tid] = cnt;
  __syncthreads();
  for (int off = 1; off < kScanThreads; off <<= 1) {  // inclusive scan
    const int x = tid >= off ? scan[tid - off] : 0;
    __syncthreads();
    scan[tid] += x;
    __syncthreads();
  }
  int pos = scan[tid] - cnt;
  for (int t = lo; t < hi && pos < cap; ++t) {
    if (flags[t]) cols[pos++] = t;
  }
  for (int c = scan[kScanThreads - 1] + tid; c < cap; c += kScanThreads) {
    cols[c] = n;  // fill_value
  }
}

__global__ void delta_gather_kernel(
    const int32_t* __restrict__ d, const int32_t* __restrict__ cols,
    const int32_t* __restrict__ nh_rows, const int32_t* __restrict__ nh_ws,
    int32_t* __restrict__ dcols, uint8_t* __restrict__ nh, int S, int n,
    int cap, int L) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)(S + L) * cap) return;
  const int row = (int)(i / cap);
  const int c = (int)(i - (long long)row * cap);
  const int col = min(max(cols[c], 0), n - 1);
  if (row < S) {
    dcols[i] = d[(long long)row * n + col];
    return;
  }
  const int l = row - S;
  const unsigned sum = (unsigned)nh_ws[l] +
                       (unsigned)d[(long long)nh_rows[l] * n + col];
  nh[(long long)l * cap + c] = (uint8_t)((int)sum == d[col]);
}

}  // namespace

extern "C" int delta_columns(const void* d, const void* dp, void* col_changed,
                             void* count, int S, int n, void* stream) {
  if (n == 0) return 0;
  const int blocks = (n + kThreads - 1) / kThreads;
  delta_columns_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)d, (const int32_t*)dp, (uint8_t*)col_changed,
      (int32_t*)count, S, n);
  return (int)cudaGetLastError();
}

extern "C" int delta_compact(const void* flags, void* cols, int n, int cap,
                             void* stream) {
  if (cap == 0) return 0;
  delta_compact_kernel<<<1, kScanThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)flags, (int32_t*)cols, n, cap);
  return (int)cudaGetLastError();
}

extern "C" int delta_gather(const void* d, const void* cols,
                            const void* nh_rows, const void* nh_ws,
                            void* dcols, void* nh, int S, int n, int cap,
                            int L, void* stream) {
  const long long total = (long long)(S + L) * cap;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  delta_gather_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)d, (const int32_t*)cols, (const int32_t*)nh_rows,
      (const int32_t*)nh_ws, (int32_t*)dcols, (uint8_t*)nh, S, n, cap, L);
  return (int)cudaGetLastError();
}
