// K4 sell_apply_patches: scatter an event's weight patches into every
// resident sliced-ELL weight bucket, in place, with ONE launch for all
// buckets.
//
// Replaces: openr_tpu/ops/spf.py `_sell_apply_patches` (the per-bucket
// `wg_k.at[rows, slots].set(vals, mode="drop")` that `_sell_solver_patched`
// and `_sell_solver_warm` run before relaxing). The reference returns new
// buffers and donates the old ones; here the buckets are written in place
// and the caller keeps its handles.
//
// For every patch p of bucket k (idx [B, P, 2] = (row, slot), vals [B, P]):
//
//   if 0 <= row < nk and 0 <= slot < dk:  wg_k[row, slot] = vals[k, p]
//
// and a patch outside its bucket is dropped, as JAX's mode="drop" does: the
// host pads each bucket's fixed-width patch list with rows of 1 << 30. The
// buckets are separate buffers and the host never sends two patches for
// one slot, so the writes do not race.
//
// The buckets: the host passes a table of int64 [nb, 4] rows in HOST
// memory, one per bucket: (wg device pointer, nk, dk, 0). The entry point
// copies it into a `__grid_constant__` kernel parameter, so the launch
// needs no upload; blockIdx.y is the bucket. At most kMaxBuckets buckets:
// the sliced layout's class degrees sum to at most 1,024 (ops/graph.py
// _SELL_UNROLL_CAP), so it has at most 44. An empty bucket (nk * dk = 0)
// drops every patch; its pointer is never read.
//
// Bound on the card: launch latency. An event moves at most 64 patches a
// bucket (12 bytes each read, 4 written); the bytes take nanoseconds, the
// launch and the host's call a few microseconds.
//
// Design against that bound: one launch for every bucket (it was one a
// bucket), one thread per patch and nothing else, no synchronisation and
// no output beyond the patched slots; the buckets are never copied.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;
constexpr int kMaxBuckets = 64;
constexpr int kTableCols = 4;

struct Buckets {
  int nk[kMaxBuckets];
  int dk[kMaxBuckets];
  int32_t* wg[kMaxBuckets];
};

__global__ void sell_apply_patches_kernel(const int32_t* __restrict__ idx,
                                          const int32_t* __restrict__ vals,
                                          const __grid_constant__ Buckets b,
                                          int P) {
  const int k = blockIdx.y;
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const long long i = (long long)k * P + p;
  const int r = idx[2 * i];
  const int j = idx[2 * i + 1];
  const int nk = b.nk[k], dk = b.dk[k];
  if (r < 0 || r >= nk || j < 0 || j >= dk) return;  // mode="drop"
  b.wg[k][(long long)r * dk + j] = vals[i];
}

}  // namespace

// idx, vals: the [nb, P, 2] and [nb, P] patch lists on the card; table: the
// host rows above
extern "C" int sell_apply_patches(const void* idx, const void* vals,
                                  const void* table, int nb, int P,
                                  void* stream) {
  if (nb < 0 || nb > kMaxBuckets || P < 0) return (int)cudaErrorInvalidValue;
  if (nb == 0 || P == 0) return 0;
  Buckets b;
  const long long* t = (const long long*)table;
  for (int k = 0; k < nb; ++k) {
    const long long* row = t + (long long)k * kTableCols;
    b.wg[k] = (int32_t*)row[0];
    b.nk[k] = (int)row[1];
    b.dk[k] = (int)row[2];
  }
  const dim3 grid((P + kThreads - 1) / kThreads, nb);
  sell_apply_patches_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)idx, (const int32_t*)vals, b, P);
  return (int)cudaGetLastError();
}
