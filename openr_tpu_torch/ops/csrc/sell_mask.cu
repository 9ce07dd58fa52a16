// K8 sell_mask: the per-batch-column link-ignore masks of KSP's re-solves on
// the sliced-ELL layout. Two entry points, each ONE launch for all buckets:
// one thread per mask entry (row-in-bucket, slot, batch column) of the
// buckets' [M, 3] int32 lists, laid end to end in bucket order:
//
//   build  bits_k[r, j, c / 32] |= 1 << (c % 32) by atomicOr, into bucket
//          k's [nk, dk, W] uint32 bit mask (W = ceil(S / 32)), which K9
//          reads as "the weight of slot (r, j) is INF for batch column c".
//          An entry with ANY index out of range is dropped (padding rows
//          carry 1 << 30), as the reference's .at[m0, m1, m2].set(INF,
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
// The buckets: the host passes a table of int64 [nb, 8] rows in HOST
// memory, one per bucket: (first entry, nk, dk, row0, first word of the
// bucket's bit mask, nbr, wg, 0), nbr and wg being device pointers (the
// build reads neither). The entry point copies it into a kernel parameter,
// so the launch needs no upload; an entry finds its bucket by binary
// search over the first entries. At most kMaxBuckets buckets: the sliced
// layout's class degrees sum to at most 1,024 (ops/graph.py
// _SELL_UNROLL_CAP), so it has at most 44.
//
// Layout: dp and marks are row-major [S, n] (marks one byte each). Each
// entry point zeroes its outputs with one memset on the stream before its
// launch (the bit masks; the marks and the flag), not with a PyTorch fill:
// the call is host-bound. The host never sends a negative index.
//
// Bound on the card: device-memory bytes, and tiny: a KSP call masks the
// links of one or two traced paths per batch column, tens of entries. The
// build writes 4 bytes per entry (the bit masks are sum nk * dk * W * 4
// bytes, zeroed first); the seed reads two distances and one slot per
// entry. Both are bound by their launch, not by the card: hence one launch
// per entry point, whatever the bucket count, and one allocation per call.
//
// Design: the expanded weights of the reference (nk * dk * S int32 a
// bucket) are never built; the bit mask is a 32nd of their size, and K9
// reads one word per slot for 32 columns.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr int kThreads = 256;
constexpr int kMaxBuckets = 64;
constexpr int kTableCols = 8;

struct Buckets {
  int nb;
  int first[kMaxBuckets + 1];  // first entry of each bucket, then M
  int nk[kMaxBuckets];
  int dk[kMaxBuckets];
  int row0[kMaxBuckets];
  long long word0[kMaxBuckets];
  const int32_t* nbr[kMaxBuckets];
  const int32_t* wg[kMaxBuckets];
};

// the bucket of entry i: the last k with first[k] <= i (empty buckets share
// their first entry with the next one, which owns it)
__device__ __forceinline__ int bucket_of(const Buckets& b, int i) {
  int lo = 0, hi = b.nb - 1;
  while (lo < hi) {
    const int mid = (lo + hi + 1) >> 1;
    if (b.first[mid] <= i)
      lo = mid;
    else
      hi = mid - 1;
  }
  return lo;
}

__global__ void sell_mask_build_kernel(const int32_t* __restrict__ m,
                                       uint32_t* __restrict__ bits,
                                       const __grid_constant__ Buckets b,
                                       int S, int W) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b.first[b.nb]) return;
  const int k = bucket_of(b, i);
  const int nk = b.nk[k], dk = b.dk[k];
  const int r = m[3 * i], j = m[3 * i + 1], c = m[3 * i + 2];
  if (r < 0 || r >= nk || j < 0 || j >= dk || c < 0 || c >= S) return;
  atomicOr(bits + b.word0[k] + ((long long)r * dk + j) * W + (c >> 5),
           1u << (c & 31));
}

__global__ void sell_mask_seed_kernel(const int32_t* __restrict__ dp,
                                      uint8_t* __restrict__ marks,
                                      int32_t* __restrict__ any,
                                      const int32_t* __restrict__ m,
                                      const __grid_constant__ Buckets b,
                                      int S, int n) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= b.first[b.nb]) return;
  const int k = bucket_of(b, i);
  const int nk = b.nk[k], dk = b.dk[k];
  const int rows = m[3 * i];
  if (!(rows < (1 << 29)) || nk == 0 || dk == 0) return;  // padding: 1 << 30
  const int r = min(max(rows, 0), nk - 1);
  const int j = min(max(m[3 * i + 1], 0), dk - 1);
  const int c = min(max(m[3 * i + 2], 0), S - 1);
  const long long slot = (long long)r * dk + j;
  const int u = b.nbr[k][slot];
  const int w = b.wg[k][slot];
  const int v = b.row0[k] + r;
  const long long base = (long long)c * n;
  const int dv = dp[base + v];
  if (dv < kInf && min(dp[base + u] + w, kInf) == dv) {
    marks[base + v] = 1;
    *any = 1;
  }
}

// the host table (int64 [nb, kTableCols]) as a kernel parameter; false when
// it does not fit
bool read_table(const void* table, int nb, int M, Buckets* b) {
  if (nb < 1 || nb > kMaxBuckets || M < 0) return false;
  const long long* t = (const long long*)table;
  b->nb = nb;
  for (int k = 0; k < nb; ++k) {
    const long long* row = t + (long long)k * kTableCols;
    b->first[k] = (int)row[0];
    b->nk[k] = (int)row[1];
    b->dk[k] = (int)row[2];
    b->row0[k] = (int)row[3];
    b->word0[k] = row[4];
    b->nbr[k] = (const int32_t*)row[5];
    b->wg[k] = (const int32_t*)row[6];
  }
  b->first[nb] = M;
  return true;
}

unsigned blocks_for(int total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

}  // namespace

// bits: every bucket's mask, end to end (the last bucket's first word plus
// its nk * dk * W words), zeroed here on the stream before the kernel ORs
extern "C" int sell_mask_build(const void* m, void* bits, const void* table,
                               int nb, int M, int S, int W, void* stream) {
  if (M == 0 || S == 0) return 0;
  Buckets b;
  if (!read_table(table, nb, M, &b)) return (int)cudaErrorInvalidValue;
  const long long words =
      b.word0[nb - 1] + (long long)b.nk[nb - 1] * b.dk[nb - 1] * W;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t rc = cudaMemsetAsync(bits, 0, sizeof(uint32_t) * words, st);
  if (rc != cudaSuccess) return (int)rc;
  sell_mask_build_kernel<<<blocks_for(M), kThreads, 0, st>>>(
      (const int32_t*)m, (uint32_t*)bits, b, S, W);
  return (int)cudaGetLastError();
}

// marks: the [S, n] bytes, then at the next multiple of 4 the int32 flag;
// both zeroed here on the stream before the kernel sets them
extern "C" int sell_mask_seed(const void* dp, void* marks, const void* m,
                              const void* table, int nb, int M, int S, int n,
                              void* stream) {
  if (M == 0 || S == 0) return 0;
  Buckets b;
  if (!read_table(table, nb, M, &b)) return (int)cudaErrorInvalidValue;
  const long long at = ((long long)S * n + 3) / 4 * 4;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t rc = cudaMemsetAsync(marks, 0, at + sizeof(int32_t), st);
  if (rc != cudaSuccess) return (int)rc;
  sell_mask_seed_kernel<<<blocks_for(M), kThreads, 0, st>>>(
      (const int32_t*)dp, (uint8_t*)marks, (int32_t*)((uint8_t*)marks + at),
      (const int32_t*)m, b, S, n);
  return (int)cudaGetLastError();
}
