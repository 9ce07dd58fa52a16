// K2 bf_relax_round: one Jacobi round of the edge-list min-plus relaxation.
//
// Replaces: openr_tpu/ops/spf.py `_bf_relax` (one iteration of its
// while_loop body), the solve behind `_bf_fixpoint` (weights shared by all
// rows) and `_bf_fixpoint_vw_core` (one weight row per source row), with the
// transit mask of `_bf_allow` computed in the kernel.
//
// Layout: distances are row-major [S, n] int32 (INF = 1 << 29). Edges are
// sorted by destination; csr[v] .. csr[v + 1] is the edge range of v's
// in-edges (padded edges point at the last real destination with INF
// weight, so they never lower anything). Weights are w[s * w_stride + e]:
// w_stride is 0 for shared weights and the edge count for per-row weights.
// For every (source row s, node v):
//
//   d_new[s, v] = min(d_old[s, v],
//                     min_{e in in(v)} min(dt[s, src[e]] + w[s, e], INF))
//   dt[s, u]    = d_old[s, u] if (!ov[u] || u == sources[s]) else INF
//
// An empty segment leaves d unchanged, as the reference's segment_min gives
// the int32 maximum there and the outer min keeps d. `*changed` is set when
// any entry went down.
//
// Bound on the card: device-memory bytes. Per round each (s, v) reads its
// own entry and one gathered entry d_old[s, src[e]] per in-edge, and writes
// once; the gathers are scattered within one 4 * n-byte row, so each costs a
// 32-byte sector when it misses L2.
//
// Design against that bound: consecutive threads take consecutive v of one
// source row, so the reads of csr, of the edge arrays and of d_old[s, v] and
// the write are coalesced; the [S, E] contributions of the reference are
// never materialised.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr int kThreads = 256;

__global__ void bf_relax_round_kernel(
    const int32_t* __restrict__ d_old, int32_t* __restrict__ d_new,
    int32_t* __restrict__ changed, const int32_t* __restrict__ sources,
    const uint8_t* __restrict__ ov, const int32_t* __restrict__ src,
    const int32_t* __restrict__ csr, const int32_t* __restrict__ w,
    long long w_stride, int S, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)S * n) return;
  const int s = (int)(i / n);
  const int v = (int)(i - (long long)s * n);
  const int me = sources[s];
  const int32_t* row = d_old + (long long)s * n;
  const int32_t* wrow = w + (long long)s * w_stride;
  const int old = row[v];
  int acc = old;
  const int hi = csr[v + 1];
  for (int e = csr[v]; e < hi; ++e) {
    const int u = src[e];
    const int du = (ov[u] && u != me) ? kInf : row[u];
    acc = min(acc, min(du + wrow[e], kInf));
  }
  d_new[i] = acc;
  if (acc != old) *changed = 1;
}

}  // namespace

extern "C" int bf_relax_round(const void* d_old, void* d_new, void* changed,
                              const void* sources, const void* ov,
                              const void* src, const void* csr, const void* w,
                              int w_stride, int S, int n, void* stream) {
  const long long total = (long long)S * n;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  bf_relax_round_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)d_old, (int32_t*)d_new, (int32_t*)changed,
      (const int32_t*)sources, (const uint8_t*)ov, (const int32_t*)src,
      (const int32_t*)csr, (const int32_t*)w, (long long)w_stride, S, n);
  return (int)cudaGetLastError();
}
