// K6 bf_mark: Ramalingam-Reps invalidation on the edge-list layout.
//
// Replaces: openr_tpu/ops/spf.py `_bf_warm_core`'s seeding (on the old
// shortest-path DAG and w_new > w_old), its segment-max bool fixpoint and
// its reset (d0 = where(marks, INF, dp), sources re-pinned). Three entry
// points, each one thread per (source row s, node v), row-major [S, n]:
//
//   seed   marks[s, v] = any_{e in in(v)} on_old(e, s)
//                                          && w_new[s, e] > w_old[e]
//   round  m_new[s, v] = m_old[s, v]
//                        | any_{e in in(v)} m_old[s, src[e]] && on_old(e, s)
//   reset  d0[s, v] = (v == sources[s]) ? 0 : marks[s, v] ? INF : dp[s, v]
//
//   on_old(e, s) = dp[s, v] < INF && min(dp[s, src[e]] + w_old[e], INF)
//                                    == dp[s, v]
//
// recomputed per edge from dp and w_old, so the reference's [S, E] bool is
// never materialised. The seed's w_new is shared ([E], w_stride 0: an LSDB
// event, `_bf_warm_core`) or per row ([S, E], w_stride E: KSP's link-ignore
// re-solves warm-started from the base fixpoint, `_bf_warm_vw_core`), as
// K2 takes its weights. Rounds are Jacobi (two mark buffers), so the round
// count equals the reference's; `*flag` is set when a mark is set (seed)
// or newly set (round).
//
// Only the real edges are walked: csr[v] .. csr[v + 1] ranges over v's
// in-edges among the first e (destination-sorted) edges. That is exact. A
// padding edge carries weight INF in both w_old and w_new and points at the
// last real node, so on_old needs dp[s, v] < INF == min(dp + INF, INF),
// which never holds, and w_new > w_old is false for it. Walking the
// e_pad - e padding edges would hand one thread per row a serial walk of
// all of them (124,288 on the 100k-node WAN: the fault that cost the first
// edge-list relaxation kernel 16x).
//
// Bound on the card: device-memory bytes. Seed reads dp once and, per
// in-edge, the edge's tail distance and two weights; a round reads each
// entry's mark and one gathered mark per in-edge, and distances only where
// a gathered mark is set.
//
// Design against that bound: consecutive threads take consecutive v of one
// source row, so csr, the own entries and the writes are coalesced; marked
// entries gather nothing, and the walk stops at the first hit.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr int kThreads = 256;

__global__ void bf_mark_seed_kernel(
    const int32_t* __restrict__ dp, uint8_t* __restrict__ marks,
    int32_t* __restrict__ any, const int32_t* __restrict__ src,
    const int32_t* __restrict__ csr, const int32_t* __restrict__ w_new,
    const int32_t* __restrict__ w_old, int w_stride, int S, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)S * n) return;
  const int s = (int)(i / n);
  const int v = (int)(i - (long long)s * n);
  const int32_t* row = dp + (long long)s * n;
  const int32_t* wn = w_new + (long long)s * w_stride;
  const int dv = row[v];
  uint8_t m = 0;
  if (dv < kInf) {
    const int hi = csr[v + 1];
    for (int e = csr[v]; e < hi; ++e) {
      const int wo = w_old[e];
      if (wn[e] > wo && min(row[src[e]] + wo, kInf) == dv) {
        m = 1;
        break;
      }
    }
  }
  marks[i] = m;
  if (m) *any = 1;
}

__global__ void bf_mark_round_kernel(
    const int32_t* __restrict__ dp, const uint8_t* __restrict__ m_old,
    uint8_t* __restrict__ m_new, int32_t* __restrict__ changed,
    const int32_t* __restrict__ src, const int32_t* __restrict__ csr,
    const int32_t* __restrict__ w_old, int S, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)S * n) return;
  const int s = (int)(i / n);
  const int v = (int)(i - (long long)s * n);
  const long long base = (long long)s * n;
  uint8_t m = m_old[i];
  if (!m) {
    bool have_dv = false;
    int dv = 0;
    const int hi = csr[v + 1];
    for (int e = csr[v]; e < hi; ++e) {
      const int u = src[e];
      if (!m_old[base + u]) continue;
      if (!have_dv) {
        dv = dp[i];
        have_dv = true;
        if (dv >= kInf) break;  // unreachable entries never mark
      }
      if (min(dp[base + u] + w_old[e], kInf) == dv) {
        m = 1;
        *changed = 1;
        break;
      }
    }
  }
  m_new[i] = m;
}

__global__ void bf_mark_reset_kernel(const int32_t* __restrict__ dp,
                                     const uint8_t* __restrict__ marks,
                                     const int32_t* __restrict__ sources,
                                     int32_t* __restrict__ d0, int S, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)S * n) return;
  const int s = (int)(i / n);
  const int v = (int)(i - (long long)s * n);
  d0[i] = (v == sources[s]) ? 0 : (marks[i] ? kInf : dp[i]);
}

long long blocks_for(long long total) {
  return (total + kThreads - 1) / kThreads;
}

}  // namespace

extern "C" int bf_mark_seed(const void* dp, void* marks, void* any,
                            const void* src, const void* csr,
                            const void* w_new, const void* w_old,
                            int w_stride, int S, int n, void* stream) {
  const long long total = (long long)S * n;
  if (total == 0) return 0;
  bf_mark_seed_kernel<<<(unsigned)blocks_for(total), kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)dp, (uint8_t*)marks, (int32_t*)any,
      (const int32_t*)src, (const int32_t*)csr, (const int32_t*)w_new,
      (const int32_t*)w_old, w_stride, S, n);
  return (int)cudaGetLastError();
}

extern "C" int bf_mark_round(const void* dp, const void* m_old, void* m_new,
                             void* changed, const void* src, const void* csr,
                             const void* w_old, int S, int n, void* stream) {
  const long long total = (long long)S * n;
  if (total == 0) return 0;
  bf_mark_round_kernel<<<(unsigned)blocks_for(total), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)dp, (const uint8_t*)m_old, (uint8_t*)m_new,
      (int32_t*)changed, (const int32_t*)src, (const int32_t*)csr,
      (const int32_t*)w_old, S, n);
  return (int)cudaGetLastError();
}

extern "C" int bf_mark_reset(const void* dp, const void* marks,
                             const void* sources, void* d0, int S, int n,
                             void* stream) {
  const long long total = (long long)S * n;
  if (total == 0) return 0;
  bf_mark_reset_kernel<<<(unsigned)blocks_for(total), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)dp, (const uint8_t*)marks, (const int32_t*)sources,
      (int32_t*)d0, S, n);
  return (int)cudaGetLastError();
}
