// K2 bf_relax_round: the Jacobi rounds of the edge-list min-plus
// relaxation, a whole fixpoint enqueued in chunks of rounds.
//
// Replaces: openr_tpu/ops/spf.py `_bf_relax` (one iteration of its
// while_loop body), the solve behind `_bf_fixpoint` (weights shared by all
// rows) and `_bf_fixpoint_vw_core` (one weight row per source row), with the
// transit mask of `_bf_allow` computed in the kernel.
//
// Layout: distances are destination-major [n, S] int32 (INF = 1 << 29), as
// K1 keeps them; the wrappers transpose the reference's row-major [S, n]
// in and out once a solve (a cold solve builds its initial state
// dest-major, a warm one gets it from K6's reset). Edges are sorted by
// destination; csr[v] .. csr[v + 1] is the range of v's in-edges among the
// real edges [0, m), m = csr[n] (the padding edges past m carry INF and are
// never walked). Weights: w[e] for every column (shared), or per source
// column from a [E, S] matrix, the transpose of the reference's [S, E]
// per-row weights. For every (node v, source column s):
//
//   d_new[v, s] = min(d_old[v, s],
//                     min_{e in in(v)} min(dt[src[e], s] + w[e, s], INF))
//   dt[u, s]    = d_old[u, s] if (!ov[u] || u == sources[s]) else INF
//
// An empty segment leaves d unchanged, as the reference's segment_min gives
// the int32 maximum there and the outer min keeps d.
//
// The rounds run under the protocol of sell_rounds.cuh (state on the card,
// one host call a chunk of rounds, one host read a chunk) and skip what
// cannot change, as K1's do: round t reads buffer (t - 1) & 1 and writes
// buffer t & 1 (the host's d0 is buffer 0 and buffer 1 starts as its copy);
// stamps[t & 1][v] = t + 1 when row v went down in round t (stamps int32
// [2, n], zeroed by the host, 0 "never"; a cold start stamps the source
// rows 1, the rows the initial state moved). A slot whose tail did not
// change in round t - 1 offers round t nothing new, so round t gathers only
// from tails stamped t, and a row that gathers nothing keeps d_{t-1}: the
// buffer round t writes holds d_{t-2}, so a row that changed in round t - 1
// is written through, and any other row already holds its value. Round 1
// takes every slot (`full`) unless the host stamped the source rows (a
// cold start). A round is two launches: the first lists the rows that can
// move (a thread an edge: an edge with a stamped tail lists its head; a
// stamped row lists itself) into the row lists of sell_rounds.cuh, one per
// slot split; the second relaxes the listed rows, each list with its own
// split, so a hub's 1,100 in-edges go over 32 lanes of 35 edges each.
//
// Bound on the card: device-memory bytes. Each round reads, for every row
// that can move, one gathered row of S int32 per in-edge whose tail moved,
// plus the row itself, and writes it once; the 512-byte gathered rows of
// the 100k-node WAN's [n, 128] matrix (51 MB in its real rows) do not all
// stay in the 50 MB L2. There are 2 integer ops per gathered int32, far
// below the card's integer rate.
//
// Design against that bound: a thread takes 4 consecutive source columns of
// one row (16-byte loads and stores) where S is a multiple of 4 and the
// buffers (and per-row weights) are 16-byte aligned, one column otherwise;
// at S = 128 a warp is one row and each gather one 512-byte read, where
// the first design's row-major [S, n] gathered 4 bytes at a time from
// anywhere in a 512 KB row and re-read the edge arrays for every row. A
// row's in-edges split over up to 32 lanes (pull_slots, as K1's slots),
// issued 4 at a time per lane. Per-row weights are read as 16 bytes an
// (edge, 4 columns) from the transposed matrix.

#include "sell_rounds.cuh"

namespace {

using sell::CsrLists;
using sell::RoundState;
using sell::Vec;
using sell::kClasses;
using sell::kInf;
using sell::kThreads;

struct Aux {
  int32_t* stamps;  // [2, n]
  RoundState* st;
  CsrLists lists;
};

// aux: stamps [2, n], the RoundState (8 words), the row lists
__host__ __device__ inline Aux aux_of(void* p, int n) {
  int32_t* a = (int32_t*)p;
  return {a, (RoundState*)(a + 2LL * n), sell::csr_lists(a + 2LL * n + 8, n)};
}

// Round t's first pass: the rows that can move, into the row lists
__global__ void __launch_bounds__(kThreads) bf_relax_active_kernel(
    void* aux, const int32_t* __restrict__ csr,
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst, int n,
    int t, int full) {
  const Aux a = aux_of(aux, n);
  if (sell::round_done(a.st)) return;
  const int32_t* cp = a.stamps + (long long)((t - 1) & 1) * n;
  const int m = __ldg(csr + n);
  const long long total = full ? n : (m > n ? m : n);
  for (long long at = (long long)blockIdx.x * kThreads; at < total;
       at += (long long)gridDim.x * kThreads)
    sell::list_rows(a.lists, cp, csr, src, dst, n, m, at + threadIdx.x, t,
                    true, full);
}

// Round t's second pass over the listed rows: V columns a thread, list k's
// rows over P = 2^k lanes each
template <int V, bool PerCol>
__global__ void __launch_bounds__(kThreads) bf_relax_round_kernel(
    int32_t* __restrict__ buf0, int32_t* __restrict__ buf1, void* aux,
    const int32_t* __restrict__ sources, const uint8_t* __restrict__ ov,
    const int32_t* __restrict__ csr, const int32_t* __restrict__ src,
    const int32_t* __restrict__ w, int S, int n, int t, int full) {
  const Aux a = aux_of(aux, n);
  if (sell::round_done(a.st)) return;
  const int32_t* d_old = (t & 1) ? buf0 : buf1;
  int32_t* d_new = (t & 1) ? buf1 : buf0;
  const int32_t* cp = a.stamps + (long long)((t - 1) & 1) * n;
  int32_t* cq = a.stamps + (long long)(t & 1) * n;
  const int G = S / V;
  bool changed = false;
  for (int k = 0; k < kClasses; ++k) {
    const int P = 1 << k;
    const long long items = (long long)__ldcg(a.lists.counts + k) * G << k;
    for (long long at = (long long)blockIdx.x * kThreads; at < items;
         at += (long long)gridDim.x * kThreads) {
      const long long item = at + threadIdx.x;
      const bool valid = item < items;
      const long long rg = valid ? item >> k : 0;
      const long long e = rg / G;
      const int v = valid ? __ldcg(a.lists.list + (long long)k * n + e) : 0;
      const int p = (int)(item & (P - 1));
      const int s0 = (int)(rg - e * G) * V;
      const int lo = valid ? __ldg(csr + v) : 0;
      const int count = valid ? __ldg(csr + v + 1) - lo : 0;
      int srcs[V];
      Vec<V> acc;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        srcs[c] = valid ? __ldg(sources + s0 + c) : 0;
        acc.x[c] = kInf;
      }
      sell::pull_slots<V, PerCol>(
          acc, src + lo, PerCol ? w + (long long)lo * S : w + lo, count, p,
          P, cp, t, full, ov, srcs, d_old, S, s0);
      if (P > 1) {
#pragma unroll
        for (int c = 0; c < V; ++c) acc.x[c] = sell::group_min(acc.x[c], P);
      }
      if (!valid || p != 0) continue;
      const bool through = !full && __ldg(cp + v) == t;
      if (sell::finish_row<V>(acc, d_old, d_new, (long long)v * S + s0,
                              through)) {
        cq[v] = t + 1;
        changed = true;
      }
    }
  }
  sell::finish_round(a.st, t, changed, a.lists.counts, kClasses);
}

template <int V, bool PerCol>
int launch_rounds(void* buf0, void* buf1, void* aux, const void* sources,
                  const void* ov, const void* csr, const void* src,
                  const void* dst, const void* w, int S, int n, int e,
                  int t0, int count, int full, cudaStream_t stream) {
  const long long items_a = e > n ? e : n;
  const long long items_b = (long long)n * (S / V);
  const int grid_a = sell::grid_blocks(
      (const void*)bf_relax_active_kernel, (items_a + kThreads - 1) / kThreads);
  const int grid_b = sell::grid_blocks(
      (const void*)bf_relax_round_kernel<V, PerCol>,
      (items_b + kThreads - 1) / kThreads);
  for (int t = t0; t < t0 + count; ++t) {
    const int f = full && t == 1;
    bf_relax_active_kernel<<<grid_a, kThreads, 0, stream>>>(
        aux, (const int32_t*)csr, (const int32_t*)src, (const int32_t*)dst,
        n, t, f);
    bf_relax_round_kernel<V, PerCol><<<grid_b, kThreads, 0, stream>>>(
        (int32_t*)buf0, (int32_t*)buf1, aux, (const int32_t*)sources,
        (const uint8_t*)ov, (const int32_t*)csr, (const int32_t*)src,
        (const int32_t*)w, S, n, t, f);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

}  // namespace

// Launches rounds t0 .. t0 + count - 1, two kernels each (the rows that can
// move, then the round over them). buf0, buf1: the two dest-major [n, S]
// round buffers (buf0 holds d0, buf1 its copy); aux: int32 stamps [2, n],
// the 8-word RoundState and the row lists ((1 + 6) n + 8 words), zeroed by
// the host but for stamped rows; csr [n + 1], src and dst [e] (e: the edge
// arrays' length, m = csr[n] of them real); w: [e] shared, or [e, S] per
// source column (per_col); t0: from 1; full: round 1 takes every slot;
// vec: 4 columns a thread (S % 4 == 0, the buffers and a per-column w
// 16-byte aligned), else 1
extern "C" int bf_relax_rounds(void* buf0, void* buf1, void* aux,
                               const void* sources, const void* ov,
                               const void* csr, const void* src,
                               const void* dst, const void* w, int per_col,
                               int S, int n, int e, int t0, int count,
                               int full, int vec, void* stream) {
  if (S <= 0 || n <= 0 || e < 0 || t0 < 1 || count < 0 || (vec && S % 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  if (vec)
    return per_col ? launch_rounds<4, true>(buf0, buf1, aux, sources, ov,
                                            csr, src, dst, w, S, n, e, t0,
                                            count, full, st)
                   : launch_rounds<4, false>(buf0, buf1, aux, sources, ov,
                                             csr, src, dst, w, S, n, e, t0,
                                             count, full, st);
  return per_col ? launch_rounds<1, true>(buf0, buf1, aux, sources, ov, csr,
                                          src, dst, w, S, n, e, t0, count,
                                          full, st)
                 : launch_rounds<1, false>(buf0, buf1, aux, sources, ov, csr,
                                           src, dst, w, S, n, e, t0, count,
                                           full, st);
}
