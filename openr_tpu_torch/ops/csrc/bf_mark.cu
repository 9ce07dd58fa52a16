// K6 bf_mark: Ramalingam-Reps invalidation on the edge-list layout.
//
// Replaces: openr_tpu/ops/spf.py `_bf_warm_core`'s seeding (on the old
// shortest-path DAG and w_new > w_old), its segment-max bool fixpoint and
// its reset (d0 = where(marks, INF, dp), sources re-pinned); the same for
// `_bf_warm_vw_core`, whose per-row w_new seeds each row against its own
// weights.
//
// The marks are K5's: bits, node-major, word w of row v bit b the mark of
// source column s = 32 w + b (W = ceil(S / 32) words a row), in K5's
// fixpoint buffer (sell_mark.cu): M [n, W] the marks, N [2, n, W] the bits
// a row newly marked in a round by parity, F [2, n] the round + 1 in which
// a row last newly marked bits (0: never; the seed's round is 0), the
// RoundState. dp is the OLD fixpoint dest-major [n, S] (a copy the warm
// solve makes once an event); csr, src, dst and w_old as K2 takes them.
//
//   on_old(e, s) = dp[v, s] < INF && min(dp[src[e], s] + w_old[e], INF)
//                                    == dp[v, s],   v = dst[e]
//
// Entry points:
//
//   seed   round 0:
//            m_0[v, s] = any_{e in in(v)} on_old(e, s) && w_new[e, s] >
//                                                         w_old[e]
//          w_new is shared ([E]) or per source column ([E, S], the
//          transpose of the reference's [S, E] rows). A warp takes 32
//          edges at a time, a lane an edge: with shared weights only the
//          edges that got heavier go on, one at a time, the lanes then
//          taking 32 columns of a mark word each. Done when nothing
//          marked: the host reads the state once after the seed, and an
//          event that raised nothing launches no round.
//   rounds round t >= 1, two launches:
//            m_t[v, s] = m_{t-1}[v, s]
//                | any_{e in in(v)} m_{t-1}[src[e], s] && on_old(e, s)
//          on_old does not change between rounds, so an entry unmarked
//          after round t - 1 can mark in round t only through a tail that
//          newly marked in round t - 1. The first launch lists the heads of
//          the edges whose tail carries stamp t in F[(t - 1) & 1] (the row
//          lists of sell_rounds.cuh, a thread an edge); the second walks
//          each listed row's in-edges, a thread per (row, mark word) and
//          the row's P lanes (its slot split), tests only the tails' new
//          bits N[(t - 1) & 1][u] that the row lacks, writes the row's
//          N[t & 1], ORs its new bits into M in place and stamps it t + 1
//          when it grew. Only the word's own thread reads or writes a word
//          of M[v] and of N[t & 1][v] in a round. The round count equals
//          the reference's Jacobi rounds (decision.spf.invalidation_
//          rounds_last is observable).
//   reset  in place on dp, which becomes K2's dest-major d0: a marked entry
//          INF, every source's own entry 0; the unmarked entries are dp's
//          already, so the reset reads the marks' bits and writes the
//          marked entries alone.
//
// INF = 1 << 29; sums stay below 2^30. Only the real edges [0, csr[n]) are
// walked: a padding edge carries INF in w_old and w_new, so it can neither
// seed (INF > INF is false) nor lie on the old DAG (dp[v, s] < INF ==
// min(dp + INF, INF) never holds).
//
// Bound on the card: device-memory bytes. The seed reads the weights once
// and, where an edge got heavier, its two distance rows; a round reads the
// stamps of the edges' tails, and the tails' new bits and two distances
// only where a tail newly marked, which an event keeps to the entries whose
// old shortest path crossed an increased edge; the reset reads the marks.
//
// Design against that bound: the first design read a mark byte per (source
// row, in-edge) every round, row-major, whether near the event or not, and
// read a flag on the host after every round; the reset was a separate pass
// over the whole matrix. Here a round's first launch reads 8 bytes an edge
// (its tail and that tail's stamp, which stay in L2), the second works on
// the listed rows only, a round with nothing left returns at once, and one
// host call enqueues a chunk of rounds whose state the host reads once.

#include "sell_rounds.cuh"

namespace {

using sell::CsrLists;
using sell::RoundState;
using sell::kClasses;
using sell::kInf;
using sell::kThreads;
using sell::MarkBuf;
using sell::mark_buf;

__global__ void __launch_bounds__(kThreads) bf_mark_seed_kernel(
    const int32_t* __restrict__ dp, void* buf,
    const int32_t* __restrict__ w_new, const int32_t* __restrict__ w_old,
    const int32_t* __restrict__ csr, const int32_t* __restrict__ src,
    const int32_t* __restrict__ dst, int per_col, int S, int n, int W) {
  const MarkBuf mb = mark_buf(buf, n, W);
  const int lane = threadIdx.x & 31;
  const int m = __ldg(csr + n);
  const long long warps = ((long long)gridDim.x * kThreads) >> 5;
  bool marked = false;
  // a warp takes 32 edges at a time, a lane an edge: with shared weights
  // only the edges that got heavier go on, one at a time, the lanes then
  // taking 32 columns each
  for (long long e0 = ((long long)blockIdx.x * kThreads + threadIdx.x -
                       lane);
       e0 < m; e0 += 32 * warps) {
    const long long mine = e0 + lane;
    const bool raised =
        mine < m && (per_col || __ldg(w_new + mine) > __ldg(w_old + mine));
    for (unsigned left = __ballot_sync(0xffffffffu, raised); left;
         left &= left - 1) {
      const long long e = e0 + __ffs(left) - 1;
      const int wo = __ldg(w_old + e);
      const int wn = per_col ? 0 : __ldg(w_new + e);
      const int u = __ldg(src + e), v = __ldg(dst + e);
      for (int w = 0; w < W; ++w) {
        const int s = 32 * w + lane;
        const bool cand =
            s < S && (per_col ? __ldg(w_new + e * S + s) : wn) > wo;
        if (!__any_sync(0xffffffffu, cand)) continue;
        bool hit = false;
        if (cand) {
          const int dv = __ldg(dp + (long long)v * S + s);
          const int du = __ldg(dp + (long long)u * S + s);
          hit = dv < kInf && min(du + wo, kInf) == dv;
        }
        const uint32_t bits = __ballot_sync(0xffffffffu, hit);
        if (lane == 0 && bits) {
          const long long word = (long long)v * W + w;
          atomicOr(mb.m + word, bits);
          atomicOr(mb.nw + word, bits);
          mb.f[v] = 1;
          marked = true;
        }
      }
    }
  }
  sell::finish_round(mb.st, 0, marked);
}

// Round t's first pass: the heads of the edges whose tail newly marked in
// round t - 1, into the row lists (lists: K6's own, after the buffer)
__global__ void __launch_bounds__(kThreads) bf_mark_active_kernel(
    void* buf, int32_t* lists, const int32_t* __restrict__ csr,
    const int32_t* __restrict__ src, const int32_t* __restrict__ dst, int n,
    int W, int t) {
  const MarkBuf mb = mark_buf(buf, n, W);
  if (sell::round_done(mb.st)) return;
  const CsrLists L = sell::csr_lists(lists, n);
  const int32_t* fp = mb.f + (long long)((t - 1) & 1) * n;
  const int m = __ldg(csr + n);
  for (long long at = (long long)blockIdx.x * kThreads; at < m;
       at += (long long)gridDim.x * kThreads)
    sell::list_rows(L, fp, csr, src, dst, n, m, at + threadIdx.x, t, false,
                    false);
}

// Round t's second pass over the listed rows: a thread per (row, mark word,
// lane), list k's rows over P = 2^k lanes each
__global__ void __launch_bounds__(kThreads) bf_mark_round_kernel(
    const int32_t* __restrict__ dp, void* buf, int32_t* lists,
    const int32_t* __restrict__ csr, const int32_t* __restrict__ src,
    const int32_t* __restrict__ w_old, int S, int n, int W, int t) {
  const MarkBuf mb = mark_buf(buf, n, W);
  if (sell::round_done(mb.st)) return;
  const CsrLists L = sell::csr_lists(lists, n);
  const long long nw = (long long)n * W;
  const uint32_t* np = mb.nw + ((t - 1) & 1) * nw;
  uint32_t* nq = mb.nw + (t & 1) * nw;
  const int32_t* fp = mb.f + (long long)((t - 1) & 1) * n;
  int32_t* fq = mb.f + (long long)(t & 1) * n;
  bool changed = false;
  for (int k = 0; k < kClasses; ++k) {
    const int P = 1 << k;
    const long long items = (long long)__ldcg(L.counts + k) * W << k;
    for (long long at = (long long)blockIdx.x * kThreads; at < items;
         at += (long long)gridDim.x * kThreads) {
      const long long item = at + threadIdx.x;
      const bool valid = item < items;
      const long long rw = valid ? item >> k : 0;
      const long long e = rw / W;
      const int w = (int)(rw - e * W);
      const int v = valid ? __ldcg(L.list + (long long)k * n + e) : 0;
      const int p = (int)(item & (P - 1));
      const int lo = valid ? __ldg(csr + v) : 0;
      const int count = valid ? __ldg(csr + v + 1) - lo : 0;
      const long long word = (long long)v * W + w;
      const uint32_t mv = valid ? mb.m[word] : 0;
      uint32_t add = 0;
      const int32_t* dv_row = dp + (long long)v * S + 32 * w;
      for (int j0 = p; j0 < count; j0 += 4 * P) {
        int u[4];
        bool f[4];
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int j = j0 + q * P;
          u[q] = j < count ? __ldg(src + lo + j) : -1;
        }
#pragma unroll
        for (int q = 0; q < 4; ++q)
          f[q] = u[q] >= 0 && __ldg(fp + u[q]) == t;
        for (int q = 0; q < 4; ++q) {
          if (!f[q]) continue;
          const int wo = __ldg(w_old + lo + j0 + q * P);
          const int32_t* du_row = dp + (long long)u[q] * S + 32 * w;
          uint32_t c = __ldg(np + (long long)u[q] * W + w) & ~mv & ~add;
          while (c) {  // 4 candidate columns at a time
            int bit[4], dv[4], du[4];
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              bit[x] = c ? __ffs(c) - 1 : -1;
              c &= c - 1;
            }
#pragma unroll
            for (int x = 0; x < 4; ++x) {
              if (bit[x] < 0) continue;
              dv[x] = __ldg(dv_row + bit[x]);
              du[x] = __ldg(du_row + bit[x]);
            }
#pragma unroll
            for (int x = 0; x < 4; ++x)
              if (bit[x] >= 0 && dv[x] < kInf &&
                  min(du[x] + wo, kInf) == dv[x])
                add |= 1u << bit[x];
          }
        }
      }
      if (P > 1) add = sell::group_or(add, P);
      if (!valid || p != 0) continue;
      nq[word] = add;
      if (add) {
        mb.m[word] = mv | add;
        fq[v] = t + 1;  // every word of the row that grew writes t + 1
        changed = true;
      }
    }
  }
  sell::finish_round(mb.st, t, changed, L.counts, kClasses);
}

__global__ void bf_mark_reset_kernel(const uint32_t* __restrict__ marks,
                                     const int32_t* __restrict__ sources,
                                     int32_t* __restrict__ d0, int S, int n,
                                     int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const long long words = (long long)n * W;
  if (i < words) {
    const int v = (int)(i / W);
    const int w = (int)(i - (long long)v * W);
    for (uint32_t bits = __ldg(marks + i); bits; bits &= bits - 1) {
      const int s = 32 * w + __ffs(bits) - 1;
      d0[(long long)v * S + s] = v == __ldg(sources + s) ? 0 : kInf;
    }
  } else if (i < words + S) {
    const int s = (int)(i - words);
    d0[(long long)__ldg(sources + s) * S + s] = 0;
  }
}

}  // namespace

// dp: the old fixpoint dest-major [n, S]; buf: K5's zeroed fixpoint buffer
// (3 n W + 2 n + 8 int32 words); w_new: [e] shared, or [e, S] per source
// column (per_col); w_old [e]; csr [n + 1], src and dst [e] (e: the edge
// arrays' length, m = csr[n] of them real)
extern "C" int bf_mark_seed(const void* dp, void* buf, const void* w_new,
                            const void* w_old, const void* csr,
                            const void* src, const void* dst, int per_col,
                            int S, int n, int e, int W, void* stream) {
  if (S <= 0 || n <= 0 || e < 0 || W != (S + 31) / 32)
    return (int)cudaErrorInvalidValue;
  const int grid = sell::grid_blocks(
      (const void*)bf_mark_seed_kernel,
      ((long long)e * 32 + kThreads - 1) / kThreads);
  bf_mark_seed_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)dp, buf, (const int32_t*)w_new, (const int32_t*)w_old,
      (const int32_t*)csr, (const int32_t*)src, (const int32_t*)dst, per_col,
      S, n, W);
  return (int)cudaGetLastError();
}

// Launches rounds t0 .. t0 + count - 1, two kernels each (the rows that can
// mark, then the round over them); t0 from 1. lists: zeroed int32 row
// lists, (1 + 6) n + 8 words
extern "C" int bf_mark_rounds(const void* dp, void* buf, void* lists,
                              const void* csr, const void* src,
                              const void* dst, const void* w_old, int S,
                              int n, int e, int W, int t0, int count,
                              void* stream) {
  if (S <= 0 || n <= 0 || e < 0 || t0 < 1 || count < 0 ||
      W != (S + 31) / 32)
    return (int)cudaErrorInvalidValue;
  const int grid_a = sell::grid_blocks((const void*)bf_mark_active_kernel,
                                       ((long long)e + kThreads - 1) /
                                           kThreads);
  const int grid_b = sell::grid_blocks((const void*)bf_mark_round_kernel,
                                       ((long long)n * W + kThreads - 1) /
                                           kThreads);
  cudaStream_t st = (cudaStream_t)stream;
  for (int t = t0; t < t0 + count; ++t) {
    bf_mark_active_kernel<<<grid_a, kThreads, 0, st>>>(
        buf, (int32_t*)lists, (const int32_t*)csr, (const int32_t*)src,
        (const int32_t*)dst, n, W, t);
    bf_mark_round_kernel<<<grid_b, kThreads, 0, st>>>(
        (const int32_t*)dp, buf, (int32_t*)lists, (const int32_t*)csr,
        (const int32_t*)src, (const int32_t*)w_old, S, n, W, t);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return (int)err;
  }
  return 0;
}

// marks: the M words [n, W] of a fixpoint buffer; d0: dp, reset in place
// into K2's dest-major initial state
extern "C" int bf_mark_reset(const void* marks, const void* sources,
                             void* d0, int S, int n, int W, void* stream) {
  if (S <= 0 || n <= 0 || W != (S + 31) / 32)
    return (int)cudaErrorInvalidValue;
  const long long total = (long long)n * W + S;
  bf_mark_reset_kernel<<<(unsigned)((total + kThreads - 1) / kThreads),
                         kThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)marks, (const int32_t*)sources, (int32_t*)d0, S, n,
      W);
  return (int)cudaGetLastError();
}
