// K16 soft_flow and K17 soft_flow_bwd: differentiable TE's soft ECMP flow,
// forward and backward.
//
// Replaces: openr_tpu/te/objective.py `_soft_utilization_core` after the
// softmin (D [N, N], we [E], up [E], demands [B, N, N] vmapped, caps [E] ->
// util [B, E] float32), and the reverse-mode derivative `jax.grad` takes
// through it. The reference:
//
//   gap[e, t]  = (we[e] + D[dst_e, t]) - D[src_e, t]
//   score      = exp(-max(gap, 0) / tau), 0 for a down edge, for t = src_e
//                and where D[dst_e, t] >= F_INF / 2
//   denom[u,t] = sum of score over u's out-edges
//   p[e, t]    = denom > 1e-20 ? score / denom : 0       (double where)
//   x_0        = demands with a zero diagonal
//   x_{r+1}[b, v, t] = sum over v's in-edges of p[e, t] * x_r[b, src_e, t]
//   util[b, e] = sum_t sum_r p[e, t] * x_r[b, src_e, t] / max(caps, 1e-9)
//
// The [E, N] flow tensor of the reference is never built: its row sums are
// sum_t p[e, t] * xsum[b, src_e, t] with xsum = sum_r x_r, which the rounds
// accumulate elementwise.
//
// Entry points:
//
//   soft_gate            K16, a block per (u, kCols columns), 4 columns a
//                        thread, u's out-edges staged: denom, then p for
//                        each out-edge (once per optimizer step)
//   soft_flow_round      K16, a block per (v, kCols columns), 4 columns a
//                        thread, all B scenarios: the pull x_{r+1}, and
//                        xsum += x_r (xsum may be null: the backward's
//                        recomputation)
//   soft_flow_util       K16, a block per kGroup out-edges in out_perm
//                        order, all B scenarios: util[b, e] (once per
//                        optimizer step)
//   soft_flow_bwd_scale  K17, once per backward: c[b, e] = g_util[b, e]
//                        / max(caps[e], 1e-9), the same correctly rounded
//                        division the rounds once made for every column
//   soft_flow_bwd_round  K17, a block per (u, kCols columns), 4 columns a
//                        thread: the adjoint round
//                          g_ef[b, e, t] = c[b, e] + lam_next[b, dst_e, t]
//                          lam[b, u, t]  = sum over out-edges p * g_ef
//                          g_p[e, t]    += sum_b x_r[b, u, t] * g_ef
//                        (lam_next null stands for lam_R = 0; `first` sets
//                        g_p instead of adding to it)
//   soft_gate_bwd_rows   K17, a block per (u, 256 columns), a column a
//                        thread: the softmax-ratio rule
//                        g_score = (g_p - sum_e g_p score / denom) / denom
//                        where denom > 1e-20, else 0; masked like the score;
//                        through exp and max(gap, 0) (half at gap == 0,
//                        which a node with one out-edge gives exactly); the
//                        gap's gradient overwrites g_p, its row sum is
//                        -g_D[u, t], and the block reduces it over its
//                        columns into partial[e, chunk]
//   soft_gate_bwd_pull   K17, a block per (v, kCols columns), 4 columns a
//                        thread: g_D[v, t] += the gap gradients of v's
//                        in-edges (a pull: deterministic)
//   soft_gate_bwd_edges  K17, g_we[e] = the sum of partial[e, :] in order
//
// The gate's forward and backward compute gap and score by one function with
// round-to-nearest intrinsics, so the backward's recomputed gap equals the
// forward's bit for bit and the gap == 0 ties land where the reference's do.
//
// The gate's backward as first designed (one thread per (u, t), each thread
// chasing out_perm -> e -> dst, we, up, a block reduction per out-edge, exp of
// __fdiv_rn) took 3.38-3.39 ms a call at 3,956 nodes and 63,840 edges on an
// H100 (rows 2.98-2.99, pull 0.39-0.41). Scratch variants of it, each with
// one cost taken out, timed on the card: the block reductions 0.25 ms of the
// rows pass, the score's division 0.36, walk 2's two other divisions 0.26.
// The redesign stages u's out-edges, takes the score's quotient from tau's
// reciprocal (div_tau) and sums the per-edge gradients kSub edges at a time
// through shared memory in the butterfly's own tree: rows 2.61-2.62, 3.01
// a call. Its own variants: 4 or 2 columns a thread (as K15's rows pass
// has them) 3.66 and 3.05, the rows of g_p and D no longer held in L1 for
// walk 2; walk 1's values kept in registers for a rack's 8 out-edges
// slower (spills); the gradient's division by tau through a guarded
// div_tau slower (2.84). What remains: walk 2 recomputes each score (its
// gather of D and its exp, 0.31 ms) and divides twice by the correctly
// rounded rule (0.25). The pull stages v's in-edge rows and moves 4
// columns a thread with 16-byte loads: 0.39 ms, as before, at the memory's
// rate. The gate (forward) takes the same quotient: 1.19-1.22 ms against
// 1.48-1.50.
//
// The gate as first designed (one thread per (u, t), each walking u's
// out-edges twice through out_perm -> e -> we, up, dst in global memory,
// 4-byte loads and stores) took 1.20 ms a call at 3,956 nodes and 63,840
// edges on an H100, against a 0.321 ms bound. The redesign stages u's
// out-edges, moves 4 columns a thread with 16-byte rows of D and p, loads
// the D rows of kU out-edges before it uses any, keeps walk 1's scores of
// u's first kKeep out-edges (a rack's all 8) in shared memory, runs the
// column chunks fastest and the nodes by out-degree, largest first
// (out_order), at 48 registers (5 blocks an SM): 0.66-0.68 ms. Its steps
// and variants, timed on the card: staging and 16-byte rows alone 0.95;
// the batched loads 0.85-0.86 (2 or 8 edges at once 0.89, 0.91); column
// chunks fastest 0.81-0.83 (node fastest 0.86); nodes in out_order 0.72
// against 0.82 in node order (the Clos numbers its 57-edge fabric switches
// last, and their blocks ran as a tail); 48 registers 0.66 against 0.71 at
// 64, 0.67 at 40; scores kept for 8 out-edges against 0.74 recomputed
// (4: 0.71, 10: 0.67; in registers, before the batched loads, 1.04
// against 0.95); walk 1's scores written to p and read back by walk 2,
// 1.16-1.22; streaming stores of p 0.66-0.67. With one cost taken out
// each (at 0.84): the division 0.10 ms, p's stores 0.09, walk 1's scores
// 0.17, walk 2's recomputed scores 0.16. What holds it at twice its bound
// is instructions: about 20 an entry for a score (gate_score's exp and a
// branch for its masks) and 10 for __fdiv_rn's quotient, both kept for
// their bits, and walk 2's recomputation of a hub's scores past the first
// kKeep.
//
// The utilization as first designed (a block an edge, for each scenario a
// pass over p's row and a gather of xsum[b, src_e, :], a block reduction
// with two barriers each) took 1.09 ms against a 0.377 ms bound. The
// redesign gives a block kGroup consecutive entries of out_perm, reads
// each p row once for all scenarios and xsum's row once a column for all
// the block's edges of one source (a block has one or two, where a node's
// range ends inside it, except on nodes of fewer out-edges than kGroup),
// reduces the kGroup * kB sums together, and has no branch between a
// column's loads: 0.44-0.46 ms. Its variants, timed on the card: the loads
// behind a branch an edge 0.97; each edge loading its own xsum row 0.72;
// kGroup 8 0.47-0.48 (127 registers), 2 0.73; the column loop unrolled 1,
// 2 or 4 times 0.455, 0.447, 0.61; streaming loads of p 0.455; a path of
// its own for one source 0.454 against 0.460. It streams p at about 2.2
// TB/s. Each (b, e) sums in the first design's order, so util keeps its
// bits.
//
// Bound on the card: bytes. p is [E, N] (1.0 GB at 3,956 nodes and 63,840
// edges): the gate writes it once; a flow round reads it once and gathers
// x[b, src_e, t] for every (e, t), B * E * N * 4 bytes (4 GB at B = 4), and
// writes B * N^2 * 4; the adjoint round reads p, gathers lam the same way
// and reads and writes g_p. Design against the bound: lanes run along t, so
// every gather of a row is coalesced; one thread handles all scenarios
// (chunks of kB), so p is read once per round, not B times; nothing scatters,
// so no atomics and no nondeterministic order.
//
// The adjoint round, measured at 3,956 nodes, 63,840 edges and B = 4 on an
// H100 by timing variants of the one-thread-per-column round that divided
// per column, each with one cost taken out: the division cost 0.5 ms of
// 4.15, the lam_next gather 1.1 ms, g_p's read 0.7 ms; ordering the grid
// node-fastest made it 0.5 ms slower (the node order of a Clos keeps a
// pod's rows together, so column chunks fastest already share the gathered
// rows in L2). So the scale is hoisted into one launch per backward (the same
// __fdiv_rn on the same operands: the values do not change by a bit), a
// block stages its node's out-edges in shared memory, a thread moves 4
// columns with 16-byte loads, and the column chunks stay fastest.
// Each (u, t) sums over out-edges in out_perm order and over b in order with
// the same round-to-nearest intrinsics, so a round equals the one-thread-
// per-column round bit for bit.
//
// The scale is one pass over about 2 MB at te_clos's width (B = 4, 63,840
// edges), under a launch's latency; its body is the first design's (a
// thread an element), since a thread 4 edges walking the B scenarios with
// 16-byte loads, caps clamped once, measured slower on the card (16
// divisions in a row a thread) and a thread an element without the modulo
// no faster (PERF.md). Its span is its wrapper's host time: an output's
// allocation and a ctypes launch.
//
// The flow round as first designed (one thread per (v, t), each thread
// chasing in_perm -> e -> src_e, 4-byte loads) took 1.54-1.57 ms at 3,956
// nodes, 63,840 edges and B = 4 on an H100, against a 0.601 ms bound.
// Scratch variants of it, each with one cost taken out, timed on the card:
// the gather of x[b, src_e, t] cost 0.25 ms (x read from v's own row
// instead: 1.30); 4 columns a thread with 16-byte loads saved 0.18; staging
// the in-edges in shared memory alone saved nothing (the chase hits L1);
// the grid node-fastest cost 0.08 more. The redesign stages v's in-edges
// (e * n, src_e * n) in shared memory, moves 4 columns a thread with
// 16-byte loads of p's row and of x's gathered rows, and loads x without
// waiting on p: 1.24 ms. Its own variants: column chunks fastest 1.27-1.29
// (with 4 columns a thread, node-fastest now wins: one chunk of every
// node's rows is in flight at once), skipping an edge whose 4 p values are
// all 0 1.34 (te_clos has 0.05% zeros; the skip makes x's loads wait on
// p's), __ldg loads 1.24, 128-thread blocks 1.26, the edge loop unrolled
// twice 1.30. Each (v, t) still adds over in-edges in in_perm order, only
// where p[e, t] is not 0, and over b in order: the bits of the first
// design.

#include "te_common.cuh"

namespace {

constexpr int kB = 4;  // scenarios per pass of a thread
constexpr int kGroup = 4;  // out-edges a utilization block owns
constexpr int kU = 4;  // out-edges whose D rows a gate thread loads at once
constexpr int kKeep = 8;  // out-edges whose scores the gate keeps for walk 2

// gap and score of one (edge, column); the exponent -max(gap, 0) / tau is
// taken by div_tau, whose exp softmin_div_check holds against exp of
// __fdiv_rn (the score is computed only where D[dst, t] < F_INF / 2, so
// |gap| < we + F_INF / 2, inside the check's domain)
__device__ __forceinline__ float gate_score(float we_e, bool up_e,
                                           float d_dst, float d_src,
                                           bool self_t, float tau, float rtau,
                                           float* gap_out) {
  const float gap = __fsub_rn(__fadd_rn(we_e, d_dst), d_src);
  *gap_out = gap;
  if (!up_e || self_t || d_dst >= kFInf * 0.5f) return 0.f;
  return expf(div_tau(-fmaxf(gap, 0.f), tau, rtau));
}

// K16's gate: a block owns node u and kCols columns, kQ a thread (16-byte
// rows of D and p where kVec, else columns kThreads apart); u's out-edges
// are staged in shared memory as (e, dst_e * n, we_e, up_e), kStage at a
// time, so no thread chases out_perm -> e -> dst per edge. Walk 1 sums each
// column's denom over out_perm order, loading the D rows of kU out-edges
// before it uses any, and keeps the scores of u's first kKeep out-edges in
// shared memory; walk 2 divides those and recomputes the rest. The column
// chunks run fastest, the nodes in out_order: the most out-edges first, so
// the longest blocks do not start last.
template <bool kVec>
__global__ void __launch_bounds__(kThreads, 5) soft_gate_kernel(
    const float* __restrict__ d, const float* __restrict__ we,
    const bool* __restrict__ up, const int32_t* __restrict__ dst,
    const int32_t* __restrict__ out_ptr, const int32_t* __restrict__ out_perm,
    const int32_t* __restrict__ out_order, float* __restrict__ p, int n,
    float tau) {
  __shared__ int s_e[kStage];
  __shared__ long long s_dst[kStage];
  __shared__ float s_we[kStage];
  __shared__ bool s_up[kStage];
  __shared__ float s_sc[kKeep][kCols];  // walk 1's scores of kKeep out-edges
  const int u = out_order[blockIdx.y];
  const int c0 = blockIdx.x * kCols + (kVec ? kQ * threadIdx.x : threadIdx.x);
  const int beg = out_ptr[u];
  const int end = out_ptr[u + 1];
  const float rtau = __frcp_rn(tau);
  float du[kQ];
  load4<kVec>(d + (long long)u * n, c0, n, du);
  bool self[kQ];
  float denom[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    self[q] = c0 + q * (kVec ? 1 : kThreads) == u;
    denom[q] = 0.f;
  }
  int staged = -1;  // the first edge of the staged out-edges
  float gap;
  for (int k0 = beg; k0 < end; k0 += kStage) {
    const int cnt = min(kStage, end - k0);
    if (k0 != staged) {
      stage_edges(out_perm, dst, we, k0, cnt, n, s_e, s_dst, s_we, up, s_up);
      staged = k0;
    }
    for (int i0 = 0; i0 < cnt; i0 += kU) {
      float dd[kU][kQ];
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        load4<kVec>(d + s_dst[min(i0 + k, cnt - 1)], c0, n, dd[k]);
      }
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        const int i = i0 + k;
        if (i < cnt) {
          const bool keep = k0 == beg && i < kKeep;
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const float score = gate_score(s_we[i], s_up[i], dd[k][q], du[q],
                                           self[q], tau, rtau, &gap);
            if (keep) s_sc[i][q * kThreads + threadIdx.x] = score;
            denom[q] = __fadd_rn(denom[q], score);
          }
        }
      }
    }
  }
  bool ok[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) ok[q] = denom[q] > 1e-20f;
  for (int k0 = beg; k0 < end; k0 += kStage) {
    const int cnt = min(kStage, end - k0);
    if (k0 != staged) {
      stage_edges(out_perm, dst, we, k0, cnt, n, s_e, s_dst, s_we, up, s_up);
      staged = k0;
    }
    const int kept = k0 == beg ? min(cnt, kKeep) : 0;
    for (int i = 0; i < kept; ++i) {
      float pv[kQ];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const float score = s_sc[i][q * kThreads + threadIdx.x];
        pv[q] = ok[q] ? __fdiv_rn(score, denom[q]) : 0.f;
      }
      store4<kVec>(p + (long long)s_e[i] * n, c0, n, pv);
    }
    for (int i0 = kept; i0 < cnt; i0 += kU) {
      float dd[kU][kQ];
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        load4<kVec>(d + s_dst[min(i0 + k, cnt - 1)], c0, n, dd[k]);
      }
#pragma unroll
      for (int k = 0; k < kU; ++k) {
        const int i = i0 + k;
        if (i < cnt) {
          float pv[kQ];
#pragma unroll
          for (int q = 0; q < kQ; ++q) {
            const float score = gate_score(s_we[i], s_up[i], dd[k][q], du[q],
                                           self[q], tau, rtau, &gap);
            pv[q] = ok[q] ? __fdiv_rn(score, denom[q]) : 0.f;
          }
          store4<kVec>(p + (long long)s_e[i] * n, c0, n, pv);
        }
      }
    }
  }
}

// K16's flow round and K17's adjoint round: a block owns one node and
// kCols consecutive columns, kQ a thread: 16-byte loads and stores along t
// where n is a multiple of 4 and the rows are 16-byte aligned (kVec), else
// columns kThreads apart (te_common.cuh's load4 and store4).

// K16's flow round. v's in-edges are staged in shared memory kStage at a
// time (the row offsets of p and of x's gathered row); the grid runs node
// fastest. A column adds only where its p is not 0, as the one-column
// round did, so the bits are the same for every x, not only finite ones.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) soft_flow_round_kernel(
    const float* __restrict__ p, const float* __restrict__ x,
    float* __restrict__ xsum, float* __restrict__ x_next,
    const int32_t* __restrict__ src, const int32_t* __restrict__ in_ptr,
    const int32_t* __restrict__ in_perm, int n, int nb) {
  __shared__ long long s_row[kStage];  // e * n: p's row
  __shared__ long long s_src[kStage];  // src_e * n: x's gathered row
  const int v = blockIdx.x;
  const int c0 = blockIdx.y * kCols + (kVec ? 4 * threadIdx.x : threadIdx.x);
  const long long nn = (long long)n * n;
  const long long vn = (long long)v * n;
  const int beg = in_ptr[v];
  const int end = in_ptr[v + 1];
  int staged = -1;  // the first edge of the staged in-edges
  for (int b0 = 0; b0 < nb; b0 += kB) {
    const int nbk = min(kB, nb - b0);
    float acc[kB][4];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
    }
    for (int k0 = beg; k0 < end; k0 += kStage) {
      const int m = min(kStage, end - k0);
      if (k0 != staged) {
        __syncthreads();  // the previous stage has been read
        for (int i = threadIdx.x; i < m; i += kThreads) {
          const int e = in_perm[k0 + i];
          s_row[i] = (long long)e * n;
          s_src[i] = (long long)src[e] * n;
        }
        __syncthreads();
        staged = k0;
      }
      for (int i = 0; i < m; ++i) {
        float pe[4];
        load4<kVec>(p + s_row[i], c0, n, pe);
#pragma unroll
        for (int j = 0; j < kB; ++j) {
          if (j < nbk) {
            float xv[4];
            load4<kVec>(x + (b0 + j) * nn + s_src[i], c0, n, xv);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (pe[q] != 0.f) {
                acc[j][q] = __fadd_rn(acc[j][q], __fmul_rn(pe[q], xv[q]));
              }
            }
          }
        }
      }
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      if (j < nbk) {
        const long long row = (b0 + j) * nn + vn;
        store4<kVec>(x_next + row, c0, n, acc[j]);
        if (xsum != nullptr) {
          float xs[4], xv[4];
          load4<kVec>(xsum + row, c0, n, xs);
          load4<kVec>(x + row, c0, n, xv);
#pragma unroll
          for (int q = 0; q < 4; ++q) xs[q] = __fadd_rn(xs[q], xv[q]);
          store4<kVec>(xsum + row, c0, n, xs);
        }
      }
    }
  }
}

// A thread's sums of the owned edges' products over its columns t = i, i +
// kThreads, ..., for kB scenarios. The owned edges have at most two
// sources, the first and the last owned edge's (`first` says which), whose
// xsum rows the thread loads once a column, with no branch between a
// column's loads, so they are in flight together; kAny: any sources, an
// edge at a time with its own row.
template <bool kAny>
__device__ __forceinline__ void util_sums(const float* const (&prow)[kGroup],
                                          const float* const (&xrow)[kGroup],
                                          const bool (&first)[kGroup],
                                          long long nn, int nbk, int n,
                                          float (&acc)[kGroup][kB]) {
  long long xoff[kB];  // a scenario past nbk reads scenario nbk - 1's row
#pragma unroll
  for (int j = 0; j < kB; ++j) xoff[j] = min(j, nbk - 1) * nn;
  if constexpr (kAny) {
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
      for (int t = threadIdx.x; t < n; t += kThreads) {
        const float pv = prow[g][t];
#pragma unroll
        for (int j = 0; j < kB; ++j) {
          acc[g][j] = __fadd_rn(acc[g][j],
                                __fmul_rn(pv, xrow[g][xoff[j] + t]));
        }
      }
    }
  } else {
#pragma unroll 2
    for (int t = threadIdx.x; t < n; t += kThreads) {
      float pv[kGroup], x1[kB], x2[kB];
#pragma unroll
      for (int g = 0; g < kGroup; ++g) pv[g] = prow[g][t];
#pragma unroll
      for (int j = 0; j < kB; ++j) {
        x1[j] = xrow[0][xoff[j] + t];
        x2[j] = xrow[kGroup - 1][xoff[j] + t];
      }
#pragma unroll
      for (int g = 0; g < kGroup; ++g) {
#pragma unroll
        for (int j = 0; j < kB; ++j) {
          acc[g][j] = __fadd_rn(acc[g][j],
                                __fmul_rn(pv[g], first[g] ? x1[j] : x2[j]));
        }
      }
    }
  }
}

// K16's utilization: a block owns kGroup consecutive entries of out_perm
// (a run of one node's out-edges, or the end of one node's and the start
// of the next's), so every block streams the same number of p rows, a
// rack's or a spine's alike. A thread sums the columns t = i, i +
// kThreads, ... of every owned edge for kB scenarios at once (util_sums);
// the kGroup * kB sums are then reduced across the block together: each
// warp's in the butterfly's own tree through shared memory, the warps in
// order from 0.f, as the first design's block reduction added one sum at a
// time
__global__ void __launch_bounds__(kThreads) soft_flow_util_kernel(
    const float* __restrict__ p, const float* __restrict__ xsum,
    const float* __restrict__ caps, const int32_t* __restrict__ src,
    const int32_t* __restrict__ out_perm, float* __restrict__ util, int n,
    int e_count, int nb) {
  __shared__ float s_g[kGroup * kB][kWarps][33];  // 33: no bank conflicts
  __shared__ float s_wsum[kGroup * kB][kWarps];
  const int k0 = blockIdx.x * kGroup;
  const int m = min(kGroup, e_count - k0);
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const long long nn = (long long)n * n;
  // an entry past the last owned one repeats the last: its sums go unused
  const float* prow[kGroup];
  long long srow[kGroup];
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    const int e = out_perm[k0 + min(g, m - 1)];
    prow[g] = p + (long long)e * n;
    srow[g] = (long long)src[e] * n;
  }
  bool first[kGroup];  // the first owned edge's source, else the last's
  bool two = true;  // at most two sources
#pragma unroll
  for (int g = 0; g < kGroup; ++g) {
    first[g] = srow[g] == srow[0];
    two = two && (first[g] || srow[g] == srow[kGroup - 1]);
  }
  for (int b0 = 0; b0 < nb; b0 += kB) {
    const int nbk = min(kB, nb - b0);
    const float* xrow[kGroup];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) xrow[g] = xsum + b0 * nn + srow[g];
    float acc[kGroup][kB];
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int j = 0; j < kB; ++j) acc[g][j] = 0.f;
    }
    if (two) {
      util_sums<false>(prow, xrow, first, nn, nbk, n, acc);
    } else {
      util_sums<true>(prow, xrow, first, nn, nbk, n, acc);
    }
    if (b0 > 0) __syncthreads();  // the previous chunk's sums have been read
#pragma unroll
    for (int g = 0; g < kGroup; ++g) {
#pragma unroll
      for (int j = 0; j < kB; ++j) s_g[g * kB + j][warp][lane] = acc[g][j];
    }
    __syncthreads();
    for (int it = threadIdx.x; it < kGroup * kB * kWarps; it += kThreads) {
      s_wsum[it / kWarps][it % kWarps] =
          butterfly_sum(s_g[it / kWarps][it % kWarps]);
    }
    __syncthreads();
    const int g = threadIdx.x / kB;
    const int j = threadIdx.x % kB;
    if (threadIdx.x < kGroup * kB && g < m && j < nbk) {
      float total = 0.f;
      for (int w = 0; w < kWarps; ++w) total += s_wsum[threadIdx.x][w];
      const int e = out_perm[k0 + g];
      util[(long long)(b0 + j) * e_count + e] =
          __fdiv_rn(total, fmaxf(caps[e], 1e-9f));
    }
  }
}

__global__ void __launch_bounds__(kThreads) soft_flow_bwd_scale_kernel(
    const float* __restrict__ g_util, const float* __restrict__ caps,
    float* __restrict__ c, int e_count, int total) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= total) return;
  c[i] = __fdiv_rn(g_util[i], fmaxf(caps[i % e_count], 1e-9f));
}

// K17's adjoint round. u's out-edges are staged in shared memory kStage at
// a time (the row offsets of p and g_p, of lam_next's gathered row, and the
// scale c[b, e]), so no thread chases out_perm -> e -> dst per edge.
template <bool kVec>
__global__ void __launch_bounds__(kThreads) soft_flow_bwd_round_kernel(
    const float* __restrict__ p, const float* __restrict__ c,
    const float* __restrict__ lam_next, const float* __restrict__ x_r,
    float* __restrict__ g_p, float* __restrict__ lam,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ out_ptr,
    const int32_t* __restrict__ out_perm, int n, int e_count, int nb,
    int first) {
  __shared__ long long s_row[kStage];  // e * n: p's and g_p's row
  __shared__ long long s_dst[kStage];  // dst_e * n: lam_next's row
  __shared__ float s_c[kB][kStage];
  const int u = blockIdx.y;
  const int c0 = blockIdx.x * kCols + (kVec ? 4 * threadIdx.x : threadIdx.x);
  const long long nn = (long long)n * n;
  const long long un = (long long)u * n;
  const int beg = out_ptr[u];
  const int end = out_ptr[u + 1];
  for (int b0 = 0; b0 < nb; b0 += kB) {
    const int nbk = min(kB, nb - b0);
    const bool set = first && b0 == 0;
    float xr[kB][4], acc[kB][4];
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      if (j < nbk) {
        load4<kVec>(x_r + (b0 + j) * nn + un, c0, n, xr[j]);
      } else {
#pragma unroll
        for (int q = 0; q < 4; ++q) xr[j][q] = 0.f;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[j][q] = 0.f;
    }
    for (int k0 = beg; k0 < end; k0 += kStage) {
      const int m = min(kStage, end - k0);
      __syncthreads();  // the previous stage has been read
      for (int i = threadIdx.x; i < m; i += kThreads) {
        const int e = out_perm[k0 + i];
        s_row[i] = (long long)e * n;
        s_dst[i] = (long long)dst[e] * n;
#pragma unroll
        for (int j = 0; j < kB; ++j) {
          s_c[j][i] = j < nbk ? c[(long long)(b0 + j) * e_count + e] : 0.f;
        }
      }
      __syncthreads();
      for (int i = 0; i < m; ++i) {
        float pe[4];
        float gp[4] = {0.f, 0.f, 0.f, 0.f};
        load4<kVec>(p + s_row[i], c0, n, pe);
#pragma unroll
        for (int j = 0; j < kB; ++j) {
          if (j < nbk) {
            const float cj = s_c[j][i];
            float g[4];
            if (lam_next != nullptr) {
              load4<kVec>(lam_next + (b0 + j) * nn + s_dst[i], c0, n,
                                 g);
#pragma unroll
              for (int q = 0; q < 4; ++q) g[q] = __fadd_rn(cj, g[q]);
            } else {
#pragma unroll
              for (int q = 0; q < 4; ++q) g[q] = cj;
            }
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              acc[j][q] = __fadd_rn(acc[j][q], __fmul_rn(pe[q], g[q]));
              gp[q] = __fadd_rn(gp[q], __fmul_rn(xr[j][q], g[q]));
            }
          }
        }
        float* row = g_p + s_row[i];
        if (!set) {
          float old[4];
          load4<kVec>(row, c0, n, old);
#pragma unroll
          for (int q = 0; q < 4; ++q) gp[q] = __fadd_rn(old[q], gp[q]);
        }
        store4<kVec>(row, c0, n, gp);
      }
    }
#pragma unroll
    for (int j = 0; j < kB; ++j) {
      if (j < nbk) store4<kVec>(lam + (b0 + j) * nn + un, c0, n, acc[j]);
    }
  }
}

// K17's gate backward, rows pass: a block owns node u and one 256-column
// chunk, a column a thread (four columns a thread, kThreads apart, took
// 3.66 ms at te_clos size against 2.62: 64 registers and 37 KB of shared
// memory a block left L1 too small to hold walk 1's rows for walk 2); u's
// out-edges are staged in shared memory as (e, dst_e * n, we_e, up_e).
// Walk 1 sums denom and s_gp; walk 2 writes g and sends the per-edge
// gradients through shared memory kSub edges at a time, added in the warp
// butterfly's own tree, the warps in order from 0.f, as the first
// design's block reduction added them
__global__ void __launch_bounds__(kThreads) soft_gate_bwd_rows_kernel(
    float* __restrict__ g_p, const float* __restrict__ d,
    const float* __restrict__ we, const bool* __restrict__ up,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ out_ptr,
    const int32_t* __restrict__ out_perm, float* __restrict__ g_d,
    float* __restrict__ partial, int n, int nchunks, float tau) {
  __shared__ int s_e[kStage];
  __shared__ long long s_dst[kStage];
  __shared__ float s_we[kStage];
  __shared__ bool s_up[kStage];
  __shared__ float s_g[kSub][kWarps][33];  // 33: no bank conflicts
  __shared__ float s_wsum[kSub][kWarps];
  const int u = blockIdx.y;
  const int chunk = blockIdx.x;
  const int t = chunk * kThreads + threadIdx.x;
  const bool active = t < n;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int beg = out_ptr[u];
  const int end = out_ptr[u + 1];
  const float rtau = __frcp_rn(tau);
  const float du = active ? d[(long long)u * n + t] : 0.f;
  int staged = -1;  // the first edge of the staged out-edges
  float denom = 0.f, s_gp = 0.f, row = 0.f;
  for (int k0 = beg; k0 < end; k0 += kStage) {
    const int cnt = min(kStage, end - k0);
    if (k0 != staged) {
      stage_edges(out_perm, dst, we, k0, cnt, n, s_e, s_dst, s_we, up, s_up);
      staged = k0;
    }
    if (!active) continue;
    for (int i = 0; i < cnt; ++i) {
      float gap;
      const float score = gate_score(s_we[i], s_up[i], d[s_dst[i] + t], du,
                                     u == t, tau, rtau, &gap);
      denom = __fadd_rn(denom, score);
      s_gp = __fadd_rn(s_gp,
                       __fmul_rn(g_p[(long long)s_e[i] * n + t], score));
    }
  }
  const bool ok = denom > 1e-20f;
  const float ratio = ok ? __fdiv_rn(s_gp, denom) : 0.f;
  for (int k0 = beg; k0 < end; k0 += kStage) {
    const int cnt = min(kStage, end - k0);
    if (k0 != staged) {
      stage_edges(out_perm, dst, we, k0, cnt, n, s_e, s_dst, s_we, up, s_up);
      staged = k0;
    }
    for (int i0 = 0; i0 < cnt; i0 += kSub) {
      const int sub = min(kSub, cnt - i0);
      for (int i = 0; i < sub; ++i) {
        float g = 0.f;
        if (active) {
          const long long at = (long long)s_e[i0 + i] * n + t;
          float gap;
          const float score =
              gate_score(s_we[i0 + i], s_up[i0 + i], d[s_dst[i0 + i] + t],
                         du, u == t, tau, rtau, &gap);
          if (ok && score != 0.f) {
            const float g_score =
                __fdiv_rn(__fsub_rn(g_p[at], ratio), denom);
            const float tie = gap > 0.f ? 1.f : (gap == 0.f ? 0.5f : 0.f);
            g = __fmul_rn(-__fdiv_rn(__fmul_rn(g_score, score), tau), tie);
          }
          g_p[at] = g;
          row = __fsub_rn(row, g);
        }
        s_g[i][warp][lane] = g;
      }
      __syncthreads();
      if (threadIdx.x < sub * kWarps) {
        const int i = threadIdx.x / kWarps;
        s_wsum[i][threadIdx.x % kWarps] =
            butterfly_sum(s_g[i][threadIdx.x % kWarps]);
      }
      __syncthreads();
      if (threadIdx.x < sub) {
        float total = 0.f;
        for (int w = 0; w < kWarps; ++w) total += s_wsum[threadIdx.x][w];
        partial[(long long)s_e[i0 + threadIdx.x] * nchunks + chunk] = total;
      }
    }
  }
  if (active) g_d[(long long)u * n + t] = row;
}

// K17's gate backward, pull: g_D[v, t] += the gap gradients of v's
// in-edges in in_perm order; a block per (v, kCols columns), v's in-edge
// rows staged in shared memory, kQ columns a thread
template <bool kVec>
__global__ void __launch_bounds__(kThreads) soft_gate_bwd_pull_kernel(
    const float* __restrict__ g_gap, const int32_t* __restrict__ in_ptr,
    const int32_t* __restrict__ in_perm, float* __restrict__ g_d, int n) {
  __shared__ long long s_row[kStage];  // e * n: g_gap's row
  const int v = blockIdx.y;
  const int c0 = blockIdx.x * kCols + (kVec ? kQ * threadIdx.x : threadIdx.x);
  const long long vn = (long long)v * n;
  const int beg = in_ptr[v];
  const int end = in_ptr[v + 1];
  float acc[kQ];
  load4<kVec>(g_d + vn, c0, n, acc);
  for (int k0 = beg; k0 < end; k0 += kStage) {
    const int cnt = min(kStage, end - k0);
    __syncthreads();  // the previous stage has been read
    for (int i = threadIdx.x; i < cnt; i += kThreads) {
      s_row[i] = (long long)in_perm[k0 + i] * n;
    }
    __syncthreads();
    for (int i = 0; i < cnt; ++i) {
      float g[kQ];
      load4<kVec>(g_gap + s_row[i], c0, n, g);
#pragma unroll
      for (int q = 0; q < kQ; ++q) acc[q] = __fadd_rn(acc[q], g[q]);
    }
  }
  store4<kVec>(g_d + vn, c0, n, acc);
}

dim3 rows_grid(int n) { return dim3((n + kThreads - 1) / kThreads, n); }

}  // namespace

extern "C" int soft_gate(const void* d, const void* we, const void* up,
                         const void* dst, const void* out_ptr,
                         const void* out_perm, const void* out_order, void* p,
                         int n, float tau, void* stream) {
  if (bad_n(n)) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && aligned16(d) && aligned16(p);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    soft_gate_kernel<true><<<cols_grid(n), kThreads, 0, st>>>(
        (const float*)d, (const float*)we, (const bool*)up,
        (const int32_t*)dst, (const int32_t*)out_ptr, (const int32_t*)out_perm,
        (const int32_t*)out_order, (float*)p, n, tau);
  } else {
    soft_gate_kernel<false><<<cols_grid(n), kThreads, 0, st>>>(
        (const float*)d, (const float*)we, (const bool*)up,
        (const int32_t*)dst, (const int32_t*)out_ptr, (const int32_t*)out_perm,
        (const int32_t*)out_order, (float*)p, n, tau);
  }
  return (int)cudaGetLastError();
}

extern "C" int soft_flow_round(const void* p, const void* x, void* xsum,
                               void* x_next, const void* src,
                               const void* in_ptr, const void* in_perm, int n,
                               int nb, void* stream) {
  if (bad_n(n) || nb < 1) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && aligned16(p) && aligned16(x) &&
                   aligned16(x_next) &&
                   (xsum == nullptr || aligned16(xsum));
  const dim3 grid(n, (n + kCols - 1) / kCols);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    soft_flow_round_kernel<true><<<grid, kThreads, 0, st>>>(
        (const float*)p, (const float*)x, (float*)xsum, (float*)x_next,
        (const int32_t*)src, (const int32_t*)in_ptr, (const int32_t*)in_perm,
        n, nb);
  } else {
    soft_flow_round_kernel<false><<<grid, kThreads, 0, st>>>(
        (const float*)p, (const float*)x, (float*)xsum, (float*)x_next,
        (const int32_t*)src, (const int32_t*)in_ptr, (const int32_t*)in_perm,
        n, nb);
  }
  return (int)cudaGetLastError();
}

extern "C" int soft_flow_util(const void* p, const void* xsum,
                              const void* caps, const void* src,
                              const void* out_perm, void* util, int n, int e,
                              int nb, void* stream) {
  if (bad_n(n) || nb < 1 || e < 0) return (int)cudaErrorInvalidValue;
  if (e == 0) return 0;
  soft_flow_util_kernel<<<(e + kGroup - 1) / kGroup, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const float*)p, (const float*)xsum, (const float*)caps,
      (const int32_t*)src, (const int32_t*)out_perm, (float*)util, n, e, nb);
  return (int)cudaGetLastError();
}

extern "C" int soft_flow_bwd_scale(const void* g_util, const void* caps,
                                   void* c, int e, int nb, void* stream) {
  if (nb < 1 || e < 0 || (long long)nb * e > 0x7fffffffLL)
    return (int)cudaErrorInvalidValue;
  if (e == 0) return 0;
  const int total = nb * e;
  soft_flow_bwd_scale_kernel<<<(total + kThreads - 1) / kThreads, kThreads, 0,
                               (cudaStream_t)stream>>>(
      (const float*)g_util, (const float*)caps, (float*)c, e, total);
  return (int)cudaGetLastError();
}

extern "C" int soft_flow_bwd_round(const void* p, const void* c,
                                   const void* lam_next, const void* x_r,
                                   void* g_p, void* lam, const void* dst,
                                   const void* out_ptr, const void* out_perm,
                                   int n, int e, int nb, int first,
                                   void* stream) {
  if (bad_n(n) || nb < 1) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && aligned16(p) && aligned16(x_r) &&
                   aligned16(g_p) && aligned16(lam) &&
                   (lam_next == nullptr || aligned16(lam_next));
  const dim3 grid((n + kCols - 1) / kCols, n);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    soft_flow_bwd_round_kernel<true><<<grid, kThreads, 0, st>>>(
        (const float*)p, (const float*)c, (const float*)lam_next,
        (const float*)x_r, (float*)g_p, (float*)lam, (const int32_t*)dst,
        (const int32_t*)out_ptr, (const int32_t*)out_perm, n, e, nb, first);
  } else {
    soft_flow_bwd_round_kernel<false><<<grid, kThreads, 0, st>>>(
        (const float*)p, (const float*)c, (const float*)lam_next,
        (const float*)x_r, (float*)g_p, (float*)lam, (const int32_t*)dst,
        (const int32_t*)out_ptr, (const int32_t*)out_perm, n, e, nb, first);
  }
  return (int)cudaGetLastError();
}

extern "C" int soft_gate_bwd_rows(void* g_p, const void* d, const void* we,
                                  const void* up, const void* dst,
                                  const void* out_ptr, const void* out_perm,
                                  void* g_d, void* partial, int n,
                                  int nchunks, float tau, void* stream) {
  if (bad_n(n) || nchunks != (n + kThreads - 1) / kThreads)
    return (int)cudaErrorInvalidValue;
  soft_gate_bwd_rows_kernel<<<rows_grid(n), kThreads, 0,
                              (cudaStream_t)stream>>>(
      (float*)g_p, (const float*)d, (const float*)we, (const bool*)up,
      (const int32_t*)dst, (const int32_t*)out_ptr, (const int32_t*)out_perm,
      (float*)g_d, (float*)partial, n, nchunks, tau);
  return (int)cudaGetLastError();
}

extern "C" int soft_gate_bwd_pull(const void* g_gap, const void* in_ptr,
                                  const void* in_perm, void* g_d, int n,
                                  void* stream) {
  if (bad_n(n)) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && aligned16(g_gap) && aligned16(g_d);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    soft_gate_bwd_pull_kernel<true><<<cols_grid(n), kThreads, 0, st>>>(
        (const float*)g_gap, (const int32_t*)in_ptr, (const int32_t*)in_perm,
        (float*)g_d, n);
  } else {
    soft_gate_bwd_pull_kernel<false><<<cols_grid(n), kThreads, 0, st>>>(
        (const float*)g_gap, (const int32_t*)in_ptr, (const int32_t*)in_perm,
        (float*)g_d, n);
  }
  return (int)cudaGetLastError();
}

extern "C" int soft_gate_bwd_edges(const void* partial, void* g_we, int e,
                                   int nchunks, void* stream) {
  if (e == 0) return 0;
  sum_chunks_kernel<<<(e + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>((const float*)partial,
                                              (float*)g_we, e, nchunks);
  return (int)cudaGetLastError();
}
