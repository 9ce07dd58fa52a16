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
//   soft_gate            K16, one thread per (u, t): denom, then p for each
//                        out-edge (once per optimizer step)
//   soft_flow_round      K16, a block per (v, kCols columns), 4 columns a
//                        thread, all B scenarios: the pull x_{r+1}, and
//                        xsum += x_r (xsum may be null: the backward's
//                        recomputation)
//   soft_flow_util       K16, one block per edge: util[b, e]
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
// chasing out_perm -> e -> dst, we, up, a block_sum per out-edge, exp of
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

__device__ __forceinline__ float block_sum(float v, float* red) {
  for (int off = 16; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  float total = 0.f;
  if (threadIdx.x == 0) {
    for (int w = 0; w < kThreads / 32; ++w) total += red[w];
  }
  __syncthreads();
  return total;  // valid in thread 0
}

__global__ void __launch_bounds__(kThreads) soft_gate_kernel(
    const float* __restrict__ d, const float* __restrict__ we,
    const bool* __restrict__ up, const int32_t* __restrict__ dst,
    const int32_t* __restrict__ out_ptr, const int32_t* __restrict__ out_perm,
    float* __restrict__ p, int n, float tau) {
  const int u = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const float rtau = __frcp_rn(tau);
  const float du = d[(long long)u * n + t];
  const int beg = out_ptr[u];
  const int end = out_ptr[u + 1];
  float denom = 0.f;
  float gap;
  for (int k = beg; k < end; ++k) {
    const int e = out_perm[k];
    denom = __fadd_rn(denom, gate_score(we[e], up[e],
                                        d[(long long)dst[e] * n + t], du,
                                        u == t, tau, rtau, &gap));
  }
  const bool ok = denom > 1e-20f;
  for (int k = beg; k < end; ++k) {
    const int e = out_perm[k];
    const float score = gate_score(we[e], up[e], d[(long long)dst[e] * n + t],
                                   du, u == t, tau, rtau, &gap);
    p[(long long)e * n + t] = ok ? __fdiv_rn(score, denom) : 0.f;
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

__global__ void __launch_bounds__(kThreads) soft_flow_util_kernel(
    const float* __restrict__ p, const float* __restrict__ xsum,
    const float* __restrict__ caps, const int32_t* __restrict__ src,
    float* __restrict__ util, int n, int e_count, int nb) {
  __shared__ float red[kThreads / 32];
  const int e = blockIdx.x;
  const long long nn = (long long)n * n;
  const float* pe = p + (long long)e * n;
  const long long u_row = (long long)src[e] * n;
  const float cap = fmaxf(caps[e], 1e-9f);
  for (int b = 0; b < nb; ++b) {
    const float* xs = xsum + b * nn + u_row;
    float acc = 0.f;
    for (int t = threadIdx.x; t < n; t += kThreads) {
      acc = __fadd_rn(acc, __fmul_rn(pe[t], xs[t]));
    }
    acc = block_sum(acc, red);
    if (threadIdx.x == 0) util[(long long)b * e_count + e] = __fdiv_rn(acc, cap);
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
// butterfly's own tree, the warps in order from 0.f, as block_sum added
// them
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
                         const void* out_perm, void* p, int n, float tau,
                         void* stream) {
  if (bad_n(n)) return (int)cudaErrorInvalidValue;
  soft_gate_kernel<<<rows_grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d, (const float*)we, (const bool*)up,
      (const int32_t*)dst, (const int32_t*)out_ptr, (const int32_t*)out_perm,
      (float*)p, n, tau);
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
                              const void* caps, const void* src, void* util,
                              int n, int e, int nb, void* stream) {
  if (bad_n(n) || nb < 1) return (int)cudaErrorInvalidValue;
  if (e == 0) return 0;
  soft_flow_util_kernel<<<e, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)p, (const float*)xsum, (const float*)caps,
      (const int32_t*)src, (float*)util, n, e, nb);
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
