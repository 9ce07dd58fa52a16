// K14 softmin_round and K15 softmin_round_bwd: one round of differentiable
// TE's softmin relaxation, forward and backward.
//
// Replaces: openr_tpu/te/objective.py `_segment_softmin` and the scan body
// of `_softmin_fixpoint_core` (we [E] float32, src_e/dst_e [E] int32, tau,
// D [N, N] float32 with F_INF = 1e9 for unreachable), and the reverse-mode
// derivative `jax.grad` takes through it. Per round, for each node u and
// destination t (row u, column t of D):
//
//   x_e      = min(min(we[e] + D[dst_e, t], F_INF), F_INF)  over u's out-edges
//   m        = min(min_e x_e, F_INF)                (F_INF for no out-edge)
//   s        = sum_e exp(-(x_e - m) / tau)
//   out      = m - tau * log(max(s, 1e-30))
//   relaxed  = s > 0 ? min(out, F_INF) : F_INF
//   D'[u, t] = u == t ? 0 : min(D[u, t], relaxed)
//
// Entry points:
//
//   softmin_round      K14: D -> D', one thread per (u, t); also records
//                      the fold's outcome, keep[u, t] = 2 where D < relaxed,
//                      1 at a tie, 0 where relaxed < D (one byte)
//   softmin_bwd_rows   K15, pass 1, a block per (u, kCols columns), 4
//                      columns a thread: recomputes m and s, splits g'
//                      between the incumbent (keep / 2 of it, written to
//                      g_prev) and the softmin, and stores (coef = g_out /
//                      s, m) side by side; also reduces
//                      g_x_e = coef * exp(-(x_e - m) / tau) * clamp over
//                      each 256 columns for each out-edge into
//                      partial[e, chunk]
//   softmin_bwd_pull   K15, pass 2, a block per (v, kCols columns), 4
//                      columns a thread: g_prev[v, t] += g_x_e over v's
//                      in-edges (a pull: no atomics, a fixed order,
//                      deterministic)
//   softmin_bwd_edges  K15, g_we[e] = the sum of partial[e, :] in order
//   softmin_div_check  not a kernel of the path: counts the exponents at
//                      which K15's quotient by tau (below) would give exp
//                      other bits than the correctly rounded division
//
// Tie rules, as the reference's reverse mode has them: an exact tie of
// min(a, b) sends half the gradient to each side. The fold D' = min(D,
// relaxed) ties wherever a converged entry meets the same softmin again;
// min(out, F_INF) ties when m = F_INF and tau * log(s) is below half the
// float32 spacing at 1e9 (64); each of a candidate's two clamps ties when
// we + D[dst, t] == F_INF exactly, which float32 gives for we <= 32 when
// D[dst, t] = F_INF, so such a candidate passes a quarter of its gradient.
// The kernels test the float32 values exactly as the reference computes
// them, with explicit round-to-nearest intrinsics (nvcc contracts nothing
// into an FMA). The fold's outcome is recorded by the forward, not
// recomputed: a converged entry ties with its softmin because the forward
// recomputes the softmin from the same inputs, and a backward that
// recomputed it in another arithmetic order (the plain version, another
// library's exp) could miss by one rounding and move half the gradient.
//
// The stabiliser m: its gradient is g_out * (1 - sum_e p_e), zero in exact
// arithmetic; the backward drops it (the reference keeps its rounding).
//
// Bound on the card: bytes (the kernels line counts each input read once
// and each output written once). The forward gathers D[dst_e, t] for every
// (e, t), E * N * 4 bytes (1.0 GB at 3,956 nodes and 63,840 edges), and
// reads and writes D once; its E * N exponentials take 0.06 ms at the MUFU
// rate (16 per SM per clock). The backward gathers D three times, (coef,
// m) once, reads keep and writes g_prev and (coef, m). Lanes run along t,
// so every gather of a row is coalesced. The forward keeps two passes over
// the out-edges (min, then the sum) so that its rounding is the
// reference's formula, the second pass hitting L2.
//
// K15 as first designed (one thread per (u, t), a block reduction per
// out-edge, coef and m in two arrays) took 2.86-2.89 ms a call at 3,956
// nodes, 63,840 edges and tau 0.5 on an H100 (rows 1.95, pull 0.92). Scratch
// variants of it, each with one cost taken out, timed on the card: the
// rows pass's third walk cost 1.09 ms of its 1.98 (its block reductions
// 0.31, its gather of D 0.37, its exp 0.10); the pull's two gathers 0.52
// of 0.92 (interleaving coef and m saved 0.17). The redesign's own
// variants then showed what the memory traffic had hidden: the division
// by tau before each exp (__fdiv_rn, a subroutine with a slow path) cost
// 0.71 ms of the new rows pass's 1.75 and 0.29 of its pull's 0.66, and the
// warp shuffles of the per-edge butterflies 0.14-0.16. So:
//
//   - a block owns 4 x 256 columns and stages its node's edges (e, the row
//     offset of dst_e or src_e, we_e) in shared memory, 128 at a time;
//   - the rows pass reduces kSub out-edges at a time: the gradients go to
//     shared memory, a thread per (edge, 32 columns) adds them in the xor
//     butterfly's own tree, a thread per (edge, 256 columns) sums the 8
//     warps: two barriers per 8 edges, no shuffles;
//   - the rows pass writes (coef, m) as one float2, so the pull gathers
//     one 8-byte value an in-edge, 16-byte loads where the rows allow;
//   - a / tau is q = a * r, r = tau's correctly rounded reciprocal, then
//     q + (a - q * tau) * r with two fused multiply-adds (Markstein's
//     correction), the correctly rounded quotient; softmin_div_check
//     shows on the card that exp of it has the bits of exp(__fdiv_rn(a,
//     tau)) at every exponent K15 can meet (a <= 0, |a| <= 2^32),
//     exhaustively, for the temperatures it is given. The rows' division
//     g_out / s, once a (u, t), stays __fdiv_rn.
//
// The orders are the first design's, so K15's bits are: g_prev is gn *
// keep / 2, then v's in-edges in in_perm order; a (u, t)'s m and s run over
// u's out-edges in out_perm order; partial[e, chunk] is the same 32-lane
// tree for each warp of 32 consecutive columns, then warps 0..7 in order
// from 0.f; g_we adds the chunks in order.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr float kFInf = 1.0e9f;
constexpr int kThreads = 256;
constexpr int kMaxN = 65535;

// The softmin of (u, t) over u's out-edges out_perm[beg:end]: m and s.
__device__ __forceinline__ void softmin_cell(
    const float* __restrict__ d, const float* __restrict__ we,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ out_perm,
    int beg, int end, int n, int t, float tau, float* m_out, float* s_out) {
  float m = INFINITY;
  for (int k = beg; k < end; ++k) {
    const int e = out_perm[k];
    const float x =
        fminf(__fadd_rn(we[e], d[(long long)dst[e] * n + t]), kFInf);
    m = fminf(m, x);
  }
  m = fminf(m, kFInf);
  float s = 0.f;
  for (int k = beg; k < end; ++k) {
    const int e = out_perm[k];
    const float x =
        fminf(__fadd_rn(we[e], d[(long long)dst[e] * n + t]), kFInf);
    s = __fadd_rn(s, expf(__fdiv_rn(-__fsub_rn(x, m), tau)));
  }
  *m_out = m;
  *s_out = s;
}

__device__ __forceinline__ float softmin_out(float m, float s, float tau) {
  return __fsub_rn(m, __fmul_rn(tau, logf(fmaxf(s, 1e-30f))));
}

__device__ __forceinline__ float relaxed_of(float out, float s) {
  return s > 0.f ? fminf(out, kFInf) : kFInf;
}

// d min(a, b) / d a with half at a tie
__device__ __forceinline__ float half_ties(float a, float b) {
  return a < b ? 1.f : (a == b ? 0.5f : 0.f);
}

// the gradient factor of a candidate's two F_INF clamps
__device__ __forceinline__ float clamp_factor(float total) {
  return total < kFInf ? 1.f : (total == kFInf ? 0.25f : 0.f);
}

// K15's a / tau from r, tau's correctly rounded reciprocal: a product and
// two fused corrections (Markstein), the correctly rounded quotient where
// it neither overflows nor is subnormal; a = -0 gives +0, whose exp is the
// same 1 (softmin_div_check holds exp of it against __fdiv_rn's)
__device__ __forceinline__ float div_tau(float a, float tau, float r) {
  const float q = __fmul_rn(a, r);
  return __fmaf_rn(__fmaf_rn(-q, tau, a), r, q);
}

__global__ void __launch_bounds__(kThreads) softmin_round_kernel(
    const float* __restrict__ d_prev, const float* __restrict__ we,
    const int32_t* __restrict__ dst, const int32_t* __restrict__ out_ptr,
    const int32_t* __restrict__ out_perm, float* __restrict__ d_new,
    uint8_t* __restrict__ keep, int n, float tau) {
  const int u = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  float m, s;
  softmin_cell(d_prev, we, dst, out_perm, out_ptr[u], out_ptr[u + 1], n, t,
               tau, &m, &s);
  const float relaxed = relaxed_of(softmin_out(m, s, tau), s);
  const long long i = (long long)u * n + t;
  const float dp = d_prev[i];
  d_new[i] = u == t ? 0.f : fminf(dp, relaxed);
  keep[i] = dp < relaxed ? 2 : (dp == relaxed ? 1 : 0);
}

// K15's column layout: a block owns one node and kCols columns, kQ a
// thread. In the rows pass the columns of a thread lie kThreads apart, so
// for each group q warp w holds 32 consecutive columns, those that warp w
// of a one-column-a-thread block of 256 held. In the pull they lie side by
// side where the rows allow 16-byte loads (kVec).
constexpr int kQ = 4;
constexpr int kCols = kQ * kThreads;
constexpr int kWarps = kThreads / 32;
constexpr int kStage = 128;  // edges a block stages in shared memory
constexpr int kSub = 8;  // out-edges a rows block reduces at a time
static_assert(kSub * kQ * kWarps == kThreads, "a tree a thread");

// The sum a warp's xor butterfly (v += shfl_xor(v, 16), 8, 4, 2, 1) leaves
// in every lane, of the 32 values v[0..32) that its lanes held, added in
// the butterfly's own tree
__device__ __forceinline__ float butterfly_sum(const float* v) {
  float a[16];  // each level written out, so a stays in registers
#pragma unroll
  for (int j = 0; j < 16; ++j) a[j] = v[j] + v[j + 16];
#pragma unroll
  for (int j = 0; j < 8; ++j) a[j] = a[j] + a[j + 8];
#pragma unroll
  for (int j = 0; j < 4; ++j) a[j] = a[j] + a[j + 4];
#pragma unroll
  for (int j = 0; j < 2; ++j) a[j] = a[j] + a[j + 2];
  return a[0] + a[1];
}

// Stage edges perm[k0:k0 + m]: e, the row offset of `node`[e] and we[e].
// The leading barrier lets the block finish reading the previous stage.
__device__ __forceinline__ void stage_edges(
    const int32_t* __restrict__ perm, const int32_t* __restrict__ node,
    const float* __restrict__ we, int k0, int m, int n, int* s_e,
    long long* s_row, float* s_we) {
  __syncthreads();
  for (int i = threadIdx.x; i < m; i += kThreads) {
    const int e = perm[k0 + i];
    s_e[i] = e;
    s_row[i] = (long long)node[e] * n;
    s_we[i] = we[e];
  }
  __syncthreads();
}

__global__ void __launch_bounds__(kThreads) softmin_bwd_rows_kernel(
    const float* __restrict__ g_new, const float* __restrict__ d_prev,
    const uint8_t* __restrict__ keep, const float* __restrict__ we,
    const int32_t* __restrict__ dst,
    const int32_t* __restrict__ out_ptr, const int32_t* __restrict__ out_perm,
    float* __restrict__ g_prev, float2* __restrict__ cm,
    float* __restrict__ partial, int n, int nchunks, float tau) {
  __shared__ int s_e[kStage];
  __shared__ long long s_dst[kStage];
  __shared__ float s_we[kStage];
  __shared__ float s_g[kSub][kQ][kWarps][33];  // 33: no bank conflicts
  __shared__ float s_wsum[kSub][kQ][kWarps];
  const int u = blockIdx.y;
  const int t0 = blockIdx.x * kCols + threadIdx.x;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int beg = out_ptr[u];
  const int end = out_ptr[u + 1];
  const float rtau = __frcp_rn(tau);
  int staged = -1;  // the first edge of the staged out-edges
  float m[kQ], s[kQ], c[kQ];
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    m[q] = INFINITY;
    s[q] = 0.f;
    c[q] = 0.f;
  }
  // the softmin's two walks, softmin_cell's arithmetic for each column
  for (int k0 = beg; k0 < end; k0 += kStage) {
    const int cnt = min(kStage, end - k0);
    if (k0 != staged) {
      stage_edges(out_perm, dst, we, k0, cnt, n, s_e, s_dst, s_we);
      staged = k0;
    }
    for (int i = 0; i < cnt; ++i) {
      const float* row = d_prev + s_dst[i];
      const float w = s_we[i];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int t = t0 + q * kThreads;
        if (t < n) m[q] = fminf(m[q], fminf(__fadd_rn(w, row[t]), kFInf));
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q) m[q] = fminf(m[q], kFInf);
  for (int k0 = beg; k0 < end; k0 += kStage) {
    const int cnt = min(kStage, end - k0);
    if (k0 != staged) {
      stage_edges(out_perm, dst, we, k0, cnt, n, s_e, s_dst, s_we);
      staged = k0;
    }
    for (int i = 0; i < cnt; ++i) {
      const float* row = d_prev + s_dst[i];
      const float w = s_we[i];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        const int t = t0 + q * kThreads;
        if (t < n) {
          const float x = fminf(__fadd_rn(w, row[t]), kFInf);
          s[q] = __fadd_rn(s[q],
                           expf(div_tau(-__fsub_rn(x, m[q]), tau, rtau)));
        }
      }
    }
  }
#pragma unroll
  for (int q = 0; q < kQ; ++q) {
    const int t = t0 + q * kThreads;
    if (t < n) {
      const float out = softmin_out(m[q], s[q], tau);
      const long long i = (long long)u * n + t;
      const float gn = u == t ? 0.f : g_new[i];
      const float k = 0.5f * keep[i];
      g_prev[i] = __fmul_rn(gn, k);
      if (s[q] > 0.f) {
        const float g_out = __fmul_rn(__fmul_rn(gn, 1.f - k),
                                      half_ties(out, kFInf));
        c[q] = __fdiv_rn(g_out, s[q]);
      }
      cm[i] = make_float2(c[q], m[q]);
    }
  }
  // each out-edge's gradient, reduced over the block's columns chunk by
  // chunk, kSub edges at a time: the gradients go to shared memory; a
  // thread per (edge, group, warp) adds its warp's 32 in the xor
  // butterfly's tree; a thread per (edge, group) sums the 8 warps in order
  for (int k0 = beg; k0 < end; k0 += kStage) {
    const int cnt = min(kStage, end - k0);
    if (k0 != staged) {
      stage_edges(out_perm, dst, we, k0, cnt, n, s_e, s_dst, s_we);
      staged = k0;
    }
    for (int i0 = 0; i0 < cnt; i0 += kSub) {
      const int sub = min(kSub, cnt - i0);
      for (int i = 0; i < sub; ++i) {
        const float* row = d_prev + s_dst[i0 + i];
        const float w = s_we[i0 + i];
#pragma unroll
        for (int q = 0; q < kQ; ++q) {
          const int t = t0 + q * kThreads;
          float g = 0.f;
          if (t < n && c[q] != 0.f) {
            const float total = __fadd_rn(w, row[t]);
            const float x = fminf(total, kFInf);
            const float z = expf(div_tau(-__fsub_rn(x, m[q]), tau, rtau));
            g = __fmul_rn(__fmul_rn(c[q], z), clamp_factor(total));
          }
          s_g[i][q][warp][lane] = g;
        }
      }
      __syncthreads();
      const int i = threadIdx.x >> 5;
      if (i < sub) {
        const int q = (threadIdx.x >> 3) & (kQ - 1);
        const int wv = threadIdx.x & (kWarps - 1);
        s_wsum[i][q][wv] = butterfly_sum(s_g[i][q][wv]);
      }
      __syncthreads();
      if (threadIdx.x < sub * kQ) {
        const int i = threadIdx.x / kQ;
        const int q = threadIdx.x % kQ;
        const int chunk = blockIdx.x * kQ + q;
        if (chunk < nchunks) {
          float total = 0.f;
          for (int w = 0; w < kWarps; ++w) total += s_wsum[i][q][w];
          partial[(long long)s_e[i0 + i] * nchunks + chunk] = total;
        }
      }
    }
  }
}

template <bool kVec>
__device__ __forceinline__ void load4(const float* __restrict__ row, int c0,
                                      int n, float (&v)[kQ]) {
  if (kVec) {
    float4 x = make_float4(0.f, 0.f, 0.f, 0.f);
    if (c0 < n) x = *reinterpret_cast<const float4*>(row + c0);
    v[0] = x.x; v[1] = x.y; v[2] = x.z; v[3] = x.w;
  } else {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int t = c0 + q * kThreads;
      v[q] = t < n ? row[t] : 0.f;
    }
  }
}

// (coef, m) of 4 columns: two 16-byte loads, or columns kThreads apart
template <bool kVec>
__device__ __forceinline__ void load_cm(const float2* __restrict__ row,
                                        int c0, int n, float (&c)[kQ],
                                        float (&m)[kQ]) {
  if (kVec) {
    float4 a = make_float4(0.f, 0.f, 0.f, 0.f), b = a;
    if (c0 < n) {
      const float4* p = reinterpret_cast<const float4*>(row + c0);
      a = p[0];
      b = p[1];
    }
    c[0] = a.x; m[0] = a.y; c[1] = a.z; m[1] = a.w;
    c[2] = b.x; m[2] = b.y; c[3] = b.z; m[3] = b.w;
  } else {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int t = c0 + q * kThreads;
      const float2 v = t < n ? row[t] : make_float2(0.f, 0.f);
      c[q] = v.x;
      m[q] = v.y;
    }
  }
}

template <bool kVec>
__global__ void __launch_bounds__(kThreads) softmin_bwd_pull_kernel(
    const float* __restrict__ d_prev, const float* __restrict__ we,
    const int32_t* __restrict__ src, const int32_t* __restrict__ in_ptr,
    const int32_t* __restrict__ in_perm, const float2* __restrict__ cm,
    float* __restrict__ g_prev, int n, float tau) {
  __shared__ int s_e[kStage];
  __shared__ long long s_src[kStage];
  __shared__ float s_we[kStage];
  const int v = blockIdx.y;
  const int c0 = blockIdx.x * kCols + (kVec ? kQ * threadIdx.x : threadIdx.x);
  const long long vn = (long long)v * n;
  const int beg = in_ptr[v];
  const int end = in_ptr[v + 1];
  const float rtau = __frcp_rn(tau);
  float dv[kQ], acc[kQ];
  load4<kVec>(d_prev + vn, c0, n, dv);
  load4<kVec>(g_prev + vn, c0, n, acc);
  for (int k0 = beg; k0 < end; k0 += kStage) {
    const int cnt = min(kStage, end - k0);
    stage_edges(in_perm, src, we, k0, cnt, n, s_e, s_src, s_we);
    for (int i = 0; i < cnt; ++i) {
      float c[kQ], m[kQ];
      load_cm<kVec>(cm + s_src[i], c0, n, c, m);
      const float w = s_we[i];
#pragma unroll
      for (int q = 0; q < kQ; ++q) {
        if (c[q] == 0.f) continue;
        const float total = __fadd_rn(w, dv[q]);
        const float x = fminf(total, kFInf);
        const float z = expf(div_tau(-__fsub_rn(x, m[q]), tau, rtau));
        acc[q] = __fadd_rn(acc[q],
                           __fmul_rn(__fmul_rn(c[q], z), clamp_factor(total)));
      }
    }
  }
  float* out = g_prev + vn;
  if (kVec) {
    if (c0 < n) {
      *reinterpret_cast<float4*>(out + c0) =
          make_float4(acc[0], acc[1], acc[2], acc[3]);
    }
  } else {
#pragma unroll
    for (int q = 0; q < kQ; ++q) {
      const int t = c0 + q * kThreads;
      if (t < n) out[t] = acc[q];
    }
  }
}

// A check of div_tau, not a kernel of the path: over every float a <= 0
// with |a| <= 2^32 (K15's exponents -(x - m), 0 <= x - m <= F_INF), the
// count of a whose expf(div_tau(a, tau)) differs in its bits from
// expf(__fdiv_rn(a, tau))
__global__ void __launch_bounds__(kThreads) div_check_kernel(
    float tau, unsigned long long* __restrict__ count) {
  constexpr unsigned kLast = 0x4f800000u;  // 2^32
  const float r = __frcp_rn(tau);
  unsigned long long bad = 0;
  for (unsigned long long u =
           blockIdx.x * (unsigned long long)kThreads + threadIdx.x;
       u <= kLast; u += (unsigned long long)gridDim.x * kThreads) {
    const float a = -__uint_as_float((unsigned)u);
    bad += __float_as_uint(expf(div_tau(a, tau, r))) !=
           __float_as_uint(expf(__fdiv_rn(a, tau)));
  }
  if (bad != 0) atomicAdd(count, bad);
}

__global__ void __launch_bounds__(kThreads) sum_chunks_kernel(
    const float* __restrict__ partial, float* __restrict__ out, int e,
    int nchunks) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= e) return;
  float acc = 0.f;
  for (int c = 0; c < nchunks; ++c) acc += partial[(long long)i * nchunks + c];
  out[i] = acc;
}

bool bad_n(int n) { return n < 1 || n > kMaxN; }

dim3 rows_grid(int n) { return dim3((n + kThreads - 1) / kThreads, n); }

dim3 cols_grid(int n) { return dim3((n + kCols - 1) / kCols, n); }

bool aligned16(const void* ptr) { return ((uintptr_t)ptr & 15) == 0; }

}  // namespace

extern "C" int softmin_round(const void* d_prev, const void* we,
                             const void* dst, const void* out_ptr,
                             const void* out_perm, void* d_new, void* keep,
                             int n, float tau, void* stream) {
  if (bad_n(n)) return (int)cudaErrorInvalidValue;
  softmin_round_kernel<<<rows_grid(n), kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)d_prev, (const float*)we, (const int32_t*)dst,
      (const int32_t*)out_ptr, (const int32_t*)out_perm, (float*)d_new,
      (uint8_t*)keep, n, tau);
  return (int)cudaGetLastError();
}

extern "C" int softmin_bwd_rows(const void* g_new, const void* d_prev,
                                const void* keep, const void* we,
                                const void* dst,
                                const void* out_ptr, const void* out_perm,
                                void* g_prev, void* cm, void* partial, int n,
                                int nchunks, float tau, void* stream) {
  if (bad_n(n) || nchunks != (n + kThreads - 1) / kThreads)
    return (int)cudaErrorInvalidValue;
  softmin_bwd_rows_kernel<<<cols_grid(n), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)g_new, (const float*)d_prev, (const uint8_t*)keep,
      (const float*)we, (const int32_t*)dst, (const int32_t*)out_ptr,
      (const int32_t*)out_perm, (float*)g_prev, (float2*)cm,
      (float*)partial, n, nchunks, tau);
  return (int)cudaGetLastError();
}

extern "C" int softmin_bwd_pull(const void* d_prev, const void* we,
                                const void* src, const void* in_ptr,
                                const void* in_perm, const void* cm,
                                void* g_prev, int n, float tau,
                                void* stream) {
  if (bad_n(n)) return (int)cudaErrorInvalidValue;
  const bool vec = n % 4 == 0 && aligned16(d_prev) && aligned16(cm) &&
                   aligned16(g_prev);
  cudaStream_t st = (cudaStream_t)stream;
  if (vec) {
    softmin_bwd_pull_kernel<true><<<cols_grid(n), kThreads, 0, st>>>(
        (const float*)d_prev, (const float*)we, (const int32_t*)src,
        (const int32_t*)in_ptr, (const int32_t*)in_perm, (const float2*)cm,
        (float*)g_prev, n, tau);
  } else {
    softmin_bwd_pull_kernel<false><<<cols_grid(n), kThreads, 0, st>>>(
        (const float*)d_prev, (const float*)we, (const int32_t*)src,
        (const int32_t*)in_ptr, (const int32_t*)in_perm, (const float2*)cm,
        (float*)g_prev, n, tau);
  }
  return (int)cudaGetLastError();
}

extern "C" int softmin_bwd_edges(const void* partial, void* g_we, int e,
                                 int nchunks, void* stream) {
  if (e == 0) return 0;
  sum_chunks_kernel<<<(e + kThreads - 1) / kThreads, kThreads, 0,
                      (cudaStream_t)stream>>>((const float*)partial,
                                              (float*)g_we, e, nchunks);
  return (int)cudaGetLastError();
}

extern "C" int softmin_div_check(float tau, void* count, void* stream) {
  div_check_kernel<<<2048, kThreads, 0, (cudaStream_t)stream>>>(
      tau, (unsigned long long*)count);
  return (int)cudaGetLastError();
}
