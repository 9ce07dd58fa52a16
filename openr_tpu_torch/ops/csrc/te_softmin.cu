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
//   softmin_bwd_rows   K15, pass 1, one thread per (u, t): recomputes m and
//                      s, splits g' between the incumbent (keep / 2 of it,
//                      written to g_prev) and the softmin, and stores coef =
//                      g_out / s and m; a block per (u, 256 columns) also
//                      reduces
//                      g_x_e = coef * exp(-(x_e - m) / tau) * clamp over its
//                      columns for each out-edge into partial[e, chunk]
//   softmin_bwd_pull   K15, pass 2, one thread per (v, t): g_prev[v, t] +=
//                      g_x_e over v's in-edges (a pull: no atomics, a fixed
//                      order, deterministic)
//   softmin_bwd_edges  K15, g_we[e] = the sum of partial[e, :] in order
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
// Bound on the card: bytes. The forward gathers D[dst_e, t] for every (e,
// t), E * N * 4 bytes (1.0 GB at 3,956 nodes and 63,840 edges), and reads
// and writes D once (2 * N^2 * 4 bytes); its E * N exponentials take 0.06
// ms at the MUFU rate (16 per SM per clock). The backward gathers D twice
// more and coef and m once, reads keep and writes three [N, N] arrays:
// about twice the forward's bytes. keep is N^2 bytes a round (2 GB over 128
// rounds at full width, beside 8 GB of saved D). Design against the bound: lanes run along t, so every
// gather of a D row is coalesced; the out-edge loop of a (u, t) thread
// reads the same rows as its block's other lanes; the forward keeps two
// passes over the out-edges (min, then the sum) so that its rounding is the
// reference's formula, the second pass hitting L2.

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

__global__ void __launch_bounds__(kThreads) softmin_bwd_rows_kernel(
    const float* __restrict__ g_new, const float* __restrict__ d_prev,
    const uint8_t* __restrict__ keep, const float* __restrict__ we,
    const int32_t* __restrict__ dst,
    const int32_t* __restrict__ out_ptr, const int32_t* __restrict__ out_perm,
    float* __restrict__ g_prev, float* __restrict__ coef,
    float* __restrict__ mstab, float* __restrict__ partial, int n,
    int nchunks, float tau) {
  __shared__ float red[kThreads / 32];
  const int u = blockIdx.y;
  const int chunk = blockIdx.x;
  const int t = chunk * kThreads + threadIdx.x;
  const bool active = t < n;
  const int beg = out_ptr[u];
  const int end = out_ptr[u + 1];
  float m = kFInf;
  float c = 0.f;
  if (active) {
    float s;
    softmin_cell(d_prev, we, dst, out_perm, beg, end, n, t, tau, &m, &s);
    const float out = softmin_out(m, s, tau);
    const long long i = (long long)u * n + t;
    const float gn = u == t ? 0.f : g_new[i];
    const float k = 0.5f * keep[i];
    g_prev[i] = __fmul_rn(gn, k);
    if (s > 0.f) {
      const float g_out = __fmul_rn(__fmul_rn(gn, 1.f - k),
                                    half_ties(out, kFInf));
      c = __fdiv_rn(g_out, s);
    }
    coef[i] = c;
    mstab[i] = m;
  }
  for (int k = beg; k < end; ++k) {
    const int e = out_perm[k];
    float g = 0.f;
    if (active && c != 0.f) {
      const float total = __fadd_rn(we[e], d_prev[(long long)dst[e] * n + t]);
      const float x = fminf(total, kFInf);
      const float z = expf(__fdiv_rn(-__fsub_rn(x, m), tau));
      g = __fmul_rn(__fmul_rn(c, z), clamp_factor(total));
    }
    g = block_sum(g, red);
    if (threadIdx.x == 0) partial[(long long)e * nchunks + chunk] = g;
  }
}

__global__ void __launch_bounds__(kThreads) softmin_bwd_pull_kernel(
    const float* __restrict__ d_prev, const float* __restrict__ we,
    const int32_t* __restrict__ src, const int32_t* __restrict__ in_ptr,
    const int32_t* __restrict__ in_perm, const float* __restrict__ coef,
    const float* __restrict__ mstab, float* __restrict__ g_prev, int n,
    float tau) {
  const int v = blockIdx.y;
  const int t = blockIdx.x * kThreads + threadIdx.x;
  if (t >= n) return;
  const long long i = (long long)v * n + t;
  const float dv = d_prev[i];
  float acc = g_prev[i];
  for (int k = in_ptr[v]; k < in_ptr[v + 1]; ++k) {
    const int e = in_perm[k];
    const long long j = (long long)src[e] * n + t;
    const float c = coef[j];
    if (c == 0.f) continue;
    const float total = __fadd_rn(we[e], dv);
    const float x = fminf(total, kFInf);
    const float z = expf(__fdiv_rn(-__fsub_rn(x, mstab[j]), tau));
    acc = __fadd_rn(acc, __fmul_rn(__fmul_rn(c, z), clamp_factor(total)));
  }
  g_prev[i] = acc;
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
                                void* g_prev, void* coef, void* mstab,
                                void* partial, int n, int nchunks, float tau,
                                void* stream) {
  if (bad_n(n) || nchunks != (n + kThreads - 1) / kThreads)
    return (int)cudaErrorInvalidValue;
  softmin_bwd_rows_kernel<<<rows_grid(n), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)g_new, (const float*)d_prev, (const uint8_t*)keep,
      (const float*)we, (const int32_t*)dst, (const int32_t*)out_ptr, (const int32_t*)out_perm,
      (float*)g_prev, (float*)coef, (float*)mstab, (float*)partial, n,
      nchunks, tau);
  return (int)cudaGetLastError();
}

extern "C" int softmin_bwd_pull(const void* d_prev, const void* we,
                                const void* src, const void* in_ptr,
                                const void* in_perm, const void* coef,
                                const void* mstab, void* g_prev, int n,
                                float tau, void* stream) {
  if (bad_n(n)) return (int)cudaErrorInvalidValue;
  softmin_bwd_pull_kernel<<<rows_grid(n), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const float*)d_prev, (const float*)we, (const int32_t*)src,
      (const int32_t*)in_ptr, (const int32_t*)in_perm, (const float*)coef,
      (const float*)mstab, (float*)g_prev, n, tau);
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
