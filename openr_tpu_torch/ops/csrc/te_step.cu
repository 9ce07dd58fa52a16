// K18 te_step: the O(B * E) tail of differentiable TE's optimizer step:
// the soft max-link-utilization loss, its gradient seed, and the Adam
// update.
//
// Replaces: openr_tpu/te/optimizer.py `_loss_core` after the utilization
// (util [B, E] float32, scen_mask [B] -> the scenario-averaged soft MLU)
// and the update of `_adam_scan_core`'s step. Entry points:
//
//   te_mlu      one block: lse[b] = logsumexp(util[b] / tau_obj) (shifted
//               by the row max, as jax.scipy.special.logsumexp), mlu[b] =
//               tau_obj * lse[b], loss = sum_b mlu[b] * mask[b] /
//               max(sum_b mask[b], 1)
//   te_mlu_bwd  one thread per (b, e): g_util = g_loss * mask[b] /
//               max(sum mask, 1) * tau_obj * exp(util / tau_obj - lse[b]) /
//               tau_obj, the softmax of the row
//   te_adam     one thread per edge: g = up ? g : 0 (down links are not
//               optimizable); m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g g;
//               w -= lr (m / bc1) / (sqrt(v / bc2) + eps); w = clip(w,
//               w_min, w_max); the trajectory row gets w. The bias
//               corrections bc1 = 1 - b1^(i + 1), bc2 = 1 - b2^(i + 1) come
//               from the host in float32, as the reference's traced step
//               computes them.
//
// Each product and sum is an explicit round-to-nearest intrinsic, so the
// update rounds as the reference's separate operations do (no FMA).
//
// Bound on the card: bytes, and tiny: util read twice and written once (B
// * E * 4 bytes each, 1 MB at B = 4 and 63,840 edges), and six [E] float32
// streams for Adam; the exponentials (2 * B * E) are far under the MUFU
// rate. Every launch is latency-bound; te_mlu runs in one block so the
// loss needs no second pass.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMluThreads = 1024;

template <int T>
__device__ __forceinline__ float block_reduce(float v, float* red, bool is_max) {
  for (int off = 16; off > 0; off >>= 1) {
    const float o = __shfl_xor_sync(0xffffffffu, v, off);
    v = is_max ? fmaxf(v, o) : v + o;
  }
  const int warp = threadIdx.x >> 5;
  if ((threadIdx.x & 31) == 0) red[warp] = v;
  __syncthreads();
  if (threadIdx.x == 0) {
    float total = red[0];
    for (int w = 1; w < T / 32; ++w)
      total = is_max ? fmaxf(total, red[w]) : total + red[w];
    red[0] = total;
  }
  __syncthreads();
  const float total = red[0];
  __syncthreads();
  return total;  // in every thread
}

__global__ void __launch_bounds__(kMluThreads) te_mlu_kernel(
    const float* __restrict__ util, const float* __restrict__ mask,
    float* __restrict__ lse, float* __restrict__ loss, int nb, int e,
    float tau_obj) {
  __shared__ float red[kMluThreads / 32];
  float num = 0.f, den = 0.f;
  for (int b = 0; b < nb; ++b) {
    const float* row = util + (long long)b * e;
    float mx = -INFINITY;
    for (int i = threadIdx.x; i < e; i += kMluThreads)
      mx = fmaxf(mx, __fdiv_rn(row[i], tau_obj));
    mx = block_reduce<kMluThreads>(mx, red, true);
    float s = 0.f;
    for (int i = threadIdx.x; i < e; i += kMluThreads)
      s += expf(__fsub_rn(__fdiv_rn(row[i], tau_obj), mx));
    s = block_reduce<kMluThreads>(s, red, false);
    const float l = __fadd_rn(logf(s), mx);
    if (threadIdx.x == 0) {
      lse[b] = l;
      num = __fadd_rn(num, __fmul_rn(__fmul_rn(tau_obj, l), mask[b]));
      den = __fadd_rn(den, mask[b]);
    }
  }
  if (threadIdx.x == 0) loss[0] = __fdiv_rn(num, fmaxf(den, 1.f));
}

__global__ void __launch_bounds__(kThreads) te_mlu_bwd_kernel(
    const float* __restrict__ g_loss, const float* __restrict__ util,
    const float* __restrict__ lse, const float* __restrict__ mask,
    float* __restrict__ g_util, int nb, int e, float tau_obj) {
  const long long i = (long long)blockIdx.x * kThreads + threadIdx.x;
  if (i >= (long long)nb * e) return;
  const int b = (int)(i / e);
  float den = 0.f;
  for (int k = 0; k < nb; ++k) den = __fadd_rn(den, mask[k]);
  const float g_mlu = __fdiv_rn(__fmul_rn(g_loss[0], mask[b]), fmaxf(den, 1.f));
  const float soft =
      expf(__fsub_rn(__fdiv_rn(util[i], tau_obj), lse[b]));
  g_util[i] = __fdiv_rn(__fmul_rn(__fmul_rn(g_mlu, tau_obj), soft), tau_obj);
}

__global__ void __launch_bounds__(kThreads) te_adam_kernel(
    float* __restrict__ w, float* __restrict__ m, float* __restrict__ v,
    const float* __restrict__ g, const bool* __restrict__ up,
    float* __restrict__ w_row, int e, float lr, float b1, float b2, float eps,
    float bc1, float bc2, float w_min, float w_max) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= e) return;
  const float gi = up[i] ? g[i] : 0.f;
  const float mi = __fadd_rn(__fmul_rn(b1, m[i]), __fmul_rn(1.f - b1, gi));
  const float vi = __fadd_rn(__fmul_rn(b2, v[i]),
                             __fmul_rn(__fmul_rn(1.f - b2, gi), gi));
  const float mh = __fdiv_rn(mi, bc1);
  const float vh = __fdiv_rn(vi, bc2);
  const float step =
      __fdiv_rn(__fmul_rn(lr, mh), __fadd_rn(__fsqrt_rn(vh), eps));
  const float wi = fminf(fmaxf(__fsub_rn(w[i], step), w_min), w_max);
  m[i] = mi;
  v[i] = vi;
  w[i] = wi;
  w_row[i] = wi;
}

}  // namespace

extern "C" int te_mlu(const void* util, const void* mask, void* lse,
                      void* loss, int nb, int e, float tau_obj, void* stream) {
  if (nb < 1 || e < 1) return (int)cudaErrorInvalidValue;
  te_mlu_kernel<<<1, kMluThreads, 0, (cudaStream_t)stream>>>(
      (const float*)util, (const float*)mask, (float*)lse, (float*)loss, nb,
      e, tau_obj);
  return (int)cudaGetLastError();
}

extern "C" int te_mlu_bwd(const void* g_loss, const void* util,
                          const void* lse, const void* mask, void* g_util,
                          int nb, int e, float tau_obj, void* stream) {
  const long long total = (long long)nb * e;
  if (total == 0) return 0;
  te_mlu_bwd_kernel<<<(unsigned)((total + kThreads - 1) / kThreads), kThreads,
                      0, (cudaStream_t)stream>>>(
      (const float*)g_loss, (const float*)util, (const float*)lse,
      (const float*)mask, (float*)g_util, nb, e, tau_obj);
  return (int)cudaGetLastError();
}

extern "C" int te_adam(void* w, void* m, void* v, const void* g,
                       const void* up, void* w_row, int e, float lr, float b1,
                       float b2, float eps, float bc1, float bc2, float w_min,
                       float w_max, void* stream) {
  if (e == 0) return 0;
  te_adam_kernel<<<(e + kThreads - 1) / kThreads, kThreads, 0,
                   (cudaStream_t)stream>>>(
      (float*)w, (float*)m, (float*)v, (const float*)g, (const bool*)up,
      (float*)w_row, e, lr, b1, b2, eps, bc1, bc2, w_min, w_max);
  return (int)cudaGetLastError();
}
