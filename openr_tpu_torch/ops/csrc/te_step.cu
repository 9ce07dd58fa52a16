// K18 te_step: the O(B * E) tail of differentiable TE's optimizer step:
// the soft max-link-utilization loss, its gradient seed, and the Adam
// update.
//
// Replaces: openr_tpu/te/optimizer.py `_loss_core` after the utilization
// (util [B, E] float32, scen_mask [B] -> the scenario-averaged soft MLU)
// and the update of `_adam_scan_core`'s step. Entry points:
//
//   te_mlu      lse[b] = logsumexp(util[b] / tau_obj) (shifted by the row
//               max, as jax.scipy.special.logsumexp), mlu[b] = tau_obj *
//               lse[b], loss = sum_b mlu[b] * mask[b] / max(sum_b mask[b],
//               1)
//   te_mlu_bwd  g_util = g_loss * mask[b] / max(sum mask, 1) * tau_obj *
//               exp(util / tau_obj - lse[b]) / tau_obj, the softmax of the
//               row
//   te_adam     one thread per edge: g = up ? g : 0 (down links are not
//               optimizable); m = b1 m + (1 - b1) g; v = b2 v + (1 - b2) g g;
//               w -= lr (m / bc1) / (sqrt(v / bc2) + eps); w = clip(w,
//               w_min, w_max); the trajectory row gets w. The bias
//               corrections bc1 = 1 - b1^(i + 1), bc2 = 1 - b2^(i + 1) come
//               from the host in float32, as the reference's traced step
//               computes them, with the other constants in one struct
//               passed by value (AdamConsts).
//   te_mlu_div_check  not a kernel of the path: counts the floats at which
//               te_mlu's quotient by tau differs from __fdiv_rn's
//
// Each product and sum is an explicit round-to-nearest intrinsic, so the
// update rounds as the reference's separate operations do (no FMA).
//
// Bound on the card: bytes, and tiny: util read once and g_util written
// once (B * E * 4 bytes each, 1 MB at B = 4 and 63,840 edges), and six [E]
// float32 streams for Adam; the exponentials (B * E each) are far under
// the MUFU rate. All three bounds are under a launch's latency.
//
// The bits. te_mlu keeps the sum order of its first design, one block of
// 1,024 threads walking the scenarios in turn: partial t (t < 1,024) adds
// exp(util[b, i] / tau - max) for i = t, t + 1,024, ... in turn from 0;
// each warp folds its lanes by the xor butterfly (16, 8, 4, 2, 1); the 32
// warp totals are added in warp order from warp 0; then log(s) + max, and
// the masked mean folds over b in order. The row max is a max of finite
// values, the same in any order. te_mlu_bwd keeps its first design's
// expression for each element and the mask's sum in k order.
//
// Design against the latency (the first te_mlu ran on one SM: a scenario
// at a time, the row read twice, two block reductions of three barriers
// each a scenario):
//   te_mlu      a grid of (8, B') blocks of 128 threads. Block j of
//               scenario b owns the first design's partials 128 j ..
//               128 j + 127, so its warp w is that design's warp 4 j + w
//               and each warp total keeps its bits; loads stay coalesced.
//               A thread loads all its elements before it divides any, and
//               keeps up to 64 quotients in registers (E <= 65,536; past
//               that it divides the rest again in the sum, reading the row
//               from L2). The quotient is tau's correctly rounded
//               reciprocal times a with Markstein's correction (div_tau of
//               te_common.cuh), the correctly rounded quotient where a is
//               0 or 2^-100 <= |a| <= 2^100 and 2^-20 <= |tau| <= 2^20; a
//               warp that meets any other value takes __fdiv_rn for all
//               its quotients. So the loops over a thread's elements have
//               no branch and their iterations interleave: a guard, or
//               __fdiv_rn's slow path, which a 0 takes (te_clos's
//               utilization is 70% zeros), serialised them. The row max: each block's max goes into a per-
//               scenario atomicMax on the order-keeping integer image of
//               the float, then the scenario's 8 blocks meet at an arrival
//               counter. Each warp writes its total; the last block to
//               finish (a ticket) adds each scenario's 32 totals in warp
//               order and folds the mean, then zeroes every counter it
//               used, so the next call and a CUDA-graph replay start from
//               0. The counters and totals live in a scratch the wrapper
//               keeps per card, zeroed once: calls on one card must not
//               overlap (one stream). B' = min(B, the scenarios whose 8
//               blocks the card keeps resident at once); a block walks the
//               scenarios b = y, y + B', ..., so a scenario's blocks wait
//               only on blocks that are resident. A wait past 2^24 polls
//               (seconds) traps rather than hangs.
//   te_mlu_bwd  a grid of (ceil(E / 1,024), B) blocks of 256 threads:
//               blockIdx.y is the scenario, so no division finds it;
//               thread 0 folds the mask and computes g_mlu once a block
//               while the others load; 4 elements a thread, as one 16-byte
//               load and store where util and g_util are 16-byte aligned
//               and E % 4 == 0, else 4 scalars 256 apart.
//   te_adam     a thread an edge, its body as first designed: on the
//               card its time is a launch's latency at te_clos's 63,840
//               edges (PERF.md), and 4 edges a thread with 16-byte
//               loads and stores (four chains of three divisions and a
//               root in a row on a quarter of the threads) measured slower.
//               Its span was host time, so the redesign is the host side:
//               the constants come as one struct by value (16 ctypes
//               arguments became 9), made once a solve (te/kernels.py
//               adam_schedule).

#include <limits.h>

#include "te_common.cuh"

// te_adam's constants, passed by value as one argument: step i's (lr,
// beta1, beta2, eps, 1 - beta1^(i + 1), 1 - beta2^(i + 1), w_min, w_max)
// in float32, ops/_cuda.py's AdamConsts
struct AdamConsts {
  float lr, b1, b2, eps, bc1, bc2, w_min, w_max;
};

namespace {

constexpr int kSeedVec = 4;       // te_mlu_bwd: elements a thread
constexpr int kMluPartials = 1024;  // te_mlu: the first design's threads
constexpr int kMluSplit = 8;        // te_mlu: blocks a scenario
constexpr int kMluThreads = kMluPartials / kMluSplit;
constexpr int kMluWarps = kMluThreads / 32;
constexpr int kMluWarpsAll = kMluPartials / 32;
constexpr int kMluKeep = 64;  // te_mlu: quotients a thread keeps
constexpr int kGridCache = 16;  // devices te_mlu's residency is kept for

// te_mlu's scratch: a done ticket, then a record of kMluRecord words a
// scenario: its arrival count, the key of its row max, its 32 warp totals
constexpr int kMluRecord = 2 + kMluWarpsAll;

__device__ __forceinline__ unsigned max_key(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float key_max(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7fffffffu) : ~k);
}

// te_mlu's quotient a / tau: div_tau (te_common.cuh), whose residual and
// result stay normal, so it is the correctly rounded quotient, where a is 0
// (a * r, which keeps the sign) or 2^-100 <= |a| <= 2^100 and 2^-20 <=
// |tau| <= 2^20; elsewhere (fast_* false) the kernel takes __fdiv_rn.
// te_mlu_div_check counts the floats at which the two differ
__device__ __forceinline__ bool fast_tau(float tau) {
  return fabsf(tau) >= 0x1p-20f && fabsf(tau) <= 0x1p20f;
}

__device__ __forceinline__ bool fast_quotient(float a) {
  return a == 0.f || (fabsf(a) >= 0x1p-100f && fabsf(a) <= 0x1p100f);
}

__device__ __forceinline__ float mlu_quotient(float a, float tau, float r) {
  return a == 0.f ? __fmul_rn(a, r) : div_tau(a, tau, r);
}

__device__ __forceinline__ unsigned load_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__global__ void __launch_bounds__(kMluThreads) te_mlu_kernel(
    const float* __restrict__ util, const float* __restrict__ mask,
    float* __restrict__ lse, float* __restrict__ loss,
    unsigned* __restrict__ scratch, int nb, int e, float tau_obj) {
  __shared__ float red[kMluWarps];
  __shared__ float row_max;
  __shared__ bool last;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int t = blockIdx.x * kMluThreads + threadIdx.x;  // first design's
  const float r = __frcp_rn(tau_obj);
  for (int b = blockIdx.y; b < nb; b += gridDim.y) {
    const float* row = util + (long long)b * e;
    unsigned* rec = scratch + 1 + (long long)b * kMluRecord;
    // every load issued before the first division, so all are in flight
    float q[kMluKeep];
#pragma unroll
    for (int k = 0; k < kMluKeep; ++k) {
      const int i = t + k * kMluPartials;
      q[k] = i < e ? row[i] : 0.f;
    }
    // no branch in the loops over k, so their iterations interleave (a
    // guard or __fdiv_rn's slow path, which 0 takes, serialises them); the
    // padding quotients are 0 and are left out by selects
    bool slow = !fast_tau(tau_obj);
#pragma unroll
    for (int k = 0; k < kMluKeep; ++k) {
      const float a = q[k];
      q[k] = mlu_quotient(a, tau_obj, r);
      slow |= !fast_quotient(a);
    }
    if (__any_sync(0xffffffffu, slow)) {
#pragma unroll
      for (int k = 0; k < kMluKeep; ++k) {
        const int i = t + k * kMluPartials;
        if (i < e) q[k] = __fdiv_rn(row[i], tau_obj);
      }
    }
    float mx = -INFINITY;
#pragma unroll
    for (int k = 0; k < kMluKeep; ++k)
      mx = fmaxf(mx, t + k * kMluPartials < e ? q[k] : -INFINITY);
    for (int i = t + kMluKeep * kMluPartials; i < e; i += kMluPartials)
      mx = fmaxf(mx, __fdiv_rn(row[i], tau_obj));
    for (int off = 16; off > 0; off >>= 1)
      mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off));
    if (lane == 0) red[warp] = mx;
    __syncthreads();
    if (threadIdx.x == 0) {
      for (int w = 1; w < kMluWarps; ++w) mx = fmaxf(mx, red[w]);
      atomicMax(rec + 1, max_key(mx));
      __threadfence();
      atomicAdd(rec, 1u);
      for (long long spins = 0; load_acquire(rec) < (unsigned)kMluSplit;
           ++spins) {
        if (spins > (1ll << 24)) __trap();  // a block never came
        __nanosleep(64);
      }
      row_max = key_max(load_acquire(rec + 1));
    }
    __syncthreads();
    const float m = row_max;
    float s = 0.f;
    // a padding term adds exp(-inf) = +0, which leaves s's bits as they are
#pragma unroll
    for (int k = 0; k < kMluKeep; ++k)
      s += expf(t + k * kMluPartials < e ? __fsub_rn(q[k], m) : -INFINITY);
    for (int i = t + kMluKeep * kMluPartials; i < e; i += kMluPartials)
      s += expf(__fsub_rn(__fdiv_rn(row[i], tau_obj), m));
    for (int off = 16; off > 0; off >>= 1)
      s += __shfl_xor_sync(0xffffffffu, s, off);
    if (lane == 0)
      reinterpret_cast<float*>(rec)[2 + blockIdx.x * kMluWarps + warp] = s;
  }
  __threadfence();
  __syncthreads();
  if (threadIdx.x == 0)
    last = atomicAdd(scratch, 1u) == gridDim.x * gridDim.y - 1;
  __syncthreads();
  if (!last) return;
  __threadfence();
  // a scenario a thread, kMluThreads at a time; thread 0 folds their mean
  // terms in order from shared memory
  __shared__ float term[kMluThreads], weight[kMluThreads];
  float num = 0.f, den = 0.f;
  for (int b0 = 0; b0 < nb; b0 += kMluThreads) {
    const int b = b0 + threadIdx.x;
    if (b < nb) {
      unsigned* rec = scratch + 1 + (long long)b * kMluRecord;
      const float* tot = reinterpret_cast<const float*>(rec) + 2;
      float s = __ldcg(tot);
#pragma unroll
      for (int w = 1; w < kMluWarpsAll; ++w) s = s + __ldcg(tot + w);
      const float l = __fadd_rn(logf(s), key_max(__ldcg(rec + 1)));
      lse[b] = l;
      weight[threadIdx.x] = mask[b];
      term[threadIdx.x] = __fmul_rn(__fmul_rn(tau_obj, l), mask[b]);
      rec[0] = 0u;
      rec[1] = 0u;
    }
    __syncthreads();
    if (threadIdx.x == 0) {
      const int m = nb - b0 < kMluThreads ? nb - b0 : kMluThreads;
      for (int k = 0; k < m; ++k) {
        num = __fadd_rn(num, term[k]);
        den = __fadd_rn(den, weight[k]);
      }
    }
    __syncthreads();
  }
  if (threadIdx.x == 0) {
    loss[0] = __fdiv_rn(num, fmaxf(den, 1.f));
    scratch[0] = 0u;
  }
}

__device__ __forceinline__ float seed_of(float u, float g, float l,
                                         float tau_obj) {
  return __fdiv_rn(
      __fmul_rn(g, expf(__fsub_rn(__fdiv_rn(u, tau_obj), l))), tau_obj);
}

template <bool Vec>
__global__ void __launch_bounds__(kThreads) te_mlu_bwd_kernel(
    const float* __restrict__ g_loss, const float* __restrict__ util,
    const float* __restrict__ lse, const float* __restrict__ mask,
    float* __restrict__ g_util, int nb, int e, float tau_obj) {
  __shared__ float g_tau;  // g_mlu * tau_obj
  const int b = blockIdx.y;
  const float* row = util + (long long)b * e;
  float* out = g_util + (long long)b * e;
  const int i0 = Vec ? (blockIdx.x * kThreads + threadIdx.x) * kSeedVec
                     : blockIdx.x * kThreads * kSeedVec + threadIdx.x;
  float u[kSeedVec] = {0.f, 0.f, 0.f, 0.f};
  if (Vec) {
    if (i0 < e) {
      const float4 v = *reinterpret_cast<const float4*>(row + i0);
      u[0] = v.x, u[1] = v.y, u[2] = v.z, u[3] = v.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kSeedVec; ++k)
      if (i0 + k * kThreads < e) u[k] = row[i0 + k * kThreads];
  }
  const float l = lse[b];
  if (threadIdx.x == 0) {
    float den = 0.f;
#pragma unroll 4
    for (int k = 0; k < nb; ++k) den = __fadd_rn(den, mask[k]);
    g_tau = __fmul_rn(
        __fdiv_rn(__fmul_rn(g_loss[0], mask[b]), fmaxf(den, 1.f)), tau_obj);
  }
  __syncthreads();
  const float g = g_tau;
  if (Vec) {
    if (i0 < e) {
      float4 v;
      v.x = seed_of(u[0], g, l, tau_obj);
      v.y = seed_of(u[1], g, l, tau_obj);
      v.z = seed_of(u[2], g, l, tau_obj);
      v.w = seed_of(u[3], g, l, tau_obj);
      *reinterpret_cast<float4*>(out + i0) = v;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kSeedVec; ++k)
      if (i0 + k * kThreads < e)
        out[i0 + k * kThreads] = seed_of(u[k], g, l, tau_obj);
  }
}

__global__ void __launch_bounds__(kThreads) te_adam_kernel(
    float* __restrict__ w, float* __restrict__ m, float* __restrict__ v,
    const float* __restrict__ g, const bool* __restrict__ up,
    float* __restrict__ w_row, int e, AdamConsts k) {
  const int i = blockIdx.x * kThreads + threadIdx.x;
  if (i >= e) return;
  const float gi = up[i] ? g[i] : 0.f;
  const float mi =
      __fadd_rn(__fmul_rn(k.b1, m[i]), __fmul_rn(1.f - k.b1, gi));
  const float vi = __fadd_rn(__fmul_rn(k.b2, v[i]),
                             __fmul_rn(__fmul_rn(1.f - k.b2, gi), gi));
  const float mh = __fdiv_rn(mi, k.bc1);
  const float vh = __fdiv_rn(vi, k.bc2);
  const float step =
      __fdiv_rn(__fmul_rn(k.lr, mh), __fadd_rn(__fsqrt_rn(vh), k.eps));
  const float wi = fminf(fmaxf(__fsub_rn(w[i], step), k.w_min), k.w_max);
  m[i] = mi;
  v[i] = vi;
  w[i] = wi;
  w_row[i] = wi;
}

// Not a kernel of the path: the count of floats a (every bit pattern) at
// which te_mlu's quotient differs in its bits from __fdiv_rn(a, tau), NaNs
// taken as equal
__global__ void __launch_bounds__(kThreads) mlu_div_check_kernel(
    float tau, unsigned long long* __restrict__ count) {
  const float r = __frcp_rn(tau);
  const bool slow_tau = !fast_tau(tau);
  unsigned long long bad = 0;
  for (unsigned long long u =
           blockIdx.x * (unsigned long long)kThreads + threadIdx.x;
       u < (1ull << 32); u += (unsigned long long)gridDim.x * kThreads) {
    const float a = __uint_as_float((unsigned)u);
    const float want = __fdiv_rn(a, tau);
    const float got =
        slow_tau || !fast_quotient(a) ? want : mlu_quotient(a, tau, r);
    bad += __float_as_uint(got) != __float_as_uint(want) &&
           !(isnan(got) && isnan(want));
  }
  if (bad) atomicAdd(count, bad);
}

// The scenarios whose kMluSplit blocks the card keeps resident at once
// (at least 1), cached per device.
int mlu_resident_scenarios() {
  static int cache[kGridCache];
  int dev = 0;
  cudaGetDevice(&dev);
  if (dev < kGridCache && cache[dev] > 0) return cache[dev];
  int sms = 1, per = 0;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, te_mlu_kernel,
                                                kMluThreads, 0);
  const int c = sms * per / kMluSplit;
  const int r = c > 0 ? c : 1;
  if (dev < kGridCache) cache[dev] = r;
  return r;
}

}  // namespace

// scratch: 1 + 34 * nb uint32 words, zero but for the warp totals (the
// kernel leaves them so); the wrapper keeps one per card
extern "C" int te_mlu(const void* util, const void* mask, void* lse,
                      void* loss, void* scratch, int nb, int e, float tau_obj,
                      void* stream) {
  if (nb < 1 || e < 1 || e > INT_MAX - kMluPartials)
    return (int)cudaErrorInvalidValue;
  int rows = mlu_resident_scenarios();
  rows = rows < nb ? rows : nb;
  rows = rows < 65535 ? rows : 65535;
  te_mlu_kernel<<<dim3(kMluSplit, rows), kMluThreads, 0,
                  (cudaStream_t)stream>>>(
      (const float*)util, (const float*)mask, (float*)lse, (float*)loss,
      (unsigned*)scratch, nb, e, tau_obj);
  return (int)cudaGetLastError();
}

extern "C" int te_mlu_bwd(const void* g_loss, const void* util,
                          const void* lse, const void* mask, void* g_util,
                          int nb, int e, float tau_obj, void* stream) {
  if (nb == 0 || e == 0) return 0;
  if (nb < 0 || e < 0 || nb > 65535 || e > INT_MAX - kThreads * kSeedVec)
    return (int)cudaErrorInvalidValue;
  const dim3 grid((e + kThreads * kSeedVec - 1) / (kThreads * kSeedVec), nb);
  const bool vec = e % kSeedVec == 0 &&
                   ((uintptr_t)util | (uintptr_t)g_util) % 16 == 0;
  auto kernel = vec ? te_mlu_bwd_kernel<true> : te_mlu_bwd_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const float*)g_loss, (const float*)util, (const float*)lse,
      (const float*)mask, (float*)g_util, nb, e, tau_obj);
  return (int)cudaGetLastError();
}

// count: one uint64, zeroed by the caller
extern "C" int te_mlu_div_check(float tau, void* count, void* stream) {
  int dev = 0, sms = 1;
  cudaGetDevice(&dev);
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  mlu_div_check_kernel<<<sms * 8, kThreads, 0, (cudaStream_t)stream>>>(
      tau, (unsigned long long*)count);
  return (int)cudaGetLastError();
}

extern "C" int te_adam(void* w, void* m, void* v, const void* g,
                       const void* up, void* w_row, int e, AdamConsts k,
                       void* stream) {
  if (e == 0) return 0;
  te_adam_kernel<<<(e + kThreads - 1) / kThreads, kThreads, 0,
                   (cudaStream_t)stream>>>(
      (float*)w, (float*)m, (float*)v, (const float*)g, (const bool*)up,
      (float*)w_row, e, k);
  return (int)cudaGetLastError();
}
