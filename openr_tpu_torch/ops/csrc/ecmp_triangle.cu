// K3 ecmp_triangle: per-edge first-hop membership by the triangle test.
//
// Replaces: openr_tpu/ops/spf.py `_ecmp_dag` (ru = src, rv = dst, ve = dst
// over an all-pairs matrix) and the triangle of openr_tpu/solver/tpu.py
// `_AreaSolve.nh_mask` (ru = 0, the batch row of me; rv = the batch rows of
// me's up-neighbours; ve = their node ids), including the rule that an
// overloaded neighbour is a first hop only toward itself.
//
// For every edge e and destination column t of the [R, T] int32 matrix d:
//
//   out[e, t] = min(w[e] + d[rv[e], t], INF) == d[ru[e], t]
//               && d[ru[e], t] < INF
//               && (!ov[ve[e]] || t == ve[e])
//
// Bound on the card: device-memory bytes. Two gathered rows of T int32 and
// one row of T bytes written per edge; one compare chain per output byte.
//
// Design against that bound: one elementwise pass, consecutive threads on
// consecutive t of one edge, so both row gathers and the write are
// coalesced and the per-edge scalars are warp-uniform broadcast loads.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr int kThreads = 256;

__global__ void ecmp_triangle_kernel(
    const int32_t* __restrict__ d, const int32_t* __restrict__ ru,
    const int32_t* __restrict__ rv, const int32_t* __restrict__ ve,
    const int32_t* __restrict__ w, const uint8_t* __restrict__ ov,
    uint8_t* __restrict__ out, int E, int T) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)E * T) return;
  const int e = (int)(i / T);
  const int t = (int)(i - (long long)e * T);
  const int du = d[(long long)ru[e] * T + t];
  const int dv = d[(long long)rv[e] * T + t];
  const int v = ve[e];
  const bool tri = min(w[e] + dv, kInf) == du;
  out[i] = (uint8_t)(tri && du < kInf && (!ov[v] || t == v));
}

}  // namespace

extern "C" int ecmp_triangle(const void* d, const void* ru, const void* rv,
                             const void* ve, const void* w, const void* ov,
                             void* out, int E, int T, void* stream) {
  const long long total = (long long)E * T;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  ecmp_triangle_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const int32_t*)d, (const int32_t*)ru, (const int32_t*)rv,
      (const int32_t*)ve, (const int32_t*)w, (const uint8_t*)ov,
      (uint8_t*)out, E, T);
  return (int)cudaGetLastError();
}
