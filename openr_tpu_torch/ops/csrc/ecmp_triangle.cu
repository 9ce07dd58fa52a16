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
// Bound on the card: device-memory bytes. The matrix read once and [E, T]
// bytes written once; if every row gather came from device memory, two
// rows of T int32 a edge besides. One compare chain per output byte.
//
// Design against that bound: a 2D grid, a run of 8 consecutive edges on x
// and 1,024 columns on y, edges fastest, so the blocks in flight share one
// column strip of the matrix and its rows stay in L2. A thread owns 16
// columns: four 16-byte loads each of its part of d[ru] and d[rv], sixteen
// compare chains and one 16-byte store of its 16 output bytes. The edge's
// scalars are warp-uniform loads, once an edge; a row the previous edge of
// the run also read stays in registers (the edges of a CompiledGraph are
// sorted by head, so the DAG's rv repeats; nh_mask's ru is always 0). The
// overload test is decided once an edge: an overloaded head loads nothing
// but its own column. Where T % 16, or the alignment of d or out, rules the
// 16-byte path out, a thread takes every 64th column of the block's 1,024
// with scalar loads and byte stores.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr int kThreads = 64;
constexpr int kCols = 16;                    // columns a thread
constexpr int kBlockCols = kThreads * kCols;  // 1,024 columns a block
constexpr int kRun = 8;                      // edges a block

// column k of the thread's 16: adjacent (wide) or every 64th (scalar)
template <bool kWide>
__device__ __forceinline__ int col_of(int c0, int k) {
  return kWide ? c0 + kCols * threadIdx.x + k : c0 + threadIdx.x + kThreads * k;
}

template <bool kWide>
__device__ __forceinline__ void load_row(const int32_t* __restrict__ row,
                                         int c0, int T, int (&v)[kCols]) {
  if (kWide) {
    const int c = col_of<true>(c0, 0);
    if (c >= T) return;
#pragma unroll
    for (int k = 0; k < kCols; k += 4) {
      const int4 x = *reinterpret_cast<const int4*>(row + c + k);
      v[k] = x.x;
      v[k + 1] = x.y;
      v[k + 2] = x.z;
      v[k + 3] = x.w;
    }
  } else {
#pragma unroll
    for (int k = 0; k < kCols; ++k) {
      const int c = col_of<false>(c0, k);
      v[k] = c < T ? row[c] : kInf;
    }
  }
}

__device__ __forceinline__ bool tri(int we, int dv, int du) {
  return min(we + dv, kInf) == du && du < kInf;
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads) ecmp_triangle_kernel(
    const int32_t* __restrict__ d, const int32_t* __restrict__ ru,
    const int32_t* __restrict__ rv, const int32_t* __restrict__ ve,
    const int32_t* __restrict__ w, const uint8_t* __restrict__ ov,
    uint8_t* __restrict__ out, int E, int T) {
  const int e0 = blockIdx.x * kRun;
  const int e1 = min(e0 + kRun, E);
  const int c0 = blockIdx.y * kBlockCols;
  int du[kCols], dv[kCols];
  int a_row = -1, b_row = -1;  // the rows du and dv hold
  for (int e = e0; e < e1; ++e) {
    const int a = ru[e];
    const int b = rv[e];
    const int v = ve[e];
    const int we = w[e];
    uint8_t* orow = out + (long long)e * T;
    uint8_t bytes[kCols];
    if (!ov[v]) {
      if (a != a_row) {
        load_row<kWide>(d + (long long)a * T, c0, T, du);
        a_row = a;
      }
      if (b != b_row) {
        load_row<kWide>(d + (long long)b * T, c0, T, dv);
        b_row = b;
      }
#pragma unroll
      for (int k = 0; k < kCols; ++k) bytes[k] = tri(we, dv[k], du[k]);
    } else {
      // an overloaded head is a first hop only toward itself
#pragma unroll
      for (int k = 0; k < kCols; ++k) bytes[k] = 0;
#pragma unroll
      for (int k = 0; k < kCols; ++k)
        if (col_of<kWide>(c0, k) == v && v < T)
          bytes[k] = tri(we, d[(long long)b * T + v], d[(long long)a * T + v]);
    }
    if (kWide) {
      const int c = col_of<true>(c0, 0);
      if (c < T) {
        uint32_t word[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          word[q] = (uint32_t)bytes[4 * q] | (uint32_t)bytes[4 * q + 1] << 8 |
                    (uint32_t)bytes[4 * q + 2] << 16 |
                    (uint32_t)bytes[4 * q + 3] << 24;
        *reinterpret_cast<uint4*>(orow + c) =
            make_uint4(word[0], word[1], word[2], word[3]);
      }
    } else {
#pragma unroll
      for (int k = 0; k < kCols; ++k) {
        const int c = col_of<false>(c0, k);
        if (c < T) orow[c] = bytes[k];
      }
    }
  }
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

extern "C" int ecmp_triangle(const void* d, const void* ru, const void* rv,
                             const void* ve, const void* w, const void* ov,
                             void* out, int E, int T, void* stream) {
  if (E < 0 || T < 0) return (int)cudaErrorInvalidValue;
  if ((long long)E * T == 0) return 0;
  const bool wide = T % kCols == 0 && aligned16(d) && aligned16(out);
  const dim3 grid((unsigned)((E + kRun - 1) / kRun),
                  (unsigned)((T + kBlockCols - 1) / kBlockCols));
  auto kernel =
      wide ? ecmp_triangle_kernel<true> : ecmp_triangle_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)d, (const int32_t*)ru, (const int32_t*)rv,
      (const int32_t*)ve, (const int32_t*)w, (const uint8_t*)ov,
      (uint8_t*)out, E, T);
  return (int)cudaGetLastError();
}
