// K11 fw_close: the cold masked blocked Floyd-Warshall close of the dense
// [n, n] distance matrix, in place.
//
// Replaces: openr_tpu/apsp/kernels.py `_fw_solver` (w [N, N] int32 direct
// edges with a 0 diagonal, allow [N, N] bool per-source transit mask ->
// the closed D and a probe scalar). The wrapper copies w into d first; the
// three entry points below run one stage k each, and the host launches
// them for k = 0 .. nb - 1:
//
//   fw_close_diag    block (k, k) closed by in-block sequential FW:
//                      for m in block k: D[i, j] = min(D[i, j],
//                        maskA(D)[i, m] + D[m, j])       (i, j in block k)
//   fw_close_panels  row panel    D[k, j] = min(D[k, j], maskA(C) (x) D[k, j])
//                    column panel D[i, k] = min(D[i, k], maskA(D[i, k]) (x) C)
//                    for every block j, i != k, C = the closed D[k, k]
//   fw_close_outer   D[i, j] = min(D[i, j], maskA(D[i, k]) (x) D[k, j])
//                    for every block i, j != k
//   fw_close_probe   probe = min over D (the reference's jnp.min(d)), read
//                    by the host so the close's wall time covers the card
//
// maskA masks the LEFT operand's intermediate columns with allow[i, m]
// (!overloaded[m] or m == i). The reference closes the diagonal block by
// log2(B) masked squarings; only the closed matrix is observable, and the
// in-block sequential FW gives the same exact closure (every update is a
// min over real path lengths, and after stage k every pair holds its
// shortest path through blocks 0..k), so the order here is free. B = 128
// (the reference's _FW_BLOCK) when nb > 1; with one block, B = n <= 128.
//
// Bound on the card: integer operations. A close does n^3 add-and-min
// steps (nb^2 * B^3 a stage: the diagonal, the panels and the outer
// sweep), each one DPX instruction on Hopper: at n = 4,096 that is 6.9e10,
// 4.1 ms at the card's int32 lane rate (16.7e12 a second), against 0.05 ms
// for its 9 * n^2 bytes.
//
// Design against that bound: the diagonal block is one block of 1,024
// threads over a 128 x 128 tile in dynamic shared memory (64 KB, plus its
// 16 KB mask), two barriers a step so no thread reads an entry another is
// writing; the panels and the outer sweep are the tiled (min,+) product of
// fw_minplus.cuh. A row-panel block owns all B rows of a 32-column strip
// (128 x 32) and a column-panel block all B columns of a 32-row strip
// (32 x 128): each reads its own strip as one operand and writes it only
// after its last slab, so the in-place panels do not race. The outer
// sweep's 64 x 64 tiles read only the two panels, which it never writes.

#include "fw_minplus.cuh"

namespace {

using fw::kInf;

constexpr int kDiagThreads = 1024;

__global__ void __launch_bounds__(kDiagThreads) fw_close_diag_kernel(
    int32_t* __restrict__ d, const uint8_t* __restrict__ allow, int k, int n,
    int bsz) {
  extern __shared__ int32_t smem[];
  int32_t* t = smem;                               // [bsz][bsz]
  uint8_t* am = (uint8_t*)(smem + bsz * bsz);      // [bsz][bsz]
  const long long base = (long long)k * bsz * n + (long long)k * bsz;
  const int cells = bsz * bsz;
  for (int e = threadIdx.x; e < cells; e += kDiagThreads) {
    const int i = e / bsz;
    const int j = e - i * bsz;
    t[e] = d[base + (long long)i * n + j];
    am[e] = allow[base + (long long)i * n + j];
  }
  __syncthreads();
  constexpr int kPer = 16;  // cells per thread at bsz = 128
  for (int m = 0; m < bsz; ++m) {
    int nv[kPer];
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int e = threadIdx.x + s * kDiagThreads;
      nv[s] = 0;
      if (e < cells) {
        const int i = e / bsz;
        const int j = e - i * bsz;
        const int a = am[i * bsz + m] ? t[i * bsz + m] : kInf;
        nv[s] = min(min(a + t[m * bsz + j], kInf), t[e]);
      }
    }
    __syncthreads();
#pragma unroll
    for (int s = 0; s < kPer; ++s) {
      const int e = threadIdx.x + s * kDiagThreads;
      if (e < cells) t[e] = nv[s];
    }
    __syncthreads();
  }
  for (int e = threadIdx.x; e < cells; e += kDiagThreads) {
    const int i = e / bsz;
    d[base + (long long)i * n + (e - i * bsz)] = t[e];
  }
}

constexpr int kStrip = 32;

// blockIdx.x < (nb - 1) * (B / 32): a row-panel strip; the rest: a
// column-panel strip. Panel block index p skips k.
__global__ void __launch_bounds__(fw::kThreads) fw_close_panels_kernel(
    int32_t* __restrict__ d, const uint8_t* __restrict__ allow, int k, int n,
    int bsz) {
  __shared__ union {
    fw::TileSmem<128, kStrip> row;
    fw::TileSmem<kStrip, 128> col;
  } sm;
  const int nb = n / bsz;
  const int per = bsz / kStrip;
  const int strips = (nb - 1) * per;
  int x = blockIdx.x;
  const bool row_panel = x < strips;
  if (!row_panel) x -= strips;
  int blk = x / per;
  blk += blk >= k;  // skip the diagonal block
  const int off = blk * bsz + (x % per) * kStrip;
  const long long kk = (long long)k * bsz;
  if (row_panel) {
    // D[k rows, strip] = min(., maskA(C) (x) D[k rows, strip])
    int acc[128 / 16][kStrip / 16];
    int32_t* out = d + kk * n + off;
    fw::load_tile<128, kStrip>(acc, out, n, bsz, kStrip);
    fw::mp_tile<128, kStrip>(acc, d + kk * n + kk, n, allow + kk * n + kk, n,
                             out, n, bsz, kStrip, bsz, sm.row);
    fw::store_tile<128, kStrip>(acc, out, n, bsz, kStrip, false);
  } else {
    // D[strip, k cols] = min(., maskA(D[strip, k cols]) (x) C)
    int acc[kStrip / 16][128 / 16];
    int32_t* out = d + (long long)off * n + kk;
    fw::load_tile<kStrip, 128>(acc, out, n, kStrip, bsz);
    fw::mp_tile<kStrip, 128>(acc, out, n, allow + (long long)off * n + kk, n,
                             d + kk * n + kk, n, kStrip, bsz, bsz, sm.col);
    fw::store_tile<kStrip, 128>(acc, out, n, kStrip, bsz, false);
  }
}

constexpr int kTile = 64;

__global__ void __launch_bounds__(fw::kThreads) fw_close_outer_kernel(
    int32_t* __restrict__ d, const uint8_t* __restrict__ allow, int k, int n,
    int bsz) {
  __shared__ fw::TileSmem<kTile, kTile> sm;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  if (r0 / bsz == k || c0 / bsz == k) return;  // the panels: not this pass
  const long long kk = (long long)k * bsz;
  int acc[kTile / 16][kTile / 16];
  int32_t* out = d + (long long)r0 * n + c0;
  fw::load_tile<kTile, kTile>(acc, out, n, kTile, kTile);
  fw::mp_tile<kTile, kTile>(acc, d + (long long)r0 * n + kk, n,
                            allow + (long long)r0 * n + kk, n, d + kk * n + c0,
                            n, kTile, kTile, bsz, sm);
  fw::store_tile<kTile, kTile>(acc, out, n, kTile, kTile, false);
}

constexpr int kProbeThreads = 256;

__global__ void fw_close_probe_kernel(const int32_t* __restrict__ d,
                                      int32_t* __restrict__ probe,
                                      long long count) {
  int v = 0x7fffffff;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x)
    v = min(v, d[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffff, v, o));
  if ((threadIdx.x & 31) == 0) atomicMin(probe, v);
}

}  // namespace

extern "C" int fw_close_diag(void* d, const void* allow, int k, int n,
                             int bsz, void* stream) {
  if (bsz <= 0 || bsz > 128 || n % bsz != 0) return (int)cudaErrorInvalidValue;
  const int shmem = bsz * bsz * 5;  // the tile and its mask: 80 KB at 128
  cudaError_t err = cudaFuncSetAttribute(
      fw_close_diag_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      shmem);
  if (err != cudaSuccess) return (int)err;
  fw_close_diag_kernel<<<1, kDiagThreads, shmem, (cudaStream_t)stream>>>(
      (int32_t*)d, (const uint8_t*)allow, k, n, bsz);
  return (int)cudaGetLastError();
}

extern "C" int fw_close_panels(void* d, const void* allow, int k, int n,
                               int bsz, void* stream) {
  if (bsz != 128 || n % bsz != 0) return (int)cudaErrorInvalidValue;
  const int nb = n / bsz;
  if (nb < 2) return 0;
  const int blocks = 2 * (nb - 1) * (bsz / kStrip);
  fw_close_panels_kernel<<<blocks, fw::kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)d, (const uint8_t*)allow, k, n, bsz);
  return (int)cudaGetLastError();
}

extern "C" int fw_close_outer(void* d, const void* allow, int k, int n,
                              int bsz, void* stream) {
  if (bsz != 128 || n % bsz != 0) return (int)cudaErrorInvalidValue;
  if (n / bsz < 2) return 0;
  const dim3 grid(n / kTile, n / kTile);
  fw_close_outer_kernel<<<grid, fw::kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)d, (const uint8_t*)allow, k, n, bsz);
  return (int)cudaGetLastError();
}

extern "C" int fw_close_probe(const void* d, void* probe, int n,
                              void* stream) {
  const long long count = (long long)n * n;
  long long blocks = (count + kProbeThreads - 1) / kProbeThreads;
  if (blocks > 1056) blocks = 1056;  // 8 blocks per SM, grid-stride beyond
  if (blocks < 1) blocks = 1;
  fw_close_probe_kernel<<<(unsigned)blocks, kProbeThreads, 0,
                          (cudaStream_t)stream>>>((const int32_t*)d,
                                                  (int32_t*)probe, count);
  return (int)cudaGetLastError();
}
