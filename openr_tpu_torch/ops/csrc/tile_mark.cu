// K21 tile_mark: the per-tile elementwise steps of the tiled solves, four
// entry points over one rank's row-major [S, n_tile] tiles (INF = 1 << 29).
//
// Replaces, in openr_tpu/ops/spf.py:
//
//   tile_init         `_tile_d0_allow`'s d0: INF, 0 at [s, sources[s] -
//                     offset] where the tile holds that column
//   tile_mark         `_tile_solver_warm`'s marks0 and its mark round's
//                     new_m = m | ((recv == dp) & (dp < INF)) (m null: no
//                     marks yet), *flag = 1 where an entry is newly marked
//                     (the reference's any(new_m != m)); recv is reset to
//                     INF for the next exchange
//   tile_reset        where(marks, INF, dp) with the sources re-pinned to 0
//                     (.at[].set(0, mode="drop"): a source outside the tile
//                     drops)
//   tile_col_changed  one thread per column t: col_changed[t] |=
//                     any_s d[s, t] != dp[s, t], *count += 1 for each column
//                     it newly sets; run rank after rank over the batch ranks
//                     of a column block, that is the reference's pmax over
//                     'batch' and its psum'd popcount
//
// Bound on the card: device-memory bytes; each entry reads and writes every
// entry of its tiles once (tile_col_changed stops a column at its first
// difference) and does one or two integer operations per entry.
//
// Design against that bound: one thread per entry (per column in
// tile_col_changed, walking down the rows), consecutive threads on
// consecutive addresses, so every access of a warp is one coalesced line.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr int kThreads = 256;

__global__ void tile_init_kernel(int32_t* __restrict__ d0,
                                 const int32_t* __restrict__ sources,
                                 int offset, int S, int n_tile) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)S * n_tile) return;
  const int s = (int)(i / n_tile);
  const int c = (int)(i - (long long)s * n_tile);
  d0[i] = offset + c == sources[s] ? 0 : kInf;
}

__global__ void tile_mark_kernel(const uint8_t* __restrict__ m,
                                 int32_t* __restrict__ recv,
                                 const int32_t* __restrict__ dp,
                                 uint8_t* __restrict__ m_out,
                                 int32_t* __restrict__ flag, long long total) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= total) return;
  const int p = dp[i];
  const uint8_t old = m ? m[i] : 0;
  const uint8_t hit = (recv[i] == p) && (p < kInf);
  m_out[i] = old | hit;
  recv[i] = kInf;
  if (hit && !old) *flag = 1;
}

__global__ void tile_reset_kernel(int32_t* __restrict__ d0,
                                  const uint8_t* __restrict__ marks,
                                  const int32_t* __restrict__ dp,
                                  const int32_t* __restrict__ sources,
                                  int offset, int S, int n_tile) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)S * n_tile) return;
  const int s = (int)(i / n_tile);
  const int c = (int)(i - (long long)s * n_tile);
  d0[i] = offset + c == sources[s] ? 0 : (marks[i] ? kInf : dp[i]);
}

__global__ void tile_col_changed_kernel(const int32_t* __restrict__ d,
                                        const int32_t* __restrict__ dp,
                                        uint8_t* __restrict__ col_changed,
                                        int32_t* __restrict__ count, int S,
                                        int n_tile) {
  const int t = blockIdx.x * blockDim.x + threadIdx.x;
  if (t >= n_tile) return;
  if (col_changed[t]) return;
  for (int s = 0; s < S; ++s) {
    const long long i = (long long)s * n_tile + t;
    if (d[i] != dp[i]) {
      col_changed[t] = 1;
      atomicAdd(count, 1);
      return;
    }
  }
}

unsigned blocks_for(long long total) {
  return (unsigned)((total + kThreads - 1) / kThreads);
}

}  // namespace

extern "C" int tile_init(void* d0, const void* sources, int offset, int S,
                         int n_tile, void* stream) {
  const long long total = (long long)S * n_tile;
  if (total == 0) return 0;
  tile_init_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)d0, (const int32_t*)sources, offset, S, n_tile);
  return (int)cudaGetLastError();
}

// m may be null (no marks yet: the seed)
extern "C" int tile_mark(const void* m, void* recv, const void* dp,
                         void* m_out, void* flag, int total, void* stream) {
  if (total == 0) return 0;
  tile_mark_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)m, (int32_t*)recv, (const int32_t*)dp,
      (uint8_t*)m_out, (int32_t*)flag, (long long)total);
  return (int)cudaGetLastError();
}

extern "C" int tile_reset(void* d0, const void* marks, const void* dp,
                          const void* sources, int offset, int S, int n_tile,
                          void* stream) {
  const long long total = (long long)S * n_tile;
  if (total == 0) return 0;
  tile_reset_kernel<<<blocks_for(total), kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)d0, (const uint8_t*)marks, (const int32_t*)dp,
      (const int32_t*)sources, offset, S, n_tile);
  return (int)cudaGetLastError();
}

extern "C" int tile_col_changed(const void* d, const void* dp,
                                void* col_changed, void* count, int S,
                                int n_tile, void* stream) {
  if (n_tile == 0) return 0;
  tile_col_changed_kernel<<<blocks_for(n_tile), kThreads, 0,
                            (cudaStream_t)stream>>>(
      (const int32_t*)d, (const int32_t*)dp, (uint8_t*)col_changed,
      (int32_t*)count, S, n_tile);
  return (int)cudaGetLastError();
}
