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
//   tile_col_changed  col_changed[t] |= any_s d[s, t] != dp[s, t], *count
//                     += the number of columns it newly sets; run rank after
//                     rank over the batch ranks of a column block, that is
//                     the reference's pmax over 'batch' and its psum'd
//                     popcount
//
// Bound on the card: device-memory bytes; each entry reads and writes every
// entry of its tiles once (tile_col_changed stops a column at its first
// difference) and does one or two integer operations per entry.
//
// Design against that bound. Every entry moves 4 int32 columns a thread
// with 16-byte loads and stores (the marks and the changed columns as
// 4-byte words), and falls back to a column a thread where n_tile % 4, or
// a buffer's alignment, rules the wide path out.
//   - tile_init and tile_reset run a 2D grid, the row from blockIdx.y and
//     1,024 columns a block from x, so no division per entry; a source's
//     pin is one unsigned compare per 4 columns.
//   - tile_mark runs a grid of the blocks the card keeps resident over the
//     flat tile (the tail of a total not divisible by 4 in block 0) and
//     writes the flag once a warp, after __any_sync.
//   - tile_col_changed gives each block a strip of 128 columns (32 lanes x
//     4) across all S rows; its 8 warps split the rows 4 at a time and
//     issue the 4 rows' 8 loads before any compare, so a column's rows are
//     read in parallel and not as one thread's chain of loads. A lane skips
//     the columns already set (an earlier batch rank) or already found
//     different; a warp stops when all its lanes have. The warps' findings
//     meet in shared memory, the newly set columns are written and counted
//     by one atomicAdd a block.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr int kThreads = 256;
constexpr int kRowCols = 4 * kThreads;  // tile_init / tile_reset: a block
constexpr int kStrip = 128;             // tile_col_changed: a block's columns
constexpr int kRowStep = 4;             // rows a warp loads before comparing
constexpr int kGridCache = 16;

bool aligned(const void* p, uintptr_t bytes) {
  return p == nullptr || (reinterpret_cast<uintptr_t>(p) & (bytes - 1)) == 0;
}

// INF in four columns from c, 0 in column `local` where it is one of them
__device__ __forceinline__ int4 pin4(int4 v, int local, int c) {
  const unsigned q = (unsigned)(local - c);
  if (q < 4u) {
    v.x = q == 0 ? 0 : v.x;
    v.y = q == 1 ? 0 : v.y;
    v.z = q == 2 ? 0 : v.z;
    v.w = q == 3 ? 0 : v.w;
  }
  return v;
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
    tile_init_kernel(int32_t* __restrict__ d0,
                     const int32_t* __restrict__ sources, int offset, int S,
                     int n_tile) {
  const int c0 = blockIdx.x * kRowCols;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const int local = sources[s] - offset;
    int32_t* row = d0 + (long long)s * n_tile;
    if (kWide) {
      const int c = c0 + 4 * threadIdx.x;
      if (c < n_tile)
        *reinterpret_cast<int4*>(row + c) =
            pin4(make_int4(kInf, kInf, kInf, kInf), local, c);
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = c0 + k * kThreads + threadIdx.x;
        if (c < n_tile) row[c] = c == local ? 0 : kInf;
      }
    }
  }
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
    tile_reset_kernel(int32_t* __restrict__ d0,
                      const uint8_t* __restrict__ marks,
                      const int32_t* __restrict__ dp,
                      const int32_t* __restrict__ sources, int offset, int S,
                      int n_tile) {
  const int c0 = blockIdx.x * kRowCols;
  for (int s = blockIdx.y; s < S; s += gridDim.y) {
    const int local = sources[s] - offset;
    const long long r = (long long)s * n_tile;
    if (kWide) {
      const int c = c0 + 4 * threadIdx.x;
      if (c < n_tile) {
        const int4 p = *reinterpret_cast<const int4*>(dp + r + c);
        const uchar4 m = *reinterpret_cast<const uchar4*>(marks + r + c);
        const int4 v = make_int4(m.x ? kInf : p.x, m.y ? kInf : p.y,
                                 m.z ? kInf : p.z, m.w ? kInf : p.w);
        *reinterpret_cast<int4*>(d0 + r + c) = pin4(v, local, c);
      }
    } else {
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        const int c = c0 + k * kThreads + threadIdx.x;
        if (c < n_tile)
          d0[r + c] = c == local ? 0 : (marks[r + c] ? kInf : dp[r + c]);
      }
    }
  }
}

__device__ __forceinline__ bool mark_one(const uint8_t* m, int32_t* recv,
                                         const int32_t* dp, uint8_t* m_out,
                                         long long i) {
  const int p = dp[i];
  const uint8_t old = m ? m[i] : 0;
  const uint8_t hit = (recv[i] == p) && (p < kInf);
  m_out[i] = old | hit;
  recv[i] = kInf;
  return hit && !old;
}

// the mark bytes (0 or 1) of four entries as one word, byte q entry q
__device__ __forceinline__ uint32_t hits4(int4 r, int4 p) {
  return (uint32_t)(r.x == p.x && p.x < kInf) |
         (uint32_t)(r.y == p.y && p.y < kInf) << 8 |
         (uint32_t)(r.z == p.z && p.z < kInf) << 16 |
         (uint32_t)(r.w == p.w && p.w < kInf) << 24;
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
    tile_mark_kernel(const uint8_t* __restrict__ m,
                     int32_t* __restrict__ recv,
                     const int32_t* __restrict__ dp,
                     uint8_t* __restrict__ m_out, int32_t* __restrict__ flag,
                     long long total) {
  const long long stride = (long long)gridDim.x * kThreads;
  const long long first = (long long)blockIdx.x * kThreads + threadIdx.x;
  bool fresh = false;
  if (kWide) {
    const long long quads = total >> 2;
    for (long long i = first; i < quads; i += stride) {
      const int4 r = reinterpret_cast<const int4*>(recv)[i];
      const int4 p = reinterpret_cast<const int4*>(dp)[i];
      const uint32_t old = m ? reinterpret_cast<const uint32_t*>(m)[i] : 0u;
      const uint32_t hit = hits4(r, p);
      reinterpret_cast<uint32_t*>(m_out)[i] = old | hit;
      reinterpret_cast<int4*>(recv)[i] = make_int4(kInf, kInf, kInf, kInf);
      fresh |= (hit & ~old) != 0;
    }
    if (first < (total & 3))
      fresh |= mark_one(m, recv, dp, m_out, (quads << 2) + first);
  } else {
    for (long long i = first; i < total; i += stride)
      fresh |= mark_one(m, recv, dp, m_out, i);
  }
  if (__any_sync(0xffffffffu, fresh) && (threadIdx.x & 31) == 0) *flag = 1;
}

// lane's column q of the strip: 4 adjacent columns a lane (wide) or a
// column every 32 (scalar)
template <bool kWide>
__device__ __forceinline__ int strip_col(int c0, int lane, int q) {
  return kWide ? c0 + 4 * lane + q : c0 + lane + 32 * q;
}

// bit q: column q of the lane differs between d and dp in row s
template <bool kWide>
__device__ __forceinline__ uint32_t row_diff(const int32_t* __restrict__ d,
                                             const int32_t* __restrict__ dp,
                                             long long r, int c0, int lane,
                                             uint32_t valid) {
  if (kWide) {
    const int c = strip_col<true>(c0, lane, 0);
    const int4 a = *reinterpret_cast<const int4*>(d + r + c);
    const int4 b = *reinterpret_cast<const int4*>(dp + r + c);
    return (uint32_t)(a.x != b.x) | (uint32_t)(a.y != b.y) << 1 |
           (uint32_t)(a.z != b.z) << 2 | (uint32_t)(a.w != b.w) << 3;
  }
  uint32_t bits = 0;
#pragma unroll
  for (int q = 0; q < 4; ++q) {
    const int c = strip_col<false>(c0, lane, q);
    if (valid >> q & 1) bits |= (uint32_t)(d[r + c] != dp[r + c]) << q;
  }
  return bits;
}

template <bool kWide>
__global__ void __launch_bounds__(kThreads)
    tile_col_changed_kernel(const int32_t* __restrict__ d,
                            const int32_t* __restrict__ dp,
                            uint8_t* __restrict__ col_changed,
                            int32_t* __restrict__ count, int S, int n_tile) {
  __shared__ uint32_t seen[32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int c0 = blockIdx.x * kStrip;
  // the lane's columns inside the tile, and those an earlier rank set
  uint32_t valid = 0, preset = 0;
  if (kWide) {
    const int c = strip_col<true>(c0, lane, 0);
    if (c < n_tile) {  // n_tile % 4 == 0: all four or none
      valid = 0xfu;
      const uchar4 cc = *reinterpret_cast<const uchar4*>(col_changed + c);
      preset = (uint32_t)(cc.x != 0) | (uint32_t)(cc.y != 0) << 1 |
               (uint32_t)(cc.z != 0) << 2 | (uint32_t)(cc.w != 0) << 3;
    }
  } else {
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int c = strip_col<false>(c0, lane, q);
      if (c < n_tile) {
        valid |= 1u << q;
        preset |= (uint32_t)(col_changed[c] != 0) << q;
      }
    }
  }
  if (threadIdx.x < 32) seen[threadIdx.x] = 0;
  __syncthreads();
  uint32_t diff = 0;
  const uint32_t settled = preset | (~valid & 0xfu);
  // warp w takes rows 4 w .. 4 w + 3, then 4 (w + 8) .., all lanes alike
  for (int s0 = warp * kRowStep; s0 < S; s0 += (kThreads / 32) * kRowStep) {
    const bool busy = ((settled | diff) & 0xfu) != 0xfu;
    if (!__any_sync(0xffffffffu, busy)) break;
    if (!busy) continue;
    uint32_t bits[kRowStep];
#pragma unroll
    for (int k = 0; k < kRowStep; ++k)
      bits[k] = s0 + k < S ? row_diff<kWide>(d, dp, (long long)(s0 + k) *
                                                        n_tile,
                                             c0, lane, valid & ~preset)
                           : 0u;
#pragma unroll
    for (int k = 0; k < kRowStep; ++k) diff |= bits[k];
  }
  diff &= valid & ~preset;
  if (diff) atomicOr(&seen[lane], diff);
  __syncthreads();
  if (warp != 0) return;
  const uint32_t fresh = seen[lane];
  if (fresh) {
    if (kWide) {
      const uint32_t set = preset | fresh;
      *reinterpret_cast<uchar4*>(col_changed + strip_col<true>(c0, lane, 0)) =
          make_uchar4(set & 1, set >> 1 & 1, set >> 2 & 1, set >> 3 & 1);
    } else {
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (fresh >> q & 1) col_changed[strip_col<false>(c0, lane, q)] = 1;
    }
  }
  const int n = __reduce_add_sync(0xffffffffu, __popc(fresh));
  if (lane == 0 && n) atomicAdd(count, n);
}

// The blocks of tile_mark_kernel the card keeps resident, at most `want`
// (at least 1); cached per device.
int mark_grid(long long want) {
  static int cache_dev[kGridCache], cache_blocks[kGridCache];
  static int used = 0;
  if (want < 1) want = 1;
  int dev = 0;
  cudaGetDevice(&dev);
  int c = 0;
  for (int i = 0; i < used && !c; ++i)
    if (cache_dev[i] == dev) c = cache_blocks[i];
  if (!c) {
    int sms = 1, per = 1;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        &per, (const void*)tile_mark_kernel<true>, kThreads, 0);
    c = sms * (per > 0 ? per : 1);
    if (used < kGridCache) {
      cache_dev[used] = dev;
      cache_blocks[used++] = c;
    }
  }
  return want < c ? (int)want : c;
}

// tile_init / tile_reset: x over the row's 1,024-column groups, y the rows
dim3 row_grid(int S, int n_tile) {
  return dim3((unsigned)((n_tile + kRowCols - 1) / kRowCols),
              (unsigned)(S < 65535 ? S : 65535));
}

}  // namespace

extern "C" int tile_init(void* d0, const void* sources, int offset, int S,
                         int n_tile, void* stream) {
  if (S < 0 || n_tile < 0) return (int)cudaErrorInvalidValue;
  if ((long long)S * n_tile == 0) return 0;
  const bool wide = n_tile % 4 == 0 && aligned(d0, 16);
  auto kernel = wide ? tile_init_kernel<true> : tile_init_kernel<false>;
  kernel<<<row_grid(S, n_tile), kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)d0, (const int32_t*)sources, offset, S, n_tile);
  return (int)cudaGetLastError();
}

// m may be null (no marks yet: the seed)
extern "C" int tile_mark(const void* m, void* recv, const void* dp,
                         void* m_out, void* flag, int total, void* stream) {
  if (total < 0) return (int)cudaErrorInvalidValue;
  if (total == 0) return 0;
  const bool wide = aligned(recv, 16) && aligned(dp, 16) && aligned(m, 4) &&
                    aligned(m_out, 4);
  const long long items = wide ? total / 4 : total;
  const int grid = mark_grid((items + kThreads - 1) / kThreads);
  auto kernel = wide ? tile_mark_kernel<true> : tile_mark_kernel<false>;
  kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)m, (int32_t*)recv, (const int32_t*)dp,
      (uint8_t*)m_out, (int32_t*)flag, (long long)total);
  return (int)cudaGetLastError();
}

extern "C" int tile_reset(void* d0, const void* marks, const void* dp,
                          const void* sources, int offset, int S, int n_tile,
                          void* stream) {
  if (S < 0 || n_tile < 0) return (int)cudaErrorInvalidValue;
  if ((long long)S * n_tile == 0) return 0;
  const bool wide = n_tile % 4 == 0 && aligned(d0, 16) && aligned(dp, 16) &&
                    aligned(marks, 4);
  auto kernel = wide ? tile_reset_kernel<true> : tile_reset_kernel<false>;
  kernel<<<row_grid(S, n_tile), kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)d0, (const uint8_t*)marks, (const int32_t*)dp,
      (const int32_t*)sources, offset, S, n_tile);
  return (int)cudaGetLastError();
}

extern "C" int tile_col_changed(const void* d, const void* dp,
                                void* col_changed, void* count, int S,
                                int n_tile, void* stream) {
  if (S < 0 || n_tile < 0) return (int)cudaErrorInvalidValue;
  if (n_tile == 0) return 0;
  const bool wide = n_tile % 4 == 0 && aligned(d, 16) && aligned(dp, 16) &&
                    aligned(col_changed, 4);
  auto kernel =
      wide ? tile_col_changed_kernel<true> : tile_col_changed_kernel<false>;
  kernel<<<(n_tile + kStrip - 1) / kStrip, kThreads, 0,
           (cudaStream_t)stream>>>((const int32_t*)d, (const int32_t*)dp,
                                   (uint8_t*)col_changed, (int32_t*)count, S,
                                   n_tile);
  return (int)cudaGetLastError();
}
