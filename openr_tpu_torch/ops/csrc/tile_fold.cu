// K20 tile_fold: fold one frontier into the columns a rank owns, the halo
// exchange's scatter-min.
//
// Replaces: openr_tpu/ops/spf.py `_tile_fold_min` (and so each fold of
// `_tile_halo_min`): tile.at[:, local].min(ctr, mode="drop") with
// local = cols - me * n_tile, out of range -> dropped; plus the round's
// change flag, the reference's any(new_d != d), set where an entry went down.
//
// Layout: out is the rank's row-major [S, n_tile] int32 tile, folded into in
// place; ctr [S, h] a frontier's minima and cols [h] the global column of
// each slot (the sentinel 1 << 30 marks an unused slot). For every (s, k):
//
//   local = cols[k] - base            (base = me * n_tile)
//   if 0 <= local < n_tile:  out[s, local] = min(out[s, local], ctr[s, k])
//
// Precondition: cols ascends, its sentinels last (each partition's columns
// are np.unique of its destinations: parallel/mesh.py tile_graph, and the
// hops copy them as they are; convert.tiling_ranks raises on a row that
// does not ascend). So the slots a rank owns form one stretch [k0, k1),
// k0 = lower_bound(cols, base), k1 = lower_bound(cols, base + n_tile), and
// the slots outside it are dropped without a read of ctr. A partition's
// slots name distinct columns, so no two threads of one fold write one
// entry: no atomics. A slot inside the stretch whose column is out of range
// (cols not ascending) is still dropped, so a broken precondition loses
// entries but writes nothing outside the tile. `flag` may be null.
//
// Bound on the card: device-memory bytes. cols is read once, the ctr entries
// of the stretch once, and those entries of out read and written once; at
// graph = g about 1/g of a frontier's slots land in this rank's columns.
//
// Design against that bound. Each block finds the stretch itself: two
// warps run the two lower bounds at once, each a 32-way search (the lanes
// probe 32 evenly spaced slots, a ballot keeps the part between the last
// probe below the bound and the first at or above it; 4 steps at h =
// 131,072, cols sitting in L2), so there is no host sync and no extra
// launch. The blocks, as many as the card keeps resident, then walk chunks
// of kChunk consecutive slots of one row with a stride of the grid: a warp
// takes 32 consecutive slots, so the reads of cols and ctr are coalesced
// and the writes to out land in ascending columns; a thread issues kUnroll
// slots of its chunk together (the loads of cols and ctr, then those of
// out, which need the column), so 4 slots are in flight a thread. A warp
// sets the flag once, by a vote after its last chunk, not a store from
// every thread that lowered an entry.
//
// The first design ran a thread per (row, slot) over all S x h slots
// (16.8 M threads at tile_wan), of which about 3/4 read a column and
// returned, and each thread that lowered an entry stored the flag. Not
// built: 16-byte accesses where a stretch's columns are consecutive; the
// fold that chip_smoke.py times (partition 0's frontier into rank 1 of the
// 100k WAN on (1, 4)) owns 18,283 slots across rank 1's 32,768 columns, so
// its columns have gaps and would take the scalar path.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;
constexpr int kChunk = kThreads * kUnroll;  // slots of one row a block takes
constexpr int kGridCache = 16;              // devices grid_blocks keeps

// The first k in [0, h) with cols[k] >= x, h when there is none, found by
// one warp (every lane calls this and gets the answer); cols ascends.
__device__ int warp_lower_bound(const int32_t* __restrict__ cols, int h,
                                long long x) {
  const unsigned all = 0xffffffffu;
  const int lane = threadIdx.x & 31;
  int lo = 0, hi = h;  // the answer lies in [lo, hi]
  while (lo < hi) {
    const int step = (hi - lo + 31) >> 5;
    const int q = lo + lane * step;
    const bool probe = q < hi;
    const unsigned probed = __ballot_sync(all, probe);
    const unsigned ge = __ballot_sync(all, probe && __ldg(cols + q) >= x);
    if (!ge) {  // every probe below x: after the last one
      lo += (31 - __clz(probed)) * step + 1;
    } else {  // between the probe before the first at or above x and it
      const int first = __ffs(ge) - 1;
      hi = lo + first * step;
      if (first) lo += (first - 1) * step + 1;
    }
  }
  return lo;
}

__global__ void __launch_bounds__(kThreads) tile_fold_kernel(
    int32_t* __restrict__ out, const int32_t* __restrict__ ctr,
    const int32_t* __restrict__ cols, int32_t* __restrict__ flag, int base,
    int S, int n_tile, int h) {
  __shared__ int stretch[2];
  const int warp = threadIdx.x >> 5;
  if (warp < 2) {
    const int k = warp_lower_bound(cols, h, (long long)base + warp * n_tile);
    if ((threadIdx.x & 31) == 0) stretch[warp] = k;
  }
  __syncthreads();
  const int k0 = stretch[0], k1 = stretch[1];
  const int per_row = (k1 - k0 + kChunk - 1) / kChunk;
  const long long chunks = (long long)S * per_row;
  bool lowered = false;
  // block-uniform: every thread of a block runs the same chunks
  for (long long c = blockIdx.x; c < chunks; c += gridDim.x) {
    const int s = (int)(c / per_row);
    const int k = k0 + (int)(c - (long long)s * per_row) * kChunk +
                  threadIdx.x;
    const int32_t* crow = ctr + (long long)s * h;
    int32_t* orow = out + (long long)s * n_tile;
    int local[kUnroll], v[kUnroll], o[kUnroll];
    bool in[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int kq = k + q * kThreads;
      in[q] = kq < k1;
      local[q] = in[q] ? __ldg(cols + kq) - base : -1;
      v[q] = in[q] ? __ldg(crow + kq) : 0;
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      in[q] = in[q] && local[q] >= 0 && local[q] < n_tile;
      o[q] = in[q] ? orow[local[q]] : 0;
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      if (in[q] && v[q] < o[q]) {
        orow[local[q]] = v[q];
        lowered = true;
      }
    }
  }
  if (flag && __any_sync(0xffffffffu, lowered) && (threadIdx.x & 31) == 0)
    *flag = 1;
}

// The blocks of tile_fold_kernel the card keeps resident, at most `want`
// (at least 1); cached per device.
int grid_blocks(long long want) {
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
        &per, (const void*)tile_fold_kernel, kThreads, 0);
    c = sms * (per > 0 ? per : 1);
    if (used < kGridCache) {
      cache_dev[used] = dev;
      cache_blocks[used++] = c;
    }
  }
  return want < c ? (int)want : c;
}

}  // namespace

extern "C" int tile_fold(void* out, const void* ctr, const void* cols,
                         void* flag, int base, int S, int n_tile, int h,
                         void* stream) {
  if (S < 0 || n_tile < 0 || h < 0) return (int)cudaErrorInvalidValue;
  if ((long long)S * h == 0) return 0;
  // the stretch is not known on the host: at most S x h slots
  const int grid = grid_blocks(((long long)S * h + kChunk - 1) / kChunk);
  tile_fold_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)ctr, (const int32_t*)cols,
      (int32_t*)flag, base, S, n_tile, h);
  return (int)cudaGetLastError();
}
