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
// The column is checked in range before ctr is read, so a dropped slot costs
// no read of ctr. A partition's slots name distinct columns, so no two
// threads of one fold write one entry: no atomics. `flag` may be null.
//
// Bound on the card: device-memory bytes. cols is read once, the ctr entries
// of this rank's slots once, and those entries of out read and written once;
// at graph = g about 1/g of a frontier's slots land in this rank's columns
// (cols are sorted, so they form one stretch).
//
// Design against that bound: one thread per (row, slot), consecutive threads
// on consecutive slots, so the cols reads and the ctr reads are coalesced,
// and since cols ascend, neighbouring threads update neighbouring (often
// adjacent) columns of one tile row.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;

__global__ void tile_fold_kernel(int32_t* __restrict__ out,
                                 const int32_t* __restrict__ ctr,
                                 const int32_t* __restrict__ cols,
                                 int32_t* __restrict__ flag, int base, int S,
                                 int n_tile, int h) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)S * h) return;
  const int s = (int)(i / h);
  const int k = (int)(i - (long long)s * h);
  const long long local = (long long)cols[k] - base;
  if (local < 0 || local >= n_tile) return;
  const int v = ctr[i];
  int32_t* o = out + (long long)s * n_tile + local;
  if (v < *o) {
    *o = v;
    if (flag) *flag = 1;
  }
}

}  // namespace

extern "C" int tile_fold(void* out, const void* ctr, const void* cols,
                         void* flag, int base, int S, int n_tile, int h,
                         void* stream) {
  const long long total = (long long)S * h;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  tile_fold_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)out, (const int32_t*)ctr, (const int32_t*)cols,
      (int32_t*)flag, base, S, n_tile, h);
  return (int)cudaGetLastError();
}
