// What K1's and K5's fixpoint rounds share: the bucket table each launch
// takes for every degree bucket at once, the grid a round runs on, and the
// device-side round protocol that lets the host enqueue rounds without
// reading a flag after each one.
//
// The bucket table. The host passes int64 [nb, 5] rows in HOST memory, one
// per bucket of the sliced layout: (nbr device pointer, wg device pointer,
// row0, nk, dk). `fill_buckets` copies them into a `__grid_constant__`
// kernel parameter, so a launch needs no upload, and gives each bucket its
// first virtual block (`blk0`) for `items_per_row` items a row times its
// slot split. At most
// kMaxBuckets buckets: the sliced layout's class degrees sum to at most
// 1,024 (ops/graph.py _SELL_UNROLL_CAP), so it has at most 44.
//
// The slot split. A row's dk slots go to P = 2^lp consecutive threads,
// thread p taking slots p, p + P, ..., and the P partial results meet in
// warp shuffles (`group_min`, `group_or`): P is the least power of two
// that leaves each thread at most kSlotsPerThread slots, at most 32. A
// row of a Clos spine (dk 340) is then 32 threads of 11 slots, not one
// thread walking 340 dependent loads; the WAN's rows (dk <= 12) keep P 1
// or 2. Every lane of a warp runs the shuffles: a block's virtual block
// lies in one bucket, so P is uniform in a block.
//
// The grid. A round runs over virtual blocks of kThreads items, bucket
// after bucket; a launch takes at most as many real blocks as the card
// keeps resident (`grid_blocks`) and each real block walks the virtual
// blocks with a stride of the grid. A round that has nothing left to do
// then costs a few microseconds whatever the graph's size.
//
// The round protocol. A fixpoint's state is 8 int32 words on the card:
// done, rounds, arrived, changed[2] (by round parity). Round t (t >= 1;
// the seed or pack of K5 is round 0):
//   - returns at once, every block, if `done` is set: the host enqueues
//     rounds in chunks and reads the state once a chunk;
//   - sets changed[t & 1] when one of its entries changed;
//   - its last block to finish (a ticket on `arrived`) records rounds = t,
//     sets done when round t changed nothing, clears changed[(t + 1) & 1]
//     for the next round and resets `arrived`.
// So `rounds` counts the rounds that ran, the final no-change round
// included: the reference's count. Rounds stay Jacobi: a round reads only
// what the rounds before it wrote.

#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace sell {

constexpr int kInf = 1 << 29;
constexpr int kThreads = 256;
constexpr int kMaxBuckets = 64;
constexpr int kTableCols = 5;
constexpr int kGridCache = 64;  // (kernel, device) pairs grid_blocks keeps
constexpr int kSlotsPerThread = 8;

struct Buckets {
  const int32_t* nbr[kMaxBuckets];
  const int32_t* wg[kMaxBuckets];
  int row0[kMaxBuckets];
  int nk[kMaxBuckets];
  int dk[kMaxBuckets];
  int lp[kMaxBuckets];
  int blk0[kMaxBuckets + 1];
  int nb;
};

struct RoundState {
  int done;
  int rounds;
  unsigned arrived;
  int changed[2];
  int pad[3];
};

// log2 of the slot split of a bucket of dk slots
inline int slot_split_log2(int dk) {
  int lp = 0;
  while (lp < 5 && (kSlotsPerThread << lp) < dk) ++lp;
  return lp;
}

// Fills `b` from the host table; returns the number of virtual blocks, or
// -1 for a bucket count outside [0, kMaxBuckets].
inline int fill_buckets(Buckets& b, const void* table, int nb,
                        int items_per_row) {
  if (nb < 0 || nb > kMaxBuckets) return -1;
  const long long* t = (const long long*)table;
  long long blocks = 0;
  b.nb = nb;
  for (int k = 0; k < nb; ++k) {
    const long long* row = t + (long long)k * kTableCols;
    b.nbr[k] = (const int32_t*)row[0];
    b.wg[k] = (const int32_t*)row[1];
    b.row0[k] = (int)row[2];
    b.nk[k] = (int)row[3];
    b.dk[k] = (int)row[4];
    b.lp[k] = slot_split_log2(b.dk[k]);
    b.blk0[k] = (int)blocks;
    const long long items = (row[3] * (long long)items_per_row) << b.lp[k];
    blocks += (items + kThreads - 1) / kThreads;
  }
  b.blk0[nb] = (int)blocks;
  return (int)blocks;
}

// The blocks of `kernel` the card keeps resident at kThreads a block, at
// most `want`; cached per (kernel, device), since the kernels of one
// library differ in registers and so in occupancy.
inline int grid_blocks(const void* kernel, int want) {
  struct Cap {
    const void* kernel;
    int dev, blocks;
  };
  static Cap cache[kGridCache];
  static int used = 0;
  int dev = 0;
  cudaGetDevice(&dev);
  for (int i = 0; i < used; ++i)
    if (cache[i].kernel == kernel && cache[i].dev == dev)
      return want < cache[i].blocks ? want : cache[i].blocks;
  int sms = 1, per = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, 0);
  const int c = sms * (per > 0 ? per : 1);
  if (used < kGridCache) cache[used++] = {kernel, dev, c};
  return want < c ? want : c;
}

__device__ __forceinline__ bool round_done(const RoundState* st) {
  return *(volatile const int*)&st->done != 0;
}

// Every thread of every block calls this once, last, with whether one of
// its own entries changed; the last block also zeroes clear[0, nclear)
// (per-round counters the next round starts from).
__device__ __forceinline__ void finish_round(RoundState* st, int t,
                                             bool changed,
                                             int* clear = nullptr,
                                             int nclear = 0) {
  const int any = __syncthreads_or(changed);
  if (threadIdx.x != 0 || threadIdx.y != 0) return;
  if (any) atomicOr(&st->changed[t & 1], 1);
  __threadfence();
  const unsigned blocks = gridDim.x * gridDim.y;
  if (atomicAdd(&st->arrived, 1u) != blocks - 1) return;
  __threadfence();
  const int c = atomicOr(&st->changed[t & 1], 0);
  st->rounds = t;
  if (!c) st->done = 1;
  st->changed[(t + 1) & 1] = 0;
  st->arrived = 0;
  for (int i = 0; i < nclear; ++i) clear[i] = 0;
  __threadfence();
}

__device__ __forceinline__ int group_min(int x, int P) {
  for (int o = 1; o < P; o <<= 1)
    x = min(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}

__device__ __forceinline__ uint32_t group_or(uint32_t x, int P) {
  for (int o = 1; o < P; o <<= 1) x |= __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// The bucket of virtual block vb, searching up from bucket k.
__device__ __forceinline__ int bucket_of(const Buckets& b, int vb, int k) {
  while (vb >= b.blk0[k + 1]) ++k;
  return k;
}

}  // namespace sell
