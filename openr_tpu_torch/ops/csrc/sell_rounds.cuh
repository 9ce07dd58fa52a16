// What the fixpoint rounds of K1 and K5 (the sliced layout) and of K2 and
// K6 (the edge-list layout) share: the device-side round protocol that lets
// the host enqueue rounds without reading a flag after each one, the grid a
// round runs on, the slot split of a row over up to 32 lanes, the pull of a
// row's slots K1 and K2 both run, and two ways of listing a round's rows:
// the bucket table of the sliced layout and the per-split row lists of the
// edge-list layout.
//
// The bucket table (K1, K5, K9). The host passes int64 [nb, 5] rows in
// HOST memory, one per bucket of the sliced layout: (nbr device pointer, wg
// device pointer, row0, nk, dk), and for K9 a second host array of nb
// device pointers, each bucket's [nk, dk, W] mask words. `fill_buckets`
// copies them into a `__grid_constant__` kernel parameter, so a launch
// needs no upload, and gives each bucket its first virtual block (`blk0`)
// for `items_per_row` items a row times its slot split. At most
// kMaxBuckets buckets: the sliced layout's class degrees sum to at most
// 1,024 (ops/graph.py _SELL_UNROLL_CAP), so it has at most 44. The table
// is 2,824 bytes of the 4,096 a kernel's parameters may take.
//
// The slot split. A row's dk slots go to P = 2^lp consecutive threads,
// thread p taking slots p, p + P, ..., and the P partial results meet in
// warp shuffles (`group_min`, `group_or`): P is the least power of two
// that leaves each thread at most kSlotsPerThread slots, at most 32. A
// row of a Clos spine (dk 340) is then 32 threads of 11 slots, not one
// thread walking 340 dependent loads; the WAN's rows (dk <= 12) keep P 1
// or 2. Every lane of a warp runs the shuffles: a warp's rows share one P.
//
// The row lists (K2, K6). The edge-list layout has no buckets: a node's
// in-edges are the range csr[v] .. csr[v + 1] of the edges sorted by
// destination, and a hub may have thousands. A round's first pass lists
// the rows that can move, each into the list of its slot split (kClasses
// lists, lp = slot_split_log2 of the row's in-degree), and its second pass
// walks list lp with P = 2^lp lanes a row, as K1 walks a bucket. The first
// pass runs a thread an EDGE, so a hub's in-edges spread over many threads:
// an edge whose tail carries stamp t lists its head; of the lanes of a
// warp that name one head (neighbours, the edges being sorted) the first
// goes on, the warps meet in an atomicExch of the row's claim word to t,
// so a row is listed once a round; the lanes of a warp that list rows of
// one split append with one atomicAdd. Lists are in no fixed order.
//
// The grid. A round runs over virtual blocks of kThreads items (bucket
// after bucket, or list after list); a launch takes at most as many real
// blocks as the card keeps resident (`grid_blocks`) and each real block
// walks the virtual blocks with a stride of the grid. A round that has
// nothing left to do then costs a few microseconds whatever the graph's
// size.
//
// The round protocol. A fixpoint's state is 8 int32 words on the card:
// done, rounds, arrived, changed[2] (by round parity). Round t (t >= 1;
// the seed or pack of K5 and K6 is round 0):
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
constexpr int kUnroll = 4;   // slots a thread issues together in a pull
constexpr int kClasses = 6;  // slot splits 1, 2, ..., 32: the row lists

struct Buckets {
  const int32_t* nbr[kMaxBuckets];
  const int32_t* wg[kMaxBuckets];
  const uint32_t* mask[kMaxBuckets];  // K9's mask words; null for K1, K5
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

// log2 of the slot split of a row of dk slots
__host__ __device__ inline int slot_split_log2(int dk) {
  int lp = 0;
  while (lp < 5 && (kSlotsPerThread << lp) < dk) ++lp;
  return lp;
}

// Fills `b` from the host table (and `masks`, K9's host array of mask
// pointers, or null); returns the number of virtual blocks, or -1 for a
// bucket count outside [0, kMaxBuckets].
inline int fill_buckets(Buckets& b, const void* table, int nb,
                        int items_per_row, const void* masks = nullptr) {
  // a launch's other parameters take well under 256 bytes
  static_assert(sizeof(Buckets) <= 4096 - 256, "the table outgrew a launch");
  if (nb < 0 || nb > kMaxBuckets) return -1;
  const long long* t = (const long long*)table;
  long long blocks = 0;
  b.nb = nb;
  for (int k = 0; k < nb; ++k) {
    const long long* row = t + (long long)k * kTableCols;
    b.nbr[k] = (const int32_t*)row[0];
    b.wg[k] = (const int32_t*)row[1];
    b.mask[k] = masks ? (const uint32_t*)((const long long*)masks)[k]
                      : nullptr;
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
// most `want` (at least 1); cached per (kernel, device), since the kernels
// of one library differ in registers and so in occupancy.
inline int grid_blocks(const void* kernel, long long want) {
  struct Cap {
    const void* kernel;
    int dev, blocks;
  };
  static Cap cache[kGridCache];
  static int used = 0;
  if (want < 1) want = 1;
  int dev = 0;
  cudaGetDevice(&dev);
  for (int i = 0; i < used; ++i)
    if (cache[i].kernel == kernel && cache[i].dev == dev)
      return want < cache[i].blocks ? (int)want : cache[i].blocks;
  int sms = 1, per = 1;
  cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per, kernel, kThreads, 0);
  const int c = sms * (per > 0 ? per : 1);
  if (used < kGridCache) cache[used++] = {kernel, dev, c};
  return want < c ? (int)want : c;
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

// -- a row's pull: K1 over a bucket row, K2 over an in-edge range ---------

// The V columns s0 .. s0 + V - 1 of a row that one thread moves, the
// first nc of them real: V = 1, or V = 4 as one 16-byte access (Wide: S %
// 4 == 0 and 16-byte aligned rows) or as nc <= 4 scalar accesses (Wide
// false: any alignment, and a row's last group holds S % 4 columns). A
// column past nc loads as INF and is never stored.
template <int V, bool Wide = true>
struct Vec {
  int x[V];
  __device__ __forceinline__ void load(const int32_t* p, int nc = V) {
    if constexpr (V == 4 && Wide) {
      const int4 a = __ldg(reinterpret_cast<const int4*>(p));
      x[0] = a.x; x[1] = a.y; x[2] = a.z; x[3] = a.w;
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c) x[c] = c < nc ? __ldg(p + c) : kInf;
    }
  }
  __device__ __forceinline__ void store(int32_t* p, int nc = V) const {
    if constexpr (V == 4 && Wide) {
      *reinterpret_cast<int4*>(p) = make_int4(x[0], x[1], x[2], x[3]);
    } else {
#pragma unroll
      for (int c = 0; c < V; ++c)
        if (c < nc) p[c] = x[c];
    }
  }
};

// Lane p's share of one row's pull: over the slots j = p, p + P, ... <
// count, acc[c] = min(acc[c], min(dt[u_j, s0 + c] + w_j, INF)), dt INF
// through an overloaded tail that is not column c's source (src[c]), taking
// only the slots whose tail carries stamp t in cp (every slot when `full`).
// nb[j] is slot j's tail; d_old is dest-major [n, S]; the thread's columns
// are s0 .. s0 + nc - 1 (Vec). The weights: w[j] for every column, or
// with PerCol V columns from a [slots, S] matrix (w + j * S + s0, one
// weight row per source column: KSP's per-row weights). With Masked (K9),
// slot j weighs INF for column s0 + c where that bit of its mask word mw[j
// * W] is set (mw: the row's words at word s0 / 32; the V columns lie in
// one word, s0 being a multiple of V = 4 or V = 1): a masked column takes
// nothing from the slot, and a slot masked in all nc columns is not
// gathered. A lane issues kUnroll slots at once: their tails, mask words,
// stamps, ov bytes and gathers are in flight together. The sums stay in
// int32: both terms are at most INF = 2^29.
template <int V, bool PerCol, bool Masked = false, bool Wide = true>
__device__ __forceinline__ void pull_slots(
    Vec<V, Wide>& acc, const int32_t* __restrict__ nb,
    const int32_t* __restrict__ w, int count, int p, int P,
    const int32_t* __restrict__ cp, int t, int full,
    const uint8_t* __restrict__ ov, const int (&src)[V],
    const int32_t* __restrict__ d_old, int S, int s0,
    const uint32_t* __restrict__ mw = nullptr, int W = 0, int nc = V) {
  const uint32_t all = (1u << nc) - 1;
  const int step = P * kUnroll;
  for (int j0 = p; j0 < count; j0 += step) {
    int u[kUnroll], wj[kUnroll];
    uint32_t mk[kUnroll];
    bool take[kUnroll], o[kUnroll];
    Vec<V, Wide> du[kUnroll], wv[kUnroll];
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      const int j = j0 + q * P;
      const bool in = j < count;
      u[q] = in ? __ldg(nb + j) : 0;
      if (!PerCol) wj[q] = in ? __ldg(w + j) : kInf;
      mk[q] = Masked && in
                  ? (__ldg(mw + (long long)j * W) >> (s0 & 31)) & all
                  : 0u;
      take[q] = in && mk[q] != all && (full || __ldg(cp + u[q]) == t);
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      if (take[q]) {
        o[q] = __ldg(ov + u[q]) != 0;
        du[q].load(d_old + (long long)u[q] * S + s0, nc);
        if (PerCol) wv[q].load(w + (long long)(j0 + q * P) * S + s0, nc);
      }
    }
#pragma unroll
    for (int q = 0; q < kUnroll; ++q) {
      if (!take[q]) continue;
#pragma unroll
      for (int c = 0; c < V; ++c) {
        const int dt = (o[q] && u[q] != src[c]) ? kInf : du[q].x[c];
        const int wc = PerCol ? wv[q].x[c] : wj[q];
        if (!Masked || !((mk[q] >> c) & 1u))
          acc.x[c] = min(acc.x[c], min(dt + wc, kInf));
      }
    }
  }
}

// A row's end of a round, on its lane 0, once the lanes' partial minima
// met: a row that took nothing below INF cannot move and reads its own
// entries only to write them through (`through`: it changed in the round
// before, and the buffer this round writes holds its value of two rounds
// ago); otherwise d_new gets min(acc, d_old) where it went down or must
// be written through. Returns whether it went down. Only the first nc
// columns are read and written (a column past them is INF in acc).
template <int V, bool Wide = true>
__device__ __forceinline__ bool finish_row(Vec<V, Wide>& acc,
                                           const int32_t* __restrict__ d_old,
                                           int32_t* __restrict__ d_new,
                                           long long at, bool through,
                                           int nc = V) {
  bool offer = false;
#pragma unroll
  for (int c = 0; c < V; ++c) offer |= acc.x[c] < kInf;
  if (!offer && !through) return false;
  Vec<V, Wide> old;
  old.load(d_old + at, nc);
  bool moved = false;
#pragma unroll
  for (int c = 0; c < V; ++c) {
    moved |= acc.x[c] < old.x[c];
    acc.x[c] = min(acc.x[c], old.x[c]);
  }
  if (moved || through) acc.store(d_new + at, nc);
  return moved;
}

// -- the row lists of the edge-list layout (K2, K6) ------------------------

// The lists' buffer, int32 words from p, zeroed by the host: claim [n] (the
// round that last listed each row), list [kClasses, n], counts [8] (the
// first kClasses used, cleared by each round's last block).
struct CsrLists {
  int32_t* claim;
  int32_t* list;
  int32_t* counts;
};

__host__ __device__ inline CsrLists csr_lists(int32_t* p, int n) {
  return {p, p + n, p + (1LL + kClasses) * n};
}

// Lists row v (v < 0: nothing) of round t, once a round: every lane of the
// warp calls this together. Lanes that name one head sit side by side
// (edges are sorted by destination), so a lane lists its head only where
// the lane before it names another; the warps that name one head meet in
// the claim word. The lanes that list rows of one split append with one
// atomicAdd, a split at a time.
__device__ __forceinline__ void list_row(const CsrLists& L,
                                         const int32_t* __restrict__ csr,
                                         int n, int v, int t) {
  const unsigned all = 0xffffffffu;
  if (!__any_sync(all, v >= 0)) return;  // the warp lists nothing
  const int lane = threadIdx.x & 31;
  const int before = __shfl_up_sync(all, v, 1);
  bool want = v >= 0 && (lane == 0 || before != v);
  // the row's split, loaded beside the claim rather than after it
  const int deg = want ? __ldg(csr + v + 1) - __ldg(csr + v) : 0;
  if (want) want = atomicExch(L.claim + v, t) != t;
  const int cls = want ? slot_split_log2(deg) : -1;
  for (unsigned left = __ballot_sync(all, want); left;) {
    const int leader = __ffs(left) - 1;
    const int c = __shfl_sync(all, cls, leader);
    const unsigned peers = __ballot_sync(all, want && cls == c);
    int base = 0;
    if (lane == leader) base = atomicAdd(L.counts + c, __popc(peers));
    base = __shfl_sync(all, base, leader);
    if (want && cls == c)
      L.list[(long long)c * n + base + __popc(peers & ((1u << lane) - 1))] =
          v;
    left &= ~peers;
  }
}

// Round t's first pass, every lane of a warp on consecutive items i of a
// grid-stride loop: edge i (i < m) lists its head when its tail carries
// stamp t in cp; with `own`, row i (i < n) lists itself when it carries
// stamp t (K2's write-through); with `full`, row i lists itself when it
// has in-edges (a round that takes every slot), and no edge lists.
__device__ __forceinline__ void list_rows(const CsrLists& L,
                                          const int32_t* __restrict__ cp,
                                          const int32_t* __restrict__ csr,
                                          const int32_t* __restrict__ src,
                                          const int32_t* __restrict__ dst,
                                          int n, int m, long long i, int t,
                                          bool own, bool full) {
  int v = -1, self = -1;
  if (full) {
    if (i < n && __ldg(csr + i + 1) > __ldg(csr + i)) v = (int)i;
  } else {
    // the loads that do not wait for each other go out together
    const bool edge = i < m;
    const int u = edge ? __ldg(src + i) : 0;
    const int head = edge ? __ldg(dst + i) : 0;
    const int stamp = own && i < n ? __ldg(cp + i) : 0;
    if (edge && __ldg(cp + u) == t) v = head;
    if (stamp == t) self = (int)i;
  }
  list_row(L, csr, n, v, t);
  if (own && !full) list_row(L, csr, n, self, t);
}

// -- the marks of K5 and K6 --------------------------------------------------

// A mark fixpoint's buffer, int32 words zeroed by the host: M [n, W] the
// marks so far (bit b of word w of row v: source column 32 w + b), N [2, n,
// W] the bits a row newly marked in a round, by round parity, F [2, n] the
// round a row last newly marked bits, by parity, as round + 1 (0: never;
// the seed's round is 0), the RoundState: 3 n W + 2 n + 8 words.
struct MarkBuf {
  uint32_t* m;
  uint32_t* nw;  // [2, n, W]
  int32_t* f;    // [2, n]
  RoundState* st;
};

__host__ __device__ inline MarkBuf mark_buf(void* buf, int n, int W) {
  uint32_t* base = (uint32_t*)buf;
  const long long nw = (long long)n * W;
  MarkBuf b;
  b.m = base;
  b.nw = base + nw;
  b.f = (int32_t*)(base + 3 * nw);
  b.st = (RoundState*)(base + 3 * nw + 2LL * n);
  return b;
}

}  // namespace sell
