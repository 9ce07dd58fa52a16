// K1 sell_relax_round: one Jacobi round of the sliced-ELL pull min-plus
// relaxation over every degree bucket. K9 sell_relax_masked_round: the same
// round with per-(row, slot, source column) weights, the form KSP's
// link-ignore re-solves feed it.
//
// Replaces: openr_tpu/ops/spf.py `_sell_relax` (one iteration of its
// while_loop body over all buckets; K9: for bucket k with wg_k of shape
// [nk, dk, S], as `_sell_solver_vw` and `_sell_solver_vw_warm` build it),
// with the transit mask of `_sell_d0_allow` computed in the kernel instead
// of materialised as an [n_pad, S] bool.
//
// Layout: distances are destination-major [n_pad, S] int32 (INF = 1 << 29).
// Bucket k covers rows [row0, row0 + nk); nbr/wg are its [nk, dk] in-neighbour
// ids and weights (INF in slot padding). For every (row r, source column s):
//
//   d_new[r, s] = min(d_old[r, s],
//                     min_j min(dt[nbr[r, j], s] + wg[r, j], INF))
//   dt[u, s]    = d_old[u, s] if (!ov[u] || u == sources[s]) else INF
//
// K1 runs a whole fixpoint as rounds t = 1, 2, ... through the protocol of
// sell_rounds.cuh (one host call enqueues a chunk of rounds and the host
// reads the round state once a chunk). A round is two launches, each over
// every bucket: the first lists the rows that can move, the second relaxes
// only those. Round t reads buffer (t - 1) & 1 and writes buffer t & 1; the
// host's d0 is buffer 0.
//
// K1 skips what cannot change. Let a row be "changed in round t" when one
// of its columns went down in round t; stamps[t & 1][v] = t + 1 records it
// (stamps are int32 [2, n_pad], zeroed by the host, so 0 is "never"; the
// initial state's changes carry stamp 1). After a round that took every
// slot, d_t[r] <= f(d_{t-1}[u]) for every slot (r, u) (f: the transit mask,
// the weight and the clamp), and a slot whose tail did not change in round
// t - 1 offers round t nothing new. So round t gathers only the slots
// whose tail has stamps[(t - 1) & 1][u] == t, and the result is the Jacobi
// round's, entry for entry. Round 1 takes every slot (`full`), unless the
// host has stamped the rows that differ from INF (a cold start: the source
// rows). The two-buffer trap: a row that gathers nothing keeps d_{t-1}, but
// buffer t & 1 holds d_{t-2}; the row is written through when it changed in
// round t - 1, and otherwise the buffer already holds its value. A row is
// written only when it changed or was stamped in round t - 1. The first
// pass lists a row when a tail or the row itself carries stamp t, so a
// round costs a pass over the slots' stamps plus the listed rows' gathers,
// not a pass over the whole matrix.
//
// K9 is K1's two passes with masks (`Masked`): it reads the weight as INF
// where bit s of mask[r, j] (a [nk, dk, W] uint32 bit mask, W = ceil(S /
// 32), built by K8 sell_mask_build) is set: the reference's where-masked
// [nk, dk, S] weights, which are never materialised here. A masked (slot,
// column) contributes min(du + INF, INF) = INF, which never lowers acc
// (every entry is at most INF), so K9 skips it, and skips the gather of a
// slot masked in all of a thread's columns. Each bucket's mask pointer sits
// in the bucket table beside nbr and wg. The stamp skip holds with masks: a
// slot's mask is fixed for the whole fixpoint, so the bound d_t[r, s] <=
// f_s(d_{t-1}[u, s]) after a round that took every slot holds per column
// (f_s INF where masked), and a slot whose tail did not change in round t
// - 1 still offers round t nothing new. K9 runs on the same protocol as
// K1: its state on the card, rounds enqueued a chunk a host call, two
// launches a round for every bucket; a cold masked solve stamps the
// source rows, a warm one (after K8's seed and K5's reset) takes every slot
// in round 1. The active-row pass is K1's, unmasked: a row listed for a
// tail that is masked in every column gathers nothing and is not written.
//
// Bound on the card: device-memory bytes. Each round reads dk gathered rows
// of S int32 per destination row, plus the row itself, and writes it once;
// at S = 128 the [n_pad, S] matrix of a 100k-node graph is 51 MB in its
// real rows, just over the 50 MB L2, so most gathers come from HBM. There
// are 2 integer ops per gathered int32, far below the card's integer rate.
//
// Design against that bound: K1 gives a thread 4 consecutive source columns
// of one row, as 16-byte loads and stores where S is a multiple of 4 and
// the buffers are 16-byte aligned (`Wide`), else as scalar accesses, a
// row's last group holding S % 4 columns; at S = 128 a warp is one row and
// each gather one 512-byte read. (A width off a multiple of 4 used to run
// a column a thread: every thread of a row then repeated the row's slot
// loads and its chain of dependent loads, and on an H100 the round passes
// of K9's KSP batch, S = 19, took longer than with 4 columns a thread.) A
// row's slots are split over
// up to 32 threads (the slot split of sell_rounds.cuh), so the 340-slot
// rows of a Clos spine are no longer one thread's chain of dependent
// loads. Each thread takes its slots 4 at a time: the 4 tails, their
// stamps, their ov bytes and their gathers are issued together, so 4
// gathers are in flight a thread. The sum stays in int32 with no
// overflow: both terms are at most INF = 2^29, their sum at most 2^30.
// K9 reads a slot's mask word once for a thread's 4 columns, which lie in
// one 32-bit word (s0 is a multiple of 4); at the KSP batch of the 50k WAN
// (S = 19, W = 1) that is 4 bytes a slot beside the 4 of its tail. Its
// [n_pad, S] matrix is a few MB and sits in L2, so a masked solve is not
// bound by bytes but by its rounds' passes, each a chain of dependent
// loads over up to every row, and by the host's 64 launches and 4 reads of
// the round state a solve. Measured on an H100 and dropped: skipping the
// slots of weight INF in both passes (slot padding points at row 0, which
// lists every padded row while row 0 changes) gained nothing in the round
// pass and slowed the active pass. The first design launched a kernel a
// bucket a round, a thread per (row, column), and read a changed flag
// after every round (`PERF.md` §6 row 7 keeps its times).

#include "sell_rounds.cuh"

namespace {

using sell::Buckets;
using sell::RoundState;
using sell::kInf;
using sell::kThreads;
using sell::kUnroll;
using sell::Vec;

constexpr int kV = 4;  // columns a thread of the round pass moves

// Round t's first pass: the rows that can move. A row is listed when a
// tail carries stamp t (changed in round t - 1), when it carries stamp t
// itself (the write-through), or, in a round that takes every slot, always.
// A thread per (row, slot part), the parts of a row meeting in a shuffle;
// each warp appends its rows to its bucket's list with one atomic. The
// list of bucket k is list[row0, row0 + counts[k]), in no fixed order.
__global__ void __launch_bounds__(kThreads) sell_relax_active_kernel(
    const int32_t* __restrict__ stamps, const RoundState* __restrict__ st,
    int32_t* __restrict__ list, int32_t* __restrict__ counts,
    const __grid_constant__ Buckets b, int n, int t, int full) {
  if (sell::round_done(st)) return;
  const int32_t* cp = stamps + (long long)((t - 1) & 1) * n;
  const int lane = threadIdx.x & 31;
  int k = 0;
  for (int vb = blockIdx.x; vb < b.blk0[b.nb]; vb += gridDim.x) {
    k = sell::bucket_of(b, vb, k);
    const int dk = b.dk[k], lp = b.lp[k], P = 1 << lp;
    const int item = (vb - b.blk0[k]) * kThreads + threadIdx.x;
    const bool valid = item < (b.nk[k] << lp);
    const int r = valid ? item >> lp : 0;
    const int p = item & (P - 1);
    bool act = valid && (full || (p == 0 && __ldg(cp + b.row0[k] + r) == t));
    const int32_t* nb = b.nbr[k] + (long long)r * dk;
    for (int j0 = valid ? p : dk; j0 < dk && !act; j0 += kUnroll * P) {
      int u[kUnroll];
#pragma unroll
      for (int q = 0; q < kUnroll; ++q) {
        const int j = j0 + q * P;
        u[q] = j < dk ? __ldg(nb + j) : -1;
      }
#pragma unroll
      for (int q = 0; q < kUnroll; ++q)
        act |= u[q] >= 0 && __ldg(cp + u[q]) == t;
    }
    if (P > 1) act = sell::group_or(act, P) != 0;
    act = act && p == 0;
    const unsigned ballot = __ballot_sync(0xffffffffu, act);
    if (!ballot) continue;
    const int leader = __ffs(ballot) - 1;
    int base = 0;
    if (lane == leader) base = atomicAdd(counts + k, __popc(ballot));
    base = __shfl_sync(0xffffffffu, base, leader);
    if (act)
      list[b.row0[k] + base + __popc(ballot & ((1u << lane) - 1))] = r;
  }
}

// Round t's second pass over the listed rows: 4 columns a thread (Wide:
// one 16-byte access each, else scalar accesses and a row's last group of
// S % 4 columns), a row's slots split over P = 2^lp threads (see the
// header comment); with Masked (K9) each slot's weight is INF in the
// columns its mask word names
template <bool Wide, bool Masked>
__global__ void __launch_bounds__(kThreads) sell_relax_round_kernel(
    int32_t* __restrict__ buf0, int32_t* __restrict__ buf1,
    int32_t* __restrict__ stamps, RoundState* __restrict__ st,
    const int32_t* __restrict__ sources, const uint8_t* __restrict__ ov,
    const int32_t* __restrict__ list, int32_t* __restrict__ counts,
    const __grid_constant__ Buckets b, int S, int n, int t, int full) {
  if (sell::round_done(st)) return;
  const int32_t* d_old = (t & 1) ? buf0 : buf1;
  int32_t* d_new = (t & 1) ? buf1 : buf0;
  const int32_t* cp = stamps + (long long)((t - 1) & 1) * n;
  int32_t* cq = stamps + (long long)(t & 1) * n;
  const int G = (S + kV - 1) / kV;
  const int W = (S + 31) >> 5;
  bool changed = false;
  for (int k = 0; k < b.nb; ++k) {
    const int dk = b.dk[k], lp = b.lp[k], P = 1 << lp;
    const long long items = (long long)__ldcg(counts + k) * G << lp;
    for (long long at = (long long)blockIdx.x * kThreads; at < items;
         at += (long long)gridDim.x * kThreads) {
      const long long item = at + threadIdx.x;
      const bool valid = item < items;
      const long long rg = valid ? item >> lp : 0;
      const long long e = rg / G;
      const int r = valid ? __ldcg(list + b.row0[k] + e) : 0;
      const int p = (int)(item & (P - 1));
      const int s0 = (int)(rg - e * G) * kV;
      const int nc = min(kV, S - s0);
      const int v = b.row0[k] + r;
      int src[kV];
      Vec<kV, Wide> acc;
#pragma unroll
      for (int c = 0; c < kV; ++c) {
        src[c] = valid && c < nc ? __ldg(sources + s0 + c) : -1;
        acc.x[c] = kInf;
      }
      sell::pull_slots<kV, false, Masked, Wide>(
          acc, b.nbr[k] + (long long)r * dk, b.wg[k] + (long long)r * dk,
          valid ? dk : 0, p, P, cp, t, full, ov, src, d_old, S, s0,
          Masked ? b.mask[k] + (long long)r * dk * W + (s0 >> 5) : nullptr,
          W, nc);
      if (P > 1) {
#pragma unroll
        for (int c = 0; c < kV; ++c)
          acc.x[c] = sell::group_min(acc.x[c], P);
      }
      if (!valid || p != 0) continue;
      const bool through = !full && __ldg(cp + v) == t;
      if (sell::finish_row<kV, Wide>(acc, d_old, d_new,
                                     (long long)v * S + s0, through, nc)) {
        cq[v] = t + 1;
        changed = true;
      }
    }
  }
  sell::finish_round(st, t, changed, counts, b.nb);
}

template <bool Wide, bool Masked>
int launch_rounds(void* buf0, void* buf1, void* aux, const void* sources,
                  const void* ov, const void* table, const void* masks,
                  int nb, int S, int n, int t0, int count, int full,
                  cudaStream_t stream) {
  // aux: stamps [2, n], list [n], counts [kMaxBuckets], RoundState
  int32_t* stamps = (int32_t*)aux;
  int32_t* list = stamps + 2LL * n;
  int32_t* counts = list + n;
  RoundState* st = (RoundState*)(counts + sell::kMaxBuckets);
  Buckets rows, cols;
  const int blocks_a = sell::fill_buckets(rows, table, nb, 1);
  const int blocks_b =
      sell::fill_buckets(cols, table, nb, (S + kV - 1) / kV, masks);
  if (blocks_a < 0 || blocks_b < 0) return (int)cudaErrorInvalidValue;
  if (blocks_a == 0 || blocks_b == 0) return 0;
  const int grid_a =
      sell::grid_blocks((const void*)sell_relax_active_kernel, blocks_a);
  const int grid_b = sell::grid_blocks(
      (const void*)sell_relax_round_kernel<Wide, Masked>, blocks_b);
  for (int t = t0; t < t0 + count; ++t) {
    const int f = full && t == 1;
    sell_relax_active_kernel<<<grid_a, kThreads, 0, stream>>>(
        stamps, st, list, counts, rows, n, t, f);
    sell_relax_round_kernel<Wide, Masked><<<grid_b, kThreads, 0, stream>>>(
        (int32_t*)buf0, (int32_t*)buf1, stamps, st,
        (const int32_t*)sources, (const uint8_t*)ov, list, counts, cols, S,
        n, t, f);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

int launch(void* buf0, void* buf1, void* aux, const void* sources,
           const void* ov, const void* table, const void* masks, int nb,
           int S, int n, int t0, int count, int full, int vec,
           void* stream) {
  if (S <= 0 || t0 < 1 || count < 0 || (vec && S % 4))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const auto run = vec ? (masks ? launch_rounds<true, true>
                                : launch_rounds<true, false>)
                       : (masks ? launch_rounds<false, true>
                                : launch_rounds<false, false>);
  return run(buf0, buf1, aux, sources, ov, table, masks, nb, S, n, t0, count,
             full, st);
}

}  // namespace

// Launches rounds t0 .. t0 + count - 1, two kernels each (the active rows,
// then the round over them). buf0, buf1: the two [n, S] round buffers
// (buf0 holds d0); aux: int32 stamps [2, n], list [n], counts [64] and the
// 8-word RoundState, zeroed by the host but for stamped rows; table: the
// host bucket rows of sell_rounds.cuh; t0: from 1; full: round 1 takes
// every slot; vec: a thread's 4 columns as one 16-byte access (S % 4 ==
// 0, both buffers 16-byte aligned), else as scalar accesses
extern "C" int sell_relax_rounds(void* buf0, void* buf1, void* aux,
                                 const void* sources, const void* ov,
                                 const void* table, int nb, int S, int n,
                                 int t0, int count, int full, int vec,
                                 void* stream) {
  return launch(buf0, buf1, aux, sources, ov, table, nullptr, nb, S, n, t0,
                count, full, vec, stream);
}

// K9: the same rounds with K8's masks; masks: a host array of nb int64
// device pointers, bucket k's [nk, dk, ceil(S / 32)] uint32 mask words
extern "C" int sell_relax_masked_rounds(void* buf0, void* buf1, void* aux,
                                        const void* sources, const void* ov,
                                        const void* table, const void* masks,
                                        int nb, int S, int n, int t0,
                                        int count, int full, int vec,
                                        void* stream) {
  if (!masks) return (int)cudaErrorInvalidValue;
  return launch(buf0, buf1, aux, sources, ov, table, masks, nb, S, n, t0,
                count, full, vec, stream);
}
