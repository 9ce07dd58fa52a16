// K5 sell_mark: Ramalingam-Reps invalidation on the sliced-ELL layout.
//
// Replaces: openr_tpu/ops/spf.py `_sell_invalidate` (seeding) and
// `_sell_mark_fixpoint` (the bool mark fixpoint), plus the reset of
// `_sell_solver_warm` (d0 = where(marks, INF, dp), sources re-pinned).
//
// The marks live on the card as bits, node-major: word w of row v, bit b
// is the mark of source column s = 32 w + b (W = ceil(S / 32) int32 words a
// row). A fixpoint works in one int32 buffer, zeroed by the host:
//
//   M [n, W]      the marks so far
//   N [2, n, W]   the bits a row newly marked in a round, by round parity
//   F [2, n]      the round a row last newly marked bits, by parity, as
//                 round + 1 (0: never; the seed's round is 0)
//   RoundState    8 words, the protocol of sell_rounds.cuh
//
// Entry points:
//
//   seed   one thread per (bucket k, patch p, source s), one launch for
//          every bucket. Like the reference, valid = row < 1 << 29, then
//          row and slot are CLIPPED into the bucket (not dropped, unlike
//          K4), and the entry (s, v) marks when
//            valid && dp[s, v] < INF
//                  && min(dp[s, u] + w_old, INF) == dp[s, v]
//          with u = nbr[row, slot], w_old = wg[row, slot] (the weights
//          BEFORE the event: this entry must run before K4 patches them),
//          v = row0 + row. Round 0 of the protocol: done when nothing
//          marked.
//   pack   round 0 from marks already made (K8's seed on KSP's path): bool
//          [S, n] row-major into M and N[0], F[0] where a row has a bit.
//   round  round t >= 1 over every bucket, a row's slots split over up to
//          32 threads (the slot split of sell_rounds.cuh):
//            m_t[s, v] = m_{t-1}[s, v]
//                | any_j (m_{t-1}[s, u_j] && dp[s, v] < INF
//                         && min(dp[s, u_j] + wg[r, j], INF) == dp[s, v])
//          The condition on the slot does not change between rounds, so an
//          entry unmarked after round t - 1 can mark in round t only
//          through a tail that newly marked in round t - 1 (a tail marked
//          earlier would have marked it already). A row reads the stamps
//          F[(t - 1) & 1] of its dk tails; a row none of whose tails has
//          stamp t gathers nothing and writes nothing, and the others test
//          only the bits N[(t - 1) & 1][u] & ~M[v]. The round count equals
//          the reference's Jacobi rounds (decision.spf.invalidation_
//          rounds_last is observable). Only row v's thread reads or writes
//          M[v] in a round, so M is updated in place.
//   reset  d0[v, s] = (v == sources[s]) ? 0 : bit(M[v], s) ? INF : dp[s, v]:
//          reads the row-major resident D and writes the destination-major
//          matrix K1 relaxes, so the transpose rides the same pass.
//
// Layout: dp is row-major [S, n] (the solver's resident D). INF = 1 << 29;
// sums stay below 2^30.
//
// Bound on the card: device-memory bytes, most of them the reset's (D read
// once, d0 written once). A round reads each row's dk tail stamps, and the
// tails' new bits and two distances only where a tail newly marked, which
// an event keeps to the entries whose old shortest path crossed an
// increased edge.
//
// Design against that bound: the first design read a mark byte per (slot,
// source) every round, whether near the event or not (n x S x dk byte
// gathers a round), launched once a bucket a round and read a flag on the
// host after each round. Here a round reads n x dk 4-byte stamps from a
// 2 x n array that stays in L2, one launch covers every bucket, a round
// with nothing left returns at once, and one host call enqueues a chunk of
// rounds, whose round state the host reads once. Reset is a 32 x 32 tiled
// transpose through shared memory, so both its reads and its writes are
// coalesced.

#include "sell_rounds.cuh"

namespace {

using sell::Buckets;
using sell::RoundState;
using sell::kInf;
using sell::kThreads;
using sell::MarkBuf;
using sell::mark_buf;

constexpr int kTile = 32;
constexpr int kTileRows = 8;

__global__ void sell_mark_seed_kernel(const int32_t* __restrict__ dp,
                                      void* buf,
                                      const int32_t* __restrict__ inc,
                                      const __grid_constant__ Buckets b,
                                      int P, int S, int n, int W) {
  const MarkBuf mb = mark_buf(buf, n, W);
  const int k = blockIdx.y;
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  const int nk = b.nk[k], dk = b.dk[k];
  bool marked = false;
  if (i < (long long)P * S && nk > 0 && dk > 0) {
    const int p = (int)(i / S);
    const int s = (int)(i - (long long)p * S);
    const long long e = (long long)k * P + p;
    const int rows = inc[2 * e];
    if (rows < (1 << 29)) {  // padding rows carry 1 << 30
      const int r = min(max(rows, 0), nk - 1);
      const int j = min(max(inc[2 * e + 1], 0), dk - 1);
      const int u = b.nbr[k][(long long)r * dk + j];
      const int w = b.wg[k][(long long)r * dk + j];
      const int v = b.row0[k] + r;
      const long long base = (long long)s * n;
      const int dv = dp[base + v];
      if (dv < kInf && min(dp[base + u] + w, kInf) == dv) {
        const long long word = (long long)v * W + (s >> 5);
        const uint32_t bit = 1u << (s & 31);
        atomicOr(mb.m + word, bit);
        atomicOr(mb.nw + word, bit);
        mb.f[v] = 1;
        marked = true;
      }
    }
  }
  sell::finish_round(mb.st, 0, marked);
}

__global__ void sell_mark_pack_kernel(const uint8_t* __restrict__ marks,
                                      void* buf, int S, int n, int W) {
  const MarkBuf mb = mark_buf(buf, n, W);
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  bool marked = false;
  if (i < (long long)n * W) {
    const int v = (int)(i / W);
    const int w = (int)(i - (long long)v * W);
    uint32_t bits = 0;
    for (int b = 0; b < 32; ++b) {
      const int s = 32 * w + b;
      if (s < S && marks[(long long)s * n + v]) bits |= 1u << b;
    }
    mb.m[i] = bits;
    mb.nw[i] = bits;
    if (bits) {
      mb.f[v] = 1;
      marked = true;
    }
  }
  sell::finish_round(mb.st, 0, marked);
}

__global__ void __launch_bounds__(kThreads) sell_mark_round_kernel(
    const int32_t* __restrict__ dp, void* buf,
    const __grid_constant__ Buckets b, int n, int W, int t) {
  const MarkBuf mb = mark_buf(buf, n, W);
  if (sell::round_done(mb.st)) return;
  const long long nw = (long long)n * W;
  const uint32_t* np = mb.nw + ((t - 1) & 1) * nw;
  uint32_t* nq = mb.nw + (t & 1) * nw;
  const int32_t* fp = mb.f + (long long)((t - 1) & 1) * n;
  int32_t* fq = mb.f + (long long)(t & 1) * n;
  bool changed = false;
  int k = 0;
  for (int vb = blockIdx.x; vb < b.blk0[b.nb]; vb += gridDim.x) {
    k = sell::bucket_of(b, vb, k);
    const int dk = b.dk[k], lp = b.lp[k], P = 1 << lp;
    const int item = (vb - b.blk0[k]) * kThreads + threadIdx.x;
    const bool valid = item < (b.nk[k] << lp);
    const int r = valid ? item >> lp : 0;
    const int p = item & (P - 1);
    const int32_t* nb = b.nbr[k] + (long long)r * dk;
    // this thread's slots are j = p + i P, i < 32 (the slot split leaves a
    // thread at most 32); bit i of `front` when slot j's tail newly marked
    // bits in round t - 1
    uint32_t front = 0;
    for (int j0 = valid ? p : dk, i0 = 0; j0 < dk; j0 += 4 * P, i0 += 4) {
      int u[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int j = j0 + q * P;
        u[q] = j < dk ? __ldg(nb + j) : -1;
      }
#pragma unroll
      for (int q = 0; q < 4; ++q)
        if (u[q] >= 0 && __ldg(fp + u[q]) == t) front |= 1u << (i0 + q);
    }
    const bool visit = P > 1 ? sell::group_or(front, P) != 0 : front != 0;
    if (!__any_sync(0xffffffffu, visit)) continue;
    const int32_t* wr = b.wg[k] + (long long)r * dk;
    const int v = b.row0[k] + r;
    bool grew = false;
    for (int w0 = 0; w0 < W; w0 += 4) {
      uint32_t m[4], add[4];
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const bool in = visit && w0 + q < W;
        m[q] = in ? mb.m[(long long)v * W + w0 + q] : 0;
        add[q] = 0;
      }
      for (uint32_t f = front; f; f &= f - 1) {
        const int j = p + (__ffs(f) - 1) * P;
        const int u = __ldg(nb + j);
        const int wj = __ldg(wr + j);
        uint32_t cand[4];
#pragma unroll
        for (int q = 0; q < 4; ++q)
          cand[q] = w0 + q < W
                        ? __ldg(np + (long long)u * W + w0 + q) & ~m[q]
                        : 0;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          uint32_t c = cand[q] & ~add[q];
          while (c) {  // 4 candidate columns at a time
            int bit[4], dv[4], du[4];
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              bit[e] = c ? __ffs(c) - 1 : -1;
              c &= c - 1;
            }
#pragma unroll
            for (int e = 0; e < 4; ++e) {
              if (bit[e] < 0) continue;
              const long long base = (long long)(32 * (w0 + q) + bit[e]) * n;
              dv[e] = __ldg(dp + base + v);
              du[e] = __ldg(dp + base + u);
            }
#pragma unroll
            for (int e = 0; e < 4; ++e)
              if (bit[e] >= 0 && dv[e] < kInf &&
                  min(du[e] + wj, kInf) == dv[e])
                add[q] |= 1u << bit[e];
          }
        }
      }
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (P > 1) add[q] = sell::group_or(add[q], P);
        if (visit && p == 0 && w0 + q < W) {
          const long long word = (long long)v * W + w0 + q;
          nq[word] = add[q];
          if (add[q]) {
            mb.m[word] = m[q] | add[q];
            grew = true;
          }
        }
      }
    }
    if (grew) {
      fq[v] = t + 1;
      changed = true;
    }
  }
  sell::finish_round(mb.st, t, changed);
}

__global__ void sell_mark_reset_kernel(const int32_t* __restrict__ dp,
                                       const uint32_t* __restrict__ marks,
                                       const int32_t* __restrict__ sources,
                                       int32_t* __restrict__ d0, int S,
                                       int n, int W) {
  __shared__ int32_t tile[kTile][kTile + 1];
  const int v0 = blockIdx.x * kTile;
  const int s0 = blockIdx.y * kTile;
  for (int k = threadIdx.y; k < kTile; k += kTileRows) {
    const int s = s0 + k;
    const int v = v0 + threadIdx.x;
    if (s < S && v < n) {
      const bool m = (marks[(long long)v * W + (s >> 5)] >> (s & 31)) & 1u;
      tile[k][threadIdx.x] =
          (v == sources[s]) ? 0 : (m ? kInf : dp[(long long)s * n + v]);
    }
  }
  __syncthreads();
  for (int k = threadIdx.y; k < kTile; k += kTileRows) {
    const int v = v0 + k;
    const int s = s0 + threadIdx.x;
    if (s < S && v < n) d0[(long long)v * S + s] = tile[threadIdx.x][k];
  }
}

}  // namespace

// buf: the zeroed fixpoint buffer (3 n W + 2 n + 8 int32 words); inc: int32
// [nb, P, 2] (row, slot) of the increased edges; table: the host bucket
// rows of sell_rounds.cuh (the OLD weights)
extern "C" int sell_mark_seed(const void* dp, void* buf, const void* inc,
                              const void* table, int nb, int P, int S, int n,
                              int W, void* stream) {
  Buckets b;
  if (sell::fill_buckets(b, table, nb, 1) < 0 || nb == 0 || P <= 0 ||
      S <= 0 || W != (S + 31) / 32)
    return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)P * S + kThreads - 1) / kThreads;
  const dim3 grid((unsigned)blocks, nb);
  sell_mark_seed_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)dp, buf, (const int32_t*)inc, b, P, S, n, W);
  return (int)cudaGetLastError();
}

// marks: bool [S, n] row-major
extern "C" int sell_mark_pack(const void* marks, void* buf, int S, int n,
                              int W, void* stream) {
  if (S <= 0 || n <= 0 || W != (S + 31) / 32)
    return (int)cudaErrorInvalidValue;
  const long long blocks = ((long long)n * W + kThreads - 1) / kThreads;
  sell_mark_pack_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const uint8_t*)marks, buf, S, n, W);
  return (int)cudaGetLastError();
}

// Launches rounds t0 .. t0 + count - 1, one kernel each; t0 from 1
extern "C" int sell_mark_rounds(const void* dp, void* buf, const void* table,
                                int nb, int S, int n, int W, int t0,
                                int count, void* stream) {
  Buckets b;
  const int blocks = sell::fill_buckets(b, table, nb, 1);
  if (blocks < 0 || S <= 0 || t0 < 1 || count < 0 || W != (S + 31) / 32)
    return (int)cudaErrorInvalidValue;
  if (blocks == 0) return 0;
  const int grid =
      sell::grid_blocks((const void*)sell_mark_round_kernel, blocks);
  for (int t = t0; t < t0 + count; ++t) {
    sell_mark_round_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
        (const int32_t*)dp, buf, b, n, W, t);
    const cudaError_t e = cudaGetLastError();
    if (e != cudaSuccess) return (int)e;
  }
  return 0;
}

// marks: the M words [n, W] of a fixpoint buffer
extern "C" int sell_mark_reset(const void* dp, const void* marks,
                               const void* sources, void* d0, int S, int n,
                               int W, void* stream) {
  if (S == 0 || n == 0) return 0;
  const dim3 grid((n + kTile - 1) / kTile, (S + kTile - 1) / kTile);
  const dim3 block(kTile, kTileRows);
  sell_mark_reset_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)dp, (const uint32_t*)marks, (const int32_t*)sources,
      (int32_t*)d0, S, n, W);
  return (int)cudaGetLastError();
}
