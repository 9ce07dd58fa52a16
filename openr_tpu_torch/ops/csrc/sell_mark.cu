// K5 sell_mark: Ramalingam-Reps invalidation on the sliced-ELL layout.
//
// Replaces: openr_tpu/ops/spf.py `_sell_invalidate` (seeding) and
// `_sell_mark_fixpoint` (the bool mark fixpoint), plus the reset of
// `_sell_solver_warm` (d0 = where(marks, INF, dp), sources re-pinned).
// Three entry points:
//
//   seed   one thread per (patch p, source s) of bucket k. Like the
//          reference, valid = row < 1 << 29, then row and slot are CLIPPED
//          into the bucket (not dropped, unlike K4), and
//            marks[s, v] |= valid && dp[s, v] < INF
//                           && min(dp[s, u] + w_old, INF) == dp[s, v]
//          with u = nbr[row, slot], w_old = wg[row, slot] (the weights
//          BEFORE the event: this entry must run before K4 patches them),
//          v = row0 + row. `*any` is set when a mark is set.
//   round  one Jacobi round over bucket k, one thread per (row, source):
//            m_new[s, v] = m_old[s, v]
//                | any_j (m_old[s, u_j] && dp[s, v] < INF
//                         && min(dp[s, u_j] + wg[r, j], INF) == dp[s, v])
//          reading the previous round's marks only, so the round count
//          equals the reference's (decision.spf.invalidation_rounds_last
//          is observable; an in-place round would finish in fewer).
//          `*changed` is set when an entry newly marks.
//   reset  d0[v, s] = (v == sources[s]) ? 0 : marks[s, v] ? INF : dp[s, v]:
//          reads the row-major resident D and writes the destination-major
//          matrix K1 relaxes, so the transpose rides the same pass.
//
// Layout: dp and marks are row-major [S, n] (the solver's resident D);
// marks are one byte each. INF = 1 << 29; sums stay below 2^30.
//
// Bound on the card: device-memory bytes. A round reads each entry's mark
// (1 byte) and, per slot, one gathered mark; distances are read only where
// a gathered mark is set, which an event keeps to the few entries whose old
// shortest path crossed an increased edge. The [S, n] marks (2 MB a
// thousand nodes at S = 128) stay in the 50 MB L2 at the WAN's size.
//
// Design against that bound: consecutive threads take consecutive rows of
// one source row (blockIdx.y = s), so the own-mark read and the write are
// coalesced; an entry already marked gathers nothing, an unmarked entry
// reads dp only after it finds a marked in-neighbour, and stops at the
// first hit. Reset is a 32 x 32 tiled transpose through shared memory, so
// both its reads and its writes are coalesced.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr int kThreads = 256;
constexpr int kTile = 32;
constexpr int kTileRows = 8;

__global__ void sell_mark_seed_kernel(
    const int32_t* __restrict__ dp, uint8_t* __restrict__ marks,
    int32_t* __restrict__ any, const int32_t* __restrict__ nbr,
    const int32_t* __restrict__ wg, const int32_t* __restrict__ inc, int P,
    int row0, int nk, int dk, int S, int n) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)P * S) return;
  const int p = (int)(i / S);
  const int s = (int)(i - (long long)p * S);
  const int rows = inc[2 * p];
  if (!(rows < (1 << 29))) return;  // padding rows carry 1 << 30
  const int r = min(max(rows, 0), nk - 1);
  const int j = min(max(inc[2 * p + 1], 0), dk - 1);
  const int u = nbr[(long long)r * dk + j];
  const int w = wg[(long long)r * dk + j];
  const int v = row0 + r;
  const long long base = (long long)s * n;
  const int dv = dp[base + v];
  if (dv < kInf && min(dp[base + u] + w, kInf) == dv) {
    marks[base + v] = 1;
    *any = 1;
  }
}

__global__ void sell_mark_round_kernel(
    const int32_t* __restrict__ dp, const uint8_t* __restrict__ m_old,
    uint8_t* __restrict__ m_new, int32_t* __restrict__ changed,
    const int32_t* __restrict__ nbr, const int32_t* __restrict__ wg,
    int row0, int nk, int dk, int n) {
  const int r = blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= nk) return;
  const long long base = (long long)blockIdx.y * n;
  const int v = row0 + r;
  uint8_t m = m_old[base + v];
  if (!m) {
    const int32_t* nb = nbr + (long long)r * dk;
    const int32_t* w = wg + (long long)r * dk;
    bool have_dv = false;
    int dv = 0;
    for (int j = 0; j < dk; ++j) {
      const int u = nb[j];
      if (!m_old[base + u]) continue;
      if (!have_dv) {
        dv = dp[base + v];
        have_dv = true;
        if (dv >= kInf) break;  // unreachable entries never mark
      }
      if (min(dp[base + u] + w[j], kInf) == dv) {
        m = 1;
        *changed = 1;
        break;
      }
    }
  }
  m_new[base + v] = m;
}

__global__ void sell_mark_reset_kernel(const int32_t* __restrict__ dp,
                                       const uint8_t* __restrict__ marks,
                                       const int32_t* __restrict__ sources,
                                       int32_t* __restrict__ d0, int S,
                                       int n) {
  __shared__ int32_t tile[kTile][kTile + 1];
  const int v0 = blockIdx.x * kTile;
  const int s0 = blockIdx.y * kTile;
  for (int k = threadIdx.y; k < kTile; k += kTileRows) {
    const int s = s0 + k;
    const int v = v0 + threadIdx.x;
    if (s < S && v < n) {
      const long long i = (long long)s * n + v;
      tile[k][threadIdx.x] =
          (v == sources[s]) ? 0 : (marks[i] ? kInf : dp[i]);
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

extern "C" int sell_mark_seed(const void* dp, void* marks, void* any,
                              const void* nbr, const void* wg, const void* inc,
                              int P, int row0, int nk, int dk, int S, int n,
                              void* stream) {
  const long long total = (long long)P * S;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  sell_mark_seed_kernel<<<(unsigned)blocks, kThreads, 0,
                          (cudaStream_t)stream>>>(
      (const int32_t*)dp, (uint8_t*)marks, (int32_t*)any,
      (const int32_t*)nbr, (const int32_t*)wg, (const int32_t*)inc, P, row0,
      nk, dk, S, n);
  return (int)cudaGetLastError();
}

extern "C" int sell_mark_round(const void* dp, const void* m_old, void* m_new,
                               void* changed, const void* nbr, const void* wg,
                               int row0, int nk, int dk, int S, int n,
                               void* stream) {
  if (nk == 0 || S == 0) return 0;
  const dim3 grid((nk + kThreads - 1) / kThreads, S);
  sell_mark_round_kernel<<<grid, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)dp, (const uint8_t*)m_old, (uint8_t*)m_new,
      (int32_t*)changed, (const int32_t*)nbr, (const int32_t*)wg, row0, nk,
      dk, n);
  return (int)cudaGetLastError();
}

extern "C" int sell_mark_reset(const void* dp, const void* marks,
                               const void* sources, void* d0, int S, int n,
                               void* stream) {
  if (S == 0 || n == 0) return 0;
  const dim3 grid((n + kTile - 1) / kTile, (S + kTile - 1) / kTile);
  const dim3 block(kTile, kTileRows);
  sell_mark_reset_kernel<<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)dp, (const uint8_t*)marks, (const int32_t*)sources,
      (int32_t*)d0, S, n);
  return (int)cudaGetLastError();
}
