// K13 fw_reclose: one warm re-close round of the resident all-pairs matrix
// over its dirty block rows, in place.
//
// Replaces: openr_tpu/apsp/kernels.py `_fw_reclose_solver` (d [N, N],
// allow [N, N] bool, dirty [nb] bool -> d_new, dirty_new, num_dirty,
// changed_blocks, for a padded dirty-block capacity kb). The host runs the
// entry points in this order, one round:
//
//   fw_reclose_compact    blk[kb] = nonzero(dirty, size=kb, fill_value=nb)
//                         (ascending, on the card), changed[nb] = 0
//   fw_reclose_rows       rule (a), Jacobi: for each compacted dirty block
//                         c, scratch[c] = min(D[k rows, :],
//                         maskA(D[k rows, :]) (x) D), a product over every
//                         intermediate of the PRE-round matrix
//   fw_reclose_rows_apply D[k rows, :] = min(D[k rows, :], scratch[c])
//   fw_reclose_snapshot   rule (b) step c: colm = maskA(D[:, k cols]) and
//   fw_reclose_step       row = D[k rows, :] copied, then D = min(D, colm
//                         (x) row) over every block row; steps in
//                         ascending c, each from its own snapshots
//   fw_reclose_finish     dirty_new = dirty | changed, and the counts
//                         (num_dirty, changed_blocks), on the card
//
// with k = blk[c]; a padding slot (k = nb) does nothing. The block edge is
// the reference's B = min(128, n) whatever the tiling, and the order above
// is the reference's: round counts, dirty sets and changed counts are
// observable (decision.spf.apsp_reclose_rounds_last), so rule (a) reads the
// pre-round matrix through a scratch buffer, and each rule (b) step reads
// snapshots taken at its start; an in-place step that read the block row
// or column it writes could converge in fewer rounds.
//
// "Changed" without a copy of D: every write of a round is a min, so a
// block row's entries after the round differ from those before it exactly
// when some write of the round strictly lowered one of them. The kernels
// store only entries they lower and set changed[block row] when they do,
// which is the reference's any(d_new != d) per block row.
//
// Bound on the card: integer operations. Rule (a) is a [B, N] x [N, N]
// product per dirty block, rule (b) an [N, B] x [B, N] product per dirty
// block: B * N^2 add-and-min steps each (one DPX instruction apiece), 0.13
// ms at N = 4,096, so a round over kd dirty blocks is bound by 2 * kd *
// 0.13 ms. A round with most of the 32 block rows dirty costs about two
// full closes' products, which the reference accepts (its warm path is not
// capped).
//
// Design against that bound: both rules are the tiled (min,+) product of
// fw_minplus.cuh over 64 x 64 output tiles; the dirty block indices stay on
// the card (every launch reads blk[c] itself and returns for a padding
// slot), so the host only needs kb, a power-of-two bucket.

#include "fw_minplus.cuh"

namespace {

using fw::kInf;

constexpr int kTile = 64;
constexpr int kFlat = 256;
constexpr int kMaxBlocks = 1024;

__global__ void fw_reclose_compact_kernel(const uint8_t* __restrict__ dirty,
                                          int32_t* __restrict__ blk,
                                          uint8_t* __restrict__ changed,
                                          int nb, int kb) {
  for (int b = threadIdx.x; b < nb; b += blockDim.x) changed[b] = 0;
  if (threadIdx.x == 0) {
    int c = 0;
    for (int b = 0; b < nb && c < kb; ++b)
      if (dirty[b]) blk[c++] = b;
    for (; c < kb; ++c) blk[c] = nb;  // fill_value = nb
  }
}

__global__ void __launch_bounds__(fw::kThreads) fw_reclose_rows_kernel(
    const int32_t* __restrict__ d, const uint8_t* __restrict__ allow,
    const int32_t* __restrict__ blk, int32_t* __restrict__ scratch, int nb,
    int bsz) {
  __shared__ fw::TileSmem<kTile, kTile> sm;
  const int c = blockIdx.z;
  const int k = blk[c];
  if (k >= nb) return;
  const int n = nb * bsz;
  const int rr = blockIdx.y * kTile;  // row inside the block row
  const int c0 = blockIdx.x * kTile;
  const int m = min(kTile, bsz - rr);
  const int w = min(kTile, n - c0);
  const long long r0 = (long long)k * bsz + rr;
  int acc[kTile / 16][kTile / 16];
  fw::load_tile<kTile, kTile>(acc, d + r0 * n + c0, n, m, w);
  fw::mp_tile<kTile, kTile>(acc, d + r0 * n, n, allow + r0 * n, n, d + c0, n,
                            m, w, n, sm);
  fw::store_tile<kTile, kTile>(
      acc, scratch + ((long long)c * bsz + rr) * n + c0, n, m, w, true);
}

__global__ void fw_reclose_rows_apply_kernel(
    int32_t* __restrict__ d, const int32_t* __restrict__ scratch,
    const int32_t* __restrict__ blk, uint8_t* __restrict__ changed, int kb,
    int nb, int bsz) {
  const long long n = (long long)nb * bsz;
  const long long per = (long long)bsz * n;
  const long long total = per * kb;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    const int c = (int)(e / per);
    const int k = blk[c];
    if (k >= nb) continue;
    const int32_t v = scratch[e];
    int32_t* p = d + (long long)k * per + (e - (long long)c * per);
    if (v < *p) {
      *p = v;
      changed[k] = 1;
    }
  }
}

__global__ void fw_reclose_snapshot_kernel(
    const int32_t* __restrict__ d, const uint8_t* __restrict__ allow,
    const int32_t* __restrict__ blk, int32_t* __restrict__ colm,
    int32_t* __restrict__ rowk, int c, int nb, int bsz) {
  const int k = blk[c];
  if (k >= nb) return;
  const long long n = (long long)nb * bsz;
  const long long kk = (long long)k * bsz;
  const long long total = n * bsz;
  for (long long e = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       e < total; e += (long long)gridDim.x * blockDim.x) {
    // colm[i, m] (row-major [n, bsz]) and rowk[m, j] (row-major [bsz, n])
    const long long i = e / bsz;
    const long long m = e - i * bsz;
    const long long src = i * n + kk + m;
    colm[e] = allow[src] ? d[src] : kInf;
    rowk[e] = d[kk * n + e];
  }
}

__global__ void __launch_bounds__(fw::kThreads) fw_reclose_step_kernel(
    int32_t* __restrict__ d, const int32_t* __restrict__ colm,
    const int32_t* __restrict__ rowk, const int32_t* __restrict__ blk,
    uint8_t* __restrict__ changed, int c, int nb, int bsz) {
  __shared__ fw::TileSmem<kTile, kTile> sm;
  const int k = blk[c];
  if (k >= nb) return;
  const int n = nb * bsz;
  const int r0 = blockIdx.y * kTile;
  const int c0 = blockIdx.x * kTile;
  const int m = min(kTile, n - r0);
  const int w = min(kTile, n - c0);
  int acc[kTile / 16][kTile / 16];
  int32_t* out = d + (long long)r0 * n + c0;
  fw::load_tile<kTile, kTile>(acc, out, n, m, w);
  fw::mp_tile<kTile, kTile>(acc, colm + (long long)r0 * bsz, bsz, nullptr, 0,
                            rowk + c0, n, m, w, bsz, sm);
  const bool lowered = fw::store_tile<kTile, kTile>(acc, out, n, m, w, false);
  // a 64-row tile lies inside one block row: B = 128 when nb > 1
  if (__syncthreads_or(lowered) && threadIdx.x == 0) changed[r0 / bsz] = 1;
}

__global__ void __launch_bounds__(kMaxBlocks) fw_reclose_finish_kernel(
    const uint8_t* __restrict__ dirty, const uint8_t* __restrict__ changed,
    uint8_t* __restrict__ dirty_new, int32_t* __restrict__ counts, int nb) {
  const int b = threadIdx.x;
  bool dn = false;
  bool ch = false;
  if (b < nb) {
    ch = changed[b] != 0;
    dn = dirty[b] != 0 || ch;
    dirty_new[b] = dn;
  }
  const int nd = __syncthreads_count(dn);
  const int nc = __syncthreads_count(ch);
  if (b == 0) {
    counts[0] = nd;  // num_dirty
    counts[1] = nc;  // changed_blocks
  }
}

unsigned flat_blocks(long long total) {
  long long b = (total + kFlat - 1) / kFlat;
  if (b > 4096) b = 4096;  // grid-stride beyond
  return (unsigned)(b < 1 ? 1 : b);
}

}  // namespace

extern "C" int fw_reclose_compact(const void* dirty, void* blk, void* changed,
                                  int nb, int kb, void* stream) {
  if (nb < 1 || nb > kMaxBlocks) return (int)cudaErrorInvalidValue;
  fw_reclose_compact_kernel<<<1, 256, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)dirty, (int32_t*)blk, (uint8_t*)changed, nb, kb);
  return (int)cudaGetLastError();
}

extern "C" int fw_reclose_rows(const void* d, const void* allow,
                               const void* blk, void* scratch, int kb, int nb,
                               int bsz, void* stream) {
  if (kb == 0) return 0;
  const int n = nb * bsz;
  const dim3 grid((n + kTile - 1) / kTile, (bsz + kTile - 1) / kTile, kb);
  fw_reclose_rows_kernel<<<grid, fw::kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)d, (const uint8_t*)allow, (const int32_t*)blk,
      (int32_t*)scratch, nb, bsz);
  return (int)cudaGetLastError();
}

extern "C" int fw_reclose_rows_apply(void* d, const void* scratch,
                                     const void* blk, void* changed, int kb,
                                     int nb, int bsz, void* stream) {
  if (kb == 0) return 0;
  const long long total = (long long)kb * bsz * nb * bsz;
  fw_reclose_rows_apply_kernel<<<flat_blocks(total), kFlat, 0,
                                 (cudaStream_t)stream>>>(
      (int32_t*)d, (const int32_t*)scratch, (const int32_t*)blk,
      (uint8_t*)changed, kb, nb, bsz);
  return (int)cudaGetLastError();
}

extern "C" int fw_reclose_snapshot(const void* d, const void* allow,
                                   const void* blk, void* colm, void* rowk,
                                   int c, int nb, int bsz, void* stream) {
  const long long total = (long long)nb * bsz * bsz;
  fw_reclose_snapshot_kernel<<<flat_blocks(total), kFlat, 0,
                               (cudaStream_t)stream>>>(
      (const int32_t*)d, (const uint8_t*)allow, (const int32_t*)blk,
      (int32_t*)colm, (int32_t*)rowk, c, nb, bsz);
  return (int)cudaGetLastError();
}

extern "C" int fw_reclose_step(void* d, const void* colm, const void* rowk,
                               const void* blk, void* changed, int c, int nb,
                               int bsz, void* stream) {
  const int n = nb * bsz;
  const int g = (n + kTile - 1) / kTile;
  const dim3 grid(g, g);
  fw_reclose_step_kernel<<<grid, fw::kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)d, (const int32_t*)colm, (const int32_t*)rowk,
      (const int32_t*)blk, (uint8_t*)changed, c, nb, bsz);
  return (int)cudaGetLastError();
}

extern "C" int fw_reclose_finish(const void* dirty, const void* changed,
                                 void* dirty_new, void* counts, int nb,
                                 void* stream) {
  if (nb < 1 || nb > kMaxBlocks) return (int)cudaErrorInvalidValue;
  fw_reclose_finish_kernel<<<1, kMaxBlocks, 0, (cudaStream_t)stream>>>(
      (const uint8_t*)dirty, (const uint8_t*)changed, (uint8_t*)dirty_new,
      (int32_t*)counts, nb);
  return (int)cudaGetLastError();
}
