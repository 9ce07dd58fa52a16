// K1 sell_relax_round: one Jacobi round of the sliced-ELL pull min-plus
// relaxation over one degree bucket. K9 sell_relax_masked_round: the same
// round with per-(row, slot, source column) weights, the form KSP's
// link-ignore re-solves feed it.
//
// Replaces: openr_tpu/ops/spf.py `_sell_relax` (one iteration of its
// while_loop body for bucket k; K9: with wg_k of shape [nk, dk, S], as
// `_sell_solver_vw` and `_sell_solver_vw_warm` build it), with the transit
// mask of `_sell_d0_allow` computed in the kernel instead of materialised as
// an [n_pad, S] bool.
//
// Layout: distances are destination-major [n_pad, S] int32 (INF = 1 << 29).
// Bucket k covers rows [row0, row0 + nk); nbr/wg are its [nk, dk] in-neighbour
// ids and weights (INF in slot padding). For every (row r, source column s):
//
//   d_new[r, s] = min(d_old[r, s],
//                     min_j min(dt[nbr[r, j], s] + wg[r, j], INF))
//   dt[u, s]    = d_old[u, s] if (!ov[u] || u == sources[s]) else INF
//
// and `*changed` is set to 1 when any entry went down. K9 reads the weight
// as INF where bit s of mask[r, j] (a [nk, dk, W] uint32 bit mask, W =
// ceil(S / 32), built by K8 sell_mask_build) is set: the reference's
// where-masked [nk, dk, S] weights, which are never materialised here. A
// masked slot contributes min(du + INF, INF) = INF, which never lowers acc
// (every entry is at most INF), so K9 skips its gather. Rounds are Jacobi:
// every round reads the previous round's matrix (d_old) and writes a second
// buffer (d_new), so the round count equals the reference's.
//
// Bound on the card: device-memory bytes. Each round reads dk gathered rows
// of S int32 per destination row, plus the row itself, and writes it once;
// at S = 128 the [n_pad, S] matrix of a 100k-node graph is 64 MB, larger than
// the 50 MB L2, so most gathers come from HBM. There are 2 integer ops per
// gathered int32, far below the card's integer rate.
//
// Design against that bound: consecutive threads take consecutive source
// columns s of one destination row, so each gather d_old[nbr[r, j], :] is one
// contiguous S * 4-byte read (512 bytes at S = 128) shared by the threads of
// that row, and the nbr/wg entries are warp-uniform broadcast loads. Nothing
// of size [nk, dk, S] is materialised. The sum stays in int32 with no
// overflow: both terms are at most INF = 2^29, their sum at most 2^30. K9
// adds one mask word per slot, shared by the 32 source columns it covers
// (a warp-uniform load when S >= 32). At S = 1, as a per-prefix KSP call
// has it, a warp covers 32 rows and each gather is a scattered 4-byte read.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr int kThreads = 256;

template <bool kMasked>
__global__ void sell_relax_round_kernel(
    const int32_t* __restrict__ d_old, int32_t* __restrict__ d_new,
    int32_t* __restrict__ changed, const int32_t* __restrict__ sources,
    const uint8_t* __restrict__ ov, const int32_t* __restrict__ nbr,
    const int32_t* __restrict__ wg, const uint32_t* __restrict__ mask,
    int row0, int nk, int dk, int S, int W) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)nk * S) return;
  const int r = (int)(i / S);
  const int s = (int)(i - (long long)r * S);
  const int src = sources[s];
  const long long out = (long long)(row0 + r) * S + s;
  const int old = d_old[out];
  int acc = old;
  const int32_t* nb = nbr + (long long)r * dk;
  const int32_t* w = wg + (long long)r * dk;
  const uint32_t* mw = kMasked ? mask + (long long)r * dk * W + (s >> 5)
                               : nullptr;
  const uint32_t bit = 1u << (s & 31);
  for (int j = 0; j < dk; ++j) {
    if (kMasked && (mw[(long long)j * W] & bit)) continue;
    const int u = nb[j];
    const int du = (ov[u] && u != src) ? kInf : d_old[(long long)u * S + s];
    const int c = min(du + w[j], kInf);
    acc = min(acc, c);
  }
  d_new[out] = acc;
  if (acc != old) *changed = 1;
}

template <bool kMasked>
int launch(const void* d_old, void* d_new, void* changed, const void* sources,
           const void* ov, const void* nbr, const void* wg, const void* mask,
           int row0, int nk, int dk, int S, int W, void* stream) {
  const long long total = (long long)nk * S;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  sell_relax_round_kernel<kMasked><<<(unsigned)blocks, kThreads, 0,
                                     (cudaStream_t)stream>>>(
      (const int32_t*)d_old, (int32_t*)d_new, (int32_t*)changed,
      (const int32_t*)sources, (const uint8_t*)ov, (const int32_t*)nbr,
      (const int32_t*)wg, (const uint32_t*)mask, row0, nk, dk, S, W);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int sell_relax_round(const void* d_old, void* d_new, void* changed,
                                const void* sources, const void* ov,
                                const void* nbr, const void* wg, int row0,
                                int nk, int dk, int S, void* stream) {
  return launch<false>(d_old, d_new, changed, sources, ov, nbr, wg, nullptr,
                       row0, nk, dk, S, 0, stream);
}

// mask: [nk, dk, W] uint32 bit mask of bucket k, W = ceil(S / 32)
extern "C" int sell_relax_masked_round(const void* d_old, void* d_new,
                                       void* changed, const void* sources,
                                       const void* ov, const void* nbr,
                                       const void* wg, const void* mask,
                                       int row0, int nk, int dk, int S, int W,
                                       void* stream) {
  return launch<true>(d_old, d_new, changed, sources, ov, nbr, wg, mask, row0,
                      nk, dk, S, W, stream);
}
