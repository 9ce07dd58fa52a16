// K19 tile_round: one round of the destination-tiled relaxation on one rank,
// up to its frontier.
//
// Replaces: openr_tpu/ops/spf.py `_tile_relax` (the while_loop body before
// the halo exchange: `jnp.where(allow, d, INF)`, the gather
// `dt[:, src_l] + w2` clamped to INF, and `_tile_seg_min`), with the transit
// mask of `_tile_d0_allow` computed in the kernel from `sources`, `ov` and
// the tile's first column, never materialised as an [S_l, n_tile] bool. Two
// optional masks make it serve `_tile_solver_warm` too: with w_new/ov_new
// only the seed edges count (w_new[e] > w2[e], or a tail overloaded in
// ov_new and not in ov), the seed exchange; with marks only the edges whose
// tail is marked in the row, a mark round.
//
// Layout: the rank's tile d is row-major [S, n_tile] int32 (INF = 1 << 29),
// holding columns [offset, offset + n_tile) of the sources' distances. The
// partition's edges are dst-sorted: src_l [e_tile] tile-local tails, w2
// [e_tile] weights, and frontier slot k covers the real edges
// [hptr[k], hptr[k + 1]); the padding edges past hptr[h] and the padding slot
// h - 1 are never walked. For every (row s, slot k):
//
//   ctr[s, k] = min over e in slot k of min(dt[s, src_l[e]] + w2[e], INF)
//   dt[s, u]  = d[s, u] if (!ov[offset + u] || offset + u == sources[s])
//               else INF
//
// and INF for an empty slot (the reference's segment_min gives the int32
// maximum there and clamps it to INF). The sum stays in int32: both terms
// are at most 2^29.
//
// Bound on the card: device-memory bytes. The frontier ctr [S, h] is
// written once, the tile read once (its gathers hit the same rows), the real
// edges' src_l and w2 read once and hptr once. On the 100k-node WAN at
// graph = 4 the frontier has as many slots as the graph has padded nodes
// (h = 131,072): ctr is 64 MiB a rank at S = 128 against a 16 MiB tile, so
// the frontier's write sets the bound, not the edges (about 100,000 real ones
// a partition).
//
// Design against that bound: one thread per (row, slot), consecutive
// threads on consecutive slots of one row, so the ctr writes and the hptr
// reads are coalesced and the edge ranges of neighbouring threads are
// neighbouring stretches of src_l and w2; each thread pulls its slot's edges
// (no atomics) and walks real edges only (the edge-list kernel's lesson:
// threads walking padding edges cost 361.58 ms there).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr int kThreads = 256;

__global__ void tile_round_kernel(
    const int32_t* __restrict__ d, int32_t* __restrict__ ctr,
    const int32_t* __restrict__ sources, const uint8_t* __restrict__ ov,
    const int32_t* __restrict__ src_l, const int32_t* __restrict__ hptr,
    const int32_t* __restrict__ w2, const int32_t* __restrict__ w_new,
    const uint8_t* __restrict__ ov_new, const uint8_t* __restrict__ marks,
    int offset, int S, int n_tile, int h) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)S * h) return;
  const int s = (int)(i / h);
  const int k = (int)(i - (long long)s * h);
  const int src = sources[s];
  const int32_t* row = d + (long long)s * n_tile;
  const uint8_t* mrow = marks ? marks + (long long)s * n_tile : nullptr;
  int acc = kInf;
  const int e1 = hptr[k + 1];
  for (int e = hptr[k]; e < e1; ++e) {
    const int u = src_l[e];
    if (mrow && !mrow[u]) continue;
    const int gu = offset + u;
    if (w_new && !(w_new[e] > w2[e] || (ov_new[gu] && !ov[gu]))) continue;
    const int du = (ov[gu] && gu != src) ? kInf : row[u];
    acc = min(acc, min(du + w2[e], kInf));
  }
  ctr[i] = acc;
}

}  // namespace

// w_new, ov_new and marks may be null (no seed mask, no mark mask)
extern "C" int tile_round(const void* d, void* ctr, const void* sources,
                          const void* ov, const void* src_l, const void* hptr,
                          const void* w2, const void* w_new,
                          const void* ov_new, const void* marks, int offset,
                          int S, int n_tile, int h, void* stream) {
  const long long total = (long long)S * h;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  tile_round_kernel<<<(unsigned)blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (const int32_t*)d, (int32_t*)ctr, (const int32_t*)sources,
      (const uint8_t*)ov, (const int32_t*)src_l, (const int32_t*)hptr,
      (const int32_t*)w2, (const int32_t*)w_new, (const uint8_t*)ov_new,
      (const uint8_t*)marks, offset, S, n_tile, h);
  return (int)cudaGetLastError();
}
