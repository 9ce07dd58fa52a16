// K19 tile_round: one round of the destination-tiled relaxation on one rank,
// up to its frontier.
//
// Replaces: openr_tpu/ops/spf.py `_tile_relax` (the while_loop body before
// the halo exchange: `jnp.where(allow, d, INF)`, the gather
// `dt[:, src_l] + w2` clamped to INF, and `_tile_seg_min`), with the transit
// mask of `_tile_d0_allow` computed on the card from `sources`, `ov` and
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
// written once, the tile read once, the real edges' src_l and w2 read once
// and hptr once. On the 100k-node WAN at graph = 4 the frontier has as many
// slots as the graph has padded nodes (h = 131,072): ctr is 64 MiB a rank
// at S = 128 against a 16 MiB tile, so the frontier's write sets the bound,
// not the edges (about 100,000 real ones a partition).
//
// Design against that bound, two launches a call:
// - tile_round_nodes writes a node-major copy of the tile, nodes [n_tile,
//   ldt] (ldt = S rounded up to 32), with both per-row masks applied on
//   the way (transit through an overloaded node that is not the row's
//   source, and an unmarked tail, give INF): a tail's 128 rows are then
//   512 contiguous bytes, where in the row-major tile each row's value was
//   a 32-byte sector of its own. The copy is 16 MiB written and read back,
//   mostly from L2, against the 64 MiB frontier.
// - tile_round_slots: a block owns 64 frontier slots and up to 128 rows
//   (4 a lane). It stages the slots' hptr in shared memory and splits their
//   real edges evenly over its 8 warps, so a hub slot's edges spread over
//   several warps and an empty slot costs no walk. A warp reads 32 edges'
//   src_l and w2 at once (and the seed mask, per edge), passes them lane to
//   lane, and for each edge reads the tail's rows as four coalesced
//   128-byte loads and takes 4 add-and-mins (DPX, __viaddmin_s32); at a
//   slot boundary it folds its minima into the block's [64, 129] shared
//   frontier with shared atomicMin (two warps may share a slot). The
//   frontier then goes out row by row, 16-byte stores where h and ctr's
//   alignment allow, scalar stores elsewhere. The frontier's stores and the
//   tile's reads are marked streaming (evict first), so that the 64 MiB
//   going out does not push the node-major copy out of L2 while its rows
//   are gathered.
// - Each edge and each hptr entry is read once a block, whatever the rows.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 128;  // rows a block: 4 a lane
constexpr int kSlots = 64;  // frontier slots a block
constexpr int kCols = 32;   // tile columns a block of the node-major copy

__device__ __forceinline__ int addmin(int a, int b, int c) {
#if defined(__CUDA_ARCH__) && (__CUDA_ARCH__ >= 900)
  return __viaddmin_s32(a, b, c);
#else
  return min(a + b, c);
#endif
}

// nodes[u][s] = the row's masked d[s][u] (INF for s >= S); a block copies
// 32 tile columns of up to 128 rows through shared memory
__global__ void __launch_bounds__(kThreads) tile_round_nodes_kernel(
    const int32_t* __restrict__ d, int32_t* __restrict__ nodes,
    const int32_t* __restrict__ sources, const uint8_t* __restrict__ ov,
    const uint8_t* __restrict__ marks, int offset, int S, int n_tile,
    int ldt) {
  __shared__ int32_t t[kRows][kCols + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int u0 = blockIdx.x * kCols;
  const int s0 = blockIdx.y * kRows;
  const int u = u0 + lane;
  const bool col = u < n_tile;
  const bool ov_u = col && ov[offset + u];
#pragma unroll
  for (int i = 0; i < kRows / kWarps; ++i) {
    const int r = warp + i * kWarps;
    const int s = s0 + r;
    int v = kInf;
    if (col && s < S) {
      const long long i = (long long)s * n_tile + u;
      v = min(__ldcs(d + i), kInf);  // read once: kept out of L2's way
      if ((ov_u && offset + u != sources[s]) || (marks && !marks[i]))
        v = kInf;
    }
    t[r][lane] = v;
  }
  __syncthreads();
  const int rows = min(kRows, ldt - s0);
  for (int c = warp; c < kCols; c += kWarps) {
    const int uu = u0 + c;
    if (uu >= n_tile) break;
    int32_t* out = nodes + (long long)uu * ldt + s0;
    for (int r = lane; r < rows; r += 32) out[r] = t[r][c];
  }
}

__global__ void __launch_bounds__(kThreads) tile_round_slots_kernel(
    const int32_t* __restrict__ nodes, int ldt, int32_t* __restrict__ ctr,
    const uint8_t* __restrict__ ov, const int32_t* __restrict__ src_l,
    const int32_t* __restrict__ hptr, const int32_t* __restrict__ w2,
    const int32_t* __restrict__ w_new, const uint8_t* __restrict__ ov_new,
    int offset, int S, int h, int vec) {
  __shared__ int32_t res[kSlots][kRows + 1];
  __shared__ int32_t hp[kSlots + 1];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int k0 = blockIdx.x * kSlots;
  const int ns = min(kSlots, h - k0);
  const int s0 = blockIdx.y * kRows;
  const int groups = min(4, (ldt - s0) / 32);  // lane rows that exist
  for (int i = threadIdx.x; i < kSlots * (kRows + 1); i += kThreads)
    (&res[0][0])[i] = kInf;
  for (int i = threadIdx.x; i <= ns; i += kThreads) hp[i] = hptr[k0 + i];
  __syncthreads();

  // this warp's stretch of the block's real edges
  const int e0 = hp[0];
  const int per = (hp[ns] - e0 + kWarps - 1) / kWarps;
  const int a = e0 + warp * per;
  const int b = min(hp[ns], a + per);
  int slot = 0;
  int acc[4] = {kInf, kInf, kInf, kInf};
  const int32_t* col = nodes + s0 + lane;
  for (int base = a; base < b; base += 32) {
    const int e = base + lane;
    int u = 0;
    int w = kInf;
    if (e < b) {
      u = src_l[e];
      w = w2[e];
      if (w_new != nullptr) {
        const int gu = offset + u;
        if (!(w_new[e] > w || (ov_new[gu] && !ov[gu]))) w = kInf;
      }
    }
    const int count = min(32, b - base);
    for (int j = 0; j < count; ++j) {
      const int uj = __shfl_sync(0xffffffffu, u, j);
      const int wj = __shfl_sync(0xffffffffu, w, j);
      if (base + j >= hp[slot + 1]) {  // the warp leaves its slot
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          if (acc[r] < kInf) atomicMin(&res[slot][r * 32 + lane], acc[r]);
          acc[r] = kInf;
        }
        while (base + j >= hp[slot + 1]) ++slot;
      }
      if (wj >= kInf) continue;  // a seed mask's other edge or a down link
      const int32_t* p = col + (long long)uj * ldt;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        if (r < groups) acc[r] = addmin(__ldg(p + r * 32), wj, acc[r]);
    }
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (acc[r] < kInf) atomicMin(&res[slot][r * 32 + lane], acc[r]);
  __syncthreads();

  const int rows = min(kRows, S - s0);
  if (vec) {  // h % 4 == 0 and ctr 16-byte aligned: ns % 4 == 0
    const int chunks = ns / 4;
    for (int i = threadIdx.x; i < rows * (kSlots / 4); i += kThreads) {
      const int r = i / (kSlots / 4);
      const int c = i - r * (kSlots / 4);
      if (c >= chunks) continue;
      __stcs((int4*)(ctr + (long long)(s0 + r) * h + k0 + c * 4),
             make_int4(res[c * 4][r], res[c * 4 + 1][r], res[c * 4 + 2][r],
                       res[c * 4 + 3][r]));
    }
  } else {
    for (int i = threadIdx.x; i < rows * kSlots; i += kThreads) {
      const int r = i / kSlots;
      const int k = i - r * kSlots;
      if (k < ns)
        __stcs(ctr + (long long)(s0 + r) * h + k0 + k, res[k][r]);
    }
  }
}

}  // namespace

// nodes: the [n_tile, ldt] int32 buffer of the node-major copy, ldt = S
// rounded up to 32. w_new, ov_new and marks may be null (no seed mask, no
// mark mask). Two launches.
extern "C" int tile_round(const void* d, void* ctr, const void* sources,
                          const void* ov, const void* src_l, const void* hptr,
                          const void* w2, const void* w_new,
                          const void* ov_new, const void* marks, void* nodes,
                          int offset, int S, int n_tile, int h,
                          void* stream) {
  if (S <= 0 || h <= 0) return (int)cudaErrorInvalidValue;
  const int ldt = (S + 31) / 32 * 32;
  const int groups = (S + kRows - 1) / kRows;
  const cudaStream_t st = (cudaStream_t)stream;
  const dim3 copy_grid(n_tile > 0 ? (n_tile + kCols - 1) / kCols : 1,
                       groups);
  tile_round_nodes_kernel<<<copy_grid, kThreads, 0, st>>>(
      (const int32_t*)d, (int32_t*)nodes, (const int32_t*)sources,
      (const uint8_t*)ov, (const uint8_t*)marks, offset, S, n_tile, ldt);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const int vec = (h % 4 == 0) && (((uintptr_t)ctr & 15) == 0);
  const dim3 grid((h + kSlots - 1) / kSlots, groups);
  tile_round_slots_kernel<<<grid, kThreads, 0, st>>>(
      (const int32_t*)nodes, ldt, (int32_t*)ctr, (const uint8_t*)ov,
      (const int32_t*)src_l, (const int32_t*)hptr, (const int32_t*)w2,
      (const int32_t*)w_new, (const uint8_t*)ov_new, offset, S, h, vec);
  return (int)cudaGetLastError();
}
