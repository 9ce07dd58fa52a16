// K12 fw_seed: the warm re-close seed of the resident all-pairs matrix.
//
// Replaces: openr_tpu/apsp/kernels.py `_fw_seed_solver` (d_prev [N, N],
// w_new [N, N], the increased pairs inc_u, inc_v, inc_w [p] -> d0 [N, N],
// dirty [nb] bool, num_dirty). One entry point, one launch a seed:
//
//   aff[i]    = exists valid p, j:
//                 min(min(D[i, u_p] + w_old_p, INF) + D[v_p, j], INF)
//                   == D[i, j] < INF
//   d0[i, :]  = min(aff[i] ? INF : D[i, :], w_new[i, :])
//   dirty[b]  = exists row i of block row b (bsz rows): aff[i] or
//               d0[i, :] != D[i, :]
//   num_dirty = the count of dirty blocks
//
// A slot is valid when u_p < n (padding slots carry u = 1 << 30); u_p and
// v_p are clipped into [0, n), as the reference clips them. Row i's old
// shortest-path witness may cross an increased pair exactly when the
// triangle equality holds (over-marking is safe: the re-close rebuilds the
// row). When min(D[i, u] + w_old, INF) is INF the candidate is INF, which
// never equals an entry below INF, so such a pair is skipped for row i. The
// three-term sum stays below 2^31: w_old < INF and each D entry <= INF.
//
// Bound on the card: the bytes, D and w_new read once and d0 written once,
// 12 N^2 (201 MB at N = 4,096, 0.060 ms at 3.35 TB/s); the operations, an
// add, a min and a compare per entry of each pass a row makes (one per
// valid pair whose u it reaches, up to its first hit), stay under them on
// the all-pairs events.
//
// Design (a block of kThreads threads owns one row; measured on the card
// against the first design, a block a row with the row in shared memory
// and a block barrier a pair, and against blocks of 4 rows staged in
// shared memory, which left too little L1 for the pairs' rows):
//   - a thread loads its columns of D[i, :] and w_new[i, :] into registers
//     at once, 16 bytes a load, so D and w_new are read from device memory
//     once and both are in flight together;
//   - the pair table is staged in shared memory 64 slots at a time, with
//     each slot's min(D[i, u_p] + w_old_p, INF) (INF for a padding slot),
//     so a pair the row does not reach costs nothing;
//   - for each pair, a thread loads its columns of D[v_p, :] (the p rows
//     stay in L1 and L2: every block scans the same rows in the same order)
//     and tests them against its registers;
//   - the row stops at its first hit without a block barrier: a warp votes
//     its hits (__any_sync) and posts them to the row's flag in shared
//     memory, which every warp reads before its next pair;
//   - d0 is written from the registers with 16-byte stores;
//   - the block-row OR and the count are the kernel's tail, one atomic a
//     row: it adds 1, and 1 << 16 if the row is dirty, to its block row's
//     word; the row that completes a block row writes dirty[b] and adds to
//     the block rows' word the same way, and the one that completes the
//     last block row writes num_dirty. The nb + 1 words are a scratch the
//     wrapper keeps per card, zeroed once: the kernel leaves them at 0, so
//     seeds on one card must not overlap (the all-pairs state runs them on
//     one stream).
// Where n % 4 != 0 or a matrix is not 16-byte aligned every access is a
// 4-byte one. A thread holds K units (16-byte or 4-byte) of each row, K a
// power of two up to 8 (16 on the 4-byte path), so registers hold rows of
// up to 16,384 columns (8,192 on the 4-byte path); past them the rest of
// the row is read from memory in each pass (L1 and L2). bsz and nb stay
// below 32,768.

#include <cuda_runtime.h>
#include <stdint.h>

#include <type_traits>

namespace {

constexpr int kInf = 1 << 29;
constexpr int kThreads = 512;  // a block, one row
constexpr int kPairs = 64;
// the most units a thread holds in registers
__host__ __device__ constexpr int max_units(bool vec) {
  return vec ? 8 : 16;
}
constexpr unsigned kFull = 0xffffffffu;

__device__ __forceinline__ int4 ld(const int4* p) { return __ldg(p); }
__device__ __forceinline__ int ld(const int* p) { return __ldg(p); }

__device__ __forceinline__ bool on_path(int dij, int a, int dvj) {
  return dij < kInf && min(a + dvj, kInf) == dij;
}

__device__ __forceinline__ bool on_path(int4 x, int a, int4 y) {
  return on_path(x.x, a, y.x) | on_path(x.y, a, y.y) |
         on_path(x.z, a, y.z) | on_path(x.w, a, y.w);
}

__device__ __forceinline__ int fold(bool aff, int x, int w) {
  return min(aff ? kInf : x, w);
}

__device__ __forceinline__ int4 fold(bool aff, int4 x, int4 w) {
  return make_int4(fold(aff, x.x, w.x), fold(aff, x.y, w.y),
                   fold(aff, x.z, w.z), fold(aff, x.w, w.w));
}

__device__ __forceinline__ bool differs(int a, int b) { return a != b; }

__device__ __forceinline__ bool differs(int4 a, int4 b) {
  return (a.x != b.x) | (a.y != b.y) | (a.z != b.z) | (a.w != b.w);
}

// Row i arrives at its block row; called by one thread. scratch: a word a
// block row, then one for the rows: arrivals in the low 16 bits, dirty
// arrivals above them, so one atomic carries both and no fence is needed.
__device__ void arrive_block_row(int i, bool dirty_row, uint8_t* dirty,
                                 int32_t* num_dirty, int32_t* scratch,
                                 int nb, int bsz) {
  const int b = i / bsz;
  const int mine = 1 | (int)dirty_row << 16;
  const int before = atomicAdd(&scratch[b], mine);
  if ((before & 0xffff) + 1 != bsz) return;
  // this row completes block row b
  const bool f = (before >> 16) + dirty_row > 0;
  scratch[b] = 0;
  dirty[b] = f;
  const int row_mine = 1 | (int)f << 16;
  const int done = atomicAdd(&scratch[nb], row_mine);
  if ((done & 0xffff) + 1 == nb) {  // the last block row
    *num_dirty = (done >> 16) + f;
    scratch[nb] = 0;
  }
}

template <int K, bool kVec>
__global__ void __launch_bounds__(kThreads)
fw_seed_kernel(
    const int32_t* __restrict__ d_prev, const int32_t* __restrict__ w_new,
    const int32_t* __restrict__ inc_u, const int32_t* __restrict__ inc_v,
    const int32_t* __restrict__ inc_w, int32_t* __restrict__ d0,
    uint8_t* __restrict__ dirty, int32_t* __restrict__ num_dirty,
    int32_t* __restrict__ scratch, int p, int n, int nb, int bsz) {
  using U = typename std::conditional<kVec, int4, int>::type;
  __shared__ int s_a[kPairs], s_v[kPairs];
  __shared__ volatile int s_hit;
  const int tid = threadIdx.x, lane = tid & 31;
  const int i = blockIdx.x;
  const int units = kVec ? n >> 2 : n;
  const long long base = (long long)i * n;
  const U* drow = reinterpret_cast<const U*>(d_prev + base);
  const U* wrow = reinterpret_cast<const U*>(w_new + base);
  U x[K], w[K];
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = tid + k * kThreads;
    if (c < units) {
      x[k] = ld(drow + c);
      w[k] = ld(wrow + c);
    }
  }
  if (tid == 0) s_hit = 0;
  bool hit = false;  // warp-uniform: the row has a hit
  for (int q0 = 0; q0 < p; q0 += kPairs) {
    const int m = min(kPairs, p - q0);
    __syncthreads();  // s_hit set; the last chunk's table read
    if (tid < m) {
      const int u = inc_u[q0 + tid];
      s_a[tid] = u < n ? min(__ldg(d_prev + base + min(max(u, 0), n - 1)) +
                                 inc_w[q0 + tid], kInf)
                       : kInf;  // a padding slot
      s_v[tid] = min(max(inc_v[q0 + tid], 0), n - 1);
    }
    __syncthreads();
    if (hit) continue;
    for (int q = 0; q < m; ++q) {
      const int a = s_a[q];
      if (a >= kInf) continue;  // the row does not reach u, or padding
      if (__any_sync(kFull, s_hit != 0)) {  // another warp's hit
        hit = true;
        break;
      }
      const U* dv =
          reinterpret_cast<const U*>(d_prev + (long long)s_v[q] * n);
      bool h = false;
#pragma unroll
      for (int k = 0; k < K; ++k) {
        const int c = tid + k * kThreads;
        if (c < units) h |= on_path(x[k], a, ld(dv + c));
      }
      if constexpr (K == max_units(kVec))  // the columns past the registers
        for (int c = tid + K * kThreads; c < units; c += kThreads)
          h |= on_path(ld(drow + c), a, ld(dv + c));
      if (__any_sync(kFull, h)) {
        if (lane == 0) s_hit = 1;
        hit = true;
        break;
      }
    }
  }
  __syncthreads();
  const bool aff = s_hit != 0;
  bool changed = aff;
  U* orow = reinterpret_cast<U*>(d0 + base);
#pragma unroll
  for (int k = 0; k < K; ++k) {
    const int c = tid + k * kThreads;
    if (c < units) {
      const U v = fold(aff, x[k], w[k]);
      orow[c] = v;
      changed |= differs(v, x[k]);
    }
  }
  if constexpr (K == max_units(kVec))
    for (int c = tid + K * kThreads; c < units; c += kThreads) {
      const U xc = ld(drow + c);
      const U v = fold(aff, xc, ld(wrow + c));
      orow[c] = v;
      changed |= differs(v, xc);
    }
  const bool dirty_row = __syncthreads_or(changed);
  if (tid == 0)
    arrive_block_row(i, dirty_row, dirty, num_dirty, scratch, nb, bsz);
}

template <bool kVec>
int launch(int units, const void* d_prev, const void* w_new,
           const void* inc_u, const void* inc_v, const void* inc_w, void* d0,
           void* dirty, void* num_dirty, void* scratch, int p, int n, int nb,
           int bsz, cudaStream_t stream) {
  const int need = (units + kThreads - 1) / kThreads;
  auto kernel = fw_seed_kernel<1, kVec>;
  if (need > 8) {
    kernel = fw_seed_kernel<max_units(kVec), kVec>;
  } else if (need > 4) {
    kernel = fw_seed_kernel<8, kVec>;
  } else if (need > 2) {
    kernel = fw_seed_kernel<4, kVec>;
  } else if (need > 1) {
    kernel = fw_seed_kernel<2, kVec>;
  }
  kernel<<<n, kThreads, 0, stream>>>(
      (const int32_t*)d_prev, (const int32_t*)w_new, (const int32_t*)inc_u,
      (const int32_t*)inc_v, (const int32_t*)inc_w, (int32_t*)d0,
      (uint8_t*)dirty, (int32_t*)num_dirty, (int32_t*)scratch, p, n, nb,
      bsz);
  return (int)cudaGetLastError();
}

}  // namespace

// scratch: nb + 1 int32, all 0, left at 0
extern "C" int fw_seed(const void* d_prev, const void* w_new,
                       const void* inc_u, const void* inc_v,
                       const void* inc_w, void* d0, void* dirty,
                       void* num_dirty, void* scratch, int p, int n, int nb,
                       int bsz, void* stream) {
  if (n < 1 || nb < 1 || bsz < 1 || (long long)nb * bsz != n || p < 0 ||
      nb > 0x7fff || bsz > 0x7fff)
    return (int)cudaErrorInvalidValue;
  const bool vec =
      n % 4 == 0 &&
      ((uintptr_t)d_prev | (uintptr_t)w_new | (uintptr_t)d0) % 16 == 0;
  if (vec)
    return launch<true>(n / 4, d_prev, w_new, inc_u, inc_v, inc_w, d0, dirty,
                        num_dirty, scratch, p, n, nb, bsz,
                        (cudaStream_t)stream);
  return launch<false>(n, d_prev, w_new, inc_u, inc_v, inc_w, d0, dirty,
                       num_dirty, scratch, p, n, nb, bsz,
                       (cudaStream_t)stream);
}
