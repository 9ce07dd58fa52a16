// K7 delta_extract: the changed destination columns of a warm solve and
// their O(changes) copy-back.
//
// Replaces: openr_tpu/ops/spf.py `_delta_extract` and the `col_changed` /
// `num_changed` outputs of `_sell_solver_warm` and `_bf_warm_core`. Three
// entry points over the row-major [S, n] int32 distance matrices:
//
//   columns  col_changed[t] = any_s d[s, t] != dp[s, t], and *count += the
//            number of changed columns (the host reads that 4-byte count
//            to size the extraction)
//   compact  cols[0 .. cap) = the changed columns in ASCENDING order,
//            padded with n, exactly `jnp.nonzero(col_changed, size=cap,
//            fill_value=n)` (an atomic-counter compaction would give
//            another order)
//   gather   dcols[s, c] = d[s, clip(cols[c], 0, n - 1)] and
//            nh[l, c] = nh_ws[l] + dcols[nh_rows[l], c] == dcols[0, c]
//            (the reference's formula: unclamped, no reachability term,
//            int32 wrap-around; the host applies the overloaded-neighbour
//            rule as the reference's _finish_delta does). The caller checks
//            nh_rows against [0, S); the kernel clamps them into it, so a
//            bad row cannot read outside d.
//
// Bound on the card: device-memory bytes. `columns` reads both matrices
// once (2 x 4 x S x n bytes: 134 MB on the 100k-node WAN at S = 128); the
// compaction reads n flag bytes and `gather` moves O(cap x (S + L)) words.
// None of the three needs the host between them: the wrapper launches all
// three without reading anything back.
//
// Design against that bound:
//   columns  a block owns 32 x V consecutive columns (V = 4 when the rows
//            are 16-byte aligned, else 1) and its 8 warps split the S rows;
//            a lane loads V columns of d and of dp with one vector load
//            each, four rows at a time, so 8 independent loads are in
//            flight a thread. A lane stops once all its V columns differ.
//            The warps OR their column masks in shared memory; one atomic
//            a block adds the block's count.
//   compact  a single-pass, order-keeping stream compaction over the whole
//            card (the decoupled look-back of Merrill and Garland, as CUB's
//            DeviceSelect): a block takes the next tile of 4,096 flags by a
//            ticket (tiles start in order, so a block only ever waits on a
//            running one), each thread loads 16 flags with one 16-byte
//            load, the block scans its counts in shared memory, publishes
//            its aggregate, and warp 0 looks back over 32 predecessors'
//            status words at a time until it finds an inclusive prefix.
//            A status word holds its flag and its value together, so one
//            64-bit relaxed store publishes both. The status array and the
//            ticket are zeroed on the stream for each call (a memset in the
//            entry point, not a PyTorch fill: the stage is host-bound). The
//            last tile writes the fill.
//   gather   one thread per output word.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kRowGroups = kThreads / 32;  // columns: warps over the rows
constexpr int kFlagsPerThread = 16;        // compact: one 16-byte load
constexpr int kTile = kThreads * kFlagsPerThread;
constexpr unsigned long long kAggregate = 1ull << 32;
constexpr unsigned long long kInclusive = 2ull << 32;

template <int V>
struct Vec;
template <>
struct Vec<4> {
  using T = int4;
  __device__ static unsigned differ(T a, T b) {
    return (unsigned)(a.x != b.x) | (unsigned)(a.y != b.y) << 1 |
           (unsigned)(a.z != b.z) << 2 | (unsigned)(a.w != b.w) << 3;
  }
};
template <>
struct Vec<1> {
  using T = int32_t;
  __device__ static unsigned differ(T a, T b) { return a != b; }
};

template <int V>
__global__ void __launch_bounds__(kThreads)
    delta_columns_kernel(const int32_t* __restrict__ d,
                         const int32_t* __restrict__ dp,
                         uint8_t* __restrict__ col_changed,
                         int32_t* __restrict__ count, int S, int n) {
  using T = typename Vec<V>::T;
  constexpr int kCols = 32 * V;
  constexpr unsigned kAll = (1u << V) - 1;
  __shared__ unsigned lane_mask[32];
  const int lane = threadIdx.x & 31;
  const int grp = threadIdx.x >> 5;
  if (threadIdx.x < 32) lane_mask[threadIdx.x] = 0;
  __syncthreads();
  const long long c0 = (long long)blockIdx.x * kCols + (long long)lane * V;
  unsigned m = 0;
  if (c0 < n) {
    const T* a = reinterpret_cast<const T*>(d + c0);
    const T* b = reinterpret_cast<const T*>(dp + c0);
    const long long row = (long long)n / V;  // one row, in vectors
    int s = grp;
    for (; s + 3 * kRowGroups < S && m != kAll; s += 4 * kRowGroups) {
      T x[4], y[4];
#pragma unroll
      for (int u = 0; u < 4; ++u) {
        const long long i = (long long)(s + u * kRowGroups) * row;
        x[u] = __ldg(a + i);
        y[u] = __ldg(b + i);
      }
#pragma unroll
      for (int u = 0; u < 4; ++u) m |= Vec<V>::differ(x[u], y[u]);
    }
    for (; s < S && m != kAll; s += kRowGroups) {
      const long long i = (long long)s * row;
      m |= Vec<V>::differ(__ldg(a + i), __ldg(b + i));
    }
  }
  if (m) atomicOr(&lane_mask[lane], m);
  __syncthreads();
  const long long t = (long long)blockIdx.x * kCols + threadIdx.x;
  uint8_t c = 0;
  if (threadIdx.x < kCols && t < n) {
    c = (lane_mask[threadIdx.x / V] >> (threadIdx.x % V)) & 1;
    col_changed[t] = c;
  }
  const int changed = __syncthreads_count(c);
  if (threadIdx.x == 0 && changed) atomicAdd(count, changed);
}

__device__ __forceinline__ unsigned long long load_status(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v)
               : "l"(p)
               : "memory");
  return v;
}

__device__ __forceinline__ void store_status(unsigned long long* p,
                                             unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(v)
               : "memory");
}

// bit k set where byte k of w is not 0 (k = 0 .. 3)
__device__ __forceinline__ unsigned byte_bits(unsigned w) {
  return (unsigned)((w & 0xffu) != 0) | (unsigned)((w & 0xff00u) != 0) << 1 |
         (unsigned)((w & 0xff0000u) != 0) << 2 |
         (unsigned)((w & 0xff000000u) != 0) << 3;
}

__global__ void __launch_bounds__(kThreads)
    delta_compact_kernel(const uint8_t* __restrict__ flags,
                         int32_t* __restrict__ cols,
                         unsigned long long* __restrict__ status,
                         unsigned* __restrict__ ticket, int n, int cap,
                         int tiles) {
  __shared__ int tile_s, prefix_s;
  __shared__ int warp_total[kThreads / 32];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  if (threadIdx.x == 0) tile_s = (int)atomicAdd(ticket, 1u);
  __syncthreads();
  const int tile = tile_s;
  const long long base =
      (long long)tile * kTile + (long long)threadIdx.x * kFlagsPerThread;
  unsigned bits = 0;  // bit k: flag base + k is set
  if (base + kFlagsPerThread <= n &&
      (reinterpret_cast<uintptr_t>(flags + base) & 15) == 0) {
    const uint4 v = *reinterpret_cast<const uint4*>(flags + base);
    bits = byte_bits(v.x) | byte_bits(v.y) << 4 | byte_bits(v.z) << 8 |
           byte_bits(v.w) << 12;
  } else {
    for (int k = 0; k < kFlagsPerThread && base + k < n; ++k)
      bits |= (unsigned)(flags[base + k] != 0) << k;
  }
  const int cnt = __popc(bits);
  int incl = cnt;  // inclusive scan over the warp
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const int y = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += y;
  }
  if (lane == 31) warp_total[warp] = incl;
  __syncthreads();
  int before = 0, total = 0;  // this warp's offset, the tile's count
#pragma unroll
  for (int w = 0; w < kThreads / 32; ++w) {
    before += w < warp ? warp_total[w] : 0;
    total += warp_total[w];
  }
  if (warp == 0) {
    int prefix = 0;
    if (tile == 0) {
      if (lane == 0) store_status(status, kInclusive | (unsigned)total);
    } else {
      if (lane == 0) store_status(status + tile, kAggregate | (unsigned)total);
      for (int end = tile - 1;; end -= 32) {
        const int p = end - lane;  // lane 0 is the nearest predecessor
        unsigned long long st = kInclusive;  // before tile 0: prefix 0
        if (p >= 0) {
          do {
            st = load_status(status + p);
          } while ((st >> 32) == 0);
        }
        const unsigned found =
            __ballot_sync(0xffffffffu, (st >> 32) == (kInclusive >> 32));
        const int stop = found ? __ffs(found) - 1 : 31;
        int v = lane <= stop ? (int)(unsigned)st : 0;
#pragma unroll
        for (int off = 16; off > 0; off >>= 1)
          v += __shfl_xor_sync(0xffffffffu, v, off);
        prefix += v;
        if (found) break;
      }
      if (lane == 0)
        store_status(status + tile, kInclusive | (unsigned)(prefix + total));
    }
    if (lane == 0) prefix_s = prefix;
  }
  __syncthreads();
  int pos = prefix_s + before + incl - cnt;
  while (bits && pos < cap) {
    const int k = __ffs(bits) - 1;
    cols[pos++] = (int32_t)(base + k);
    bits &= bits - 1;
  }
  if (tile == tiles - 1) {
    for (int c = prefix_s + total + threadIdx.x; c < cap; c += kThreads)
      cols[c] = n;  // fill_value
  }
}

__global__ void delta_gather_kernel(
    const int32_t* __restrict__ d, const int32_t* __restrict__ cols,
    const int32_t* __restrict__ nh_rows, const int32_t* __restrict__ nh_ws,
    int32_t* __restrict__ dcols, uint8_t* __restrict__ nh, int S, int n,
    int cap, int L) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= (long long)(S + L) * cap) return;
  const int row = (int)(i / cap);
  const int c = (int)(i - (long long)row * cap);
  const int col = min(max(cols[c], 0), n - 1);
  if (row < S) {
    dcols[i] = d[(long long)row * n + col];
    return;
  }
  const int l = row - S;
  const int r = min(max(nh_rows[l], 0), S - 1);
  const unsigned sum =
      (unsigned)nh_ws[l] + (unsigned)d[(long long)r * n + col];
  nh[(long long)l * cap + c] = (uint8_t)((int)sum == d[col]);
}

bool aligned16(const void* p) {
  return (reinterpret_cast<uintptr_t>(p) & 15) == 0;
}

}  // namespace

// count: zeroed here, on the stream, before the kernel adds to it
extern "C" int delta_columns(const void* d, const void* dp, void* col_changed,
                             void* count, int S, int n, void* stream) {
  if (n == 0) return 0;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t rc = cudaMemsetAsync(count, 0, sizeof(int32_t), st);
  if (rc != cudaSuccess) return (int)rc;
  if (n % 4 == 0 && aligned16(d) && aligned16(dp)) {
    const int blocks = (n + 127) / 128;
    delta_columns_kernel<4><<<blocks, kThreads, 0, st>>>(
        (const int32_t*)d, (const int32_t*)dp, (uint8_t*)col_changed,
        (int32_t*)count, S, n);
  } else {
    const int blocks = (n + 31) / 32;
    delta_columns_kernel<1><<<blocks, kThreads, 0, st>>>(
        (const int32_t*)d, (const int32_t*)dp, (uint8_t*)col_changed,
        (int32_t*)count, S, n);
  }
  return (int)cudaGetLastError();
}

// status: `tiles` 8-byte words, then the ticket (tiles = ceil(n / 4096),
// which the wrapper also computes to size the array); zeroed here, on the
// stream, for each call
extern "C" int delta_compact(const void* flags, void* cols, void* status,
                             int n, int cap, int tiles, void* stream) {
  if (cap == 0 || n == 0) return 0;
  if (tiles != (n + kTile - 1) / kTile) return (int)cudaErrorInvalidValue;
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t rc =
      cudaMemsetAsync(status, 0, sizeof(unsigned long long) * (tiles + 1), st);
  if (rc != cudaSuccess) return (int)rc;
  delta_compact_kernel<<<tiles, kThreads, 0, st>>>(
      (const uint8_t*)flags, (int32_t*)cols, (unsigned long long*)status,
      (unsigned*)((unsigned long long*)status + tiles), n, cap, tiles);
  return (int)cudaGetLastError();
}

extern "C" int delta_gather(const void* d, const void* cols,
                            const void* nh_rows, const void* nh_ws,
                            void* dcols, void* nh, int S, int n, int cap,
                            int L, void* stream) {
  const long long total = (long long)(S + L) * cap;
  if (total == 0) return 0;
  const long long blocks = (total + kThreads - 1) / kThreads;
  delta_gather_kernel<<<(unsigned)blocks, kThreads, 0,
                        (cudaStream_t)stream>>>(
      (const int32_t*)d, (const int32_t*)cols, (const int32_t*)nh_rows,
      (const int32_t*)nh_ws, (int32_t*)dcols, (uint8_t*)nh, S, n, cap, L);
  return (int)cudaGetLastError();
}
