// K11 fw_close: the cold masked blocked Floyd-Warshall close of the dense
// [n, n] distance matrix, in place.
//
// Replaces: openr_tpu/apsp/kernels.py `_fw_solver` (w [N, N] int32 direct
// edges with a 0 diagonal, allow [N, N] bool per-source transit mask ->
// the closed D and a probe scalar), with its tile product `_mp`. The
// wrapper copies w into d first; the host then launches:
//
//   fw_close_diag    once: block (0, 0) closed by in-block sequential FW
//                      for m in block 0: D[i, j] = min(D[i, j],
//                        maskA(D)[i, m] + D[m, j])       (i, j in block 0)
//                    (with one block, n <= 128, this is the whole close)
//   for each stage k = 0 .. nb - 1, C = the closed D[k, k]:
//   fw_close_panels  row panel    D[k, j] = min(D[k, j], maskA(C) (x) D[k, j])
//                    column panel D[i, k] = min(D[i, k], maskA(D[i, k]) (x) C)
//                    for every block j, i != k; the column panel also
//                    written masked and transposed into colm [B, n]
//   fw_close_outer   D[i, j] = min(D[i, j], maskA(D[i, k]) (x) D[k, j])
//                    for every block i, j != k; the block that updates
//                    D[k + 1, k + 1] then closes it in place, as
//                    fw_close_diag closes block (0, 0)
//   fw_close_probe   probe = min over D (the reference's jnp.min(d)), read
//                    by the host so the close's wall time covers the card
//
// maskA masks the LEFT operand's intermediate columns with allow[i, m]
// (!overloaded[m] or m == i). The reference closes the diagonal block by
// log2(B) masked squarings; only the closed matrix is observable, and the
// in-block sequential FW gives the same exact closure (every update is a
// min over real path lengths, and after stage k every pair holds its
// shortest path through blocks 0..k), so the order here is free. Block
// (k + 1, k + 1) takes no update of stage k + 1 other than its close, so
// closing it at the end of stage k is the same sweep. B = 128 (the
// reference's _FW_BLOCK) when nb > 1; with one block, B = n <= 128.
//
// Bound on the card: integer operations. A close does n^3 add-and-min
// steps (nb^2 * B^3 a stage), each one DPX instruction on Hopper
// (__viaddmin_s32 = min(a + b, c), VIADDMNMX): at n = 4,096 that is
// 6.9e10, 4.1 ms at the card's int32 lane rate (16.7e12 a second), against
// 0.05 ms for its 9 * n^2 bytes.
//
// Design against that bound:
// - The outer sweep, (nb - 1)^2 of the nb^2 B^3 steps, is a register-
//   blocked product: a block of 256 threads owns a 128 x 128 tile, 8 x 8
//   entries a thread (rows ty * 4 + {0..3}, 64 + ty * 4 + {0..3}, columns
//   likewise with tx), and walks the 128-deep k block in slabs of 32 that
//   cp.async copies into a two-slab ring, the next slab in flight while the
//   current one is used; a step of the inner loop reads four 16-byte shared
//   words for 64 add-and-mins. The left operand comes pre-masked and
//   transposed from colm, so the outer sweep reads no mask at all: the
//   column panel is masked once a stage, not once a block.
// - No SM waits on a serial diagonal close between stages: block
//   (k + 1, k + 1) is closed by the outer sweep's first block of stage k,
//   from the registers that hold it, while the other blocks of the sweep
//   run. The close keeps its 8 x 8 entries a thread in registers and
//   broadcasts pivot row and column m through two double-buffered shared
//   vectors, one barrier a step (row and column m do not change during
//   step m, since D[m, m] = 0). Only block (0, 0) is closed on its own.
// - The closed C is also written masked and transposed into ct, so a row
//   panel block copies its left operand as it is.
// - A close is 2 nb + 2 launches (2 with one block).

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kInf = 1 << 29;
constexpr int kB = 128;        // block edge when nb > 1
constexpr int kThreads = 256;  // 16 x 16, 8 x 8 entries of a 128 x 128 tile
constexpr int kDepth = 32;     // outer sweep's slab of the k block
constexpr int kStrip = 32;     // a panel block's strip of rows or columns

__device__ __forceinline__ int addmin(int a, int b, int c) {
#if defined(__CUDA_ARCH__) && (__CUDA_ARCH__ >= 900)
  return __viaddmin_s32(a, b, c);
#else
  return min(a + b, c);
#endif
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned s = (unsigned)__cvta_generic_to_shared(smem);
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// row (col) of register i (j) of the 8 x 8 layout, for ty (tx) in 0..15
__device__ __forceinline__ int lane_row(int t, int i) {
  return (i < 4 ? 0 : 64) + t * 4 + (i & 3);
}

struct Pivots {
  int32_t row[2][kB];  // pivot row m, buffer m & 1
  int32_t col[2][kB];  // masked pivot column m
};

// Bit i * 8 + j of the result: allow at entry (i, j) of the 8 x 8 layout
// of the bsz x bsz diagonal block at (r0, r0); entries past bsz are 0.
__device__ __forceinline__ unsigned long long load_allow(
    const uint8_t* __restrict__ allow, long long n, int r0, int bsz) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  unsigned long long bits = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int r = lane_row(ty, i);
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int c = lane_row(tx, j);
      if (r < bsz && c < bsz && allow[(r0 + r) * n + r0 + c])
        bits |= 1ull << (i * 8 + j);
    }
  }
  return bits;
}

// In-block sequential FW of the bsz x bsz block held in acc (the 8 x 8
// layout; entries past bsz are INF and stay out of every pivot). Every
// thread of the block calls it.
__device__ __forceinline__ void close_block(int (&acc)[8][8],
                                            unsigned long long allow_bits,
                                            int bsz, Pivots& pv) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  for (int m = 0; m < bsz; ++m) {
    const int p = m & 1;
    const int owner = (m & 63) >> 2;
    const int sub = (m & 3) + ((m >> 6) << 2);
    if (ty == owner) {
#pragma unroll
      for (int i = 0; i < 8; ++i)
        if (i == sub) {
          *(int4*)&pv.row[p][tx * 4] =
              make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
          *(int4*)&pv.row[p][64 + tx * 4] =
              make_int4(acc[i][4], acc[i][5], acc[i][6], acc[i][7]);
        }
    }
    if (tx == owner) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        if (j == sub) {
          int v[8];
#pragma unroll
          for (int i = 0; i < 8; ++i)
            v[i] = (allow_bits >> (i * 8 + j)) & 1 ? acc[i][j] : kInf;
          *(int4*)&pv.col[p][ty * 4] = make_int4(v[0], v[1], v[2], v[3]);
          *(int4*)&pv.col[p][64 + ty * 4] = make_int4(v[4], v[5], v[6], v[7]);
        }
    }
    __syncthreads();
    const int4 r0 = *(const int4*)&pv.row[p][tx * 4];
    const int4 r1 = *(const int4*)&pv.row[p][64 + tx * 4];
    const int4 c0 = *(const int4*)&pv.col[p][ty * 4];
    const int4 c1 = *(const int4*)&pv.col[p][64 + ty * 4];
    const int rv[8] = {r0.x, r0.y, r0.z, r0.w, r1.x, r1.y, r1.z, r1.w};
    const int cv[8] = {c0.x, c0.y, c0.z, c0.w, c1.x, c1.y, c1.z, c1.w};
#pragma unroll
    for (int i = 0; i < 8; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) acc[i][j] = addmin(cv[i], rv[j], acc[i][j]);
    // the buffers of step m are written again at step m + 2, after the
    // barrier of step m + 1, which every thread passes only once it has
    // read them
  }
  __syncthreads();
}

// The closed 128 x 128 block at (r0, r0) back into d, and masked and
// transposed into ct: ct[m][i] = allow[r0 + i, r0 + m] ? C[i][m] : INF.
__device__ __forceinline__ void store_closed(const int (&acc)[8][8],
                                             unsigned long long allow_bits,
                                             int32_t* __restrict__ d,
                                             int32_t* __restrict__ ct,
                                             long long n, int r0) {
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int32_t* p = d + (r0 + lane_row(ty, i)) * n + r0;
    *(int4*)(p + tx * 4) = make_int4(acc[i][0], acc[i][1], acc[i][2],
                                     acc[i][3]);
    *(int4*)(p + 64 + tx * 4) = make_int4(acc[i][4], acc[i][5], acc[i][6],
                                          acc[i][7]);
  }
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    int v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i)
      v[i] = (allow_bits >> (i * 8 + j)) & 1 ? acc[i][j] : kInf;
    int32_t* p = ct + lane_row(tx, j) * kB;
    *(int4*)(p + ty * 4) = make_int4(v[0], v[1], v[2], v[3]);
    *(int4*)(p + 64 + ty * 4) = make_int4(v[4], v[5], v[6], v[7]);
  }
}

// Block (0, 0), bsz x bsz (bsz <= 128), closed in place; with ct given
// (nb > 1, bsz = 128) its masked transpose goes there too.
__global__ void __launch_bounds__(kThreads) fw_close_diag_kernel(
    int32_t* __restrict__ d, const uint8_t* __restrict__ allow,
    int32_t* __restrict__ ct, int n, int bsz) {
  __shared__ Pivots pv;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;
  int acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = lane_row(ty, i);
      const int c = lane_row(tx, j);
      acc[i][j] = (r < bsz && c < bsz) ? min(d[(long long)r * n + c], kInf)
                                       : kInf;
    }
  const unsigned long long bits = load_allow(allow, n, 0, bsz);
  close_block(acc, bits, bsz, pv);
  if (ct != nullptr) {
    store_closed(acc, bits, d, ct, n, 0);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      const int r = lane_row(ty, i);
      const int c = lane_row(tx, j);
      if (r < bsz && c < bsz) d[(long long)r * n + c] = acc[i][j];
    }
}

// Copies Rows x (Cols4 * 4) int32 from g (row stride ldg) into s (row
// stride lds) with cp.async, 16 bytes a copy; both 16-byte aligned, and
// Rows * Cols4 a multiple of the block's threads.
template <int Rows, int Cols4>
__device__ __forceinline__ void copy_rows(int32_t* s, int lds,
                                          const int32_t* __restrict__ g,
                                          long long ldg) {
  static_assert(Rows * Cols4 % kThreads == 0, "whole passes only");
#pragma unroll
  for (int i = 0; i < Rows * Cols4 / kThreads; ++i) {
    const int e = threadIdx.x + i * kThreads;
    const int r = e / Cols4;
    const int c = (e - r * Cols4) * 4;
    cp_async16(s + r * lds + c, g + r * ldg + c);
  }
}

constexpr int kPanelSmem =
    (kB * kB + kB * (kStrip + 4)) * (int)sizeof(int32_t);

// Stage k's panels, C = D[k, k] closed. blockIdx.x < (nb - 1) * 4: a row
// panel strip (all 128 rows of block row k, 32 columns); the rest: a column
// panel strip (32 rows, all 128 columns of block column k). Panel block
// index skips k. Each block reads its own strip as an operand and writes it
// only after its product; no block writes D[k, k].
__global__ void __launch_bounds__(kThreads) fw_close_panels_kernel(
    int32_t* __restrict__ d, const uint8_t* __restrict__ allow,
    const int32_t* __restrict__ ct, int32_t* __restrict__ colm, int k,
    int n) {
  extern __shared__ __align__(16) int32_t smem[];
  const int nb = n / kB;
  const int per = kB / kStrip;
  const int strips = (nb - 1) * per;
  int x = blockIdx.x;
  const bool row_panel = x < strips;
  if (!row_panel) x -= strips;
  int blk = x / per;
  blk += blk >= k;  // skip the diagonal block
  const int off = blk * kB + (x % per) * kStrip;
  const long long kk = (long long)k * kB;
  const long long ln = n;
  if (row_panel) {
    // D[k rows, strip] = min(., maskA(C) (x) D[k rows, strip])
    int32_t* at = smem;              // [128][128]: maskA(C) transposed
    int32_t* xs = smem + kB * kB;    // [128][32]: the strip
    int32_t* strip = d + kk * ln + off;
    copy_rows<kB, kB / 4>(at, kB, ct, kB);
    copy_rows<kB, kStrip / 4>(xs, kStrip, strip, ln);
    cp_async_commit();
    cp_async_wait<0>();
    __syncthreads();
    const int tx = threadIdx.x & 7;   // columns tx * 4 + {0..3}
    const int ty = threadIdx.x >> 3;  // rows ty * 4 + {0..3}
    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int4 v = *(const int4*)&xs[(ty * 4 + i) * kStrip + tx * 4];
      acc[i][0] = v.x; acc[i][1] = v.y; acc[i][2] = v.z; acc[i][3] = v.w;
    }
#pragma unroll 4
    for (int m = 0; m < kB; ++m) {
      const int4 a = *(const int4*)&at[m * kB + ty * 4];
      const int4 b = *(const int4*)&xs[m * kStrip + tx * 4];
      const int av[4] = {a.x, a.y, a.z, a.w};
      const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = addmin(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *(int4*)(strip + (ty * 4 + i) * ln + tx * 4) =
          make_int4(min(acc[i][0], kInf), min(acc[i][1], kInf),
                    min(acc[i][2], kInf), min(acc[i][3], kInf));
  } else {
    // D[strip, k cols] = min(., maskA(D[strip, k cols]) (x) C), and its
    // masked transpose into colm[:, strip]
    int32_t* cs = smem;            // [128][128]: C
    int32_t* yt = smem + kB * kB;  // [128][36]: maskA(strip) transposed
    constexpr int kYt = kStrip + 4;
    int32_t* strip = d + (long long)off * ln + kk;
    const uint8_t* amask = allow + (long long)off * ln + kk;
    copy_rows<kB, kB / 4>(cs, kB, d + kk * ln + kk, ln);
    cp_async_commit();
#pragma unroll
    for (int i = 0; i < kStrip * kB / kThreads; ++i) {
      const int e = threadIdx.x + i * kThreads;
      const int r = e / kB;
      const int m = e - r * kB;
      const long long g = r * ln + m;
      yt[m * kYt + r] = amask[g] ? min(strip[g], kInf) : kInf;
    }
    const int tx = threadIdx.x & 31;  // columns tx * 4 + {0..3}
    const int ty = threadIdx.x >> 5;  // rows ty * 4 + {0..3}
    int acc[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int4 v = *(const int4*)(strip + (ty * 4 + i) * ln + tx * 4);
      acc[i][0] = min(v.x, kInf); acc[i][1] = min(v.y, kInf);
      acc[i][2] = min(v.z, kInf); acc[i][3] = min(v.w, kInf);
    }
    cp_async_wait<0>();
    __syncthreads();
#pragma unroll 4
    for (int m = 0; m < kB; ++m) {
      const int4 a = *(const int4*)&yt[m * kYt + ty * 4];
      const int4 b = *(const int4*)&cs[m * kB + tx * 4];
      const int av[4] = {a.x, a.y, a.z, a.w};
      const int bv[4] = {b.x, b.y, b.z, b.w};
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = addmin(av[i], bv[j], acc[i][j]);
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
      *(int4*)(strip + (ty * 4 + i) * ln + tx * 4) =
          make_int4(acc[i][0], acc[i][1], acc[i][2], acc[i][3]);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      int v[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        v[i] = amask[(ty * 4 + i) * ln + tx * 4 + j] ? acc[i][j] : kInf;
      *(int4*)(colm + (long long)(tx * 4 + j) * ln + off + ty * 4) =
          make_int4(v[0], v[1], v[2], v[3]);
    }
  }
}

struct OuterSmem {
  int32_t a[2][kDepth][kB];  // colm slab: a[m][i] = maskA(D[i, k])[m]
  int32_t b[2][kDepth][kB];  // row panel slab: b[m][j] = D[k row m, j]
  Pivots pv;
};

// Stage k's outer sweep over the (nb - 1)^2 tiles off block row and column
// k. The grid is rotated so that block 0 takes tile (k + 1, k + 1), which
// it then closes (the next stage's diagonal block).
__global__ void __launch_bounds__(kThreads, 2) fw_close_outer_kernel(
    int32_t* __restrict__ d, const uint8_t* __restrict__ allow,
    int32_t* __restrict__ ct, const int32_t* __restrict__ colm, int k,
    int n) {
  extern __shared__ __align__(16) unsigned char outer_raw[];
  OuterSmem& sm = *reinterpret_cast<OuterSmem*>(outer_raw);
  const int nb = n / kB;
  const int side = nb - 1;
  const int tiles = side * side;
  const bool next_diag = k + 1 < nb;
  const int t = (blockIdx.x + (next_diag ? k * side + k : 0)) % tiles;
  int bi = t / side;
  int bj = t - bi * side;
  bi += bi >= k;
  bj += bj >= k;
  const long long ln = n;
  const int r0 = bi * kB;
  const int c0 = bj * kB;
  const long long kk = (long long)k * kB;
  const int tx = threadIdx.x & 15;
  const int ty = threadIdx.x >> 4;

  // this thread's 16-byte copies of a slab: rows cr + 8 i (i < 4) at
  // columns cc, of both operands
  const int cr = threadIdx.x >> 5;
  const int cc = (threadIdx.x & 31) * 4;
  const int32_t* ga = colm + cr * ln + r0 + cc;
  const int32_t* gb = d + (kk + cr) * ln + c0 + cc;
  auto issue = [&](int s) {
    const int buf = s & 1;
    const long long off = (long long)s * kDepth * ln;
#pragma unroll
    for (int i = 0; i < kDepth / 8; ++i) {
      cp_async16(&sm.a[buf][cr + 8 * i][cc], ga + off + i * 8 * ln);
      cp_async16(&sm.b[buf][cr + 8 * i][cc], gb + off + i * 8 * ln);
    }
    cp_async_commit();
  };
  issue(0);
  int acc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    const int32_t* p = d + (r0 + lane_row(ty, i)) * ln + c0;
    const int4 v0 = *(const int4*)(p + tx * 4);
    const int4 v1 = *(const int4*)(p + 64 + tx * 4);
    acc[i][0] = min(v0.x, kInf); acc[i][1] = min(v0.y, kInf);
    acc[i][2] = min(v0.z, kInf); acc[i][3] = min(v0.w, kInf);
    acc[i][4] = min(v1.x, kInf); acc[i][5] = min(v1.y, kInf);
    acc[i][6] = min(v1.z, kInf); acc[i][7] = min(v1.w, kInf);
  }
  constexpr int kSlabs = kB / kDepth;
#pragma unroll 1
  for (int s = 0; s < kSlabs; ++s) {
    if (s + 1 < kSlabs) {
      issue(s + 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int buf = s & 1;
#pragma unroll 4
    for (int m = 0; m < kDepth; ++m) {
      const int4 a0 = *(const int4*)&sm.a[buf][m][ty * 4];
      const int4 a1 = *(const int4*)&sm.a[buf][m][64 + ty * 4];
      const int4 b0 = *(const int4*)&sm.b[buf][m][tx * 4];
      const int4 b1 = *(const int4*)&sm.b[buf][m][64 + tx * 4];
      const int av[8] = {a0.x, a0.y, a0.z, a0.w, a1.x, a1.y, a1.z, a1.w};
      const int bv[8] = {b0.x, b0.y, b0.z, b0.w, b1.x, b1.y, b1.z, b1.w};
#pragma unroll
      for (int i = 0; i < 8; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) acc[i][j] = addmin(av[i], bv[j], acc[i][j]);
    }
    __syncthreads();  // the slab's buffer is refilled two slabs on
  }
  if (next_diag && bi == k + 1 && bj == k + 1) {
    const unsigned long long bits = load_allow(allow, n, r0, kB);
    close_block(acc, bits, kB, sm.pv);
    store_closed(acc, bits, d, ct, n, r0);
    return;
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    int32_t* p = d + (r0 + lane_row(ty, i)) * ln + c0;
    *(int4*)(p + tx * 4) = make_int4(acc[i][0], acc[i][1], acc[i][2],
                                     acc[i][3]);
    *(int4*)(p + 64 + tx * 4) = make_int4(acc[i][4], acc[i][5], acc[i][6],
                                          acc[i][7]);
  }
}

constexpr int kProbeThreads = 256;

__global__ void fw_close_probe_kernel(const int32_t* __restrict__ d,
                                      int32_t* __restrict__ probe,
                                      long long count) {
  int v = 0x7fffffff;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       i < count; i += (long long)gridDim.x * blockDim.x)
    v = min(v, d[i]);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = min(v, __shfl_xor_sync(0xffffffff, v, o));
  if ((threadIdx.x & 31) == 0) atomicMin(probe, v);
}

}  // namespace

// ct: null with one block (bsz = n <= 128), else the [128, 128] buffer of
// the closed block's masked transpose (bsz = 128)
extern "C" int fw_close_diag(void* d, const void* allow, void* ct, int n,
                             int bsz, void* stream) {
  if (bsz <= 0 || bsz > kB || n % bsz != 0) return (int)cudaErrorInvalidValue;
  if ((ct == nullptr) != (n == bsz) || (ct != nullptr && bsz != kB))
    return (int)cudaErrorInvalidValue;
  fw_close_diag_kernel<<<1, kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)d, (const uint8_t*)allow, (int32_t*)ct, n, bsz);
  return (int)cudaGetLastError();
}

extern "C" int fw_close_panels(void* d, const void* allow, const void* ct,
                               void* colm, int k, int n, void* stream) {
  if (n % kB != 0 || n / kB < 2) return (int)cudaErrorInvalidValue;
  cudaError_t err = cudaFuncSetAttribute(
      fw_close_panels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kPanelSmem);
  if (err != cudaSuccess) return (int)err;
  const int blocks = 2 * (n / kB - 1) * (kB / kStrip);
  fw_close_panels_kernel<<<blocks, kThreads, kPanelSmem,
                           (cudaStream_t)stream>>>(
      (int32_t*)d, (const uint8_t*)allow, (const int32_t*)ct,
      (int32_t*)colm, k, n);
  return (int)cudaGetLastError();
}

extern "C" int fw_close_outer(void* d, const void* allow, void* ct,
                              const void* colm, int k, int n, void* stream) {
  if (n % kB != 0 || n / kB < 2) return (int)cudaErrorInvalidValue;
  const int smem = (int)sizeof(OuterSmem);
  cudaError_t err = cudaFuncSetAttribute(
      fw_close_outer_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (err != cudaSuccess) return (int)err;
  const int side = n / kB - 1;
  fw_close_outer_kernel<<<side * side, kThreads, smem,
                          (cudaStream_t)stream>>>(
      (int32_t*)d, (const uint8_t*)allow, (int32_t*)ct,
      (const int32_t*)colm, k, n);
  return (int)cudaGetLastError();
}

extern "C" int fw_close_probe(const void* d, void* probe, int n,
                              void* stream) {
  const long long count = (long long)n * n;
  long long blocks = (count + kProbeThreads - 1) / kProbeThreads;
  if (blocks > 1056) blocks = 1056;  // 8 blocks per SM, grid-stride beyond
  if (blocks < 1) blocks = 1;
  fw_close_probe_kernel<<<(unsigned)blocks, kProbeThreads, 0,
                          (cudaStream_t)stream>>>((const int32_t*)d,
                                                  (int32_t*)probe, count);
  return (int)cudaGetLastError();
}
