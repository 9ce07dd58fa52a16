// K4 sell_apply_patches: scatter an event's weight patches into one
// resident sliced-ELL weight bucket, in place.
//
// Replaces: openr_tpu/ops/spf.py `_sell_apply_patches` (the per-bucket
// `wg_k.at[rows, slots].set(vals, mode="drop")` that `_sell_solver_patched`
// and `_sell_solver_warm` run before relaxing). The reference returns new
// buffers and donates the old ones; here the bucket is written in place and
// the caller keeps its handle.
//
// For every patch p of bucket k (idx [P, 2] = (row, slot), vals [P]):
//
//   if 0 <= row < nk and 0 <= slot < dk:  wg[row, slot] = vals[p]
//
// and a patch outside the bucket is dropped, as JAX's mode="drop" does: the
// host pads each bucket's fixed-width patch list with rows of 1 << 30. The
// host never sends two patches for one slot, so the writes do not race.
//
// Bound on the card: launch latency. An event moves at most 64 patches a
// bucket (12 bytes each read, 4 written); the bytes take nanoseconds, the
// launch a few microseconds.
//
// Design against that bound: one thread per patch and nothing else, no
// synchronisation and no output beyond the patched slots, so the launch is
// the whole cost; the bucket is never copied.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 64;

__global__ void sell_apply_patches_kernel(int32_t* __restrict__ wg,
                                          const int32_t* __restrict__ idx,
                                          const int32_t* __restrict__ vals,
                                          int P, int nk, int dk) {
  const int p = blockIdx.x * blockDim.x + threadIdx.x;
  if (p >= P) return;
  const int r = idx[2 * p];
  const int j = idx[2 * p + 1];
  if (r < 0 || r >= nk || j < 0 || j >= dk) return;  // mode="drop"
  wg[(long long)r * dk + j] = vals[p];
}

}  // namespace

extern "C" int sell_apply_patches(void* wg, const void* idx, const void* vals,
                                  int P, int nk, int dk, void* stream) {
  if (P == 0) return 0;
  const int blocks = (P + kThreads - 1) / kThreads;
  sell_apply_patches_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
      (int32_t*)wg, (const int32_t*)idx, (const int32_t*)vals, P, nk, dk);
  return (int)cudaGetLastError();
}
