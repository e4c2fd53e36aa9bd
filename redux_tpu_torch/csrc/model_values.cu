// K1: per-position model values (lo, hi) of every block.
//
// Replaces redux_tpu/ops/pallas_model.py::_model_kernel (body step_bucket,
// launched by _model_lohi_jit).  For block b and position t:
//   lo[b,t] = cdf_t[v], hi[b,t] = cdf_t[v+1]   (v = syms[b,t], before update)
//   then cdf[i] += delta for every i > v while t < lens[b] and t < tfreeze,
//   tfreeze = max(ceil((freq_max - init_total) / delta), 0).
// Positions t >= lens[b] still read the (frozen) row, as the TPU kernel does.
//
// Design: one warp per block, 32 positions at a time: rxt::model_chunk
// (common.cuh, shared with K4), with the active positions of a chunk those
// below upd_end = min(lens, tfreeze, K).  The row lives in shared memory,
// 288 ints a warp (258 live).  The in-chunk counts are 32 steps of one
// broadcast shuffle and two compares; the row update is a histogram, an
// in-lane prefix, a warp scan and 9 adds.  About 8 warp instructions a
// symbol, against about 50 for a position-by-position sweep of a register
// row.  Symbols are read 32 at a time (one 32-byte load a warp, the next
// chunk's in flight) and lo/hi written 32 at a time (128-byte stores).
// What bounds it: instruction issue (16384 warps for 64 MiB); memory
// traffic is 9 bytes a symbol.
#include "common.cuh"

namespace {

constexpr int kWarps = 4;  // blocks per CTA
using rxt::kOwn;
using rxt::kSlots;

__global__ void __launch_bounds__(32 * kWarps)
model_values_kernel(const uint8_t* __restrict__ syms, const int32_t* __restrict__ lens,
                    const int32_t* __restrict__ init_cum, int32_t* __restrict__ lo,
                    int32_t* __restrict__ hi, int B, int K, int delta, int freq_max) {
  __shared__ int rows[kWarps][kSlots];
  __shared__ int hist[kWarps][kSlots];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int blk = blockIdx.x * kWarps + warp;
  if (blk >= B) return;  // uniform over the warp; only __syncwarp below
  int* R = rows[warp];
  int* H = hist[warp];
  const int own = lane * kOwn;  // this lane's entries of the row
#pragma unroll
  for (int m = 0; m < kOwn; ++m) {
    R[own + m] = own + m < rxt::kRow ? init_cum[own + m] : 0;
    H[own + m] = 0;
  }
  __syncwarp();
  const int tfreeze = rxt::freeze_point(init_cum[rxt::kRow - 1], freq_max, delta);
  int upd_end = lens[blk];
  upd_end = upd_end < tfreeze ? upd_end : tfreeze;
  upd_end = upd_end < K ? upd_end : K;  // positions t < upd_end adapt
  const size_t row = static_cast<size_t>(blk) * K;
  int v_next = lane < K ? syms[row + lane] : 0;
  for (int t0 = 0; t0 < K; t0 += 32) {
    const int t = t0 + lane;
    const int v = v_next;
    if (t0 + 32 < K) v_next = t + 32 < K ? syms[row + t + 32] : 0;
    int n_act = upd_end - t0;  // active positions of this chunk: the first n_act
    n_act = n_act < 0 ? 0 : (n_act > 32 ? 32 : n_act);
    const int2 lohi = rxt::model_chunk(R, H, v, n_act, delta, lane);
    if (t < K) {
      lo[row + t] = lohi.x;
      hi[row + t] = lohi.y;
    }
  }
}

}  // namespace

RXT_API int rxt_model_lohi(const void* syms, const void* lens, const void* init_cum,
                           void* lo, void* hi, int B, int K, int delta, int freq_max,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int grid = (B + kWarps - 1) / kWarps;
  model_values_kernel<<<grid, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(syms), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(init_cum), static_cast<int32_t*>(lo),
      static_cast<int32_t*>(hi), B, K, delta, freq_max);
  return cudaGetLastError();
}
