// K1: per-position model values (lo, hi) of every block.
//
// Replaces redux_tpu/ops/pallas_model.py::_model_kernel (body step_bucket,
// launched by _model_lohi_jit).  For block b and position t:
//   lo[b,t] = cdf_t[v], hi[b,t] = cdf_t[v+1]   (v = syms[b,t], before update)
//   then cdf[i] += delta for every i > v while t < lens[b] and t < tfreeze,
//   tfreeze = max(ceil((freq_max - init_total) / delta), 0).
// Positions t >= lens[b] still read the (frozen) row, as the TPU kernel does.
//
// Design: one warp per block.  The row sits in the warp's registers (9
// entries a lane, common.cuh); lo/hi are two register selects plus a
// shuffle, and the suffix update is 9 predicated adds a lane, with no
// shared memory and no barrier.  One thread per block with a 1 KB row would
// be right as well but does a 258-step serial update per symbol.
// Symbols are read 32 positions at a time (one coalesced 32-byte load a
// warp) and lo/hi written 32 at a time (128-byte stores).
// What bounds it: the serial dependence of position t+1's row on position
// t's update — about 30 dependent instructions a symbol per warp; memory
// traffic is 9 bytes a symbol.  Enough warps in flight (one per block,
// 16384 for 64 MiB) hide that latency.
#include "common.cuh"

namespace {

__global__ void model_values_kernel(const uint8_t* __restrict__ syms,
                                    const int32_t* __restrict__ lens,
                                    const int32_t* __restrict__ init_cum,
                                    int32_t* __restrict__ lo, int32_t* __restrict__ hi,
                                    int B, int K, int delta, int freq_max) {
  const int blk = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (blk >= B) return;  // uniform over the warp
  int r[rxt::kRegs];
  rxt::load_row(init_cum, r, lane);
  const int init_total = rxt::row_at(r, rxt::kRow - 1);
  const int tfreeze = rxt::freeze_point(init_total, freq_max, delta);
  const int len = lens[blk];
  const int upd_end = len < tfreeze ? len : tfreeze;  // positions t < upd_end adapt
  const size_t row = static_cast<size_t>(blk) * K;
  for (int t0 = 0; t0 < K; t0 += 32) {
    const int my_t = t0 + lane;
    const int my_sym = my_t < K ? syms[row + my_t] : 0;
    const int n = K - t0 < 32 ? K - t0 : 32;
    int my_lo = 0, my_hi = 0;
    for (int j = 0; j < n; ++j) {
      const int v = __shfl_sync(rxt::kFull, my_sym, j);
      const int l = rxt::row_at(r, v);
      const int h = rxt::row_at(r, v + 1);
      if (lane == j) {
        my_lo = l;
        my_hi = h;
      }
      if (t0 + j < upd_end) rxt::add_above(r, v, delta, lane);
    }
    if (my_t < K) {
      lo[row + my_t] = my_lo;
      hi[row + my_t] = my_hi;
    }
  }
}

}  // namespace

RXT_API int rxt_model_lohi(const void* syms, const void* lens, const void* init_cum,
                           void* lo, void* hi, int B, int K, int delta, int freq_max,
                           int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  constexpr int kWarps = 4;  // blocks per CTA
  const int grid = (B + kWarps - 1) / kWarps;
  model_values_kernel<<<grid, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(syms), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(init_cum), static_cast<int32_t*>(lo),
      static_cast<int32_t*>(hi), B, K, delta, freq_max);
  return cudaGetLastError();
}
