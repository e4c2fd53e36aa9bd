// K4: the fused encoder, K1's model values fed straight into K2's coder.
//
// Replaces redux_tpu/ops/pallas_encode.py::_encode_kernel with
// model_inline=True (model step model_lohi at :119-161, launched by
// _encode_fused_model_jit at :451, selected by REDUX_TPU_ENC_FUSED).  For
// block b and position t < lens[b]:
//   lo = cdf_t[v], hi = cdf_t[v+1]   (v = syms[b,t], before the update)
//   cdf[i] += delta for every i > v while t < tfreeze
//   code (lo, hi) over count_t = max(init_total + delta * min(t, tfreeze), 1)
// then the v2 terminator at t == lens[b] (none for lens < 0, a pad lane).
// Output: K2's triple (words, byte_lens, ovf), bit for bit.
//
// Design: one warp per block.  The model row lives in the warp's registers
// (9 entries a lane, common.cuh): lo/hi are two register selects plus a
// shuffle and the update 9 predicated adds a lane.  The coder step
// (rxt::Coder) then runs warp-uniformly: every lane carries the same
// low/high/pending and bit accumulator, so nothing is broadcast; lane 0
// alone stores the words (the others have a writer of capacity 0) and the
// lanes share the zero fill past the stream.
// The (B, K) lo/hi planes that K1 writes and K2 reads back (8 bytes each
// way per input byte) never exist: the kernel reads 1 byte a symbol.
// What bounds it: one warp's serial chain a symbol, the row work (about 30
// dependent instructions) plus K2's coder step (two 64-bit divisions and
// about 60 more); the model step of position t+1 does not depend on the
// coder step of t, so the compiler may overlap the two.  16384 warps for
// 64 MiB hide the latency.
#include "common.cuh"

namespace {

__global__ void encode_fused_kernel(const uint8_t* __restrict__ syms,
                                    const int32_t* __restrict__ lens,
                                    const int32_t* __restrict__ init_cum,
                                    uint32_t* __restrict__ words,
                                    int32_t* __restrict__ byte_lens,
                                    uint8_t* __restrict__ ovf_out, int B, int K, int n_words,
                                    int delta, int freq_max, int cb) {
  const int blk = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (blk >= B) return;  // uniform over the warp
  int r[rxt::kRegs];
  rxt::load_row(init_cum, r, lane);
  const int init_total = rxt::row_at(r, rxt::kRow - 1);
  const int tfreeze = rxt::freeze_point(init_total, freq_max, delta);
  int len = lens[blk];
  len = len > K ? K : len;
  const size_t srow = static_cast<size_t>(blk) * K;
  uint32_t* row = words + static_cast<size_t>(blk) * n_words;
  rxt::Coder coder(row, lane == 0 ? n_words : 0, cb);
  for (int t0 = 0; t0 < len; t0 += 32) {
    const int my_t = t0 + lane;
    const int my_sym = my_t < len ? syms[srow + my_t] : 0;
    const int n = len - t0 < 32 ? len - t0 : 32;
    for (int j = 0; j < n; ++j) {
      const int t = t0 + j;
      const int v = __shfl_sync(rxt::kFull, my_sym, j);
      const int l = rxt::row_at(r, v);
      const int h = rxt::row_at(r, v + 1);
      if (t < tfreeze) rxt::add_above(r, v, delta, lane);
      const int c = init_total + delta * (t < tfreeze ? t : tfreeze);
      coder.step(static_cast<uint32_t>(l), static_cast<uint32_t>(h), c > 1 ? c : 1);
    }
  }
  if (len >= 0) coder.terminate();  // the terminator at t == lens
  coder.finish(row, n_words, byte_lens + blk, ovf_out + blk, lane, 32);
}

}  // namespace

RXT_API int rxt_encode_fused(const void* syms, const void* lens, const void* init_cum,
                             void* words, void* byte_lens, void* ovf, int B, int K,
                             int n_words, int delta, int freq_max, int code_bits, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  constexpr int kWarps = 4;  // blocks per CTA
  const int grid = (B + kWarps - 1) / kWarps;
  encode_fused_kernel<<<grid, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(syms), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(init_cum), static_cast<uint32_t*>(words),
      static_cast<int32_t*>(byte_lens), static_cast<uint8_t*>(ovf), B, K, n_words, delta,
      freq_max, code_bits);
  return cudaGetLastError();
}
