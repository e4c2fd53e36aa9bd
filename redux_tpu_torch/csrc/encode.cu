// K2: the v2 interval coder over precomputed model values.
//
// Replaces redux_tpu/ops/pallas_encode.py::_encode_kernel (model_inline=False,
// step at :185-283, launched by _encode_pallas_jit).  Per block b:
//   count_t = max(init_total + delta * min(t, tfreeze), 1)          (t < lens)
//   narrow:  low' = low + range*lo/count,  high' = low + range*hi/count - 1
//   renorm:  closed-form E1/E2 (n1) and E3 (n3) runs (common.cuh)
//   emit:    [b1][pending opposite bits][n1-1 prefix bits], at most 64 bits;
//            a piece that would exceed 64 bits sets ovf and is cut exactly as
//            redux_tpu.ops.coder._piece64/_leftalign64 cut it
//   t==lens: the 2-bit v2 terminator tq = (low + quarter - 1) >> (cb-2)
// Output: big-endian u32 words (at most n_words a block, zero past the
// stream), byte_lens = (bits + 7) >> 3 counting every bit even past
// n_words, and ovf.  The coder step and the emission are rxt::Coder
// (common.cuh), shared with K4 and K5.
//
// Design: one thread per block.  low/high are u64 and the products
// range*lo (up to 2^42 at (8,20,22)) and their divisions are native 64-bit,
// so none of the TPU's dual-u32 + f32 division is needed.  The bit
// accumulator is a u64 that flushes each full word straight into the
// block's output row: no staging, compaction or ring (those exist on the
// TPU only because it has no per-lane scatter).
// What bounds it: the serial chain of one block (two 64-bit divisions and
// ~60 dependent integer instructions a symbol); one thread per block means
// 16384 threads for 64 MiB, so latency, not bandwidth (9 bytes read a
// symbol), is the limit.
#include "common.cuh"

namespace {

__global__ void encode_kernel(const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
                              const int32_t* __restrict__ lens, uint32_t* __restrict__ words,
                              int32_t* __restrict__ byte_lens, uint8_t* __restrict__ ovf_out,
                              int B, int K, int n_words, int init_total, int tfreeze,
                              int delta, int cb) {
  const int blk = blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= B) return;
  int len = lens[blk];
  len = len > K ? K : len;
  const int32_t* lrow = lo + static_cast<size_t>(blk) * K;
  const int32_t* hrow = hi + static_cast<size_t>(blk) * K;
  uint32_t* row = words + static_cast<size_t>(blk) * n_words;
  rxt::Coder coder(row, n_words, cb);
  for (int t = 0; t < len; ++t) {
    const int c = init_total + delta * (t < tfreeze ? t : tfreeze);
    coder.step(static_cast<uint32_t>(lrow[t]), static_cast<uint32_t>(hrow[t]), c > 1 ? c : 1);
  }
  if (len >= 0) coder.terminate();  // the terminator at t == lens
  coder.finish(row, n_words, byte_lens + blk, ovf_out + blk, 0, 1);
}

}  // namespace

RXT_API int rxt_encode_blocks(const void* lo, const void* hi, const void* lens, void* words,
                              void* byte_lens, void* ovf, int B, int K, int n_words,
                              int init_total, int tfreeze, int delta, int code_bits,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  constexpr int kThreads = 64;
  const int grid = (B + kThreads - 1) / kThreads;
  encode_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
      static_cast<const int32_t*>(lens), static_cast<uint32_t*>(words),
      static_cast<int32_t*>(byte_lens), static_cast<uint8_t*>(ovf), B, K, n_words,
      init_total, tfreeze, delta, code_bits);
  return cudaGetLastError();
}
