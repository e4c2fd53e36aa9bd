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
// Design: one thread per block (the format makes each block's chain
// serial), u64 interval state, the bit accumulator flushing each full word
// straight into the block's output row.  Three things keep the chain short:
// - count_t depends only on t, the same for every block and never on the
//   coder's state, so rxt::Count takes its reciprocal for t + 1 beside the
//   chain of t, and both bounds' quotients are rxt::div53 (a double
//   product, truncated, corrected by one) where every dividend is below
//   2^53 (kFits53: tpu_wide, tpu32); the (8,30,32) instantiation keeps
//   native u64 divisions;
// - lo/hi come 8 positions at a time (one 32-byte sector a plane, two
//   16-byte loads when the rows are 16-byte aligned, scalar loads
//   otherwise), the next group in flight while this one is coded, so no
//   load waits on the chain.  The last len % 8 positions load one by one;
// - a group's 8 steps are straight-line code but for the reciprocal's
//   slow-path test: the word stores are predicated and rxt::Count has no
//   branch, so the compiler overlaps a symbol's emission with the next
//   symbol's narrowing.
// 64 threads a CTA: 32 and 128 measured the same.
// What bounds it: the serial chain of one block, about 200 instructions a
// symbol, most of them dependent (the narrowing's products, conversions
// and corrections, the renorm and the emission, in u64); one thread per
// block means 16384 threads for 64 MiB, about one warp a scheduler, so
// latency, not bandwidth (9 bytes read a symbol), is the limit.
#include "common.cuh"

namespace {

constexpr int kThreads = 64;  // blocks per CTA
constexpr int kGroup = 8;     // positions loaded at once: one 32-byte sector a plane

struct Group {
  int lo[kGroup], hi[kGroup];
};

// Positions t .. t + kGroup - 1 of a block's planes, all inside the row;
// vec: the rows are 16-byte aligned, so t (a multiple of 8) is too.
__device__ __forceinline__ void load_group(const int32_t* __restrict__ lrow,
                                           const int32_t* __restrict__ hrow, int t, bool vec,
                                           Group& g) {
  if (vec) {
#pragma unroll
    for (int q = 0; q < kGroup; q += 4) {
      const int4 a = *reinterpret_cast<const int4*>(lrow + t + q);
      const int4 b = *reinterpret_cast<const int4*>(hrow + t + q);
      g.lo[q] = a.x, g.lo[q + 1] = a.y, g.lo[q + 2] = a.z, g.lo[q + 3] = a.w;
      g.hi[q] = b.x, g.hi[q + 1] = b.y, g.hi[q + 2] = b.z, g.hi[q + 3] = b.w;
    }
  } else {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      g.lo[j] = lrow[t + j];
      g.hi[j] = hrow[t + j];
    }
  }
}

template <bool kFits53>
__global__ void __launch_bounds__(kThreads)
encode_kernel(const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
              const int32_t* __restrict__ lens, uint32_t* __restrict__ words,
              int32_t* __restrict__ byte_lens, uint8_t* __restrict__ ovf_out, int B, int K,
              int n_words, int init_total, int tfreeze, int delta, int cb, bool vec) {
  const int blk = blockIdx.x * kThreads + threadIdx.x;
  if (blk >= B) return;
  int len = lens[blk];
  len = len > K ? K : len;
  const int32_t* lrow = lo + static_cast<size_t>(blk) * K;
  const int32_t* hrow = hi + static_cast<size_t>(blk) * K;
  uint32_t* row = words + static_cast<size_t>(blk) * n_words;
  rxt::Coder coder(row, n_words, cb);
  rxt::Count<kFits53> count(init_total, delta, tfreeze);
  Group next;
  if (len >= kGroup) load_group(lrow, hrow, 0, vec, next);
  int t0 = 0;
  for (; t0 + kGroup <= len; t0 += kGroup) {
    const Group cur = next;
    if (t0 + 2 * kGroup <= len) load_group(lrow, hrow, t0 + kGroup, vec, next);
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      coder.step<kFits53>(static_cast<uint32_t>(cur.lo[j]), static_cast<uint32_t>(cur.hi[j]),
                          count.c, count.rc);
      count.next();
    }
  }
  for (int t = t0; t < len; ++t) {
    coder.step<kFits53>(static_cast<uint32_t>(lrow[t]), static_cast<uint32_t>(hrow[t]), count.c,
                        count.rc);
    count.next();
  }
  if (len >= 0) coder.terminate();  // the terminator at t == lens
  coder.finish(row, n_words, byte_lens + blk, ovf_out + blk);
}

}  // namespace

RXT_API int rxt_encode_blocks(const void* lo, const void* hi, const void* lens, void* words,
                              void* byte_lens, void* ovf, int B, int K, int n_words,
                              int init_total, int tfreeze, int delta, int code_bits, int fits53,
                              int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const bool vec = K % 4 == 0 && reinterpret_cast<uintptr_t>(lo) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(hi) % 16 == 0;
  const int grid = (B + kThreads - 1) / kThreads;
  auto kernel = fits53 ? encode_kernel<true> : encode_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int32_t*>(lo), static_cast<const int32_t*>(hi),
      static_cast<const int32_t*>(lens), static_cast<uint32_t*>(words),
      static_cast<int32_t*>(byte_lens), static_cast<uint8_t*>(ovf), B, K, n_words,
      init_total, tfreeze, delta, code_bits, vec);
  return cudaGetLastError();
}
