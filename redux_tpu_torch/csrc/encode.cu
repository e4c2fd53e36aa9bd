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
// n_words, and ovf.
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

struct BitWriter {
  uint32_t* out;
  int cap;
  uint64_t acc = 0;  // accbits (< 32) pending bits, right-aligned
  int accbits = 0;
  int nw = 0;        // words produced, including any past cap

  __device__ __forceinline__ void put(uint64_t v, int n) {  // n <= 32, v < 2^n
    acc = (acc << n) | v;
    accbits += n;
    if (accbits >= 32) {
      accbits -= 32;
      if (nw < cap) out[nw] = static_cast<uint32_t>(acc >> accbits);
      ++nw;
      acc &= (1ull << accbits) - 1;
    }
  }

  __device__ __forceinline__ void put64(uint64_t v, int n) {  // n <= 64, v < 2^n
    if (n > 32) {
      put(v >> 32, n - 32);
      put(v & 0xFFFFFFFFull, 32);
    } else {
      put(v, n);
    }
  }
};

// Appends [lead][pending x !lead][rest (rest_len bits)].  Past 64 bits the
// piece is what the reference's 64-bit piece holds: its low 64 bits with the
// run cut to 63 and the lead bit at position 63 (so the top bit is
// lead | (rest_len >= 1)), and ovf is set.
__device__ __forceinline__ void emit(BitWriter& wr, bool& ovf, uint32_t lead,
                                     uint32_t pending, uint64_t rest, int rest_len) {
  uint32_t first = lead, run = pending;
  if (static_cast<uint64_t>(rest_len) + 1 + pending > 64) {
    ovf = true;
    first = lead | (rest_len >= 1 ? 1u : 0u);
    run = 63 - rest_len;
  }
  const uint64_t opp = lead ? 0 : ((1ull << run) - 1);  // run <= 63
  const uint64_t piece =
      (static_cast<uint64_t>(first) << (run + rest_len)) | (opp << rest_len) | rest;
  wr.put64(piece, 1 + run + rest_len);
}

__global__ void encode_kernel(const int32_t* __restrict__ lo, const int32_t* __restrict__ hi,
                              const int32_t* __restrict__ lens, uint32_t* __restrict__ words,
                              int32_t* __restrict__ byte_lens, uint8_t* __restrict__ ovf_out,
                              int B, int K, int n_words, int init_total, int tfreeze,
                              int delta, int cb) {
  const int blk = blockIdx.x * blockDim.x + threadIdx.x;
  if (blk >= B) return;
  const uint64_t cmax = (1ull << cb) - 1;
  const uint64_t quarter = 1ull << (cb - 2);
  int len = lens[blk];
  len = len > K ? K : len;
  const int32_t* lrow = lo + static_cast<size_t>(blk) * K;
  const int32_t* hrow = hi + static_cast<size_t>(blk) * K;
  BitWriter wr{words + static_cast<size_t>(blk) * n_words, n_words};
  uint64_t low = 0, high = cmax;
  uint32_t pending = 0;
  bool ovf = false;
  for (int t = 0; t < len; ++t) {
    const uint64_t flo = static_cast<uint32_t>(lrow[t]);
    const uint64_t fhi = static_cast<uint32_t>(hrow[t]);
    const int c = init_total + delta * (t < tfreeze ? t : tfreeze);
    const uint64_t count = c > 1 ? c : 1;
    const uint64_t range = high - low + 1;
    const uint64_t nlow = low + range * flo / count;
    high = low + range * fhi / count - 1;
    low = nlow;
    const uint64_t narrowed = low;
    const rxt::Renorm rn = rxt::renorm(low, high, cb);
    if (rn.n1 > 0) {
      const uint64_t prefix = narrowed >> (cb - rn.n1);
      const int rest_len = rn.n1 - 1;
      emit(wr, ovf, static_cast<uint32_t>(prefix >> rest_len), pending,
           prefix & ((1ull << rest_len) - 1), rest_len);
      pending = 0;
    }
    pending += rn.n3;
  }
  if (len >= 0) {  // the terminator at t == lens
    const uint64_t tq = (low + quarter - 1) >> (cb - 2);
    emit(wr, ovf, static_cast<uint32_t>(tq >> 1), pending, tq & 1, 1);
  }
  const long long bits = static_cast<long long>(wr.nw) * 32 + wr.accbits;
  byte_lens[blk] = static_cast<int32_t>((bits + 7) >> 3);
  ovf_out[blk] = ovf ? 1 : 0;
  int w = wr.nw;
  if (wr.accbits > 0) {
    if (w < n_words) wr.out[w] = static_cast<uint32_t>(wr.acc << (32 - wr.accbits));
    ++w;
  }
  for (; w < n_words; ++w) wr.out[w] = 0;
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
