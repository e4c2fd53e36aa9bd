// K3: the v2 block decoder (adaptive model + interval decoder + bit reader).
//
// Replaces redux_tpu/ops/pallas_decode.py::_decode_kernel (step at
// :220-421, prime at :457, launched by _decode_pallas_jit).  Per block b:
//   prime z with code_bits bits, then for t < lens[b]:
//   value = min(((z+1)*count - 1) / range, count - 1)
//   sym   = #{i : cdf[i] <= value} - 1      (flo = cdf[sym], fhi = cdf[sym+1])
//   cdf[i] += delta for i > sym while count < freq_max (count may overshoot
//   to freq_max + delta - 1); narrow with the pre-update count; z -= dlo;
//   closed-form renorm (common.cuh); z = ((z << n1+n3) | next bits) & cmax.
// Bits are read MSB-first from the block's row of big-endian u32 words;
// reads past the row give zero bits.  Output: (B, k) u8, zero past lens.
//
// Design: one warp per block.  The model row sits in the warp's registers
// (9 entries a lane, common.cuh); the symbol search is 9 ballots + popc,
// flo/fhi two register selects + shuffles, the update 9 predicated adds a
// lane.  Every lane carries the same interval and bit-reader state (u64
// registers), so there is no broadcast step and no shared memory.  The
// TPU's one-hot word pulls and slab refill sweep are gone: a lane reads its
// block's next word directly (the 32 lanes read the same address, one
// transaction).  Symbols are written 32 at a time (a 32-byte store).
// What bounds it: the serial chain of one block (three 64-bit divisions,
// the ballots and ~80 dependent instructions a symbol); one warp per block
// gives 16384 warps for 64 MiB to hide that latency.
#include "common.cuh"

namespace {

struct BitReader {
  const uint32_t* w;
  int n_words;
  uint64_t buf = 0;  // nb bits, left-aligned
  int nb = 0;
  int next = 0;

  __device__ __forceinline__ uint64_t get(int n) {  // n <= 32
    if (n == 0) return 0;
    if (nb < n) {
      const uint32_t word = next < n_words ? w[next] : 0u;
      buf |= static_cast<uint64_t>(word) << (32 - nb);
      ++next;
      nb += 32;
    }
    const uint64_t v = buf >> (64 - n);
    buf <<= n;
    nb -= n;
    return v;
  }
};

__global__ void decode_kernel(const uint32_t* __restrict__ words,
                              const int32_t* __restrict__ lens,
                              const int32_t* __restrict__ init_cum,
                              uint8_t* __restrict__ out, int B, int W, int k, int delta,
                              int freq_max, int cb) {
  const int blk = (blockIdx.x * blockDim.x + threadIdx.x) >> 5;
  const int lane = threadIdx.x & 31;
  if (blk >= B) return;  // uniform over the warp
  int r[rxt::kRegs];
  rxt::load_row(init_cum, r, lane);
  uint64_t count = static_cast<uint32_t>(rxt::row_at(r, rxt::kRow - 1));
  const uint64_t cmax = (1ull << cb) - 1;
  BitReader rd{words + static_cast<size_t>(blk) * W, W};
  uint64_t low = 0, high = cmax;
  uint64_t z = rd.get(cb);
  int len = lens[blk];
  len = len > k ? k : len;
  const size_t row = static_cast<size_t>(blk) * k;
  for (int t0 = 0; t0 < k; t0 += 32) {
    int my_sym = 0;
    const int n = len - t0 < 32 ? len - t0 : 32;  // may be <= 0
    for (int j = 0; j < n; ++j) {
      const uint64_t range = high - low + 1;
      uint64_t value = ((z + 1) * count - 1) / range;
      value = value < count - 1 ? value : count - 1;
      const int v = static_cast<int>(value);
      int c = 0;
#pragma unroll
      for (int q = 0; q < rxt::kRegs; ++q) c += __popc(__ballot_sync(rxt::kFull, r[q] <= v));
      const int sym = c - 1;
      const uint64_t flo = static_cast<uint32_t>(rxt::row_at(r, sym));
      const uint64_t fhi = static_cast<uint32_t>(rxt::row_at(r, sym + 1));
      const uint64_t dlo = range * flo / count;  // narrow with the pre-update count
      high = low + range * fhi / count - 1;
      low += dlo;
      z -= dlo;
      if (count < static_cast<uint64_t>(freq_max)) {
        rxt::add_above(r, sym, delta, lane);
        count += delta;
      }
      const rxt::Renorm rn = rxt::renorm(low, high, cb);
      int nbits = rn.n1 + rn.n3;
      nbits = nbits < cb ? nbits : cb;  // n1 + n3 <= code_bits on a valid stream
      z = ((z << nbits) | rd.get(nbits)) & cmax;
      if (lane == j) my_sym = sym;
    }
    if (t0 + lane < k) out[row + t0 + lane] = static_cast<uint8_t>(my_sym);
  }
}

}  // namespace

RXT_API int rxt_decode_blocks(const void* words, const void* lens, const void* init_cum,
                              void* out, int B, int W, int k, int delta, int freq_max,
                              int code_bits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  constexpr int kWarps = 4;  // blocks per CTA
  const int grid = (B + kWarps - 1) / kWarps;
  decode_kernel<<<grid, 32 * kWarps, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(init_cum), static_cast<uint8_t*>(out), B, W, k, delta,
      freq_max, code_bits);
  return cudaGetLastError();
}
