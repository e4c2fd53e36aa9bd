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
// Design: one thread per block, 32 blocks a CTA, the model rxt::Fenwick
// (common.cuh, K5's layout): 32,896 bytes of shared memory a CTA, so 6
// CTAs an SM and 16384 blocks all resident in one wave.  The card issues
// a warp's instructions in order, so every stall of one thread's chain
// costs the whole symbol, and a loop whose trip count differs between
// lanes runs as long as its longest lane.  Per symbol:
// - the symbol is a Fenwick descent (steps 256 .. 1, a node taken while
//   its sum is <= the remainder), giving sym and flo = value - remainder;
//   it goes three levels a round, the 7 nodes below pos loaded together,
//   so 3 rounds of dependent shared loads instead of 9;
// - fhi = flo + freq(sym), freq(sym) being node p = sym + 1 less the
//   nodes p - 2^q, q under p's trailing zero count: independent loads
//   under predicates, no loop that diverges;
// - the +delta update walk's nodes are loaded with them and stored after
//   the narrowing, off the chain;
// - count does not depend on the symbols (it grows by delta a position
//   until freq_max), so its reciprocal for the next symbol is taken off
//   the chain, and one reciprocal serves both bounds;
// - every quotient is rxt::quotient (common.cuh): where every dividend
//   stays below 2^53 (kFits53) a double reciprocal times the dividend,
//   truncated, then corrected by one, otherwise (the CLI's (8,30,32))
//   native u64 divisions;
// - the bit reader keeps the block's next word in flight one word ahead;
//   symbols collect in a 16-byte register window and are stored 16 at a
//   time (k a multiple of 16; byte stores otherwise).
// What bounds it: one thread's dependent chain a symbol (the value
// division, 3 rounds of the descent, the narrowing quotients, the renorm):
// latency, with about one warp a scheduler at 16384 blocks.
#include "common.cuh"

namespace {

using rxt::kNodes;
using rxt::lowbit;
constexpr int kThreads = rxt::kTreeThreads;

struct BitReader {
  const uint32_t* w;
  int n_words;
  uint64_t buf = 0;  // nb bits, left-aligned
  int nb = 0;
  int next = 0;       // index of `ahead`
  uint32_t ahead;     // the next word, loaded one refill early

  __device__ BitReader(const uint32_t* words, int n) : w(words), n_words(n) {
    ahead = n > 0 ? w[0] : 0u;
  }

  __device__ __forceinline__ uint64_t get(int n) {  // n <= 32
    if (n == 0) return 0;
    if (nb < n) {
      buf |= static_cast<uint64_t>(ahead) << (32 - nb);
      nb += 32;
      ++next;
      ahead = next < n_words ? w[next] : 0u;
    }
    const uint64_t v = buf >> (64 - n);
    buf <<= n;
    nb -= n;
    return v;
  }
};

template <bool kFits53>
__global__ void __launch_bounds__(kThreads)
decode_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ lens,
              const int32_t* __restrict__ init_cum, uint8_t* __restrict__ out, int B, int W,
              int k, int delta, int freq_max, int cb) {
  __shared__ int tree[rxt::kTreeInts];
  const int x = threadIdx.x;
  const int blk = blockIdx.x * kThreads + x;
  if (blk >= B) return;  // no barrier below: each thread owns its tree
  const rxt::Fenwick<> fw{tree + x};
  fw.init(init_cum);
  const uint32_t base = init_cum[0];
  uint64_t count = static_cast<uint32_t>(init_cum[kNodes]);
  double rc = kFits53 ? __drcp_rn(static_cast<double>(count)) : 0.0;
  const uint64_t cmax = (1ull << cb) - 1;
  BitReader rd(words + static_cast<size_t>(blk) * W, W);
  uint64_t low = 0, high = cmax;
  uint64_t z = rd.get(cb);
  int len = lens[blk];
  len = len > k ? k : len;
  uint8_t* orow = out + static_cast<size_t>(blk) * k;
  for (int t0 = 0; t0 < k; t0 += 16) {
    uint32_t w0 = 0, w1 = 0, w2 = 0, w3 = 0;  // symbols t0 .. t0+15, little-endian
    for (int j = 0; j < 16; ++j) {
      uint32_t sym = 0;
      if (t0 + j < len) {
        const uint64_t range = high - low + 1;
        const uint64_t a = (z + 1) * count - 1;
        uint64_t value = rxt::quotient<kFits53>(
            a, range, kFits53 ? __drcp_rn(static_cast<double>(range)) : 0.0);
        value = value < count - 1 ? value : count - 1;
        // Descent: the largest pos with prefix(pos) <= value - base, three
        // levels a round (steps 4s, 2s, s): the 7 nodes below pos load
        // together, so 3 rounds of dependent loads instead of 9.
        uint32_t rem = static_cast<uint32_t>(value) - base;
        int pos = 0;
#pragma unroll
        for (int s = 64; s >= 1; s >>= 3) {
          // n[1] = node pos + 4s; n[2 + a] = pos + 4s*a + 2s; n[4 + 2a + b] =
          // pos + 4s*a + 2s*b + s, for the decisions a, b taken above it.
          uint32_t n[8];
#pragma unroll
          for (int j = 1; j < 8; ++j) {
            const int lvl = j >= 4 ? 2 : (j >= 2 ? 1 : 0);
            const int idx = pos + ((j - (1 << lvl)) << (3 - lvl)) * s + (4 * s >> lvl);
            n[j] = idx <= kNodes ? static_cast<uint32_t>(fw.node(idx)) : 0xFFFFFFFFu;
          }
          const bool a = n[1] <= rem;
          pos += a ? 4 * s : 0;
          rem -= a ? n[1] : 0;
          const uint32_t c1 = a ? n[3] : n[2];
          const bool b = c1 <= rem;
          pos += b ? 2 * s : 0;
          rem -= b ? c1 : 0;
          const uint32_t c2 = a ? (b ? n[7] : n[6]) : (b ? n[5] : n[4]);
          const bool c = c2 <= rem;
          pos += c ? s : 0;
          rem -= c ? c2 : 0;
        }
        sym = pos;
        // freq(sym): node p = sym + 1 less the nodes below it on its path,
        // which are p - 2^q for every q under p's trailing zero count.
        const int p = pos + 1;
        const int tz = __ffs(p) - 1;
        uint32_t f = fw.node(p);
#pragma unroll
        for (int q = 0; q < 8; ++q) {
          if (q < tz) f -= fw.node(p - (1 << q));
        }
        // The update walk's nodes, loaded now and stored after the narrowing.
        int up_i[9];
        int up_v[9];
        {
          int u = p;
#pragma unroll
          for (int q = 0; q < 9; ++q) {
            up_i[q] = u;
            up_v[q] = u <= kNodes ? fw.node(u) : 0;
            u += u <= kNodes ? lowbit(u) : 0;
          }
        }
        const uint64_t flo = static_cast<uint32_t>(value) - rem;
        const uint64_t fhi = flo + f;
        // Narrow with the pre-update count.
        const uint64_t dlo = rxt::quotient<kFits53>(range * flo, count, rc);
        const uint64_t dhi = rxt::quotient<kFits53>(range * fhi, count, rc);
        high = low + dhi - 1;
        low += dlo;
        z -= dlo;
        const rxt::Renorm rn = rxt::renorm(low, high, cb);
        int nbits = rn.n1 + rn.n3;
        nbits = nbits < cb ? nbits : cb;  // n1 + n3 <= code_bits on a valid stream
        z = ((z << nbits) | rd.get(nbits)) & cmax;
        if (count < static_cast<uint64_t>(freq_max)) {  // the same on every lane
#pragma unroll
          for (int q = 0; q < 9; ++q) {
            if (up_i[q] <= kNodes) fw.node(up_i[q]) = up_v[q] + delta;
          }
          count += delta;
          if (kFits53) rc = __drcp_rn(static_cast<double>(count));  // for the next symbol
        }
      }
      w0 = __funnelshift_r(w0, w1, 8);
      w1 = __funnelshift_r(w1, w2, 8);
      w2 = __funnelshift_r(w2, w3, 8);
      w3 = __funnelshift_r(w3, sym, 8);
    }
    if ((k & 15) == 0) {
      *reinterpret_cast<uint4*>(orow + t0) = make_uint4(w0, w1, w2, w3);
    } else {
      const uint32_t ws[4] = {w0, w1, w2, w3};
#pragma unroll
      for (int j = 0; j < 16; ++j) {
        if (t0 + j < k) orow[t0 + j] = static_cast<uint8_t>(ws[j >> 2] >> (8 * (j & 3)));
      }
    }
  }
}

}  // namespace

RXT_API int rxt_decode_blocks(const void* words, const void* lens, const void* init_cum,
                              void* out, int B, int W, int k, int delta, int freq_max,
                              int code_bits, int fits53, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int grid = (B + kThreads - 1) / kThreads;
  auto kernel = fits53 ? decode_kernel<true> : decode_kernel<false>;
  kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(init_cum), static_cast<uint8_t*>(out), B, W, k, delta,
      freq_max, code_bits);
  return cudaGetLastError();
}
