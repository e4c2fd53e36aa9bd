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
// - every quotient is rxt::div53 (common.cuh), at every parameter set the
//   wrapper admits: a double reciprocal times the dividend, truncated,
//   then corrected by one.  The dividends reach 2^63 at (8,30,32), but
//   the quotients stay small: the value quotient is below 4 x count <
//   2^33 (z < 2^code_bits, a renormalised range above a quarter; a larger
//   one, on a corrupt stream only, is off by far less than itself and the
//   clamp to count - 1 takes it alike), the narrowing ones at most range
//   <= 2^32, and three roundings of 2^-53 leave the truncated product
//   within one of such a quotient;
// - the bit reader keeps the block's next word in flight one word ahead;
//   symbols collect in a 16-byte register window and are stored 16 at a
//   time (k a multiple of 16; byte stores otherwise).
// What bounds it: one thread's dependent chain a symbol (the value
// division, 3 rounds of the descent, the narrowing quotients, the renorm):
// latency, with about one warp a scheduler at 16384 blocks.
//
// A launch of few blocks (rxt_decode_blocks' `warp`, chosen by the caller
// from B and the card's SM count) takes the warp route instead, an
// overload of decode_kernel: one warp decodes one block, a CTA a block, so
// a launch of 6-188 blocks puts a warp on as many schedulers and the chain
// of a symbol, not the card's throughput, sets its time.  Per symbol:
// - the model is in registers: lane l holds cdf[8l .. 8l+7] and cdf[8l+8]
//   (lane l+1's first; lane 31's is cdf[256]); count = cdf[257] is held
//   the same in every lane;
// - no division before the search: cdf[i] <= floor(a / range) exactly when
//   cdf[i] * range <= a, for a = (z+1)*count - 1, and the clamp
//   min(value, count - 1) is the test cdf[i] != count, so each lane
//   compares its products with a (under 2^63 at (8,30,32));
// - a ballot of "my first entry qualifies" names the owning lane, the
//   highest set bit; the qualifying entries are a prefix of the row, so
//   each lane's pick is its last qualifying entry (its first if none),
//   taken by a tree of selects;
// - every lane narrows over its own pick while the ballot runs (narrow():
//   the quotient from the double reciprocal of count, one fused
//   multiply-add and one integer test, exact at every parameter set), and
//   three shuffles from the owning lane bring i, dlo and dhi - 1 to the
//   warp;
// - low, high, z and the bit reader are the same in every lane (broadcast
//   loads of the block's row), with the thread route's closed-form renorm
//   on 32 bits (renorm32);
// - the +delta update is 9 predicated adds a lane while count < freq_max;
// - lane j keeps the symbol at position t0 + j of each 32, and the warp
//   stores the 32 bytes at once.
// At 1-512 blocks a launch takes about 1.07 ms at k = 4096 against the
// thread route's 2.5 (at every parameter set); it issues about 230 warp
// instructions a symbol, so each warp a scheduler past the first adds
// about 0.6 ms, and past three the thread route is the cheaper
// (ops/decode.py).
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
  double rc = __drcp_rn(static_cast<double>(count));
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
        uint64_t value = rxt::div53(a, range, __drcp_rn(static_cast<double>(range)));
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
        const uint64_t dlo = rxt::div53(range * flo, count, rc);
        const uint64_t dhi = rxt::div53(range * fhi, count, rc);
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
          rc = __drcp_rn(static_cast<double>(count));  // for the next symbol
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

// floor(c * range / count) for c <= count (the narrowing quotients of the
// warp route), from rr = range * (1/count) in double: c * rr is within
// 2^-52 of the quotient relative, and the quotient is at most range <=
// 2^32, so within 2^-20.  One fused multiply-add rounds c * rr + 2^52 to
// the nearest integer, which is the quotient or one above: its low 52 bits
// are q, and one integer test against p = c * range (< 2^63) takes one
// off.  No conversion to an integer, no branch.
__device__ __forceinline__ uint64_t narrow(uint64_t p, uint32_t c, uint32_t count, double rr) {
  const double qd = __fma_rn(static_cast<double>(c), rr, 4503599627370496.0);  // + 2^52
  uint64_t q = static_cast<uint64_t>(__double_as_longlong(qd)) & ((1ull << 52) - 1);
  q -= q * count > p ? 1 : 0;
  return q;
}

// The position of x's highest set bit (x != 0): 31 - __clz(x) in one step.
__device__ __forceinline__ int top_bit(uint32_t x) {
  int b;
  asm("bfind.u32 %0, %1;" : "=r"(b) : "r"(x));
  return b;
}

// rxt::renorm of an interval held in 32 bits (cb <= 32): low, high <
// 2^cb, or high = low - 1 mod 2^32 after an empty interval, where
// rxt::renorm's u64 high is low - 1 mod 2^64 (both give the same n1, and
// n1 = 0 where they differ).  A shift by n1 = 32 gives 0, as in u64.
__device__ __forceinline__ rxt::Renorm renorm32(uint32_t& low, uint32_t& high, int cb) {
  const uint32_t cmax = 0xFFFFFFFFu >> (32 - cb);
  int n1 = __clz(low ^ high) - (32 - cb);
  n1 = n1 < 0 ? 0 : n1;
  const uint32_t low1 = __funnelshift_lc(0u, low, n1) & cmax;  // low << n1
  const uint32_t high1 = (__funnelshift_lc(0u, high, n1) | (__funnelshift_lc(0u, 1u, n1) - 1)) & cmax;
  const int a = __clz(~(low1 << (33 - cb)));
  const int b = __clz(high1 << (33 - cb));
  int n3 = a < b ? a : b;
  n3 = n3 < cb - 1 ? n3 : cb - 1;
  low = (low1 << n3) & (cmax >> 1);
  high = (((high1 << n3) | ((1u << n3) - 1)) & (cmax >> 1)) | (1u << (cb - 1));
  return {n1, n3};
}

constexpr int kLaneRow = 8;  // the warp route's row entries a lane owns

// The warp route: block blockIdx.x, decoded by the one warp of its CTA.
// A symbol's steps hold no branch but the bit reader's refill: the freeze
// is a predicate, and count and its reciprocal follow from the position
// alone (K2's rxt::Count): count_t = init + delta * min(t, tfreeze), lane
// j takes 1/count for position t0 + j of each 32, and each symbol
// shuffles in the next one's.  low, high and z are held in 32 bits (cb <=
// 32), and so are the shuffled dlo and dhi - 1: mod 2^32 they give the
// thread route's u64 bounds, and dlo < 2^32 as cdf[sym] < count (only a
// row with cdf[0] > 0 and no qualifying entry could give 2^32).  Two
// symbols an iteration let the compiler overlap one's tail with the
// next one's head.
__global__ void __launch_bounds__(32)
decode_kernel(const uint32_t* __restrict__ words, const int32_t* __restrict__ lens,
              const int32_t* __restrict__ init_cum, uint8_t* __restrict__ out, int W, int k,
              int delta, int freq_max, int cb) {
  const int lane = threadIdx.x;
  const int blk = blockIdx.x;
  uint32_t c[kLaneRow + 1];
#pragma unroll
  for (int j = 0; j <= kLaneRow; ++j) c[j] = init_cum[kLaneRow * lane + j];
  const int init_total = init_cum[kNodes];
  const int tfreeze = rxt::freeze_point(init_total, freq_max, delta);
  const uint32_t cmax = 0xFFFFFFFFu >> (32 - cb);
  const uint32_t* row = words + static_cast<size_t>(blk) * W;
  // The bit reader, the same in every lane: nb bits left-aligned in buf,
  // `ahead` the next word (row[next]), zeros past the row.
  uint64_t buf = 0;
  int nb = 0, next = 0;
  uint32_t ahead = W > 0 ? row[0] : 0u;
  auto get = [&](int n) -> uint32_t {  // n <= 32
    const bool refill = nb < n;
    buf |= refill ? static_cast<uint64_t>(ahead) << (32 - nb) : 0;
    nb += refill ? 32 : 0;
    next += refill ? 1 : 0;
    if (refill) ahead = next < W ? row[next] : 0u;
    const uint64_t v = (buf >> (63 - n)) >> 1;  // 0 for n = 0
    buf <<= n;
    nb -= n;
    return static_cast<uint32_t>(v);
  };
  uint32_t low = 0, high = cmax;
  uint32_t z = get(cb);
  int len = lens[blk];
  len = len > k ? k : len;
  uint8_t* orow = out + static_cast<size_t>(blk) * k;
  for (int t0 = 0; t0 < k; t0 += 32) {
    const int tl = t0 + lane;
    const double rc_lane = __drcp_rn(static_cast<double>(
        init_total + delta * (tl < tfreeze ? tl : tfreeze)));  // 1/count at t0 + lane
    double rc = __shfl_sync(rxt::kFull, rc_lane, 0);
    uint32_t mine = 0;  // the symbol at t0 + lane
#pragma unroll 2
    for (int j = 0; j < 32 && t0 + j < len; ++j) {  // the same trip count on every lane
      const int t = t0 + j;
      const bool upd = t < tfreeze;  // count < freq_max
      const uint32_t count = init_total + delta * (upd ? t : tfreeze);
      const double rc_next = __shfl_sync(rxt::kFull, rc_lane, (j + 1) & 31);  // a symbol ahead
      const uint32_t rm1 = high - low;  // range - 1, range <= 2^32
      const double rr = __fma_rn(static_cast<double>(rm1), rc, rc);  // range * rc, rounded once
      // cdf[e] <= value = min(floor(a / range), count - 1) exactly when
      // cdf[e] * range <= a and cdf[e] < count; x * range is computed as
      // x * (range - 1) + x, one wide multiply-add.
      const uint64_t a = static_cast<uint64_t>(count) * z + count - 1;
      bool q[kLaneRow + 1];
#pragma unroll
      for (int e = 0; e <= kLaneRow; ++e) {
        q[e] = static_cast<uint64_t>(c[e]) * rm1 + c[e] <= a && c[e] != count;
      }
      // The lane's pick: i = its last qualifying entry (0 if none), a tree
      // of selects over the monotone q; lo = cdf[i], hi = cdf[i + 1].
      const int i01 = q[1] ? 1 : 0, i23 = q[3] ? 3 : 2, i45 = q[5] ? 5 : 4, i67 = q[7] ? 7 : 6;
      const uint32_t l01 = q[1] ? c[1] : c[0], l23 = q[3] ? c[3] : c[2];
      const uint32_t l45 = q[5] ? c[5] : c[4], l67 = q[7] ? c[7] : c[6];
      const uint32_t h01 = q[1] ? c[2] : c[1], h23 = q[3] ? c[4] : c[3];
      const uint32_t h45 = q[5] ? c[6] : c[5], h67 = q[7] ? c[8] : c[7];
      const int i03 = q[2] ? i23 : i01, i47 = q[6] ? i67 : i45;
      const uint32_t l03 = q[2] ? l23 : l01, l47 = q[6] ? l67 : l45;
      const uint32_t h03 = q[2] ? h23 : h01, h47 = q[6] ? h67 : h45;
      const int i07 = q[4] ? i47 : i03;
      const uint32_t l07 = q[4] ? l47 : l03, h07 = q[4] ? h47 : h03;
      const uint32_t i = q[8] ? 8 : i07;
      const uint32_t lo = q[8] ? c[8] : l07, hi = q[8] ? count : h07;
      const uint64_t dlo = narrow(static_cast<uint64_t>(lo) * rm1 + lo, lo, count, rr);
      const uint64_t dhi = narrow(static_cast<uint64_t>(hi) * rm1 + hi, hi, count, rr);
      const unsigned own = __ballot_sync(rxt::kFull, q[0]);
      const int src = top_bit(own | 1u);  // lane 0 where no entry qualifies
      const uint32_t dl = __shfl_sync(rxt::kFull, static_cast<uint32_t>(dlo), src);
      const uint32_t dhm1 = __shfl_sync(rxt::kFull, static_cast<uint32_t>(dhi - 1), src);
      const uint32_t sym = kLaneRow * src + __shfl_sync(rxt::kFull, i, src);
      high = low + dhm1;
      low += dl;
      const rxt::Renorm rn = renorm32(low, high, cb);
      int nbits = rn.n1 + rn.n3;
      nbits = nbits < cb ? nbits : cb;  // n1 + n3 <= code_bits on a valid stream
      z = static_cast<uint32_t>((static_cast<uint64_t>(z - dl) << nbits) | get(nbits)) & cmax;
      const int d = static_cast<int>(sym) - kLaneRow * lane;
      const uint32_t dd = upd ? delta : 0;
#pragma unroll
      for (int e = 0; e <= kLaneRow; ++e) {
        if (e > d) c[e] += dd;
      }
      mine = j == lane ? sym : mine;
      rc = rc_next;
    }
    if (t0 + lane < k) orow[t0 + lane] = static_cast<uint8_t>(mine);
  }
}

}  // namespace

RXT_API int rxt_decode_blocks(const void* words, const void* lens, const void* init_cum,
                              void* out, int B, int W, int k, int delta, int freq_max,
                              int code_bits, int warp, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const auto w = static_cast<const uint32_t*>(words);
  const auto l = static_cast<const int32_t*>(lens);
  const auto ic = static_cast<const int32_t*>(init_cum);
  const auto o = static_cast<uint8_t*>(out);
  const auto s = static_cast<cudaStream_t>(stream);
  if (warp) {
    decode_kernel<<<B, 32, 0, s>>>(w, l, ic, o, W, k, delta, freq_max, code_bits);
  } else {
    const int grid = (B + kThreads - 1) / kThreads;
    decode_kernel<<<grid, kThreads, 0, s>>>(w, l, ic, o, B, W, k, delta, freq_max, code_bits);
  }
  return cudaGetLastError();
}
