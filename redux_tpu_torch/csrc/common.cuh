// Shared pieces of the port's kernels: K1's chunk step of the adaptive
// model (K1 and K4), the named barriers between producer and consumer warps
// (K4 and K5), the coder's total and its reciprocal, the reciprocal
// quotient (K2-K5), the closed-form interval renormalisation (K2-K5), the
// v2 coder step with its bit emission (K2, K4 and K5 all code and emit
// through Coder below), and the per-thread Fenwick model in shared memory
// (K3 and K5).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define RXT_API extern "C" __attribute__((visibility("default")))

namespace rxt {

constexpr int kRow = 258;        // live entries: cdf[0..256] and the total cdf[257]
constexpr int kOwn = 9;          // ceil(kRow / 32): row entries a lane owns in a chunk step
constexpr int kSlots = 32 * kOwn;  // 288 ints a row in shared memory
constexpr unsigned kFull = 0xFFFFFFFFu;

// K1's chunk step for one block, run by one warp (K1 and K4).  Lane j holds
// position t0 + j and its symbol v; the first n_act positions of the chunk
// adapt.  R is the block's row at the chunk's start (kSlots ints, lane l
// owning the 9 contiguous entries 9l .. 9l+8: stride 9 against 32 banks, so
// the owners' accesses never conflict) and H a zeroed histogram of kSlots.
// Returns lane j's (lo, hi):
//   lo_j = R[v_j]   + delta * #{i < j : i < n_act and v_i <  v_j}
//   hi_j = R[v_j+1] + delta * #{i < j : i < n_act and v_i <= v_j}
// then adds delta * #{i < n_act : v_i < e} to every entry e of R: a
// histogram of the active symbols (shared atomics), an in-lane prefix over
// the 9 owned entries, a 5-step warp scan of the lane totals and 9 adds.
// H comes back zeroed.
__device__ __forceinline__ int2 model_chunk(int* R, int* H, int v, int n_act, int delta,
                                            int lane) {
  int lt = 0, le = 0;
  for (int i = 0; i < n_act; ++i) {  // the same trip count on every lane
    const int vi = __shfl_sync(kFull, v, i);
    if (i < lane) {
      lt += vi < v;
      le += vi <= v;
    }
  }
  const int2 lohi = make_int2(R[v] + delta * lt, R[v + 1] + delta * le);
  if (n_act > 0) {
    if (lane < n_act) atomicAdd(&H[v], 1);
    __syncwarp();
    const int own = lane * kOwn;
    int h[kOwn];
    int total = 0;
#pragma unroll
    for (int m = 0; m < kOwn; ++m) {
      h[m] = H[own + m];
      H[own + m] = 0;
      total += h[m];
    }
    int incl = total;  // inclusive scan of the lane totals
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int y = __shfl_up_sync(kFull, incl, d);
      if (lane >= d) incl += y;
    }
    int below = incl - total;  // active symbols < entry own + m
#pragma unroll
    for (int m = 0; m < kOwn; ++m) {
      R[own + m] += delta * below;
      below += h[m];
    }
    __syncwarp();
  }
  return lohi;
}

// Named barriers between the producer and consumer warps of a CTA (K4,
// K5): the producer arrives, the consumer syncs, kN threads in all.  The
// "memory" clobber keeps shared-memory accesses on their side of it.
template <int kN>
__device__ __forceinline__ void bar_sync(int id) {
  asm volatile("bar.sync %0, %1;" ::"r"(id), "n"(kN) : "memory");
}

template <int kN>
__device__ __forceinline__ void bar_arrive(int id) {
  asm volatile("bar.arrive %0, %1;" ::"r"(id), "n"(kN) : "memory");
}

// First position whose update is frozen: max(ceil((freq_max - init_total) / delta), 0).
__device__ __forceinline__ int freeze_point(int init_total, int freq_max, int delta) {
  return freq_max > init_total ? (freq_max - init_total + delta - 1) / delta : 0;
}

// floor(a / b) for a < 2^63 and a quotient below 2^40, from rb = 1/b
// rounded: a, rb and their product each round by at most 2^-53 relative,
// so the truncated product is within one of the quotient (3 x 2^-53 x 2^40
// < 1), and one integer test corrects it; q * b stays at most a + b.  The
// coders' quotients are at most range <= 2^32 (narrowing) or below 4 x
// count < 2^33 (K3's value quotient), whatever the size of the dividend.
__device__ __forceinline__ uint64_t div53(uint64_t a, uint64_t b, double rb) {
  uint64_t q = __double2ull_rz(__ull2double_rn(a) * rb);
  const uint64_t qb = q * b;
  if (qb > a) {
    --q;
  } else if (a - qb >= b) {
    ++q;
  }
  return q;
}

// The encoders' quotient (K2, K4, K5): div53 where every dividend stays
// below 2^53 (kFits53, chosen by the wrappers from code_bits +
// bit_length(freq_max + 254) <= 53), a native u64 division otherwise (e.g.
// the reference CLI's (8,30,32), products up to 2^62).  K3 takes div53 at
// every parameter set.
template <bool kFits53>
__device__ __forceinline__ uint64_t quotient(uint64_t a, uint64_t b, double rb) {
  return kFits53 ? div53(a, b, rb) : a / b;
}

// The coder's total of K2 and K4 at position t,
//   c = max(init_total + delta * min(t, tfreeze), 1),
// the same for every block, and its reciprocal rc (kFits53).  next() moves
// to t + 1: it depends on no coder state, so it runs beside the chain of
// the symbol being coded, and one reciprocal serves both bounds.  It has
// no branch of its own (only __drcp_rn's rare slow path): a branch a
// symbol ends the straight-line code in which the compiler overlaps one
// symbol's emission with the next one's chain.
template <bool kFits53>
struct Count {
  int init_total, delta, tfreeze, t = 0;
  uint64_t c;
  double rc = 0.0;

  __device__ Count(int init_total_, int delta_, int tfreeze_)
      : init_total(init_total_), delta(delta_), tfreeze(tfreeze_) {
    set();
  }

  __device__ __forceinline__ void set() {
    const int v = init_total + delta * (t < tfreeze ? t : tfreeze);
    c = static_cast<uint64_t>(v > 1 ? v : 1);
    if (kFits53) rc = __drcp_rn(static_cast<double>(c));
  }

  __device__ __forceinline__ void next() {
    ++t;
    set();
  }
};

// Closed-form E1/E2 + E3 renormalisation of a narrowed interval.
// n1 = common leading bits of low and high (emitted/consumed bits),
// n3 = underflow steps; low/high come back renormalised.
struct Renorm {
  int n1, n3;
};

__device__ __forceinline__ Renorm renorm(uint64_t& low, uint64_t& high, int cb) {
  const uint64_t cmax = (1ull << cb) - 1;
  int n1 = __clzll(low ^ high) - (64 - cb);
  n1 = n1 < 0 ? 0 : n1;
  const uint64_t low1 = (low << n1) & cmax;
  const uint64_t high1 = ((high << n1) | ((1ull << n1) - 1)) & cmax;
  const int a = __clz(~static_cast<uint32_t>(low1 << (33 - cb)));
  const int b = __clz(static_cast<uint32_t>(high1 << (33 - cb)));
  int n3 = a < b ? a : b;
  n3 = n3 < cb - 1 ? n3 : cb - 1;
  low = (low1 << n3) & (cmax >> 1);
  high = (((high1 << n3) | ((1ull << n3) - 1)) & (cmax >> 1)) | (1ull << (cb - 1));
  return {n1, n3};
}

// A global store under a predicate, in PTX: written in C++ the compiler
// makes it a branch around the address computation, which ends the
// straight-line code of a symbol.
__device__ __forceinline__ void store_if(uint32_t* p, uint32_t v, bool pred) {
  asm volatile("{\n\t.reg .pred p;\n\tsetp.ne.u32 p, %2, 0;\n\t@p st.global.u32 [%0], %1;\n\t}"
               ::"l"(p), "r"(v), "r"(static_cast<unsigned>(pred)));
}

// MSB-first bit packer into one block's row of big-endian u32 words.  Words
// past cap are counted but not stored.  No branches: a put of 0 bits
// changes nothing, and a full word is a predicated store.
struct BitWriter {
  uint32_t* out;
  int cap;
  uint64_t acc = 0;  // accbits (< 32) pending bits, right-aligned
  int accbits = 0;
  int nw = 0;        // words produced, including any past cap

  __device__ __forceinline__ void put(uint64_t v, int n) {  // n <= 32, v < 2^n
    acc = (acc << n) | v;
    accbits += n;
    const bool full = accbits >= 32;
    store_if(out + nw, static_cast<uint32_t>(acc >> (full ? accbits - 32 : 0)), full && nw < cap);
    accbits -= full ? 32 : 0;
    nw += full ? 1 : 0;
    acc &= (1ull << accbits) - 1;
  }

  __device__ __forceinline__ void put64(uint64_t v, int n) {  // n <= 64, v < 2^n
    const int nh = n > 32 ? n - 32 : 0;
    put(v >> 32, nh);  // 0 when n <= 32
    put(v & 0xFFFFFFFFull, n - nh);
  }
};

// Appends [lead][pending x !lead][rest (rest_len bits)] when `on`.  Past 64
// bits the piece is what the reference's 64-bit piece holds: its low 64
// bits with the run cut to 63 and the lead bit at position 63 (so the top
// bit is lead | (rest_len >= 1)), and ovf is set.
__device__ __forceinline__ void emit(BitWriter& wr, bool& ovf, uint32_t lead, uint32_t pending,
                                     uint64_t rest, int rest_len, bool on = true) {
  const bool big = static_cast<uint64_t>(rest_len) + 1 + pending > 64;
  const uint32_t first = big ? (lead | (rest_len >= 1 ? 1u : 0u)) : lead;
  const uint32_t run = big ? 63 - rest_len : pending;  // <= 63
  ovf |= on && big;
  const uint64_t opp = lead ? 0 : ((1ull << run) - 1);
  const uint64_t piece =
      (static_cast<uint64_t>(first) << (run + rest_len)) | (opp << rest_len) | rest;
  wr.put64(on ? piece : 0, on ? 1 + run + rest_len : 0);
}

// The v2 interval coder of one block.  Per coded symbol, step() narrows by
// (flo, fhi) over count (rc = 1/count for the kFits53 quotients),
// renormalises in closed form and emits [b1][pending opposite bits][n1-1
// prefix bits] (nothing when n1 = 0); terminate() emits the 2-bit v2
// terminator tq = (low + quarter - 1) >> (cb - 2); finish() writes the byte
// length (every bit, even past the row's capacity), ovf, the tail word and
// zeros past the stream.
struct Coder {
  BitWriter wr;
  int cb;
  uint64_t low = 0, high;
  uint32_t pending = 0;
  bool ovf = false;

  __device__ Coder(uint32_t* out, int cap, int code_bits)
      : wr{out, cap}, cb(code_bits), high((1ull << code_bits) - 1) {}

  template <bool kFits53>
  __device__ __forceinline__ void step(uint64_t flo, uint64_t fhi, uint64_t count, double rc) {
    const uint64_t range = high - low + 1;
    const uint64_t nlow = low + quotient<kFits53>(range * flo, count, rc);
    high = low + quotient<kFits53>(range * fhi, count, rc) - 1;
    low = nlow;
    const uint64_t narrowed = low;
    const Renorm rn = renorm(low, high, cb);
    const bool on = rn.n1 > 0;
    const int rest_len = on ? rn.n1 - 1 : 0;
    const uint64_t prefix = narrowed >> (cb - rn.n1);  // 0 when n1 = 0
    emit(wr, ovf, static_cast<uint32_t>(prefix >> rest_len), pending,
         prefix & ((1ull << rest_len) - 1), rest_len, on);
    pending = (on ? 0 : pending) + rn.n3;
  }

  __device__ __forceinline__ void terminate() {
    const uint64_t tq = (low + (1ull << (cb - 2)) - 1) >> (cb - 2);
    emit(wr, ovf, static_cast<uint32_t>(tq >> 1), pending, tq & 1, 1);
  }

  __device__ __forceinline__ void finish(uint32_t* row, int n_words, int32_t* byte_len,
                                         uint8_t* ovf_out) {
    int w = wr.nw;
    const long long bits = static_cast<long long>(w) * 32 + wr.accbits;
    *byte_len = static_cast<int32_t>((bits + 7) >> 3);
    *ovf_out = ovf ? 1 : 0;
    if (wr.accbits > 0) {
      if (w < n_words) row[w] = static_cast<uint32_t>(wr.acc << (32 - wr.accbits));
      ++w;
    }
    for (int i = w; i < n_words; ++i) row[i] = 0;
  }
};

// Fenwick model of one block (K3, K5): one thread owns one block, and its
// 257 symbol frequencies are a Fenwick tree in shared memory, the layout of
// the reference library's own model (redux_tpu/models/fenwick.py): node i
// (1-based) holds the frequencies of symbols i - lowbit(i) .. i - 1, so
// cdf[v] = init_cum[0] + prefix(v).  In a CTA whose tree has kCols columns,
// node i of column x sits at tree[(i - 1) * kCols + x], so every access of
// a warp hits 32 distinct banks whatever the symbols.  The running total
// stays in a register beside the tree.  K5 reads and updates it in closed
// form (prefix, load_walk, store_walk): every node a byte touches follows
// from the byte alone, so its loads are independent and unrolled, with no
// walk whose trip count differs between lanes.
constexpr int kTreeThreads = 32;       // K3's blocks per CTA: one bank each
constexpr int kNodes = kRow - 1;       // nodes 1..257
constexpr int kTreeInts = kNodes * kTreeThreads;  // 32,896 bytes a CTA
constexpr int kWalk = 9;               // nodes of an update walk from node 1..256

__device__ __forceinline__ int lowbit(int i) { return i & -i; }

// The nodes the update freq[v] += d touches for a byte v, and their values
// as Fenwick::load_walk() read them.  The walk from node v + 1 (v + 1, then
// + lowbit each step, up to node 256) is, in closed form, node
// (v | (2^b - 1)) + 1 for every bit b < kWalk that is 0 in v; for a bit that
// is 1 the same formula gives the node of the next 0 bit above it.  So
// entry b is node (v | (2^b - 1)) + 1 for every b: repeats, but no
// predicate, and a repeated node is stored twice with the same value.
struct Walk {
  int i[kWalk];  // the nodes; i[0] is node v + 1
  int v[kWalk];  // their values
};

template <int kCols = kTreeThreads>
struct Fenwick {
  int* col;  // this thread's column, tree + x: node i is col[(i - 1) * kCols]

  __device__ __forceinline__ int& node(int i) const { return col[(i - 1) * kCols]; }

  __device__ __forceinline__ void init(const int32_t* __restrict__ init_cum) const {
    for (int i = 1; i <= kNodes; ++i) node(i) = init_cum[i] - init_cum[i - lowbit(i)];
  }

  // prefix(v) for a byte v: the read walk v, v & (v - 1), ... is v with
  // its lowest set bits cleared one at a time, one node a set bit b of v,
  // node (v >> b) << b.  `low` gets the terms of v's trailing ones b: the
  // nodes (v + 1) - 2^b that freq(v) = node(v + 1) - low subtracts (K3's
  // closed form), so flo = base + prefix and fhi = flo + node(v + 1) - low
  // share their reads.
  __device__ __forceinline__ int prefix(int v, int& low) const {
    const int ones = v & ~(v + 1);  // v's trailing ones
    int sum = 0;
    low = 0;
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      const int n = (v >> b) & 1 ? node((v >> b) << b) : 0;
      sum += n;
      if ((ones >> b) & 1) low += n;
    }
    return sum;
  }

  __device__ __forceinline__ Walk load_walk(int v) const {
    Walk w;
#pragma unroll
    for (int b = 0; b < kWalk; ++b) {
      w.i[b] = (v | ((1 << b) - 1)) + 1;
      w.v[b] = node(w.i[b]);
    }
    return w;
  }

  // Each node of the walk becomes its loaded value + d (d = 0 writes back
  // what was read).
  __device__ __forceinline__ void store_walk(const Walk& w, int d) const {
#pragma unroll
    for (int b = 0; b < kWalk; ++b) node(w.i[b]) = w.v[b] + d;
  }
};

}  // namespace rxt
