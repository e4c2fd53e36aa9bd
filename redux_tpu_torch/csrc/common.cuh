// Shared pieces of the port's kernels: the warp-held cumulative model row
// (K4; K1 keeps its row in shared memory), the closed-form interval
// renormalisation, the v2 coder step with its
// bit emission (K2, K4 and K5 all code and emit through Coder below), and
// the per-thread Fenwick model in shared memory (K3 and K5).
//
// Model row: one block's 258-entry cumulative row (257 symbols + total)
// lives in the registers of one warp, entry i in register i / 32 of lane
// i % 32 (9 registers a lane).  Entries past the row hold a pad above every
// live entry: the freeze can overshoot freq_max by delta - 1 (<= 254), so a
// pad of INT_MAX is never counted by a "<= value" test.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

#define RXT_API extern "C" __attribute__((visibility("default")))

namespace rxt {

constexpr int kRow = 258;   // live entries: cdf[0..256] and the total cdf[257]
constexpr int kRegs = 9;    // ceil(kRow / 32) entries per lane
constexpr int kPad = 0x7FFFFFFF;
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ void load_row(const int32_t* __restrict__ init_cum,
                                         int (&r)[kRegs], int lane) {
#pragma unroll
  for (int j = 0; j < kRegs; ++j) {
    const int i = j * 32 + lane;
    r[j] = i < kRow ? init_cum[i] : kPad;
  }
}

// Entry i of the row; i must be the same on every lane of the warp.
__device__ __forceinline__ int row_at(const int (&r)[kRegs], int i) {
  const int reg = i >> 5;
  int v = 0;
#pragma unroll
  for (int j = 0; j < kRegs; ++j) v = (j == reg) ? r[j] : v;
  return __shfl_sync(kFull, v, i & 31);
}

// Adaptation: cdf[i] += d for every live i > sym.
__device__ __forceinline__ void add_above(int (&r)[kRegs], int sym, int d, int lane) {
#pragma unroll
  for (int j = 0; j < kRegs; ++j) {
    const int i = j * 32 + lane;
    r[j] += (i > sym && i < kRow) ? d : 0;
  }
}

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

// MSB-first bit packer into one block's row of big-endian u32 words.  Words
// past cap are counted but not stored; a writer with cap 0 stores nothing
// (the other lanes of a warp that codes warp-uniformly).
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

// The v2 interval coder of one block.  Per coded symbol, step() narrows by
// (flo, fhi) over count, renormalises in closed form and emits
// [b1][pending opposite bits][n1-1 prefix bits]; terminate() emits the 2-bit
// v2 terminator tq = (low + quarter - 1) >> (cb - 2); finish() writes the
// byte length (every bit, even past the row's capacity), ovf, the tail word
// and zeros past the stream.
struct Coder {
  BitWriter wr;
  int cb;
  uint64_t low = 0, high;
  uint32_t pending = 0;
  bool ovf = false;

  __device__ Coder(uint32_t* out, int cap, int code_bits)
      : wr{out, cap}, cb(code_bits), high((1ull << code_bits) - 1) {}

  __device__ __forceinline__ void step(uint64_t flo, uint64_t fhi, uint64_t count) {
    const uint64_t range = high - low + 1;
    const uint64_t nlow = low + range * flo / count;
    high = low + range * fhi / count - 1;
    low = nlow;
    const uint64_t narrowed = low;
    const Renorm rn = renorm(low, high, cb);
    if (rn.n1 > 0) {
      const uint64_t prefix = narrowed >> (cb - rn.n1);
      const int rest_len = rn.n1 - 1;
      emit(wr, ovf, static_cast<uint32_t>(prefix >> rest_len), pending,
           prefix & ((1ull << rest_len) - 1), rest_len);
      pending = 0;
    }
    pending += rn.n3;
  }

  __device__ __forceinline__ void terminate() {
    const uint64_t tq = (low + (1ull << (cb - 2)) - 1) >> (cb - 2);
    emit(wr, ovf, static_cast<uint32_t>(tq >> 1), pending, tq & 1, 1);
  }

  // Lane `lane` of `nlanes` lanes that carry this same state: lane 0 writes
  // the scalars and the tail word, all lanes share the zero fill.
  __device__ __forceinline__ void finish(uint32_t* row, int n_words, int32_t* byte_len,
                                         uint8_t* ovf_out, int lane, int nlanes) {
    int w = wr.nw;
    if (lane == 0) {
      const long long bits = static_cast<long long>(w) * 32 + wr.accbits;
      *byte_len = static_cast<int32_t>((bits + 7) >> 3);
      *ovf_out = ovf ? 1 : 0;
      if (wr.accbits > 0 && w < n_words) row[w] = static_cast<uint32_t>(wr.acc << (32 - wr.accbits));
    }
    if (wr.accbits > 0) ++w;
    for (int i = w + lane; i < n_words; i += nlanes) row[i] = 0;
  }
};

// First position whose update is frozen: max(ceil((freq_max - init_total) / delta), 0).
__device__ __forceinline__ int freeze_point(int init_total, int freq_max, int delta) {
  return freq_max > init_total ? (freq_max - init_total + delta - 1) / delta : 0;
}

// Fenwick model of one block (K3, K5): one thread owns one block, and its
// 257 symbol frequencies are a Fenwick tree in shared memory, the layout of
// the reference library's own model (redux_tpu/models/fenwick.py): node i
// (1-based) holds the frequencies of symbols i - lowbit(i) .. i - 1, so
// cdf[v] = init_cum[0] + prefix(v).  Node i of the thread with index x
// sits at tree[(i - 1) * kTreeThreads + x] in a CTA of kTreeThreads
// threads, so every access of a warp hits 32 distinct banks whatever the
// symbols.  The running total stays in a register beside the tree.
constexpr int kTreeThreads = 32;       // blocks per CTA: one bank each
constexpr int kNodes = kRow - 1;       // nodes 1..257
constexpr int kTreeInts = kNodes * kTreeThreads;  // 32,896 bytes a CTA

__device__ __forceinline__ int lowbit(int i) { return i & -i; }

struct Fenwick {
  int* col;  // this thread's column: tree + threadIdx.x

  __device__ __forceinline__ int& node(int i) const { return col[(i - 1) * kTreeThreads]; }

  __device__ __forceinline__ void init(const int32_t* __restrict__ init_cum) const {
    for (int i = 1; i <= kNodes; ++i) node(i) = init_cum[i] - init_cum[i - lowbit(i)];
  }

  // freq[v] += d: the walk up from node v + 1.
  __device__ __forceinline__ void add(int v, int d) const {
    for (int i = v + 1; i <= kNodes; i += lowbit(i)) node(i) += d;
  }
};

}  // namespace rxt
