// Shared pieces of the port's kernels: the warp-held cumulative model row
// and the closed-form interval renormalisation.
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

}  // namespace rxt
