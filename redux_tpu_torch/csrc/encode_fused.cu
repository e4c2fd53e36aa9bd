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
// Design: one CTA codes a group of 32 blocks, producer and consumer warps:
// - kModelWarps model warps run K1's chunk step (rxt::model_chunk, 32
//   positions a warp step) on chunk c + 1 of each block of the group, block
//   j on warp j % kModelWarps, one block after the other (the next step's
//   symbols loaded one step ahead), and write its lo/hi into one half of a
//   double-buffered tile in shared memory;
// - one coder warp codes chunk c from the other half: lane j codes block j
//   with K2's step (rxt::Coder, reciprocal quotients, rxt::Count), so each
//   block's chain runs in exactly one lane.  Lane j reads position p at
//   tile[p * 33 + j]: a row stride of 33 words puts the 32 lanes on 32
//   banks, and the model warp's 32 lanes writing block j's 32 positions hit
//   32 banks too.
// The halves change hands through named barriers: the model warps arrive
// on FULL[b] once half b holds a chunk and the coder syncs on it; the coder
// arrives on EMPTY[b] once it has coded half b and the model warps sync on
// it before they refill it.  Shared memory a CTA: 32 rows of 288 ints, a
// histogram a model warp and 2 x 2 x 32 x 33 ints of tile, 57,216 bytes
// (dynamic, over the 48 KB static limit): 4 CTAs an SM with the 1 KB a CTA
// the card reserves, so the 512 CTAs of 64 MiB are all resident at once.
// Three model warps is the most that keeps 4 CTAs an SM; two left the
// model behind the coder, four cost a second wave.  The (B, K) lo/hi
// planes that K1 writes and K2 reads back (8 bytes each way per input
// byte) never exist: the kernel reads 1 byte a symbol.
// What bounds it: the model warps' latency.  A chunk step is K1's work for
// one block (about 500 instructions, much of it shuffles and shared memory
// round trips) and a model warp runs 11 of them a chunk in turn; with 3 or
// 4 warps a scheduler little of that latency hides.  The coder warp's
// chain (K2's) runs beside it and is the shorter of the two.
#include "common.cuh"

namespace {

constexpr int kGroupBlocks = 32;  // blocks a CTA: one coder lane each
constexpr int kModelWarps = 3;
constexpr int kThreads = 32 * (kModelWarps + 1);
constexpr int kStride = 33;             // tile row stride in ints: one row a position
constexpr int kPlane = 32 * kStride;    // lo or hi of one half
constexpr int kSmemBytes = 4 * (kGroupBlocks * rxt::kSlots + kModelWarps * rxt::kSlots +
                                2 * 2 * kPlane);
constexpr int kFullBar = 1;   // + half: the half holds a chunk (barrier 0 is __syncthreads)
constexpr int kEmptyBar = 3;  // + half: the half is free again

__global__ void __launch_bounds__(kThreads)
encode_fused_kernel(const uint8_t* __restrict__ syms, const int32_t* __restrict__ lens,
                    const int32_t* __restrict__ init_cum, uint32_t* __restrict__ words,
                    int32_t* __restrict__ byte_lens, uint8_t* __restrict__ ovf_out, int B, int K,
                    int n_words, int delta, int freq_max, int cb) {
  extern __shared__ int smem[];
  int* rows = smem;
  int* hist = rows + kGroupBlocks * rxt::kSlots;
  int* tile = hist + kModelWarps * rxt::kSlots;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int base = blockIdx.x * kGroupBlocks;
  for (int i = threadIdx.x; i < kGroupBlocks * rxt::kSlots; i += kThreads) {
    const int e = i % rxt::kSlots;
    rows[i] = e < rxt::kRow ? init_cum[e] : 0;
  }
  for (int i = threadIdx.x; i < kModelWarps * rxt::kSlots; i += kThreads) hist[i] = 0;
  const int init_total = init_cum[rxt::kRow - 1];
  const int tfreeze = rxt::freeze_point(init_total, freq_max, delta);
  // Lane j's view of block j of the group: its length, -1 past B.
  int len = base + lane < B ? lens[base + lane] : -1;
  len = len > K ? K : len;
  int max_len = len;
#pragma unroll
  for (int d = 16; d > 0; d >>= 1) {
    const int y = __shfl_xor_sync(rxt::kFull, max_len, d);
    max_len = max_len > y ? max_len : y;
  }
  const int n_chunks = (max_len + 31) / 32;  // 0 when no block has a symbol
  __syncthreads();

  if (warp < kModelWarps) {
    int* H = hist + warp * rxt::kSlots;
    // One chunk step a block in turn, the next step's symbols loaded one
    // step ahead (its latency hides under this step).  The loop stays
    // rolled: 16 copies of the chunk step would not fit the instruction cache.
    int v_next = lane < __shfl_sync(rxt::kFull, len, warp)
                     ? syms[static_cast<size_t>(base + warp) * K + lane]
                     : 0;
    for (int c = 0; c < n_chunks; ++c) {
      const int half = c & 1;
      const int t0 = c * 32;
      if (c >= 2) rxt::bar_sync<kThreads>(kEmptyBar + half);
      int* tlo = tile + half * 2 * kPlane;
      int* thi = tlo + kPlane;
#pragma unroll 1
      for (int j = warp; j < kGroupBlocks; j += kModelWarps) {
        const int blen = __shfl_sync(rxt::kFull, len, j);
        const int v = v_next;
        const bool last = j + kModelWarps >= kGroupBlocks;
        const int jn = last ? warp : j + kModelWarps;  // the next step's block
        const int tn = (last ? t0 + 32 : t0) + lane;   // and position
        v_next = tn < __shfl_sync(rxt::kFull, len, jn)
                     ? syms[static_cast<size_t>(base + jn) * K + tn]
                     : 0;
        if (t0 >= blen) continue;  // uniform over the warp
        int n_act = (blen < tfreeze ? blen : tfreeze) - t0;
        n_act = n_act < 0 ? 0 : (n_act > 32 ? 32 : n_act);
        const int2 lohi = rxt::model_chunk(rows + j * rxt::kSlots, H, v, n_act, delta, lane);
        tlo[lane * kStride + j] = lohi.x;
        thi[lane * kStride + j] = lohi.y;
      }
      rxt::bar_arrive<kThreads>(kFullBar + half);
    }
  } else {
    const int blk = base + lane;
    uint32_t* row = words + static_cast<size_t>(blk < B ? blk : 0) * n_words;
    rxt::Coder coder(row, blk < B ? n_words : 0, cb);
    rxt::Count<true> count(init_total, delta, tfreeze);
    for (int c = 0; c < n_chunks; ++c) {
      const int half = c & 1;
      rxt::bar_sync<kThreads>(kFullBar + half);
      const int* tlo = tile + half * 2 * kPlane + lane;
      const int* thi = tlo + kPlane;
#pragma unroll 1
      for (int p0 = 0; p0 < 32; p0 += 8) {
        const int t = c * 32 + p0;
        if (t + 8 <= len) {  // the whole run is this block's: no guards
#pragma unroll
          for (int q = 0; q < 8; ++q) {
            coder.step<true>(static_cast<uint32_t>(tlo[(p0 + q) * kStride]),
                             static_cast<uint32_t>(thi[(p0 + q) * kStride]), count.c, count.rc);
            count.next();
          }
        } else {
#pragma unroll 1
          for (int q = 0; q < 8; ++q) {
            if (t + q < len) {
              coder.step<true>(static_cast<uint32_t>(tlo[(p0 + q) * kStride]),
                               static_cast<uint32_t>(thi[(p0 + q) * kStride]), count.c,
                               count.rc);
            }
            count.next();
          }
        }
      }
      if (c + 2 < n_chunks) rxt::bar_arrive<kThreads>(kEmptyBar + half);
    }
    if (blk < B) {
      if (len >= 0) coder.terminate();  // the terminator at t == lens
      coder.finish(row, n_words, byte_lens + blk, ovf_out + blk);
    }
  }
}

}  // namespace

RXT_API int rxt_encode_fused(const void* syms, const void* lens, const void* init_cum,
                             void* words, void* byte_lens, void* ovf, int B, int K,
                             int n_words, int delta, int freq_max, int code_bits, int device,
                             void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(encode_fused_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(encode_fused_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const int grid = (B + kGroupBlocks - 1) / kGroupBlocks;
  encode_fused_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(syms), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(init_cum), static_cast<uint32_t*>(words),
      static_cast<int32_t*>(byte_lens), static_cast<uint8_t*>(ovf), B, K, n_words, delta,
      freq_max, code_bits);
  return cudaGetLastError();
}
