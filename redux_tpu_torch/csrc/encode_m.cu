// K5: the model-in-kernel encoder, an independent derivation of K2's streams.
//
// Replaces redux_tpu/ops/pallas_encode.py::_encode_kernel_m (step at
// :609-709, launched by _encode_pallas_m_jit at :823; entries
// encode_blocks_pallas_m and parallel/mesh.py::encode_blocks_pallas_m_sharded).
// Per block b and position t < lens[b]:
//   flo = cdf[v], fhi = cdf[v+1]   (v = syms[b,t], before the update)
//   count = tot (the running total, before the update)
//   while tot < freq_max: freq[v] += delta, tot += delta   (the freeze at :629;
//   tot overshoots to at most freq_max + delta - 1, within int32)
//   code (flo, fhi) over count
// then the v2 terminator at t == lens[b] (none for lens < 0, a pad lane).
// Output: K2's triple (words, byte_lens, ovf), bit for bit.
//
// Design: a CTA codes 128 blocks with 4 model warps and 4 coder warps, the
// model a round ahead of the coder.  The block's model is rxt::Fenwick
// (common.cuh, the layout K3 uses), kept apart from K1/K4's warp-held row:
// a Fenwick tree of its 257 frequencies in shared memory, one column a
// block.
// - Model warp w: lane j runs block 32w + j's model, kGroup positions a
//   round, and writes each position's (flo, fhi) into one half of a
//   double-buffered tile.  The round's symbols came in one load (16 bytes
//   when the rows are 16-byte aligned, byte loads otherwise) during the
//   round before.  Every node a symbol touches follows from v alone: both
//   bounds read the nodes of v's set bits under predicates
//   (Fenwick::prefix) and node v + 1, the first of the update walk's 9
//   nodes, which are v's zero bits in closed form (Fenwick::load_walk);
//   all load together, in one round of shared-memory latency.  The update
//   stores each walk node + d, d = delta while the position is in the
//   block and tot < freq_max, else 0 (Fenwick::store_walk).  No branch and
//   no loop whose trip count depends on the data: a round is straight-line
//   code.
// - Coder warp 4 + w: lane j codes block 32w + j from the other half with
//   K2's step (rxt::Coder, the kFits53 step: the parameters K5 takes,
//   fits_u32 or fits_wide32, keep every dividend below 2^53) over its own
//   copy of the running total, which moves by d the same way with no
//   branch.  kRun bounds at a time come into registers and their steps run
//   as straight-line code (K2's 8; runs of 16 measured 10% slower at
//   16384 blocks); the block's last round is guarded.
// The halves change hands through named barriers: the model warps arrive
// on FULL[h] once half h holds a round and the coder warps sync on it; the
// coder warps arrive on EMPTY[h] once they have coded half h and the model
// warps sync on it before refilling it.  Entry (h, p) of block x sits at
// tile[(h * kGroup + p) * 128 + x]: a warp's 32 lanes touch 32 consecutive
// int2, no bank conflict.
// Why 4 + 4 warps: an SM issues from 4 schedulers and integer instructions
// take 2 of a scheduler's cycles (16 lanes each).  With one model and one
// coder warp a CTA, 1.3x slower at 16384 blocks, the warps appear to land
// by slot, every model warp on schedulers 0 and 2 and every coder warp on
// 1 and 3, two coder chains a scheduler; 4 + 4 give each scheduler one of
// each.  Shared memory a CTA: the trees (131,584 bytes) and 2 x 16 x 128
// int2 of tile (32,768), 164,352 bytes (dynamic): one CTA an SM, and the
// 128 CTAs of 64 MiB are all resident at once.
// What bounds it: the schedulers' issue.  Each position costs a model step
// (about 130 SASS instructions, a third of them address arithmetic) and a
// coder step (K2's, about 200, mostly dependent) on one scheduler.
#include "common.cuh"

namespace {

using rxt::kNodes;
constexpr int kPairs = 4;               // model warps, and as many coder warps
constexpr int kBlocks = 32 * kPairs;    // blocks a CTA: a model lane and a coder lane each
constexpr int kThreads = 2 * kBlocks;   // the model warps, then the coder warps
constexpr int kGroup = 16;              // positions a round: symbols a load
constexpr int kRun = 8;                 // coder steps of straight-line code
constexpr int kFullBar = 1;   // + half: the half holds a round (barrier 0 is __syncthreads)
constexpr int kEmptyBar = 3;  // + half: the half is free again
constexpr int kTreeInts = kNodes * kBlocks;
constexpr int kSmemBytes = 4 * kTreeInts + 8 * 2 * kGroup * kBlocks;

struct Syms {
  uint32_t w[kGroup / 4];  // kGroup symbols, little-endian

  __device__ __forceinline__ int at(int j) const { return (w[j >> 2] >> (8 * (j & 3))) & 0xFF; }
};

// Symbols t .. t + kGroup - 1 of a block's row, those below len (zeros
// past it); vec: the rows are 16-byte aligned, so t (a multiple of kGroup)
// is too.
__device__ __forceinline__ Syms load_syms(const uint8_t* __restrict__ srow, int t, int len,
                                          bool vec) {
  Syms s{};
  if (t + kGroup <= len && vec) {
    const uint4 q = *reinterpret_cast<const uint4*>(srow + t);
    s.w[0] = q.x, s.w[1] = q.y, s.w[2] = q.z, s.w[3] = q.w;
  } else {
#pragma unroll
    for (int j = 0; j < kGroup; ++j) {
      if (t + j < len) s.w[j >> 2] |= static_cast<uint32_t>(srow[t + j]) << (8 * (j & 3));
    }
  }
  return s;
}

__global__ void __launch_bounds__(kThreads)
encode_m_kernel(const uint8_t* __restrict__ syms, const int32_t* __restrict__ lens,
                const int32_t* __restrict__ init_cum, uint32_t* __restrict__ words,
                int32_t* __restrict__ byte_lens, uint8_t* __restrict__ ovf_out, int B, int K,
                int n_words, int delta, int freq_max, int cb, bool vec) {
  extern __shared__ int smem[];
  int* tree = smem;
  int2* tile = reinterpret_cast<int2*>(tree + kTreeInts);
  __shared__ int warp_max[kPairs];
  const int x = threadIdx.x % kBlocks;  // the lane's block in the CTA
  const int blk = blockIdx.x * kBlocks + x;
  int len = blk < B ? lens[blk] : -1;  // -1 past B
  len = len > K ? K : len;
  const int m = __reduce_max_sync(rxt::kFull, len);
  if (threadIdx.x < kBlocks && x % 32 == 0) warp_max[x / 32] = m;
  __syncthreads();
  int max_len = warp_max[0];
#pragma unroll
  for (int w = 1; w < kPairs; ++w) max_len = max_len > warp_max[w] ? max_len : warp_max[w];
  const int n_rounds = (max_len + kGroup - 1) / kGroup;  // 0 when no block has a symbol
  const int init_total = init_cum[kNodes];
  if (threadIdx.x < kBlocks) {
    const rxt::Fenwick<kBlocks> fw{tree + x};
    fw.init(init_cum);
    const int base = init_cum[0];
    int tot = init_total;
    const uint8_t* srow = syms + static_cast<size_t>(blk < B ? blk : 0) * K;
    Syms next = load_syms(srow, 0, len, vec);
    for (int r = 0; r < n_rounds; ++r) {
      const int h = r & 1;
      const int t0 = r * kGroup;
      const Syms cur = next;
      next = load_syms(srow, t0 + kGroup, len, vec);  // in flight during this round
      if (r >= 2) rxt::bar_sync<kThreads>(kEmptyBar + h);
      int2* half = tile + h * kGroup * kBlocks + x;
#pragma unroll
      for (int j = 0; j < kGroup; ++j) {
        const int v = cur.at(j);
        int low;
        const int flo = base + fw.prefix(v, low);
        const rxt::Walk up = fw.load_walk(v);
        // fhi = flo + freq(v): node v + 1 less v's trailing-ones terms
        half[j * kBlocks] = make_int2(flo, flo + up.v[0] - low);
        const int d = t0 + j < len && tot < freq_max ? delta : 0;
        fw.store_walk(up, d);
        tot += d;
      }
      rxt::bar_arrive<kThreads>(kFullBar + h);
    }
  } else {
    uint32_t* row = words + static_cast<size_t>(blk < B ? blk : 0) * n_words;
    rxt::Coder coder(row, blk < B ? n_words : 0, cb);
    int tot = init_total;
    double rc = __drcp_rn(static_cast<double>(tot));
    // Codes one position over the total before the update, then moves the
    // total by d and takes the next position's reciprocal, with no branch.
    const auto step = [&](int2 b) {
      coder.step<true>(static_cast<uint32_t>(b.x), static_cast<uint32_t>(b.y),
                       static_cast<uint32_t>(tot), rc);
      tot += tot < freq_max ? delta : 0;
      rc = __drcp_rn(static_cast<double>(tot));
    };
    for (int r = 0; r < n_rounds; ++r) {
      const int h = r & 1;
      const int t0 = r * kGroup;
      const int2* half = tile + h * kGroup * kBlocks + x;
      rxt::bar_sync<kThreads>(kFullBar + h);
      if (t0 + kGroup <= len) {  // the whole round is this block's: no guards
#pragma unroll 1
        for (int p0 = 0; p0 < kGroup; p0 += kRun) {
          int2 b[kRun];
#pragma unroll
          for (int j = 0; j < kRun; ++j) b[j] = half[(p0 + j) * kBlocks];
#pragma unroll
          for (int j = 0; j < kRun; ++j) step(b[j]);
        }
      } else {
#pragma unroll 1
        for (int j = 0; j < kGroup; ++j) {
          if (t0 + j < len) step(half[j * kBlocks]);
        }
      }
      if (r + 2 < n_rounds) rxt::bar_arrive<kThreads>(kEmptyBar + h);
    }
    if (blk < B) {
      if (len >= 0) coder.terminate();  // the terminator at t == lens
      coder.finish(row, n_words, byte_lens + blk, ovf_out + blk);
    }
  }
}

}  // namespace

RXT_API int rxt_encode_m(const void* syms, const void* lens, const void* init_cum, void* words,
                         void* byte_lens, void* ovf, int B, int K, int n_words, int delta,
                         int freq_max, int code_bits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(encode_m_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kSmemBytes);
  if (err != cudaSuccess) return err;
  err = cudaFuncSetAttribute(encode_m_kernel, cudaFuncAttributePreferredSharedMemoryCarveout,
                             cudaSharedmemCarveoutMaxShared);
  if (err != cudaSuccess) return err;
  const bool vec = K % kGroup == 0 && reinterpret_cast<uintptr_t>(syms) % 16 == 0;
  const int grid = (B + kBlocks - 1) / kBlocks;
  encode_m_kernel<<<grid, kThreads, kSmemBytes, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(syms), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(init_cum), static_cast<uint32_t*>(words),
      static_cast<int32_t*>(byte_lens), static_cast<uint8_t*>(ovf), B, K, n_words, delta,
      freq_max, code_bits, vec);
  return cudaGetLastError();
}
