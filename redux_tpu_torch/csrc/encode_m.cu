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
// Design: one thread per block, kept apart from K1/K4's warp-held row.  The
// block's model is rxt::Fenwick (common.cuh, shared with K3): a Fenwick
// tree of its 257 frequencies in shared memory, one column a thread.  One
// walk down the shared path gives both bounds (at most 9 + 9 reads), and
// +delta on freq[v] is at most 9 writes.  The total is a register, and
// its reciprocal for the next symbol is taken with the update.  The coder
// step and the emission are rxt::Coder (common.cuh), shared with K2 and K4:
// the kFits53 step, since the parameters K5 takes (fits_u32 or
// fits_wide32) keep every dividend below 2^53.
// What bounds it: one thread's serial chain a symbol (the dependent shared
// memory walk, then K2's coder step); 33 KB of
// shared memory a CTA of 32 blocks, so up to 6 CTAs an SM and 16384 blocks
// for 64 MiB all resident at once.
#include "common.cuh"

namespace {

using rxt::kNodes;
using rxt::lowbit;
constexpr int kThreads = rxt::kTreeThreads;

__global__ void encode_m_kernel(const uint8_t* __restrict__ syms,
                                const int32_t* __restrict__ lens,
                                const int32_t* __restrict__ init_cum,
                                uint32_t* __restrict__ words, int32_t* __restrict__ byte_lens,
                                uint8_t* __restrict__ ovf_out, int B, int K, int n_words,
                                int delta, int freq_max, int cb) {
  __shared__ int tree[rxt::kTreeInts];
  const int x = threadIdx.x;
  const int blk = blockIdx.x * kThreads + x;
  if (blk >= B) return;  // no barrier below: each thread owns its tree
  const rxt::Fenwick fw{tree + x};
  fw.init(init_cum);
  const int base = init_cum[0];
  int tot = init_cum[kNodes];
  double rc = __drcp_rn(static_cast<double>(tot));
  int len = lens[blk];
  len = len > K ? K : len;
  const uint8_t* srow = syms + static_cast<size_t>(blk) * K;
  uint32_t* row = words + static_cast<size_t>(blk) * n_words;
  rxt::Coder coder(row, n_words, cb);
  for (int t = 0; t < len; ++t) {
    const int v = srow[t];
    // Shared-path walk: h climbs from v + 1 and l from v until they meet;
    // below the meeting node both prefixes share the same nodes.
    int h = v + 1, l = v, sum_h = 0, sum_l = 0;
    while (h != l) {
      if (h > l) {
        sum_h += fw.node(h);
        h -= lowbit(h);
      } else {
        sum_l += fw.node(l);
        l -= lowbit(l);
      }
    }
    int common = base;
    for (int i = h; i > 0; i -= lowbit(i)) common += fw.node(i);
    const int count = tot;
    const double rcount = rc;
    if (tot < freq_max) {
      fw.add(v, delta);
      tot += delta;
      rc = __drcp_rn(static_cast<double>(tot));  // for the next symbol
    }
    coder.step<true>(static_cast<uint32_t>(common + sum_l), static_cast<uint32_t>(common + sum_h),
                     static_cast<uint32_t>(count), rcount);
  }
  if (len >= 0) coder.terminate();  // the terminator at t == lens
  coder.finish(row, n_words, byte_lens + blk, ovf_out + blk);
}

}  // namespace

RXT_API int rxt_encode_m(const void* syms, const void* lens, const void* init_cum, void* words,
                         void* byte_lens, void* ovf, int B, int K, int n_words, int delta,
                         int freq_max, int code_bits, int device, void* stream) {
  cudaError_t err = cudaSetDevice(device);
  if (err != cudaSuccess) return err;
  const int grid = (B + kThreads - 1) / kThreads;
  encode_m_kernel<<<grid, kThreads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(syms), static_cast<const int32_t*>(lens),
      static_cast<const int32_t*>(init_cum), static_cast<uint32_t*>(words),
      static_cast<int32_t*>(byte_lens), static_cast<uint8_t*>(ovf), B, K, n_words, delta,
      freq_max, code_bits);
  return cudaGetLastError();
}
