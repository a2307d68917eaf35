// dict_lookup_scan: is each record's int code in a packed hit set u32[U]?
// Codes < 0 or >= 32 * U miss; the hits are then ∧ D.  Also writes the
// output's per-block popcount.
//
// Replaces the TPU kernel src/repro/kernels/dict_lookup.py,
// dict_lookup_scan (which selects the mask word with an O(U) loop of
// lane-aligned compares, since the TPU has no cheap per-lane gather).
//
// Bound on an H100: bytes, as predicate_scan: per live block the code
// column's 128 bytes under each non-zero input word, the W input words,
// W output words and a popcount; the mask is 4 * U bytes read once.  At
// the main shape (N = 1024 blocks of 8192 records, every word live) about
// 10.6 us at 3.35 TB/s.  A warp that owns one word at a time keeps one
// 128-byte column load in flight behind the dependent load of its bitmap
// word, and reached 30 % of that bound.
// Design: predicate_scan's compare-and-pack step (rt::scan_live_block /
// rt::pack_words32 in common.cuh) with a code test in place of the
// comparison.  One thread block per code block; each warp owns 32 words,
// reads their input words with one coalesced load and shuffles each to
// the 8 lanes that need it; each lane loads 4 codes as one float4 (a
// 512-byte warp load covers 4 words), converts each with __float2int_rz
// (truncation toward zero, NaN to 0, saturating out of range, as the
// reference's f32 -> int32 conversion) and tests it against the mask; the
// 8 lanes OR their 4-bit nibbles into the word.  The mask is staged into
// shared memory once per live block and indexed directly (one shared load
// per code, whatever U; at U <= 32 every word has a bank of its own, so
// lanes reading one word get a broadcast and lanes reading different
// words hit different banks); above 48 KiB of mask it is read from global
// memory instead, with the same result.  U is a runtime size.  Each
// thread loads its first mask word beside the block's popcount, so the
// staging adds a barrier but no dependent load.  A dead block (input
// popcount 0) writes zeros without reading its column, and a zero input
// word skips its 128 column bytes.  The column must be 16-byte aligned
// (the wrapper checks).
//
// dict_lookup_scan_multi (below) is the Q-stacked form, replacing
// src/repro/kernels/dict_lookup.py, dict_lookup_scan_multi (whose grid
// re-reads code block k % N for each of the Q rows).  Bound: bytes, as
// predicate_scan_multi (the code blocks live in any row once, each live
// input row once, every output row and popcount once).  Design:
// predicate_scan_multi's two phases with the code test.  One thread block
// per code block n:
//  1. Hit words: the block's W hit words, computed once into shared
//     memory by the same compare-and-pack step as dict_lookup_scan, the
//     mask in shared memory after them.
//  2. Rows: rt::and_hits_into_rows (shared with predicate_scan_multi) ANDs
//     the hit words into each of the Q input rows of that block, one warp
//     per row, 16-byte row loads when W % 4 == 0.
// A block dead in every row reads no code, and a dead row (q, n) writes
// zeros and reads neither its bits nor the hit words.  At small Q most
// warps wait at the barrier between the phases, but the other blocks
// resident on the SM (8, the whole grid in one wave) keep its memory
// busy.  A single-pass form, in which each warp ANDs the 32 hit words it
// computed straight from its registers into the rows and the rows'
// popcounts meet in shared memory, measured slower on an H100 at every Q
// from 2 to 64 (by 1-2 us at Q = 3 and 15 us at Q = 64): at 32 registers
// a thread it spills, with more registers fewer than 8 blocks fit an SM,
// and it keeps 4 bytes of each row in flight per lane where the row phase
// here keeps 2 x 16.
#include "common.cuh"

namespace {

constexpr int kMaxSharedWords = 48 * 1024 / 4;

// Codes below this miss: 32 * U, or 2^31 when that is larger (every
// non-negative int32 code then has a mask bit).  A negative code is a
// large unsigned, so one unsigned compare tests both ends.
__host__ __device__ inline unsigned code_limit(int u) {
  return u >= (1 << 26) ? 0x80000000u : 32u * (unsigned)u;
}

// 1 iff the code x (an f32) is in the hit set ``m``
__device__ __forceinline__ int code_bit(float x, const unsigned* m,
                                        unsigned limit) {
  const unsigned code = (unsigned)__float2int_rz(x);
  return code < limit ? (int)((m[code >> 5] >> (code & 31)) & 1u) : 0;
}

// the code test of 4 consecutive records as bits 0..3
__device__ __forceinline__ int code_nibble(float4 x, const unsigned* m,
                                           unsigned limit) {
  return code_bit(x.x, m, limit) | (code_bit(x.y, m, limit) << 1) |
         (code_bit(x.z, m, limit) << 2) | (code_bit(x.w, m, limit) << 3);
}

// Thread i's mask word i, loaded before the block knows it is live, so
// that the load overlaps the popcount loads.
template <bool kShared>
__device__ __forceinline__ unsigned first_mask_word(
    const unsigned* __restrict__ mask, int u) {
  return kShared && (int)threadIdx.x < u ? __ldg(mask + threadIdx.x) : 0u;
}

// The mask a live block reads: staged into ``smask`` (kShared) from
// ``first`` and the rest of ``mask``, or ``mask`` itself.  Every thread of
// the block must call it.
template <bool kShared>
__device__ __forceinline__ const unsigned* stage_mask(
    const unsigned* __restrict__ mask, int u, unsigned first,
    unsigned* smask) {
  if (!kShared) return mask;
  if ((int)threadIdx.x < u) smask[threadIdx.x] = first;
  for (int j = threadIdx.x + blockDim.x; j < u; j += blockDim.x)
    smask[j] = __ldg(mask + j);
  __syncthreads();
  return smask;
}

// 8 resident blocks per SM: the whole 1024-block grid in one wave, as
// predicate_scan.  Dynamic shared memory (kShared): the U mask words.
template <bool kShared>
__global__ void __launch_bounds__(rt::kThreads, 8)
dict_lookup_kernel(const float4* __restrict__ col,
                   const int* __restrict__ bits,
                   const int* __restrict__ pops_in,
                   const unsigned* __restrict__ mask, int u, int w,
                   int* __restrict__ out, int* __restrict__ pops_out) {
  extern __shared__ __align__(16) unsigned smask[];
  const int n = blockIdx.x;
  const unsigned first = first_mask_word<kShared>(mask, u);
  if (pops_in[n] == 0) {
    rt::write_dead_block(out + (long long)n * w, w, pops_out + n);
    return;
  }
  const unsigned* m = stage_mask<kShared>(mask, u, first, smask);
  const unsigned limit = code_limit(u);
  rt::scan_live_block(bits, n, w, out, pops_out + n,
                      [&](bool load, long long f4) {
    return load ? code_nibble(__ldg(col + f4), m, limit) : 0;
  });
}

// Dynamic shared memory: the block's W hit words, then (kShared) the
// mask.
template <bool kShared>
__global__ void __launch_bounds__(rt::kThreads, 8)
dict_lookup_multi_kernel(const float4* __restrict__ col,
                         const int* __restrict__ bits,
                         const int* __restrict__ pops_in,
                         const unsigned* __restrict__ mask, int u, int q,
                         int n_blocks, int w, int* __restrict__ out,
                         int* __restrict__ pops_out) {
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* hit = smem;
  const int n = blockIdx.x;
  const unsigned first = first_mask_word<kShared>(mask, u);
  if (rt::any_row_live(pops_in, q, n_blocks, n)) {
    const unsigned* m = stage_mask<kShared>(mask, u, first, smem + w);
    const unsigned limit = code_limit(u);
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    for (int base = warp * 32; base < w; base += rt::kThreads) {
      // every word of the block is computed: some live row may need it
      const int words = rt::pack_words32(
          base + lane < w ? -1 : 0, base, w, (long long)n * w + base,
          [&](bool load, long long f4) {
            return load ? code_nibble(__ldg(col + f4), m, limit) : 0;
          });
      if (base + lane < w) hit[base + lane] = (unsigned)words;
    }
    __syncthreads();
  }
  rt::and_hits_into_rows(hit, bits, pops_in, q, n_blocks, n, w, out,
                         pops_out);
}

}  // namespace

extern "C" int rt_dict_lookup_scan_multi(const float* col, const int* bits,
                                         const int* pops_in,
                                         const unsigned* mask, int u, int q,
                                         int n, int w, int* out,
                                         int* pops_out, void* stream) {
  if (n > 0 && q > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const float4* c = reinterpret_cast<const float4*>(col);
    if (w + u <= kMaxSharedWords) {
      dict_lookup_multi_kernel<true>
          <<<n, rt::kThreads, (w + u) * sizeof(unsigned), s>>>(
              c, bits, pops_in, mask, u, q, n, w, out, pops_out);
    } else {
      dict_lookup_multi_kernel<false>
          <<<n, rt::kThreads, w * sizeof(unsigned), s>>>(
              c, bits, pops_in, mask, u, q, n, w, out, pops_out);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_dict_lookup_scan(const float* col, const int* bits,
                                   const int* pops_in, const unsigned* mask,
                                   int u, int n, int w, int* out,
                                   int* pops_out, void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    const float4* c = reinterpret_cast<const float4*>(col);
    if (u <= kMaxSharedWords) {
      dict_lookup_kernel<true><<<n, rt::kThreads, u * sizeof(unsigned), s>>>(
          c, bits, pops_in, mask, u, w, out, pops_out);
    } else {
      dict_lookup_kernel<false><<<n, rt::kThreads, 0, s>>>(
          c, bits, pops_in, mask, u, w, out, pops_out);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_load_dict_lookup() {
  const int rcs[] = {rt::load_kernel(dict_lookup_kernel<true>),
                     rt::load_kernel(dict_lookup_kernel<false>),
                     rt::load_kernel(dict_lookup_multi_kernel<true>),
                     rt::load_kernel(dict_lookup_multi_kernel<false>)};
  for (int rc : rcs)
    if (rc) return rc;
  return 0;
}
