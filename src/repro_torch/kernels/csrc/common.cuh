// Shared device helpers for the bitmap kernels.
//
// Layouts (fixed for every kernel in this directory):
//   column  f32[N, B]   record-major: row n is block n, record r of the
//                       block at column r.  B = 32 * W.
//   bitmap  i32[N, W]   packed record set: record r of block n is bit
//                       r % 32 of word r / 32 (the reference's u32 words,
//                       held as int32 bit patterns).
//   pops    i32[N]      per-block popcount of a bitmap.
//
// The compare-and-pack step (pack_words32, below) is shared by every scan
// kernel, K1, K3 and K5 with a comparison and K4 and K6 with a code test:
// a warp owns 32 words of a row, each lane loads 4 records as one float4
// (a 512-byte warp load covers 4 words), and the 8 lanes of a word OR
// their 4-bit nibbles into it by shuffles.  Word w of a block starts at
// byte 128 * w of its row, so the column must be 16-byte aligned (the
// wrappers check).
//
// Built without --use_fast_math / -ftz: comparisons against denormals
// keep their IEEE meaning, and NaN compares false except under NE.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr unsigned kFull = 0xffffffffu;

// Load a kernel's module now: under lazy loading a kernel is loaded at its
// first use, and cudaFuncGetAttributes is one, so a CUDA graph capture is
// never the first use of a kernel (the rt_load_* entries; the wrappers'
// library loader calls them once).
template <class Kernel>
inline int load_kernel(Kernel* kernel) {
  cudaFuncAttributes attr;
  return (int)cudaFuncGetAttributes(&attr, kernel);
}

// opcode (LT, LE, GT, GE, EQ, NE; shared with repro_torch.kernels.ref) ->
// which of x < v, x == v, x > v and "unordered" (a NaN on either side)
// make the comparison true
__host__ __device__ __forceinline__ int compare_mask(int op) {
  switch (op) {
    case 0: return 1;          // <
    case 1: return 1 | 2;      // <=
    case 2: return 4;          // >
    case 3: return 4 | 2;      // >=
    case 4: return 2;          // ==
    default: return 1 | 4 | 8; // != (true on NaN)
  }
}

// branch-free: 1 iff x compares true against v under ``mask``
__device__ __forceinline__ int hit_bit(float x, float v, int mask) {
  int r = (int)(x < v) | ((int)(x == v) << 1) | ((int)(x > v) << 2);
  r |= (int)(r == 0) << 3;
  return (r & mask) != 0;
}

// the comparisons of 4 consecutive records as bits 0..3
__device__ __forceinline__ int nibble(float4 x, float v, int mask) {
  return hit_bit(x.x, v, mask) | (hit_bit(x.y, v, mask) << 1) |
         (hit_bit(x.z, v, mask) << 2) | (hit_bit(x.w, v, mask) << 3);
}

// The compare-and-pack step over a warp's 32 words base .. base + 31 of a
// row of W words; ``first`` is the column-wide index of word ``base``
// (row * W + base).  ``mine`` is lane i's input word for word base + i (0
// past W); lane i returns word base + i, ANDed with its input word.
//
// Each step covers 4 words: lane 8 * s + q handles records 4q..4q+3 of
// word u + s, whose float4 index in the column is (first + u + s) * 8 + q.
// ``nib(load, f4)`` returns their 4-bit nibble of hits; it must read no
// column when ``load`` is false (a zero input word: its 8 lanes skip
// their loads).  The 8 lanes of a word OR their nibbles by shuffles.
// Every lane of the warp must call it, with the same ``base``.
template <class Nib>
__device__ __forceinline__ int pack_words32(int mine, int base, int w,
                                            long long first, Nib nib) {
  const int lane = threadIdx.x & 31;
  const int s = lane >> 3;     // which of the step's 4 words
  const int q = lane & 7;      // which 4 records of that word
  int res = 0;
#pragma unroll
  for (int u = 0; u < 32; u += 4) {
    if (base + u >= w) break;                // warp-uniform
    const int in = __shfl_sync(kFull, mine, u + s);
    int word = nib(in != 0, (first + u + s) * 8 + q) << (4 * q);
    word |= __shfl_xor_sync(kFull, word, 1);
    word |= __shfl_xor_sync(kFull, word, 2);
    word |= __shfl_xor_sync(kFull, word, 4);
    word &= in;
    // lane u + t takes word u + t from the first lane of group t
    const int got = __shfl_sync(kFull, word, 8 * ((lane - u) & 3));
    if ((lane >> 2) == (u >> 2)) res = got;
  }
  return res;
}

// Sum one int per warp (held by lane 0 of each warp) across the block and
// store it from thread 0.  Every thread of the block must call it.
__device__ __forceinline__ void block_store_sum(int lane0_value, int* dst) {
  __shared__ int partial[kWarps];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  if (lane == 0) partial[warp] = lane0_value;
  __syncthreads();
  if (threadIdx.x == 0) {
    int s = 0;
#pragma unroll
    for (int i = 0; i < kWarps; ++i) s += partial[i];
    *dst = s;
  }
}

__device__ __forceinline__ int warp_sum(int v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) v += __shfl_down_sync(kFull, v, off);
  return v;
}

// A live column block n (K1, K3, K4): out row n = bits row n ∧ the hits that
// ``nib`` computes (see pack_words32), and its popcount into *pop_dst.
// Each warp reads 32 input words with one coalesced load and shuffles
// each to the lanes that need it.  Every thread of the block must call it.
template <class Nib>
__device__ __forceinline__ void scan_live_block(const int* __restrict__ bits,
                                                int n, int w,
                                                int* __restrict__ out,
                                                int* pop_dst, Nib nib) {
  const long long row = (long long)n * w;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  int count = 0;
  for (int base = warp * 32; base < w; base += kThreads) {
    const int mine = base + lane < w ? __ldg(bits + row + base + lane) : 0;
    const int res = pack_words32(mine, base, w, row + base, nib);
    if (base + lane < w) {
      out[row + base + lane] = res;
      count += __popc(res);
    }
  }
  block_store_sum(warp_sum(count), pop_dst);
}

// A dead block (input popcount 0) writes zero words and a zero popcount
// without reading its column: the counterpart of the reference's
// pl.when(pop > 0) skip.
__device__ __forceinline__ void write_dead_block(int* out_row, int w,
                                                 int* pop_dst) {
  for (int i = threadIdx.x; i < w; i += blockDim.x) out_row[i] = 0;
  if (threadIdx.x == 0) *pop_dst = 0;
}

// Q-stacked bitmaps (the lockstep kernels): i32[Q * N, W], query-major, so
// row q * N + n is block n of record set q; pops i32[Q * N] likewise.

// Is column block n live (input popcount > 0) in any of the q stacked rows?
// Every thread of the block must call it; the answer is block-uniform.
__device__ __forceinline__ bool any_row_live(const int* __restrict__ pops_in,
                                             int q, int n_blocks, int n) {
  int live = 0;
  for (int r = threadIdx.x; r < q; r += blockDim.x)
    live |= pops_in[(long long)r * n_blocks + n] != 0;
  return __syncthreads_or(live) != 0;
}

__device__ __forceinline__ int popc(int x) { return __popc(x); }
__device__ __forceinline__ int popc(int4 x) {
  return __popc(x.x) + __popc(x.y) + __popc(x.z) + __popc(x.w);
}
__device__ __forceinline__ int band(int a, int b) { return a & b; }
__device__ __forceinline__ int4 band(int4 a, int4 b) {
  return make_int4(a.x & b.x, a.y & b.y, a.z & b.z, a.w & b.w);
}
// x OP y for the set operations' opcodes (0 AND, 1 OR, 2 ANDNOT)
__device__ __forceinline__ int setop_word(int x, int y, int opcode) {
  return opcode == 0 ? (x & y) : opcode == 1 ? (x | y) : (x & ~y);
}
__device__ __forceinline__ int4 setop_word(int4 x, int4 y, int opcode) {
  return make_int4(setop_word(x.x, y.x, opcode), setop_word(x.y, y.y, opcode),
                   setop_word(x.z, y.z, opcode), setop_word(x.w, y.w, opcode));
}
template <class V> __device__ __forceinline__ V zero();
template <> __device__ __forceinline__ int zero<int>() { return 0; }
template <> __device__ __forceinline__ int4 zero<int4>() {
  return make_int4(0, 0, 0, 0);
}

// loads of a row a lane issues before its first AND: 2 int4 cover a
// 256-word row (B = 8192) in one pass
constexpr int kRowLoads = 2;

// One warp: out = bits ∧ hit over a row of ``nv`` vectors V (int4: 4
// words, or int: 1), returning this lane's popcount.  Each pass issues
// all of its kRowLoads loads per lane before any AND.  A dead row writes
// zeros and reads neither its bits nor ``hit``.
template <class V>
__device__ __forceinline__ int and_row(const V* __restrict__ bits,
                                       const V* hit, V* __restrict__ out,
                                       int nv, bool live) {
  const int lane = threadIdx.x & 31;
  int count = 0;
  for (int i0 = lane; i0 < nv; i0 += 32 * kRowLoads) {
    if (!live) {                             // warp-uniform
#pragma unroll
      for (int j = 0; j < kRowLoads; ++j)
        if (i0 + 32 * j < nv) out[i0 + 32 * j] = zero<V>();
      continue;
    }
    V x[kRowLoads];
#pragma unroll
    for (int j = 0; j < kRowLoads; ++j)
      x[j] = i0 + 32 * j < nv ? __ldg(bits + i0 + 32 * j) : zero<V>();
#pragma unroll
    for (int j = 0; j < kRowLoads; ++j) {
      if (i0 + 32 * j < nv) {
        const V y = band(x[j], hit[i0 + 32 * j]);
        out[i0 + 32 * j] = y;
        count += popc(y);
      }
    }
  }
  return count;
}

// vectors of each input a lane loads before it combines any (the set
// operations' row body): 2 int4, so a 256-word row (B = 8192) takes one
// pass and few registers, as in and_row; or 4 ints
template <class V> struct SetopLoads { static constexpr int value = 4; };
template <> struct SetopLoads<int4> { static constexpr int value = 2; };

// One warp: out = a OP b over a row of ``nv`` vectors V (int4: 4 words, or
// int: 1), returning this lane's popcount.  A row that is not read stands
// for zeros.
template <class V>
__device__ __forceinline__ int setop_vec(const V* __restrict__ a,
                                         const V* __restrict__ b,
                                         V* __restrict__ out, int nv,
                                         int opcode, bool read_a,
                                         bool read_b) {
  constexpr int kLoads = SetopLoads<V>::value;
  const int lane = threadIdx.x & 31;
  int count = 0;
  for (int i0 = lane; i0 < nv; i0 += 32 * kLoads) {
    V x[kLoads], y[kLoads];
#pragma unroll
    for (int t = 0; t < kLoads; ++t) {
      const int i = i0 + 32 * t;
      x[t] = (read_a && i < nv) ? __ldg(a + i) : zero<V>();
      y[t] = (read_b && i < nv) ? __ldg(b + i) : zero<V>();
    }
#pragma unroll
    for (int t = 0; t < kLoads; ++t) {
      const int i = i0 + 32 * t;
      if (i < nv) {
        const V v = setop_word(x[t], y[t], opcode);
        out[i] = v;
        count += popc(v);
      }
    }
  }
  return count;
}

// The set operations' row body (K2, per op and grouped): one warp writes
// out = a OP b over one row of W words and returns the row's popcount in
// lane 0.  ``a_live`` / ``b_live`` say whether each input row's popcount
// is non-zero; a dead row is all zeros, so it is not read: AND with either
// row dead, and ANDNOT with a dead, read no word; OR and ANDNOT with b
// dead, and OR with a dead, read only the live row.  Each lane keeps
// SetopLoads loads of each input in flight: 2 of 16 bytes when W % 4 == 0
// and the three rows are 16-byte aligned, else 4 of 4 bytes.  Every lane of
// the warp must call it.
__device__ __forceinline__ int setop_row(const int* __restrict__ a,
                                         const int* __restrict__ b,
                                         int* __restrict__ out, int w,
                                         int opcode, bool a_live,
                                         bool b_live) {
  const bool read_a = opcode == 0 ? (a_live && b_live) : a_live;
  const bool read_b = opcode == 1 ? b_live : (a_live && b_live);
  const bool vec = (w & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(a) | reinterpret_cast<uintptr_t>(b) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  const int count =
      vec ? setop_vec(reinterpret_cast<const int4*>(a),
                      reinterpret_cast<const int4*>(b),
                      reinterpret_cast<int4*>(out), w >> 2, opcode, read_a,
                      read_b)
          : setop_vec(a, b, out, w, opcode, read_a, read_b);
  return warp_sum(count);
}

// AND column block n's W packed hit words (``hit``, in shared memory,
// 16-byte aligned) into each of the q stacked input rows of that block,
// one warp per row, reducing the row's popcount by warp shuffles.  Row
// n * W words start 16-byte aligned only when W % 4 == 0 (and the
// tensors are): then each lane loads 16 bytes, so one warp load covers
// 128 words; otherwise 4 bytes.  A row whose input popcount is 0 writes
// zeros and reads neither its bits nor ``hit``.
__device__ __forceinline__ void and_hits_into_rows(
    const unsigned* hit, const int* __restrict__ bits,
    const int* __restrict__ pops_in, int q, int n_blocks, int n, int w,
    int* __restrict__ out, int* __restrict__ pops_out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool vec = (w & 3) == 0 &&
      ((reinterpret_cast<uintptr_t>(bits) |
        reinterpret_cast<uintptr_t>(out)) & 15) == 0;
  for (int r = warp; r < q; r += kWarps) {
    const long long row = (long long)r * n_blocks + n;
    const long long base = row * w;
    const bool live = pops_in[row] != 0;  // warp-uniform
    const int count =
        vec ? and_row(reinterpret_cast<const int4*>(bits + base),
                      reinterpret_cast<const int4*>(hit),
                      reinterpret_cast<int4*>(out + base), w >> 2, live)
            : and_row(bits + base, reinterpret_cast<const int*>(hit),
                      out + base, w, live);
    const int total = warp_sum(count);
    if (lane == 0) pops_out[row] = total;
  }
}

}  // namespace rt
