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
// A warp owns one bitmap word at a time: lane i reads record w * 32 + i,
// so the 32 loads are one coalesced 128-byte transaction, and
// __ballot_sync returns the packed word with lane i in bit i.
//
// Built without --use_fast_math / -ftz: comparisons against denormals
// keep their IEEE meaning, and NaN compares false except under NE.
#pragma once

#include <cuda_runtime.h>
#include <stdint.h>

namespace rt {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

// opcodes shared with repro_torch.kernels.ref (LT, LE, GT, GE, EQ, NE)
__device__ __forceinline__ bool compare(float x, float v, int op) {
  switch (op) {
    case 0: return x < v;
    case 1: return x <= v;
    case 2: return x > v;
    case 3: return x >= v;
    case 4: return x == v;
    default: return x != v;
  }
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

// AND column block n's W packed hit words (``hit``, in shared memory) into
// each of the q stacked input rows of that block, one warp per row: 32
// lanes read 32 consecutive words, and the row's popcount is reduced by
// warp shuffles.  A row whose input popcount is 0 writes zeros and reads
// neither its bits nor ``hit``.
__device__ __forceinline__ void and_hits_into_rows(
    const unsigned* hit, const int* __restrict__ bits,
    const int* __restrict__ pops_in, int q, int n_blocks, int n, int w,
    int* __restrict__ out, int* __restrict__ pops_out) {
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  for (int r = warp; r < q; r += kWarps) {
    const long long row = (long long)r * n_blocks + n;
    const long long base = row * w;
    const bool live = pops_in[row] != 0;  // warp-uniform
    int count = 0;
    for (int i = lane; i < w; i += 32) {
      const int word = live ? (__ldg(bits + base + i) & (int)hit[i]) : 0;
      out[base + i] = word;
      count += __popc(word);
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1)
      count += __shfl_down_sync(0xffffffffu, count, off);
    if (lane == 0) pops_out[row] = count;
  }
}

}  // namespace rt
