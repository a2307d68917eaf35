// predicate_scan_multi: bits of (col OP value) ∧ D_q for Q stacked record
// sets D_q against one column, plus each output row's popcount.
//
// Replaces the TPU kernel src/repro/kernels/predicate_scan.py,
// predicate_scan_multi (its pallas_call runs a (Q * N,) grid whose step k
// re-reads column block k % N: Q reads of the whole column).
//
// Bound on an H100: bytes.  The column blocks that are live in any row are
// read once (B * 4 bytes each), every live input row's W words once, and
// Q * N * W output words plus 2 * Q * N popcounts are written: at
// N = 1024, B = 8192 about 15 us at Q = 8 and 50 us at Q = 64 at
// 3.35 TB/s, where re-reading the column per row would move Q times the
// column.
// Design: one thread block per column block n, in two phases.
//  1. Hit words: the block's W packed comparison words, computed once into
//     shared memory (1 KiB at B = 8192) by the compare-and-pack step that
//     fused_chain_scan and predicate_scan use (rt::pack_words32): each
//     lane loads 4 records as one float4, a 512-byte warp load covers 4
//     words, and all loads of a step are issued before any compare.
//  2. Rows: rt::and_hits_into_rows ANDs the hit words into each of the Q
//     input rows of that block, one warp per row, 16 bytes a lane when
//     W % 4 == 0 (one warp load covers 128 words), all of a pass's loads
//     issued before the ANDs, and each row's popcount reduced by warp
//     shuffles.
// At Q = 8 the column is two thirds of the bytes and phase 1 sets the
// pace; at Q = 64 phase 2 does.  A block dead in every row writes zeros
// and reads no column; a dead row (q, n) writes zeros and reads neither
// its bits nor the hit words.  The column must be 16-byte aligned (the
// wrapper checks).
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(rt::kThreads, 8)
predicate_scan_multi_kernel(const float4* __restrict__ col,
                            const int* __restrict__ bits,
                            const int* __restrict__ pops_in, float value,
                            int mask, int q, int n_blocks, int w,
                            int* __restrict__ out,
                            int* __restrict__ pops_out) {
  extern __shared__ __align__(16) unsigned hit[];
  const int n = blockIdx.x;
  if (rt::any_row_live(pops_in, q, n_blocks, n)) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const long long row = (long long)n * w;
    for (int base = warp * 32; base < w; base += rt::kThreads) {
      // every word of the block is computed: some live row may need it
      const int words = rt::pack_words32(
          base + lane < w ? -1 : 0, base, w, row + base,
          [&](bool load, long long f4) {
            const float4 x = load ? __ldg(col + f4) : make_float4(0, 0, 0, 0);
            return rt::nibble(x, value, mask);
          });
      if (base + lane < w) hit[base + lane] = (unsigned)words;
    }
    __syncthreads();
  }
  rt::and_hits_into_rows(hit, bits, pops_in, q, n_blocks, n, w, out,
                         pops_out);
}

}  // namespace

extern "C" int rt_predicate_scan_multi(const float* col, const int* bits,
                                       const int* pops_in, float value,
                                       int opcode, int q, int n, int w,
                                       int* out, int* pops_out,
                                       void* stream) {
  if (n > 0 && q > 0) {
    predicate_scan_multi_kernel<<<n, rt::kThreads, w * sizeof(unsigned),
                                  (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(col), bits, pops_in, value,
        rt::compare_mask(opcode), q, n, w, out, pops_out);
  }
  return (int)cudaGetLastError();
}
