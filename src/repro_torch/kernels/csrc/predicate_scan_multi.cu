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
// N = 1024, B = 8192, Q = 64 about 168 MB, some 50 µs at 3.35 TB/s, where
// re-reading the column per row would move 2.15 GB.
// Design: one thread block per column block n.  It computes the block's W
// packed comparison words once, one warp per word with __ballot_sync as in
// predicate_scan, into shared memory (1 KiB at B = 8192), then ANDs them
// into each of the Q input rows of that block, one warp per row, reducing
// each row's popcount by warp shuffles.  A block dead in every row writes
// zeros and reads no column; a dead row (q, n) writes zeros and reads no
// bits.
#include "common.cuh"

namespace {

__global__ void __launch_bounds__(rt::kThreads)
predicate_scan_multi_kernel(const float* __restrict__ col,
                            const int* __restrict__ bits,
                            const int* __restrict__ pops_in, float value,
                            int opcode, int q, int n_blocks, int w,
                            int* __restrict__ out,
                            int* __restrict__ pops_out) {
  extern __shared__ unsigned hit[];
  const int n = blockIdx.x;
  if (rt::any_row_live(pops_in, q, n_blocks, n)) {
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const float* col_row = col + (long long)n * w * 32;
    for (int i = warp; i < w; i += rt::kWarps) {
      const bool h =
          rt::compare(__ldg(col_row + (long long)i * 32 + lane), value, opcode);
      const unsigned word = __ballot_sync(0xffffffffu, h);
      if (lane == 0) hit[i] = word;
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
        col, bits, pops_in, value, opcode, q, n, w, out, pops_out);
  }
  return (int)cudaGetLastError();
}
