// bitmap_setop: AND / OR / ANDNOT of two packed bitmaps, plus the result's
// per-block popcount.
//
// Replaces the TPU kernel src/repro/kernels/bitmap_ops.py, bitmap_setop.
//
// Bound on an H100: bytes (two input words read and one written per word,
// one popcount per block).  At the tape's shapes that is about 3 MiB, which
// the card moves in about a microsecond: the kernel is bound by its launch.
// Design: one thread block per row, one thread per word (a grid-stride
// loop covers W > 256), coalesced loads, and the popcount reduced by warp
// shuffles and one shared-memory step in the same pass.
//
// Two stacked forms serve the lockstep executor.  They replace jnp code of
// the reference's src/repro/columnar/device.py, not Pallas kernels:
//   bitmap_inter_multi   (_inter_multi_impl) one set a i32[N, W] ANDed into
//                        Q stacked sets i32[Q * N, W]: row r reads a's row
//                        r % N.  Bound: bytes, as above, over Q * N rows.
//   bitmap_union_reduce  (_union_impl) OR of Q stacked sets into one
//                        i32[N, W]: one thread block per block n, each
//                        thread ORs its word over the Q rows.  Bound: bytes
//                        (Q * N * W words read, N * W written).
// Both fuse the popcount as bitmap_setop does.
#include "common.cuh"

namespace {

// Row r of the output is (a row r % a_rows) OP (b row r).
__global__ void __launch_bounds__(rt::kThreads)
bitmap_setop_kernel(const int* __restrict__ a, const int* __restrict__ b,
                    int opcode, int a_rows, int w, int* __restrict__ out,
                    int* __restrict__ pops_out) {
  const int n = blockIdx.x;
  const long long row = (long long)n * w;
  const long long arow = (long long)(n % a_rows) * w;
  int count = 0;
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    const int x = a[arow + i];
    const int y = b[row + i];
    const int r = opcode == 0 ? (x & y) : opcode == 1 ? (x | y) : (x & ~y);
    out[row + i] = r;
    count += __popc(r);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  rt::block_store_sum(count, pops_out + n);
}

__global__ void __launch_bounds__(rt::kThreads)
bitmap_union_reduce_kernel(const int* __restrict__ bits, int q,
                           int n_blocks, int w, int* __restrict__ out,
                           int* __restrict__ pops_out) {
  const int n = blockIdx.x;
  const long long row = (long long)n * w;
  const long long stride = (long long)n_blocks * w;
  int count = 0;
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    int r = 0;
    for (int j = 0; j < q; ++j) r |= __ldg(bits + j * stride + row + i);
    out[row + i] = r;
    count += __popc(r);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  rt::block_store_sum(count, pops_out + n);
}

}  // namespace

extern "C" int rt_bitmap_setop(const int* a, const int* b, int opcode, int n,
                               int w, int* out, int* pops_out, void* stream) {
  if (n > 0) {
    bitmap_setop_kernel<<<n, rt::kThreads, 0, (cudaStream_t)stream>>>(
        a, b, opcode, n, w, out, pops_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_bitmap_inter_multi(const int* a, const int* bits, int q,
                                     int n, int w, int* out, int* pops_out,
                                     void* stream) {
  if (n > 0 && q > 0) {
    bitmap_setop_kernel<<<q * n, rt::kThreads, 0, (cudaStream_t)stream>>>(
        a, bits, 0, n, w, out, pops_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_bitmap_union_reduce(const int* bits, int q, int n, int w,
                                      int* out, int* pops_out,
                                      void* stream) {
  if (n > 0) {
    bitmap_union_reduce_kernel<<<n, rt::kThreads, 0, (cudaStream_t)stream>>>(
        bits, q, n, w, out, pops_out);
  }
  return (int)cudaGetLastError();
}
