// bitmap_setop: AND / OR / ANDNOT of two packed bitmaps, plus the result's
// per-block popcount.
//
// Replaces the TPU kernel src/repro/kernels/bitmap_ops.py, bitmap_setop.
//
// Bound on an H100: bytes.  Two input rows are read and one row and one
// popcount written per block; the input popcounts add 8 bytes per block
// and decide rows without their words: a dead row (popcount 0) is all
// zeros, so AND with either row dead, and ANDNOT with a dead, write zeros
// and read no word; OR and ANDNOT with b dead, and OR with a dead, read
// only the live row.  At the tape's shapes that is at most about 3 MiB,
// which the card moves in about a microsecond: launched alone, the kernel
// is bound by the launch's fixed part, which the tape path removes by
// replaying its whole tape as one CUDA graph (columnar/device.py).
// Design: one warp per row (rt::setop_row in common.cuh, which the
// grouped kernel shares): each lane keeps four loads of each input in
// flight, 16 bytes each when W % 4 == 0 and the rows are aligned; the
// popcount is reduced by warp shuffles only.  The operands and the input
// popcounts are the kernel's parameters: no table, so no dependent load
// before the first word.  The popcounts must be the rows' exact popcounts
// (every set the device backend holds has them).
//
// bitmap_setop_grouped: G independent set operations of the same shape in
// one launch, for the lockstep and stream paths, whose BestD set algebra
// is thousands of small operations per batch: launched one by one, each
// cost about 7 us on the card and 50-130 us of host time.  The device
// backend defers them and launches one grouped kernel per dependency
// level.  The launch reads a device table of G records (a, b, out,
// a_pops, b_pops, out_pops, opcode; int64 each), and one warp owns one
// (op, row): row r of the grid is block r % N of op r / N, with the same
// row body as bitmap_setop.  Bound: bytes, as above; the dense case (every
// row live) is G * (3 * N * W * 4 + 3 * N * 4) bytes.
//
// Two stacked forms serve the lockstep executor.  They replace jnp code of
// the reference's src/repro/columnar/device.py, not Pallas kernels:
//   bitmap_inter_multi   (_inter_multi_impl) one set a i32[N, W] ANDed into
//                        Q stacked sets i32[Q * N, W]: one thread block per
//                        row, row r reads a's row r % N.  Bound: bytes, as
//                        above, over Q * N rows.
//   bitmap_union_reduce  (_union_impl) OR of Q stacked sets into one
//                        i32[N, W]: one thread block per block n, each
//                        thread ORs its word over the Q rows.  Bound: bytes
//                        (Q * N * W words read, N * W written).
// Both fuse the popcount, reduced by warp shuffles and one shared-memory
// step.
#include "common.cuh"

namespace {

// Row r: out = a OP b, one warp per row.
__global__ void __launch_bounds__(rt::kThreads)
bitmap_setop_kernel(const int* __restrict__ a, const int* __restrict__ a_pops,
                    const int* __restrict__ b, const int* __restrict__ b_pops,
                    int opcode, int n_rows, int w, int* __restrict__ out,
                    int* __restrict__ pops_out) {
  const int r = blockIdx.x * rt::kWarps + (threadIdx.x >> 5);
  if (r >= n_rows) return;  // warp-uniform; nothing below syncs the block
  const long long base = (long long)r * w;
  const int count = rt::setop_row(a + base, b + base, out + base, w, opcode,
                                  __ldg(a_pops + r) != 0,
                                  __ldg(b_pops + r) != 0);
  if ((threadIdx.x & 31) == 0) pops_out[r] = count;
}

// bitmap_inter_multi: row r of the output is (a row r % a_rows) AND (bits
// row r), one thread block per row.
__global__ void __launch_bounds__(rt::kThreads)
inter_multi_kernel(const int* __restrict__ a, const int* __restrict__ bits,
                   int a_rows, int w, int* __restrict__ out,
                   int* __restrict__ pops_out) {
  const int n = blockIdx.x;
  const long long row = (long long)n * w;
  const long long arow = (long long)(n % a_rows) * w;
  int count = 0;
  for (int i = threadIdx.x; i < w; i += blockDim.x) {
    const int r = a[arow + i] & bits[row + i];
    out[row + i] = r;
    count += __popc(r);
  }
  rt::block_store_sum(rt::warp_sum(count), pops_out + n);
}

// Fields of one record of the grouped launch's table (int64 each).
enum GroupedField { kA, kB, kOut, kAPops, kBPops, kOutPops, kOpcode,
                    kFields };

__global__ void __launch_bounds__(rt::kThreads)
bitmap_setop_grouped_kernel(const long long* __restrict__ table,
                            long long rows, int n_blocks, int w) {
  const long long r = (long long)blockIdx.x * rt::kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;  // warp-uniform; nothing below syncs the block
  const long long g = r / n_blocks;
  const int n = (int)(r - g * n_blocks);
  const long long* rec = table + g * kFields;
  const long long base = (long long)n * w;
  const int count = rt::setop_row(
      reinterpret_cast<const int*>(__ldg(rec + kA)) + base,
      reinterpret_cast<const int*>(__ldg(rec + kB)) + base,
      reinterpret_cast<int*>(__ldg(rec + kOut)) + base, w,
      (int)__ldg(rec + kOpcode),
      __ldg(reinterpret_cast<const int*>(__ldg(rec + kAPops)) + n) != 0,
      __ldg(reinterpret_cast<const int*>(__ldg(rec + kBPops)) + n) != 0);
  if ((threadIdx.x & 31) == 0)
    reinterpret_cast<int*>(__ldg(rec + kOutPops))[n] = count;
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

extern "C" int rt_bitmap_setop(const int* a, const int* a_pops, const int* b,
                               const int* b_pops, int opcode, int n, int w,
                               int* out, int* pops_out, void* stream) {
  if (n > 0) {
    const int blocks = (n + rt::kWarps - 1) / rt::kWarps;
    bitmap_setop_kernel<<<blocks, rt::kThreads, 0, (cudaStream_t)stream>>>(
        a, a_pops, b, b_pops, opcode, n, w, out, pops_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_bitmap_setop_grouped(const long long* table, int g, int n,
                                       int w, void* stream) {
  const long long rows = (long long)g * n;
  if (rows > 0) {
    const long long blocks = (rows + rt::kWarps - 1) / rt::kWarps;
    bitmap_setop_grouped_kernel<<<(unsigned)blocks, rt::kThreads, 0,
                                  (cudaStream_t)stream>>>(table, rows, n, w);
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_bitmap_inter_multi(const int* a, const int* bits, int q,
                                     int n, int w, int* out, int* pops_out,
                                     void* stream) {
  if (n > 0 && q > 0) {
    inter_multi_kernel<<<q * n, rt::kThreads, 0, (cudaStream_t)stream>>>(
        a, bits, n, w, out, pops_out);
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

extern "C" int rt_load_bitmap_setop() {
  const int rcs[] = {rt::load_kernel(bitmap_setop_kernel),
                     rt::load_kernel(bitmap_setop_grouped_kernel),
                     rt::load_kernel(inter_multi_kernel),
                     rt::load_kernel(bitmap_union_reduce_kernel)};
  for (int rc : rcs)
    if (rc) return rc;
  return 0;
}
