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
// shuffles and one shared-memory step in the same pass.  The tape path
// launches it once per SETOP.
//
// bitmap_setop_grouped: G independent set operations of the same shape in
// one launch, for the lockstep and stream paths, whose BestD set algebra
// is thousands of small operations per batch: launched one by one, each
// cost about 7 us on the card and 50-130 us of host time.  The device
// backend defers them and launches one grouped kernel per dependency
// level.  The launch reads a device table of G records (a, b, out,
// a_pops, b_pops, out_pops, opcode; int64 each), and one warp owns one
// (op, row): row r of the grid is block r % N of op r / N.
// Bound: bytes.  The input popcounts decide many rows without their
// words, since a dead row (popcount 0) is all zeros: AND with either row
// dead, and ANDNOT with a dead, write zeros and read no word; OR and
// ANDNOT with b dead, and OR with a dead, read only the live row.  So the
// bytes are the words of the rows read, plus every output word and
// popcount written, plus 8 bytes of input popcounts per row.  The dense
// case (every row live) is G * (3 * N * W * 4 + 3 * N * 4) bytes.  Each
// lane keeps four words of each input in flight before it combines them.
// The popcounts must be the rows' exact popcounts (every set the device
// backend holds has them).
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

// Fields of one record of the grouped launch's table (int64 each).
enum GroupedField { kA, kB, kOut, kAPops, kBPops, kOutPops, kOpcode,
                    kFields };
// words of each input a lane has in flight at once
constexpr int kGroupedUnroll = 4;

__global__ void __launch_bounds__(rt::kThreads)
bitmap_setop_grouped_kernel(const long long* __restrict__ table,
                            long long rows, int n_blocks, int w) {
  const int lane = threadIdx.x & 31;
  const long long r = (long long)blockIdx.x * rt::kWarps + (threadIdx.x >> 5);
  if (r >= rows) return;  // warp-uniform; nothing below syncs the block
  const long long g = r / n_blocks;
  const int n = (int)(r - g * n_blocks);
  const long long* rec = table + g * kFields;
  const int* a = reinterpret_cast<const int*>(__ldg(rec + kA));
  const int* b = reinterpret_cast<const int*>(__ldg(rec + kB));
  int* out = reinterpret_cast<int*>(__ldg(rec + kOut));
  const int opcode = (int)__ldg(rec + kOpcode);
  const bool a_live =
      __ldg(reinterpret_cast<const int*>(__ldg(rec + kAPops)) + n) != 0;
  const bool b_live =
      __ldg(reinterpret_cast<const int*>(__ldg(rec + kBPops)) + n) != 0;
  // a row that is not read stands for zeros: exact, since a dead row is
  // all zeros, and a row the result does not need is not read either
  const bool read_a = opcode == 0 ? (a_live && b_live) : a_live;
  const bool read_b = opcode == 1 ? b_live : (a_live && b_live);
  const long long base = (long long)n * w;
  int count = 0;
  for (int i0 = lane; i0 < w; i0 += 32 * kGroupedUnroll) {
    int x[kGroupedUnroll], y[kGroupedUnroll];
#pragma unroll
    for (int t = 0; t < kGroupedUnroll; ++t) {
      const int i = i0 + 32 * t;
      x[t] = (read_a && i < w) ? __ldg(a + base + i) : 0;
      y[t] = (read_b && i < w) ? __ldg(b + base + i) : 0;
    }
#pragma unroll
    for (int t = 0; t < kGroupedUnroll; ++t) {
      const int i = i0 + 32 * t;
      if (i < w) {
        const int v = opcode == 0 ? (x[t] & y[t])
                    : opcode == 1 ? (x[t] | y[t]) : (x[t] & ~y[t]);
        out[base + i] = v;
        count += __popc(v);
      }
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    count += __shfl_down_sync(0xffffffffu, count, off);
  if (lane == 0)
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

extern "C" int rt_bitmap_setop(const int* a, const int* b, int opcode, int n,
                               int w, int* out, int* pops_out, void* stream) {
  if (n > 0) {
    bitmap_setop_kernel<<<n, rt::kThreads, 0, (cudaStream_t)stream>>>(
        a, b, opcode, n, w, out, pops_out);
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
