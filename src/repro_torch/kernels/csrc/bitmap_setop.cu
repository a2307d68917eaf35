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
// the reference's src/repro/columnar/device.py, not Pallas kernels.  Both
// read their Q input rows through row pointers passed by value in the
// launch's parameters (StackRows: each row's bits and popcounts, up to
// kMaxStackRows rows, 2 KiB of the 4 KiB a launch may pass), so no stacked
// copy of the inputs is made before the launch and no table is built or
// uploaded; a wider stack launches in chunks of kMaxStackRows rows.  The
// input popcounts must be the rows' exact popcounts: a row whose popcount
// is 0 is all zeros, so it is not read.
//   bitmap_inter_multi   (_inter_multi_impl) one set a i32[N, W] ANDed into
//                        each of the Q rows, out i32[Q, N, W] with
//                        popcounts i32[Q, N].  One warp per (row j, block
//                        n) on the set operations' row body
//                        (rt::setop_row, AND), ordered block-major so the Q
//                        warps of block n run together and read a's row n
//                        from HBM once and from the L2 after that.  A
//                        dead input row, or a dead block of a, writes zeros
//                        and reads no word.  Bound: bytes: a once, the
//                        live rows' words read, Q * N * W words and Q * N
//                        popcounts written, the N + Q * N input popcounts
//                        read.
//   bitmap_union_reduce  (_union_impl) the OR of the Q rows, out i32[N, W]
//                        with popcounts i32[N], and in the same pass the
//                        stacked copy of the rows, i32[Q, N, W] with their
//                        popcounts i32[Q, N], that K5, K6 and the zone
//                        blend read: the rows cross HBM twice (read once,
//                        the stack written once) where a stack copy and a
//                        reduce over it crossed it three times in two
//                        launches.  One thread block per column block n;
//                        warp g takes rows g, g + 8, ..., two rows' loads in
//                        flight at a time (2 int4 per lane per row at W =
//                        256), writes each row's words to the stack and ORs
//                        them into registers; the warps' partial ORs meet
//                        in shared memory and the block writes the OR with
//                        its popcount.  A dead row writes zeros to the
//                        stack and reads no word.  A chunk after the first
//                        ORs the running result in.  Bound: bytes: the live
//                        rows read, Q + 1 rows written, Q * N popcounts
//                        read and written, N written.
// Both take 16-byte loads when W % 4 == 0 and a row is aligned, checked row
// by row (the rows may be views at any offset), else 4-byte loads.
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

// The row pointers of a stacked launch, by value (see the header).
constexpr int kMaxStackRows = 128;
struct StackRows {
  const int* bits[kMaxStackRows];
  const int* pops[kMaxStackRows];
};

// bitmap_inter_multi: warp r owns output row (j, n) with n = r / q and
// j = r % q: out row j * N + n = a row n AND row j's block n.
__global__ void __launch_bounds__(rt::kThreads)
bitmap_inter_multi_kernel(const __grid_constant__ StackRows rows, int q,
                          const int* __restrict__ a,
                          const int* __restrict__ a_pops, int n_blocks,
                          int w, int* __restrict__ out,
                          int* __restrict__ pops_out) {
  const long long r = (long long)blockIdx.x * rt::kWarps + (threadIdx.x >> 5);
  if (r >= (long long)q * n_blocks) return;  // warp-uniform; no block sync
  const int n = (int)(r / q);
  const int j = (int)(r - (long long)n * q);
  const long long base = (long long)n * w;
  const long long orow = (long long)j * n_blocks + n;
  const int count = rt::setop_row(a + base, rows.bits[j] + base,
                                  out + orow * w, w, 0,
                                  __ldg(a_pops + n) != 0,
                                  __ldg(rows.pops[j] + n) != 0);
  if ((threadIdx.x & 31) == 0) pops_out[orow] = count;
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

// vectors of one row a lane loads per chunk of the OR-reduce: 2 int4 cover
// a 256-word row (B = 8192), or 4 ints
template <class V> struct UnionLoads { static constexpr int value = 4; };
template <> struct UnionLoads<int4> { static constexpr int value = 2; };

// vector i of a row: one 16-byte load when the row is aligned, else four
// 4-byte loads of the same words
template <class V> __device__ __forceinline__ V load_vec(const int* row,
                                                         int i, bool aligned);
template <> __device__ __forceinline__ int load_vec<int>(const int* row,
                                                         int i, bool) {
  return __ldg(row + i);
}
template <> __device__ __forceinline__ int4 load_vec<int4>(const int* row,
                                                           int i,
                                                           bool aligned) {
  if (aligned) return __ldg(reinterpret_cast<const int4*>(row) + i);
  const int* p = row + 4 * i;
  return make_int4(__ldg(p), __ldg(p + 1), __ldg(p + 2), __ldg(p + 3));
}
__device__ __forceinline__ int bor(int x, int y) { return x | y; }
__device__ __forceinline__ int4 bor(int4 x, int4 y) {
  return make_int4(x.x | y.x, x.y | y.y, x.z | y.z, x.w | y.w);
}

// rows of one warp whose loads are issued before any is stored or ORed
constexpr int kRowsInFlight = 2;

// bitmap_union_reduce: block n ORs block n of the q rows into out row n
// (ORing out's row in as well when ``accumulate``: a later chunk), and
// writes each row's block n to the stack.  V is int4 (W % 4 == 0, the
// stack and out 16-byte aligned) or int.
template <class V>
__global__ void __launch_bounds__(rt::kThreads)
bitmap_union_stack_kernel(const __grid_constant__ StackRows rows, int q,
                          int n_blocks, int w, int accumulate,
                          int* __restrict__ stack,
                          int* __restrict__ stack_pops,
                          int* __restrict__ out, int* __restrict__ pops_out) {
  constexpr int kLoads = UnionLoads<V>::value;
  constexpr int kVec = sizeof(V) / sizeof(int);  // words per vector
  constexpr int kChunk = 32 * kLoads;            // vectors per chunk
  __shared__ V part[rt::kWarps][kChunk];         // the warps' partial ORs
  const int n = blockIdx.x;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int nv = w / kVec;
  const long long base = (long long)n * w;
  for (int j = threadIdx.x; j < q; j += blockDim.x)
    stack_pops[(long long)j * n_blocks + n] = __ldg(rows.pops[j] + n);
  int count = 0;
  for (int c0 = 0; c0 < nv; c0 += kChunk) {
    V acc[kLoads];
#pragma unroll
    for (int t = 0; t < kLoads; ++t) acc[t] = rt::zero<V>();
    for (int j0 = warp; j0 < q; j0 += rt::kWarps * kRowsInFlight) {
      V x[kRowsInFlight][kLoads];
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int j = j0 + u * rt::kWarps;
        const int* src = j < q ? rows.bits[j] + base : nullptr;
        const bool live = j < q && __ldg(rows.pops[j] + n) != 0;
        const bool aligned = (reinterpret_cast<uintptr_t>(src) & 15) == 0;
#pragma unroll
        for (int t = 0; t < kLoads; ++t) {
          const int i = c0 + lane + 32 * t;
          x[u][t] = (live && i < nv) ? load_vec<V>(src, i, aligned)
                                     : rt::zero<V>();
        }
      }
#pragma unroll
      for (int u = 0; u < kRowsInFlight; ++u) {
        const int j = j0 + u * rt::kWarps;
        if (j >= q) break;                      // warp-uniform
        V* dst = reinterpret_cast<V*>(stack + ((long long)j * n_blocks + n)
                                      * w);
#pragma unroll
        for (int t = 0; t < kLoads; ++t) {
          const int i = c0 + lane + 32 * t;
          if (i < nv) {
            dst[i] = x[u][t];
            acc[t] = bor(acc[t], x[u][t]);
          }
        }
      }
    }
#pragma unroll
    for (int t = 0; t < kLoads; ++t) part[warp][lane + 32 * t] = acc[t];
    __syncthreads();
    const int* words = reinterpret_cast<const int*>(&part[0][0]);
    for (int k = threadIdx.x; k < kChunk * kVec; k += blockDim.x) {
      const long long word = (long long)c0 * kVec + k;
      if (word < w) {
        int v = accumulate ? out[base + word] : 0;
#pragma unroll
        for (int g = 0; g < rt::kWarps; ++g) v |= words[g * kChunk * kVec + k];
        out[base + word] = v;
        count += __popc(v);
      }
    }
    __syncthreads();
  }
  rt::block_store_sum(rt::warp_sum(count), pops_out + n);
}

// the StackRows of a launch from the host array of q (bits, pops) pointers
bool fill_rows(StackRows* rows, const long long* host_rows, int q) {
  if (q < 1 || q > kMaxStackRows) return false;
  *rows = StackRows{};
  for (int j = 0; j < q; ++j) {
    rows->bits[j] = reinterpret_cast<const int*>(host_rows[2 * j]);
    rows->pops[j] = reinterpret_cast<const int*>(host_rows[2 * j + 1]);
  }
  return true;
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

// host_rows: q (bits, pops) device addresses as int64 pairs, 1 <= q <=
// kMaxStackRows
extern "C" int rt_bitmap_inter_multi(const long long* host_rows, int q,
                                     const int* a, const int* a_pops, int n,
                                     int w, int* out, int* pops_out,
                                     void* stream) {
  StackRows rows;
  if (!fill_rows(&rows, host_rows, q)) return (int)cudaErrorInvalidValue;
  const long long total = (long long)q * n;
  if (total > 0) {
    const long long blocks = (total + rt::kWarps - 1) / rt::kWarps;
    bitmap_inter_multi_kernel<<<(unsigned)blocks, rt::kThreads, 0,
                                (cudaStream_t)stream>>>(
        rows, q, a, a_pops, n, w, out, pops_out);
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_bitmap_union_reduce(const long long* host_rows, int q,
                                      int n, int w, int accumulate,
                                      int* stack, int* stack_pops, int* out,
                                      int* pops_out, void* stream) {
  StackRows rows;
  if (!fill_rows(&rows, host_rows, q)) return (int)cudaErrorInvalidValue;
  if (n > 0) {
    const bool vec = (w & 3) == 0 &&
        ((reinterpret_cast<uintptr_t>(stack) |
          reinterpret_cast<uintptr_t>(out)) & 15) == 0;
    const cudaStream_t s = (cudaStream_t)stream;
    if (vec) {
      bitmap_union_stack_kernel<int4><<<n, rt::kThreads, 0, s>>>(
          rows, q, n, w, accumulate, stack, stack_pops, out, pops_out);
    } else {
      bitmap_union_stack_kernel<int><<<n, rt::kThreads, 0, s>>>(
          rows, q, n, w, accumulate, stack, stack_pops, out, pops_out);
    }
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_load_bitmap_setop() {
  const int rcs[] = {rt::load_kernel(bitmap_setop_kernel),
                     rt::load_kernel(bitmap_setop_grouped_kernel),
                     rt::load_kernel(bitmap_inter_multi_kernel),
                     rt::load_kernel(bitmap_union_stack_kernel<int4>),
                     rt::load_kernel(bitmap_union_stack_kernel<int>)};
  for (int rc : rcs)
    if (rc) return rc;
  return 0;
}
