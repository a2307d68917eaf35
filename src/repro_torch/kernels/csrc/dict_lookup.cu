// dict_lookup_scan: is each record's int code in a packed hit set u32[U]?
// Codes < 0 or >= 32 * U miss; the hits are then ∧ D.  Also writes the
// output's per-block popcount.
//
// Replaces the TPU kernel src/repro/kernels/dict_lookup.py,
// dict_lookup_scan (which selects the mask word with an O(U) loop of
// lane-aligned compares, since the TPU has no cheap per-lane gather).
//
// Bound on an H100: bytes, as predicate_scan (the code column's B * 4
// bytes per live block; the mask is read once per block from L2).
// Design: the mask is copied into shared memory once per thread block and
// indexed directly (one shared load per record, independent of U); above
// 48 KiB of mask the kernel reads it from global memory instead, with the
// same result.  U is a runtime size.  Codes convert with __float2int_rz:
// truncation toward zero, NaN to 0, saturating out of range, as the
// reference's f32 -> int32 conversion does.  Record-major warps and
// __ballot_sync as in predicate_scan.
//
// dict_lookup_scan_multi (below) is the Q-stacked form, replacing
// src/repro/kernels/dict_lookup.py, dict_lookup_scan_multi (whose grid
// re-reads code block k % N for each of the Q rows).  Bound: bytes, as
// predicate_scan_multi.  Same design as predicate_scan_multi: one thread
// block per code block n tests the block's codes once into W hit words in
// shared memory, then ANDs them into each of the Q rows of that block
// (rt::and_hits_into_rows, shared with predicate_scan_multi: 16-byte row
// loads when W % 4 == 0); the mask is read only by blocks live in some
// row.  Its code test still gives a warp one word at a time.
#include "common.cuh"

namespace {

constexpr int kMaxSharedWords = 48 * 1024 / 4;

// Code c of a record: in the hit set iff 0 <= c < 32 * u and its mask bit
// is set.
__device__ __forceinline__ bool code_hit(float x, const unsigned* m,
                                         long long limit) {
  const int code = __float2int_rz(x);
  return code >= 0 && (long long)code < limit &&
         ((m[code >> 5] >> (code & 31)) & 1u);
}

template <bool kShared>
__global__ void __launch_bounds__(rt::kThreads)
dict_lookup_kernel(const float* __restrict__ col,
                   const int* __restrict__ bits,
                   const int* __restrict__ pops_in,
                   const unsigned* __restrict__ mask, int u, int w,
                   int* __restrict__ out, int* __restrict__ pops_out) {
  extern __shared__ __align__(16) unsigned smask[];
  const int n = blockIdx.x;
  const long long row = (long long)n * w;
  if (pops_in[n] == 0) {
    rt::write_dead_block(out + row, w, pops_out + n);
    return;
  }
  const unsigned* m = mask;
  if (kShared) {
    for (int j = threadIdx.x; j < u; j += blockDim.x) smask[j] = mask[j];
    __syncthreads();
    m = smask;
  }
  const long long limit = 32LL * u;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const float* col_row = col + row * 32;
  int count = 0;
  for (int i = warp; i < w; i += rt::kWarps) {
    const int in = __ldg(bits + row + i);
    int word = 0;
    if (in != 0) {  // warp-uniform
      const bool hit =
          code_hit(__ldg(col_row + (long long)i * 32 + lane), m, limit);
      word = (int)__ballot_sync(0xffffffffu, hit) & in;
    }
    if (lane == 0) {
      out[row + i] = word;
      count += __popc(word);
    }
  }
  rt::block_store_sum(count, pops_out + n);
}

// Dynamic shared memory: the block's W hit words, then (kShared) the mask.
template <bool kShared>
__global__ void __launch_bounds__(rt::kThreads)
dict_lookup_multi_kernel(const float* __restrict__ col,
                         const int* __restrict__ bits,
                         const int* __restrict__ pops_in,
                         const unsigned* __restrict__ mask, int u, int q,
                         int n_blocks, int w, int* __restrict__ out,
                         int* __restrict__ pops_out) {
  extern __shared__ __align__(16) unsigned smem[];
  unsigned* hit = smem;
  const int n = blockIdx.x;
  if (rt::any_row_live(pops_in, q, n_blocks, n)) {
    const unsigned* m = mask;
    if (kShared) {
      unsigned* smask = smem + w;
      for (int j = threadIdx.x; j < u; j += blockDim.x) smask[j] = mask[j];
      __syncthreads();
      m = smask;
    }
    const long long limit = 32LL * u;
    const int warp = threadIdx.x >> 5;
    const int lane = threadIdx.x & 31;
    const float* col_row = col + (long long)n * w * 32;
    for (int i = warp; i < w; i += rt::kWarps) {
      const bool h =
          code_hit(__ldg(col_row + (long long)i * 32 + lane), m, limit);
      const unsigned word = __ballot_sync(0xffffffffu, h);
      if (lane == 0) hit[i] = word;
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
    if (w + u <= kMaxSharedWords) {
      dict_lookup_multi_kernel<true>
          <<<n, rt::kThreads, (w + u) * sizeof(unsigned), s>>>(
              col, bits, pops_in, mask, u, q, n, w, out, pops_out);
    } else {
      dict_lookup_multi_kernel<false>
          <<<n, rt::kThreads, w * sizeof(unsigned), s>>>(
              col, bits, pops_in, mask, u, q, n, w, out, pops_out);
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
    if (u <= kMaxSharedWords) {
      dict_lookup_kernel<true><<<n, rt::kThreads, u * sizeof(unsigned), s>>>(
          col, bits, pops_in, mask, u, w, out, pops_out);
    } else {
      dict_lookup_kernel<false><<<n, rt::kThreads, 0, s>>>(
          col, bits, pops_in, mask, u, w, out, pops_out);
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
