// predicate_scan: bits of (col OP value) ∧ D over blocked columns, plus the
// output's per-block popcount.
//
// Replaces the TPU kernel src/repro/kernels/predicate_scan.py,
// predicate_scan (its pallas_call; the reference reads a bit-major
// f32[N, 32, W] tile per block).
//
// Bound on an H100: bytes.  Per live block it must read the column's
// 128 bytes under each non-zero input word and the W input words, and
// write W words and one popcount: one compare per 4 bytes read is far
// below the card's compute rate.  At the main shape (N = 1024 blocks of
// 8192 records, every word live) that is about 10.6 us at 3.35 TB/s.  A
// warp that owns one word at a time keeps one 128-byte column load in
// flight behind the dependent load of its bitmap word (31 % of the bound
// in that design).
// Design: the one-column case of the compare-and-pack step that
// fused_chain_scan uses (rt::scan_live_block / rt::pack_words32 in
// common.cuh).  One thread block per column block; each warp owns 32
// words, reads their input words with one coalesced load and shuffles
// each to the 8 lanes that need it; each lane loads 4 records as one
// float4 (a 512-byte warp load covers 4 words) and the 8 lanes OR their
// 4-bit nibbles into the word by shuffles.  The opcode becomes a 4-bit
// mask (branch-free compares, NaN false except under NE).  A dead block
// (input popcount 0) writes zeros without reading its column, and a zero
// input word skips its 128 column bytes.  The output popcount is reduced
// in the same pass.  The column must be 16-byte aligned (the wrapper
// checks).
//
// Two entries: rt_predicate_scan takes the constant by value, and
// rt_predicate_scan_dv reads it from device memory (each thread of a live
// block loads the same 4 bytes, a broadcast), so a captured CUDA graph
// reads a new constant at every replay instead of baking one in.
#include "common.cuh"

namespace {

// 8 resident blocks per SM: the whole 1024-block grid in one wave, as
// fused_chain_scan at K = 1
__global__ void __launch_bounds__(rt::kThreads, 8)
predicate_scan_kernel(const float4* __restrict__ col,
                      const int* __restrict__ bits,
                      const int* __restrict__ pops_in,
                      const float* __restrict__ value_ptr, float value,
                      int mask, int w, int* __restrict__ out,
                      int* __restrict__ pops_out) {
  const int n = blockIdx.x;
  if (pops_in[n] == 0) {
    rt::write_dead_block(out + (long long)n * w, w, pops_out + n);
    return;
  }
  if (value_ptr != nullptr) value = __ldg(value_ptr);
  rt::scan_live_block(bits, n, w, out, pops_out + n,
                      [&](bool load, long long f4) {
    const float4 x = load ? __ldg(col + f4) : make_float4(0, 0, 0, 0);
    return rt::nibble(x, value, mask);
  });
}

int launch(const float* col, const int* bits, const int* pops_in,
           const float* value_ptr, float value, int opcode, int n, int w,
           int* out, int* pops_out, void* stream) {
  if (n > 0) {
    predicate_scan_kernel<<<n, rt::kThreads, 0, (cudaStream_t)stream>>>(
        reinterpret_cast<const float4*>(col), bits, pops_in, value_ptr, value,
        rt::compare_mask(opcode), w, out, pops_out);
  }
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" int rt_predicate_scan(const float* col, const int* bits,
                                 const int* pops_in, float value, int opcode,
                                 int n, int w, int* out, int* pops_out,
                                 void* stream) {
  return launch(col, bits, pops_in, nullptr, value, opcode, n, w, out,
                pops_out, stream);
}

// the constant is read from device memory at ``value`` (4-byte aligned)
extern "C" int rt_predicate_scan_dv(const float* col, const int* bits,
                                    const int* pops_in, const float* value,
                                    int opcode, int n, int w, int* out,
                                    int* pops_out, void* stream) {
  return launch(col, bits, pops_in, value, 0.0f, opcode, n, w, out, pops_out,
                stream);
}

extern "C" int rt_load_predicate_scan() {
  return rt::load_kernel(predicate_scan_kernel);
}
