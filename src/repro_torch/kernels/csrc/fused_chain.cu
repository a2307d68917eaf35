// fused_chain_scan: K comparisons combined with ∧ or ∨, then ∧ D, in one
// pass over the blocks, plus the output's per-block popcount.
//
// Replaces the TPU kernel src/repro/kernels/fused_chain.py,
// fused_chain_scan (which takes the K columns stacked as
// f32[N, K, 32, W]).
//
// Bound on an H100: bytes.  Per live word it must read K * 128 column
// bytes; the bitmaps add 8 bytes per word.  At the main shape (N = 1024
// blocks of 8192 records, every word live) that is about 20.7 us for
// K = 2 and 30.7 us for K = 3 at 3.35 TB/s.  A warp that owns one word
// at a time keeps one 128-byte column load in flight, behind two
// dependent loads (the bitmap word, then the column pointer): about 41 %
// of the bound at K = 3.
// Design: the K columns are NOT stacked (a stack would copy K columns per
// CHAIN op).  The kernel takes a table of K column base pointers, K f32
// constants and K opcodes; K and the connective have no cap.  One thread
// block owns one column block.  The compare-and-pack step is
// rt::pack_words32 (common.cuh, shared with predicate_scan and
// predicate_scan_multi): each warp reads 32 bitmap words with one
// coalesced load and shuffles each word to the lanes that need it; the
// column loads are 16 bytes a lane (a 512-byte warp load covers 4 words),
// all K of a step issued before any compare.  K = 1..8 are compiled
// apart: the table travels in the kernel's parameters (no upload before
// the launch) and is staged in shared memory once per thread block, the K
// loop is unrolled, and registers are capped so that enough blocks stay
// resident.  A larger K takes a generic path that reads an uploaded table
// from global memory in a runtime loop.  Comparisons are selected by a
// 4-bit mask per opcode (lt, eq, gt, unordered; rt::compare_mask),
// branch-free and without fast-math: NaN compares false except under NE.
// Dead blocks and zero input words skip their column reads.  The columns
// must be 16-byte aligned (the wrapper checks).
//
// Constants: rt_fused_chain_scan_small copies the K constants into the
// kernel's parameters; rt_fused_chain_scan_small_dv takes them as a device
// array instead, which thread 0 of each live block reads (one __ldg per
// constant) when it stages the table, so a captured CUDA graph reads new
// constants at every replay.  The generic path always reads device arrays.
#include "common.cuh"

namespace {

// widest chain compiled with its own unrolled column loop
constexpr int kMaxStaticK = 8;

// a chain of K <= kMaxStaticK columns, passed by value
struct ChainArgs {
  const float4* col[kMaxStaticK];
  float val[kMaxStaticK];
  int mask[kMaxStaticK];
  const float* dev_val;  // non-null: the K constants on the device
};

// thread blocks per SM the compiler must fit (registers cap at
// 65536 / (256 * value)): the whole grid of 1024 blocks resident at once
// for K <= 2; for wider chains registers matter more than occupancy
template <int K>
struct MinBlocks {
  static constexpr int value = (K >= 1 && K <= 2) ? 8 : 4;
};

// K > 0: a K-column chain from ``args``, staged in shared memory; K == 0:
// the generic path, k columns from the device table (col_ptrs, values,
// opcodes).  The step (rt::pack_words32) loads records 4q..4q+3 of a word
// as one float4 from each of the K columns, all K before any compare.
template <int K, bool kConj>
__global__ void __launch_bounds__(rt::kThreads, MinBlocks<K>::value)
fused_chain_kernel(ChainArgs args, const long long* __restrict__ col_ptrs,
                   const float* __restrict__ values,
                   const int* __restrict__ opcodes, int k,
                   const int* __restrict__ bits,
                   const int* __restrict__ pops_in, int w,
                   int* __restrict__ out, int* __restrict__ pops_out) {
  constexpr int KS = K > 0 ? K : 1;
  __shared__ const float4* s_col[KS];
  __shared__ float s_val[KS];
  __shared__ int s_mask[KS];
  const int n = blockIdx.x;
  if (pops_in[n] == 0) {
    rt::write_dead_block(out + (long long)n * w, w, pops_out + n);
    return;
  }
  if constexpr (K > 0) {
    // staged once per block with constant indices: the loop below reads
    // shared memory, never a copy of ``args`` in local memory
    if (threadIdx.x == 0) {
#pragma unroll
      for (int j = 0; j < K; ++j) {
        s_col[j] = args.col[j];
        s_val[j] = args.dev_val != nullptr ? __ldg(args.dev_val + j)
                                           : args.val[j];
        s_mask[j] = args.mask[j];
      }
    }
    __syncthreads();
  }
  rt::scan_live_block(bits, n, w, out, pops_out + n,
                      [&](bool load, long long f4) {
    int acc = kConj ? 0xF : 0;
    if constexpr (K > 0) {
      float4 x[K];
#pragma unroll
      for (int j = 0; j < K; ++j)
        x[j] = load ? __ldg(s_col[j] + f4) : make_float4(0, 0, 0, 0);
#pragma unroll
      for (int j = 0; j < K; ++j) {
        const int h = rt::nibble(x[j], s_val[j], s_mask[j]);
        acc = kConj ? (acc & h) : (acc | h);
      }
    } else {
#pragma unroll 4
      for (int j = 0; j < k; ++j) {
        const float4* c =
            reinterpret_cast<const float4*>(__ldg(col_ptrs + j));
        const float4 x = load ? __ldg(c + f4) : make_float4(0, 0, 0, 0);
        const int h = rt::nibble(x, __ldg(values + j),
                                 rt::compare_mask(__ldg(opcodes + j)));
        acc = kConj ? (acc & h) : (acc | h);
      }
    }
    return acc;
  });
}

template <int K>
void launch(const ChainArgs& args, const long long* col_ptrs,
            const float* values, const int* opcodes, int k, int conj,
            const int* bits, const int* pops_in, int n, int w, int* out,
            int* pops_out, cudaStream_t stream) {
  if (conj) {
    fused_chain_kernel<K, true><<<n, rt::kThreads, 0, stream>>>(
        args, col_ptrs, values, opcodes, k, bits, pops_in, w, out, pops_out);
  } else {
    fused_chain_kernel<K, false><<<n, rt::kThreads, 0, stream>>>(
        args, col_ptrs, values, opcodes, k, bits, pops_in, w, out, pops_out);
  }
}

template <int K>
int load_chain() {
  const int rc = rt::load_kernel(fused_chain_kernel<K, true>);
  return rc ? rc : rt::load_kernel(fused_chain_kernel<K, false>);
}

int launch_small(const long long* host_cols, const float* host_values,
                 const float* dev_values, const int* host_opcodes, int k,
                 int conj, const int* bits, const int* pops_in, int n, int w,
                 int* out, int* pops_out, void* stream) {
  if (k < 1 || k > kMaxStaticK) return (int)cudaErrorInvalidValue;
  ChainArgs args = {};
  for (int j = 0; j < k; ++j) {
    args.col[j] = reinterpret_cast<const float4*>(host_cols[j]);
    args.val[j] = host_values != nullptr ? host_values[j] : 0.0f;
    args.mask[j] = rt::compare_mask(host_opcodes[j]);
  }
  args.dev_val = dev_values;
  if (n > 0) {
    const cudaStream_t s = (cudaStream_t)stream;
    switch (k) {
#define RT_CHAIN_CASE(K)                                                  \
  case K:                                                                 \
    launch<K>(args, nullptr, nullptr, nullptr, k, conj, bits, pops_in, n, \
              w, out, pops_out, s);                                       \
    break;
      RT_CHAIN_CASE(1) RT_CHAIN_CASE(2) RT_CHAIN_CASE(3) RT_CHAIN_CASE(4)
      RT_CHAIN_CASE(5) RT_CHAIN_CASE(6) RT_CHAIN_CASE(7) RT_CHAIN_CASE(8)
#undef RT_CHAIN_CASE
    }
  }
  return (int)cudaGetLastError();
}

}  // namespace

// K <= 8: host_cols, host_values and host_opcodes are HOST arrays, copied
// into the kernel's parameters at the launch.
extern "C" int rt_fused_chain_scan_small(const long long* host_cols,
                                         const float* host_values,
                                         const int* host_opcodes, int k,
                                         int conj, const int* bits,
                                         const int* pops_in, int n, int w,
                                         int* out, int* pops_out,
                                         void* stream) {
  return launch_small(host_cols, host_values, nullptr, host_opcodes, k, conj,
                      bits, pops_in, n, w, out, pops_out, stream);
}

// K <= 8, constants on the DEVICE (dev_values, K floats, 4-byte aligned);
// host_cols and host_opcodes are HOST arrays as above.
extern "C" int rt_fused_chain_scan_small_dv(const long long* host_cols,
                                            const float* dev_values,
                                            const int* host_opcodes, int k,
                                            int conj, const int* bits,
                                            const int* pops_in, int n, int w,
                                            int* out, int* pops_out,
                                            void* stream) {
  return launch_small(host_cols, nullptr, dev_values, host_opcodes, k, conj,
                      bits, pops_in, n, w, out, pops_out, stream);
}

// any K: col_ptrs, values and opcodes are DEVICE arrays (the generic path)
extern "C" int rt_fused_chain_scan(const long long* col_ptrs,
                                   const float* values, const int* opcodes,
                                   int k, int conj, const int* bits,
                                   const int* pops_in, int n, int w, int* out,
                                   int* pops_out, void* stream) {
  if (n > 0) {
    launch<0>(ChainArgs{}, col_ptrs, values, opcodes, k, conj, bits,
              pops_in, n, w, out, pops_out, (cudaStream_t)stream);
  }
  return (int)cudaGetLastError();
}

extern "C" int rt_load_fused_chain() {
  const int rcs[] = {load_chain<0>(), load_chain<1>(), load_chain<2>(),
                     load_chain<3>(), load_chain<4>(), load_chain<5>(),
                     load_chain<6>(), load_chain<7>(), load_chain<8>()};
  for (int rc : rcs)
    if (rc) return rc;
  return 0;
}
