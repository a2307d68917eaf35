"""K4 ``dict_lookup_scan``: is each record's int code in a packed hit set?
Codes < 0 or >= 32·U miss; the hits are then ∧ D.  Also returns the
output's per-block popcount.

Replaces the TPU kernel ``src/repro/kernels/dict_lookup.py``,
``dict_lookup_scan``.  The CUDA kernel is ``csrc/dict_lookup.cu``; its
header states the bound (bytes: the live blocks' code-column reads, as
K1's) and the design: K1's compare-and-pack step of ``csrc/common.cuh``
(16-byte code loads, a warp load covering 4 words; dead blocks and zero
words skip their column reads) with a code test in place of the
comparison, the mask staged in shared memory and indexed directly
instead of the reference's O(U) word loop.

K6 ``dict_lookup_scan_multi`` is the Q-stacked form (replacing the TPU
kernel of the same name in the same file), in the same CUDA source: K5's
two phases with the code test, one thread block per code block computing
the hit words once into shared memory and ANDing them into each of the Q
rows.  Both need the column 16-byte aligned.

CPU tensors run the plain versions; CUDA tensors launch the kernel or
raise.
"""
from __future__ import annotations

import torch

from . import _build, ref


def dict_lookup_scan_plain(col: torch.Tensor, bits: torch.Tensor,
                           pops: torch.Tensor, mask_words: torch.Tensor):
    out = ref.dict_lookup_ref(col, bits, mask_words)
    out = torch.where((pops > 0)[:, None], out, 0)
    return out, ref.popcount_ref(out)


def dict_lookup_scan(col: torch.Tensor, bits: torch.Tensor,
                     pops: torch.Tensor, mask_words: torch.Tensor):
    """col f32[N, B] record-major int codes; bits i32[N, W]; pops i32[N];
    mask_words i32[U] packed code hit set (bit c of word c // 32).
    Returns ``(out i32[N, W], out_pops i32[N])``."""
    if col.device.type == "cpu":
        return dict_lookup_scan_plain(col, bits, pops, mask_words)
    if col.device.type != "cuda":
        raise ValueError(f"dict_lookup_scan: unsupported device {col.device}")
    n, w = bits.shape
    dev = col.device
    u = mask_words.shape[0] if mask_words.dim() == 1 else -1
    if u < 1:
        raise ValueError("mask_words must be a non-empty 1-D tensor")
    _build.expect(col, "col", torch.float32, (n, 32 * w), dev)
    _build.expect_aligned16(col, "col")
    _build.expect(bits, "bits", torch.int32, (n, w), dev)
    _build.expect(pops, "pops", torch.int32, (n,), dev)
    _build.expect(mask_words, "mask_words", torch.int32, (u,), dev)
    out = torch.empty_like(bits)
    out_pops = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().rt_dict_lookup_scan(
            col.data_ptr(), bits.data_ptr(), pops.data_ptr(),
            mask_words.data_ptr(), u, n, w, out.data_ptr(),
            out_pops.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "dict_lookup_scan")
    _build.count_launch("dict_lookup_scan")
    return out, out_pops


def dict_lookup_scan_multi_plain(col: torch.Tensor, bits: torch.Tensor,
                                 pops: torch.Tensor,
                                 mask_words: torch.Tensor):
    """Plain version of :func:`dict_lookup_scan_multi`."""
    n = col.shape[0]
    qn, w = bits.shape
    out = ref.dict_lookup_multi_ref(col, bits.reshape(qn // n, n, w),
                                    mask_words).reshape(qn, w)
    out = torch.where((pops > 0)[:, None], out, 0)
    return out, ref.popcount_ref(out)


def dict_lookup_scan_multi(col: torch.Tensor, bits: torch.Tensor,
                           pops: torch.Tensor, mask_words: torch.Tensor):
    """K6: K4 for Q stacked record sets against one code column.

    col f32[N, B] record-major int codes; bits i32[Q·N, W] query-major;
    pops i32[Q·N]; mask_words i32[U].  The code test is computed once per
    column block for all Q rows.  Returns ``(out i32[Q·N, W],
    out_pops i32[Q·N])``."""
    if col.device.type == "cpu":
        return dict_lookup_scan_multi_plain(col, bits, pops, mask_words)
    if col.device.type != "cuda":
        raise ValueError(f"dict_lookup_scan_multi: unsupported device "
                         f"{col.device}")
    n = col.shape[0]
    qn, w = bits.shape
    dev = col.device
    if n < 1 or qn % n:
        raise ValueError(f"bits has {qn} rows, not a multiple of the "
                         f"column's {n} blocks")
    u = mask_words.shape[0] if mask_words.dim() == 1 else -1
    if u < 1:
        raise ValueError("mask_words must be a non-empty 1-D tensor")
    _build.expect_shared_words(w, "dict_lookup_scan_multi")
    _build.expect(col, "col", torch.float32, (n, 32 * w), dev)
    _build.expect_aligned16(col, "col")
    _build.expect(bits, "bits", torch.int32, (qn, w), dev)
    _build.expect(pops, "pops", torch.int32, (qn,), dev)
    _build.expect(mask_words, "mask_words", torch.int32, (u,), dev)
    out = torch.empty_like(bits)
    out_pops = torch.empty(qn, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().rt_dict_lookup_scan_multi(
            col.data_ptr(), bits.data_ptr(), pops.data_ptr(),
            mask_words.data_ptr(), u, qn // n, n, w, out.data_ptr(),
            out_pops.data_ptr(), torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "dict_lookup_scan_multi")
    _build.count_launch("dict_lookup_scan_multi", qn // n)
    return out, out_pops
