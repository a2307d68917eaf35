"""K1 ``predicate_scan``: bits of ``(col OP value) ∧ D`` per block, plus
the output's per-block popcount; and K5 ``predicate_scan_multi``, the same
for Q stacked record sets against one column.

Replaces the TPU kernel ``src/repro/kernels/predicate_scan.py``,
``predicate_scan``.  The CUDA kernel is ``csrc/predicate_scan.cu``; its
header states the bound (bytes: the live blocks' column reads) and the
design (record-major columns, the compare-and-pack step of
``csrc/common.cuh`` that K3 also runs: 16-byte column loads, a warp load
covering 4 words; dead blocks and zero words skip their column reads).
K5 replaces the TPU kernel ``predicate_scan_multi`` of the same file; its
CUDA kernel is ``csrc/predicate_scan_multi.cu``, which reads each live
column block once for all Q rows instead of once per row.  Both need the
column 16-byte aligned.

The wrapper takes the tensors' device as the choice of path: CPU tensors
run :func:`predicate_scan_plain`, CUDA tensors launch the kernel (or
raise), and nothing falls back from one to the other.
"""
from __future__ import annotations

import torch

from . import _build, ref


def predicate_scan_plain(col: torch.Tensor, bits: torch.Tensor,
                         pops: torch.Tensor, value, opcode: int):
    """Plain version: (i32[N, W] ``(col OP value) ∧ bits`` with rows whose
    ``pops`` is 0 zeroed, i32[N] popcounts of the result)."""
    out = ref.predicate_blocks_ref(col, bits, value, opcode)
    out = torch.where((pops > 0)[:, None], out, 0)
    return out, ref.popcount_ref(out)


def predicate_scan(col: torch.Tensor, bits: torch.Tensor, pops: torch.Tensor,
                   value, opcode: int):
    """col f32[N, B] record-major blocks; bits i32[N, W] (W = B // 32);
    pops i32[N] (a block with ``pops == 0`` is dead: zero output, column
    not read); value: a number, rounded to f32, or a one-element f32
    tensor on the column's device, which the kernel reads when it runs (a
    captured CUDA graph then reads the value at each replay); opcode in
    ``ref.LT..ref.NE``.  Returns ``(out i32[N, W], out_pops i32[N])``."""
    if col.device.type == "cpu":
        return predicate_scan_plain(col, bits, pops, value, opcode)
    if col.device.type != "cuda":
        raise ValueError(f"predicate_scan: unsupported device {col.device}")
    n, w = bits.shape
    dev = col.device
    _build.expect(col, "col", torch.float32, (n, 32 * w), dev)
    _build.expect_aligned16(col, "col")
    _build.expect(bits, "bits", torch.int32, (n, w), dev)
    _build.expect(pops, "pops", torch.int32, (n,), dev)
    if not 0 <= int(opcode) <= ref.NE:
        raise ValueError(f"bad opcode {opcode}")
    if isinstance(value, torch.Tensor):
        _build.expect(value, "value", torch.float32, value.shape, dev)
        if value.numel() != 1:
            raise ValueError("value must hold one float32")
        launch, value = _build.lib().rt_predicate_scan_dv, value.data_ptr()
    else:
        launch, value = _build.lib().rt_predicate_scan, ref.f32(value)
    out = torch.empty_like(bits)
    out_pops = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = launch(col.data_ptr(), bits.data_ptr(), pops.data_ptr(), value,
                    int(opcode), n, w, out.data_ptr(), out_pops.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "predicate_scan")
    _build.count_launch("predicate_scan")
    return out, out_pops


def predicate_scan_multi_plain(col: torch.Tensor, bits: torch.Tensor,
                               pops: torch.Tensor, value, opcode: int):
    """Plain version of :func:`predicate_scan_multi`."""
    n = col.shape[0]
    qn, w = bits.shape
    out = ref.predicate_blocks_multi_ref(col, bits.reshape(qn // n, n, w),
                                         value, opcode).reshape(qn, w)
    out = torch.where((pops > 0)[:, None], out, 0)
    return out, ref.popcount_ref(out)


def predicate_scan_multi(col: torch.Tensor, bits: torch.Tensor,
                         pops: torch.Tensor, value, opcode: int):
    """K5: K1 for Q stacked record sets against one column.

    col f32[N, B] record-major blocks; bits i32[Q·N, W] query-major (row
    ``q·N + n`` is block n of set q); pops i32[Q·N] (a row with
    ``pops == 0`` is dead: zero output).  The comparison is computed once
    per column block for all Q rows (``csrc/predicate_scan_multi.cu``).
    Returns ``(out i32[Q·N, W], out_pops i32[Q·N])``."""
    if col.device.type == "cpu":
        return predicate_scan_multi_plain(col, bits, pops, value, opcode)
    if col.device.type != "cuda":
        raise ValueError(f"predicate_scan_multi: unsupported device "
                         f"{col.device}")
    n = col.shape[0]
    qn, w = bits.shape
    dev = col.device
    if n < 1 or qn % n:
        raise ValueError(f"bits has {qn} rows, not a multiple of the "
                         f"column's {n} blocks")
    _build.expect_shared_words(w, "predicate_scan_multi")
    _build.expect(col, "col", torch.float32, (n, 32 * w), dev)
    _build.expect_aligned16(col, "col")
    _build.expect(bits, "bits", torch.int32, (qn, w), dev)
    _build.expect(pops, "pops", torch.int32, (qn,), dev)
    if not 0 <= int(opcode) <= ref.NE:
        raise ValueError(f"bad opcode {opcode}")
    out = torch.empty_like(bits)
    out_pops = torch.empty(qn, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().rt_predicate_scan_multi(
            col.data_ptr(), bits.data_ptr(), pops.data_ptr(), ref.f32(value),
            int(opcode), qn // n, n, w, out.data_ptr(), out_pops.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "predicate_scan_multi")
    _build.count_launch("predicate_scan_multi", qn // n)
    return out, out_pops
