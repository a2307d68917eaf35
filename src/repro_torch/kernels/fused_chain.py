"""K3 ``fused_chain_scan``: K comparisons combined with ∧ or ∨, then ∧ D,
in one pass, plus the output's per-block popcount.

Replaces the TPU kernel ``src/repro/kernels/fused_chain.py``,
``fused_chain_scan``.  The CUDA kernel is ``csrc/fused_chain.cu`` (bound:
bytes, K column reads per live word; 16-byte column loads, K <= 8
compiled apart).  The K columns are passed as a table of base pointers
instead of a stacked copy, with K f32 constants and K opcodes.  For K <= 8
the table rides in the kernel's parameters; a wider chain uploads it from
pinned memory without a host sync.  CPU tensors run
:func:`fused_chain_scan_plain`; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

from . import _build, ref


def fused_chain_scan_plain(cols: Sequence[torch.Tensor], bits: torch.Tensor,
                           pops: torch.Tensor, values: Sequence[float],
                           opcodes: Sequence[int], conj: bool):
    out = ref.fused_chain_ref(cols, bits, values, opcodes, conj)
    out = torch.where((pops > 0)[:, None], out, 0)
    return out, ref.popcount_ref(out)


#: widest chain whose table rides in the kernel's parameters
MAX_STATIC_K = 8


def _arg_table(cols, values, opcodes) -> np.ndarray:
    """i32[4K] host table: K int64 column pointers, K f32 constants, K
    int32 opcodes."""
    k = len(cols)
    host = np.empty(4 * k, dtype=np.int32)
    host[: 2 * k].view(np.int64)[:] = [c.data_ptr() for c in cols]
    host[2 * k: 3 * k].view(np.float32)[:] = np.asarray(values, np.float32)
    host[3 * k:] = np.asarray(opcodes, dtype=np.int32)
    return host


def fused_chain_scan(cols: Sequence[torch.Tensor], bits: torch.Tensor,
                     pops: torch.Tensor, values: Sequence[float],
                     opcodes: Sequence[int], conj: bool = True):
    """cols: K tensors f32[N, B] record-major; bits i32[N, W]; pops i32[N];
    values: K constants (rounded to f32); opcodes: K opcodes; conj: ∧ (True)
    or ∨ (False).  Returns ``(out i32[N, W], out_pops i32[N])``."""
    if bits.device.type == "cpu":
        return fused_chain_scan_plain(cols, bits, pops, values, opcodes, conj)
    if bits.device.type != "cuda":
        raise ValueError(f"fused_chain_scan: unsupported device {bits.device}")
    k = len(cols)
    if k < 1 or len(values) != k or len(opcodes) != k:
        raise ValueError("fused_chain_scan needs K >= 1 columns, values and "
                         "opcodes")
    n, w = bits.shape
    dev = bits.device
    for j, c in enumerate(cols):
        _build.expect(c, f"cols[{j}]", torch.float32, (n, 32 * w), dev)
        _build.expect_aligned16(c, f"cols[{j}]")
    _build.expect(pops, "pops", torch.int32, (n,), dev)
    if any(not 0 <= int(op) <= ref.NE for op in opcodes):
        raise ValueError(f"bad opcodes {tuple(opcodes)}")
    host = _arg_table(cols, values, opcodes)
    out = torch.empty_like(bits)
    out_pops = torch.empty(n, dtype=torch.int32, device=dev)
    if k <= MAX_STATIC_K:
        # read by the launch itself, before it returns
        launch, base = _build.lib().rt_fused_chain_scan_small, host.ctypes.data
    else:
        table = torch.from_numpy(host).pin_memory().to(dev, non_blocking=True)
        launch, base = _build.lib().rt_fused_chain_scan, table.data_ptr()
    with torch.cuda.device(dev):
        rc = launch(base, base + 8 * k, base + 12 * k, k, int(bool(conj)),
                    bits.data_ptr(), pops.data_ptr(), n, w, out.data_ptr(),
                    out_pops.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "fused_chain_scan")
    _build.count_launch("fused_chain_scan")
    return out, out_pops
