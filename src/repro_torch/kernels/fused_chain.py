"""K3 ``fused_chain_scan``: K comparisons combined with ∧ or ∨, then ∧ D,
in one pass, plus the output's per-block popcount.

Replaces the TPU kernel ``src/repro/kernels/fused_chain.py``,
``fused_chain_scan``.  The CUDA kernel is ``csrc/fused_chain.cu`` (bound:
bytes, K column reads per live word; 16-byte column loads, K <= 8
compiled apart).  The K columns are passed as a table of base pointers
instead of a stacked copy, with K f32 constants and K opcodes.  For K <= 8
the table rides in the kernel's parameters; a wider chain uploads it from
pinned memory without a host sync, or takes a device table built before
(:func:`fused_chain_table`).  The constants may be an f32[K] device
tensor, which the kernel reads when it runs: a captured CUDA graph then
reads them at each replay (and a wider chain captured in a graph must be
given its table, since an upload inside a capture would re-read a freed
host buffer at every replay).  CPU tensors run
:func:`fused_chain_scan_plain`; CUDA tensors launch the kernel or raise.
"""
from __future__ import annotations

from typing import Optional, Sequence

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
    """i32[4K] host table: K int64 column pointers, K f32 constants (zeros
    when ``values`` is None), K int32 opcodes."""
    k = len(cols)
    host = np.zeros(4 * k, dtype=np.int32)
    host[: 2 * k].view(np.int64)[:] = [c.data_ptr() for c in cols]
    if values is not None:
        host[2 * k: 3 * k].view(np.float32)[:] = np.asarray(values,
                                                            np.float32)
    host[3 * k:] = np.asarray(opcodes, dtype=np.int32)
    return host


def fused_chain_table(cols: Sequence[torch.Tensor],
                      opcodes: Sequence[int]) -> torch.Tensor:
    """The generic path's device table (column pointers and opcodes) for
    a chain whose constants are a device tensor, uploaded now without a
    host sync, to be passed as ``table`` to :func:`fused_chain_scan`."""
    host = torch.from_numpy(_arg_table(cols, None, opcodes))
    return host.pin_memory().to(cols[0].device, non_blocking=True)


def fused_chain_scan(cols: Sequence[torch.Tensor], bits: torch.Tensor,
                     pops: torch.Tensor, values, opcodes: Sequence[int],
                     conj: bool = True,
                     table: Optional[torch.Tensor] = None):
    """cols: K tensors f32[N, B] record-major; bits i32[N, W]; pops i32[N];
    values: K constants (rounded to f32), or an f32[K] tensor on the
    columns' device; opcodes: K opcodes; conj: ∧ (True) or ∨ (False);
    table: for K > 8 with device constants, the chain's
    :func:`fused_chain_table` (built and uploaded here when None, which a
    graph capture refuses).  Returns ``(out i32[N, W], out_pops i32[N])``."""
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
    dev_values = isinstance(values, torch.Tensor)
    if dev_values:
        _build.expect(values, "values", torch.float32, (k,), dev)
    host = _arg_table(cols, None if dev_values else values, opcodes)
    lib = _build.lib()
    if k <= MAX_STATIC_K:
        # the host arrays are read by the launch itself, before it returns
        base = host.ctypes.data
        launch = (lib.rt_fused_chain_scan_small_dv if dev_values
                  else lib.rt_fused_chain_scan_small)
    else:
        if table is None:
            if torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    "fused_chain_scan: a chain of more than "
                    f"{MAX_STATIC_K} columns captured in a CUDA graph needs "
                    "its table built before the capture (fused_chain_table)")
            table = torch.from_numpy(host).pin_memory().to(dev,
                                                           non_blocking=True)
        _build.expect(table, "table", torch.int32, (4 * k,), dev)
        launch, base = lib.rt_fused_chain_scan, table.data_ptr()
    vals = values.data_ptr() if dev_values else base + 8 * k
    out = torch.empty_like(bits)
    out_pops = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = launch(base, vals, base + 12 * k, k, int(bool(conj)),
                    bits.data_ptr(), pops.data_ptr(), n, w, out.data_ptr(),
                    out_pops.data_ptr(),
                    torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "fused_chain_scan")
    _build.count_launch("fused_chain_scan")
    return out, out_pops
