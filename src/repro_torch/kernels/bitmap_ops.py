"""K2 ``bitmap_setop``: AND / OR / ANDNOT of packed bitmaps, plus the
result's per-block popcount.

Replaces the TPU kernel ``src/repro/kernels/bitmap_ops.py``,
``bitmap_setop``.  The CUDA kernel is ``csrc/bitmap_setop.cu`` (bound:
bytes, at most about 3 MiB at the tape's shapes, so launched alone its
launch; the tape path replays it inside the tape's CUDA graph).  The
wrapper takes the inputs' exact per-row popcounts: the kernel reads no
word of a dead row (popcount 0) and writes what the row's zeros give.
CPU tensors run :func:`bitmap_setop_plain`, which ignores the popcounts
(skipping a dead row is exact); CUDA tensors launch the kernel or raise.

The lockstep and stream paths run K2 as :func:`bitmap_setop_grouped`:
the independent set operations of one dependency level in one launch
(the device backend defers BestD's set algebra and launches one grouped
kernel per level).  Its plain version runs the per-op plain versions in
order.

The lockstep executor's two stacked set operations live in the same CUDA
source: :func:`bitmap_inter_multi` (one set ANDed into each of Q sets) and
:func:`bitmap_union_reduce` (the OR of Q sets, which also writes their
stacked copy), both with the fused popcount.  Each takes its Q input sets
as ``(bits, pops)`` pairs, which the kernel reads by pointer where they
lie, so no ``torch.stack`` copy precedes it; the popcounts must be exact.
They replace jnp code of the reference, not TPU kernels.
"""
from __future__ import annotations

from typing import NamedTuple, Sequence, Tuple

import numpy as np
import torch

from . import _build, ref

AND, OR, ANDNOT = range(3)


def bitmap_setop_plain(a: torch.Tensor, b: torch.Tensor, opcode: int):
    """Plain version of :func:`bitmap_setop` (it needs no popcounts: a
    dead row is all zeros, which the words already say)."""
    if opcode == AND:
        out = a & b
    elif opcode == OR:
        out = a | b
    elif opcode == ANDNOT:
        out = a & ~b
    else:
        raise ValueError(f"bad opcode {opcode}")
    return out, ref.popcount_ref(out)


def bitmap_setop(a: torch.Tensor, b: torch.Tensor, opcode: int,
                 a_pops: torch.Tensor, b_pops: torch.Tensor):
    """a, b: i32[N, W]; a_pops, b_pops: i32[N], their exact per-row
    popcounts -> (i32[N, W] result, i32[N] per-row popcounts).

    The kernel reads only whether a row's input popcount is 0
    (``csrc/bitmap_setop.cu``: such a row reads no word), so a nonzero
    count for a row whose words are all zero is allowed as well: the row
    is read and its output popcount is exact.  The block engine's
    live-block scan passes ones for every row, as it does not know the
    popcounts it asks the kernel for."""
    if a.device.type == "cpu":
        return bitmap_setop_plain(a, b, opcode)
    if a.device.type != "cuda":
        raise ValueError(f"bitmap_setop: unsupported device {a.device}")
    n, w = a.shape
    dev = a.device
    _build.expect(a, "a", torch.int32, (n, w), dev)
    _build.expect(b, "b", torch.int32, (n, w), dev)
    _build.expect(a_pops, "a_pops", torch.int32, (n,), dev)
    _build.expect(b_pops, "b_pops", torch.int32, (n,), dev)
    if opcode not in (AND, OR, ANDNOT):
        raise ValueError(f"bad opcode {opcode}")
    out = torch.empty_like(a)
    pops = torch.empty(n, dtype=torch.int32, device=dev)
    with torch.cuda.device(dev):
        rc = _build.lib().rt_bitmap_setop(
            a.data_ptr(), a_pops.data_ptr(), b.data_ptr(), b_pops.data_ptr(),
            int(opcode), n, w, out.data_ptr(), pops.data_ptr(),
            torch.cuda.current_stream(dev).cuda_stream)
    _build.check(rc, "bitmap_setop")
    _build.count_launch("bitmap_setop")
    return out, pops


class SetOp(NamedTuple):
    """One operation of a grouped launch: ``out = a OP b`` with the
    result's per-row popcount written to ``out_pops``.  Every bitmap is
    i32[N, W] and every popcount i32[N]; ``a_pops`` and ``b_pops`` must be
    the exact popcounts of ``a`` and ``b`` (the kernel reads no word of a
    row whose popcount is 0)."""

    a: torch.Tensor
    a_pops: torch.Tensor
    b: torch.Tensor
    b_pops: torch.Tensor
    out: torch.Tensor
    out_pops: torch.Tensor
    opcode: int


#: int64 fields per op in the grouped launch's table (csrc GroupedField)
_GROUPED_FIELDS = 7


def bitmap_setop_grouped_plain(levels: Sequence[Sequence[SetOp]]) -> None:
    for level in levels:
        for op in level:
            out, pops = bitmap_setop_plain(op.a, op.b, op.opcode)
            op.out.copy_(out)
            op.out_pops.copy_(pops)


def _check_grouped(op: SetOp, shape, device) -> None:
    for name in ("a", "b", "out"):
        _build.expect(getattr(op, name), name, torch.int32, shape, device)
    for name in ("a_pops", "b_pops", "out_pops"):
        _build.expect(getattr(op, name), name, torch.int32, shape[:1],
                      device)
    if op.opcode not in (AND, OR, ANDNOT):
        raise ValueError(f"bad opcode {op.opcode}")


def bitmap_setop_grouped(levels: Sequence[Sequence[SetOp]]) -> None:
    """Run the :class:`SetOp` s of each level, one launch per level, in
    level order: an op may read the outputs of earlier levels, never of
    its own.  Every op shares one shape i32[N, W].  Writes the outputs in
    place; returns nothing.  Every level's table is built in one pinned
    host buffer, taken fresh from torch's pinned caching allocator (which
    keeps a block until the copy that read it has run), and uploaded with
    one copy that does not sync the host."""
    levels = [lv for lv in levels if lv]
    if not levels:
        return
    dev = levels[0][0].a.device
    if dev.type == "cpu":
        return bitmap_setop_grouped_plain(levels)
    if dev.type != "cuda":
        raise ValueError(f"bitmap_setop_grouped: unsupported device {dev}")
    shape = levels[0][0].a.shape
    if len(shape) != 2:
        raise ValueError("bitmaps must be i32[N, W]")
    n, w = shape
    fields = []
    for level in levels:
        for op in level:
            _check_grouped(op, shape, dev)
            fields += (op.a.data_ptr(), op.b.data_ptr(), op.out.data_ptr(),
                       op.a_pops.data_ptr(), op.b_pops.data_ptr(),
                       op.out_pops.data_ptr(), int(op.opcode))
    host = torch.tensor(fields, dtype=torch.int64).pin_memory()
    table = host.to(dev, non_blocking=True)
    base = table.data_ptr()
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.lib()
    with torch.cuda.device(dev):
        for level in levels:
            rc = lib.rt_bitmap_setop_grouped(base, len(level), n, w, stream)
            _build.check(rc, "bitmap_setop_grouped")
            _build.count_launch("bitmap_setop_grouped")
            base += 8 * _GROUPED_FIELDS * len(level)


#: a stacked set operation's input: one set's bits i32[N, W] and its
#: exact per-row popcounts i32[N]
Row = Tuple[torch.Tensor, torch.Tensor]

#: rows one stacked launch reads by pointer (csrc kMaxStackRows); a wider
#: stack launches in chunks of this many rows, each counted as a launch
MAX_STACK_ROWS = 128


def _check_rows(rows: Sequence[Row], shape, device, name: str) -> None:
    if not rows:
        raise ValueError(f"{name}: needs at least one row")
    for j, (bits, pops) in enumerate(rows):
        _build.expect(bits, f"rows[{j}] bits", torch.int32, shape, device)
        _build.expect(pops, f"rows[{j}] pops", torch.int32, shape[:1],
                      device)


def _row_pointers(rows: Sequence[Row]) -> np.ndarray:
    """The host int64 array of (bits, pops) device addresses the C entry
    copies into the launch's parameters."""
    return np.array([p for bits, pops in rows
                     for p in (bits.data_ptr(), pops.data_ptr())],
                    dtype=np.int64)


def bitmap_inter_multi_plain(a: torch.Tensor, a_pops: torch.Tensor,
                             rows: Sequence[Row]):
    out = torch.stack([bits for bits, _ in rows]) & a[None]
    return out, ref.popcount_ref(out)


def bitmap_inter_multi(a: torch.Tensor, a_pops: torch.Tensor,
                       rows: Sequence[Row]):
    """One set ANDed into each of Q sets, with the fused popcount.

    a i32[N, W] with its exact popcounts a_pops i32[N]; rows: Q pairs
    (bits i32[N, W], exact popcounts i32[N]) -> (i32[Q, N, W], i32[Q, N]).
    The stacked form of K2 the lockstep atom-cache hit path uses (the
    reference computes it in jnp, ``bits & a[None]`` over a stack).  The
    kernel reads the rows where they lie: no stacked copy is made."""
    if a.device.type == "cpu":
        return bitmap_inter_multi_plain(a, a_pops, rows)
    if a.device.type != "cuda":
        raise ValueError(f"bitmap_inter_multi: unsupported device {a.device}")
    n, w = a.shape
    _build.expect(a, "a", torch.int32, (n, w), a.device)
    _build.expect(a_pops, "a_pops", torch.int32, (n,), a.device)
    _check_rows(rows, (n, w), a.device, "bitmap_inter_multi")
    q = len(rows)
    out = torch.empty((q, n, w), dtype=torch.int32, device=a.device)
    pops = torch.empty((q, n), dtype=torch.int32, device=a.device)
    stream = torch.cuda.current_stream(a.device).cuda_stream
    lib = _build.lib()
    with torch.cuda.device(a.device):
        for j0 in range(0, q, MAX_STACK_ROWS):
            chunk = rows[j0: j0 + MAX_STACK_ROWS]
            ptrs = _row_pointers(chunk)
            rc = lib.rt_bitmap_inter_multi(
                ptrs.ctypes.data, len(chunk), a.data_ptr(), a_pops.data_ptr(),
                n, w, out[j0].data_ptr(), pops[j0].data_ptr(), stream)
            _build.check(rc, "bitmap_inter_multi")
            _build.count_launch("bitmap_inter_multi", len(chunk))
    return out, pops


def bitmap_union_reduce_plain(rows: Sequence[Row]):
    stack = torch.stack([bits for bits, _ in rows])
    out = stack[0].clone()
    for j in range(1, stack.shape[0]):
        out |= stack[j]
    return (out, ref.popcount_ref(out), stack,
            torch.stack([pops for _, pops in rows]))


def bitmap_union_reduce(rows: Sequence[Row]):
    """OR of Q sets, with the fused popcount, and the stacked copy of the
    sets written in the same pass.

    rows: Q >= 1 pairs (bits i32[N, W], exact popcounts i32[N]) -> (union
    i32[N, W], its popcounts i32[N], the stack i32[Q, N, W], its popcounts
    i32[Q, N]).  The lockstep union the reference computes in jnp (an OR
    chain over the stack); the stack is what the Q-stacked scans (K5, K6)
    and the zone blend read, so no separate stacked copy is made."""
    if not rows:
        raise ValueError("bitmap_union_reduce: needs at least one row")
    dev = rows[0][0].device
    if dev.type == "cpu":
        return bitmap_union_reduce_plain(rows)
    if dev.type != "cuda":
        raise ValueError(f"bitmap_union_reduce: unsupported device {dev}")
    shape = tuple(rows[0][0].shape)
    if len(shape) != 2:
        raise ValueError("bitmaps must be i32[N, W]")
    _check_rows(rows, shape, dev, "bitmap_union_reduce")
    n, w = shape
    q = len(rows)
    out = torch.empty((n, w), dtype=torch.int32, device=dev)
    pops = torch.empty(n, dtype=torch.int32, device=dev)
    stack = torch.empty((q, n, w), dtype=torch.int32, device=dev)
    stack_pops = torch.empty((q, n), dtype=torch.int32, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    lib = _build.lib()
    with torch.cuda.device(dev):
        for j0 in range(0, q, MAX_STACK_ROWS):
            chunk = rows[j0: j0 + MAX_STACK_ROWS]
            ptrs = _row_pointers(chunk)
            rc = lib.rt_bitmap_union_reduce(
                ptrs.ctypes.data, len(chunk), n, w, int(j0 > 0),
                stack[j0].data_ptr(), stack_pops[j0].data_ptr(),
                out.data_ptr(), pops.data_ptr(), stream)
            _build.check(rc, "bitmap_union_reduce")
            _build.count_launch("bitmap_union_reduce", len(chunk))
    return out, pops, stack, stack_pops
