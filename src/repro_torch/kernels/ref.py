"""Plain PyTorch versions of the kernels: the CPU path and the oracle the
CUDA kernels are held against.

Layout convention (shared with ``columnar.bitmap`` / numpy packbits
``bitorder="little"``): record ``r`` of a block lives in word ``r // 32``,
bit ``r % 32``.  All functions are shape-polymorphic over a leading batch
(blocks) axis.

Packed words are ``torch.int32`` tensors holding the bit patterns of the
reference's ``uint32`` words: PyTorch's ``uint32`` lacks shifts, ``~`` and
sums on the CPU, so the port keeps signed words and converts at the edges
(``np_words.view(np.int32)`` / ``t.numpy().view(np.uint32)``).  Bits are
extracted as ``(x >> pos) & 1``, which the arithmetic shift leaves exact
for bit 31; packing sums in int64 and wraps to int32 explicitly.

Comparisons run in float32 against a float32 constant, as the reference
does: a Python double is rounded through ``np.float32`` first and never
compared with an f32 tensor directly.  A constant may also be a
one-element float32 tensor (the tape program's device constants).
"""
from __future__ import annotations

from typing import Sequence

import numpy as np
import torch

# opcode table shared with the executors and the CUDA kernels
LT, LE, GT, GE, EQ, NE = range(6)


def _bitpos(device) -> torch.Tensor:
    return torch.arange(32, dtype=torch.int32, device=device)


def unpack_u32(words: torch.Tensor) -> torch.Tensor:
    """int32[..., W] packed words -> bool[..., W*32] (record-major)."""
    bits = (words[..., :, None] >> _bitpos(words.device)) & 1
    return bits.reshape(*words.shape[:-1], -1).bool()


def pack_u32(mask: torch.Tensor) -> torch.Tensor:
    """bool[..., B] -> int32[..., B//32] packed words (bit 31 wraps to the
    sign bit)."""
    b = mask.shape[-1]
    assert b % 32 == 0, "block must be a multiple of 32 records"
    m = mask.reshape(*mask.shape[:-1], b // 32, 32).to(torch.int64)
    weights = torch.ones(32, dtype=torch.int64, device=mask.device) \
        << torch.arange(32, dtype=torch.int64, device=mask.device)
    s = (m * weights).sum(dim=-1)
    return torch.where(s >= 2 ** 31, s - 2 ** 32, s).to(torch.int32)


def f32(value) -> float:
    """Round a comparison constant through float32 (the kernels' type)."""
    return float(np.float32(value))


def compare(col: torch.Tensor, value, opcode: int) -> torch.Tensor:
    """``col OP value`` in float32; NaN compares false except under NE.
    ``value`` is a number or a one-element float32 tensor."""
    if isinstance(value, torch.Tensor):
        if value.dtype != torch.float32 or value.numel() != 1:
            raise ValueError("a tensor constant must be one float32 value")
        v = value.reshape(())
    else:
        # a 0-d CPU tensor enters a CUDA op as a scalar argument: no upload
        v = torch.tensor(f32(value), dtype=torch.float32)
    if opcode == LT:
        return col < v
    if opcode == LE:
        return col <= v
    if opcode == GT:
        return col > v
    if opcode == GE:
        return col >= v
    if opcode == EQ:
        return col == v
    if opcode == NE:
        return col != v
    raise ValueError(f"bad opcode {opcode}")


def predicate_blocks_ref(col: torch.Tensor, bits_in: torch.Tensor, value,
                         opcode: int) -> torch.Tensor:
    """Fused (col OP value) ∧ bits_in over blocked columns.

    col:     f32[N, B]   column values, one row per block
    bits_in: i32[N, W]   packed record bitmap (W = B // 32)
    returns  i32[N, W]   packed (D ∧ P) bitmap
    """
    keep = compare(col, value, opcode) & unpack_u32(bits_in)
    return pack_u32(keep)


def predicate_blocks_multi_ref(col: torch.Tensor, bits_in: torch.Tensor,
                               value, opcode: int) -> torch.Tensor:
    """Q-stacked :func:`predicate_blocks_ref`: the comparison is computed
    once per block and ANDed into Q stacked record sets.

    col:     f32[N, B]      column values, one row per block
    bits_in: i32[Q, N, W]   Q packed record bitmaps (W = B // 32)
    returns  i32[Q, N, W]   packed (D_q ∧ P) bitmaps
    """
    keep = compare(col, value, opcode)[None] & unpack_u32(bits_in)
    return pack_u32(keep)


def codes_of(col: torch.Tensor) -> torch.Tensor:
    """f32 code column -> int32 codes, truncating toward zero.  NaN maps to
    0 and out-of-range values saturate, as the reference's f32 -> int32
    conversion and the CUDA kernel's ``__float2int_rz`` both do."""
    x = torch.nan_to_num(col, nan=0.0)
    c = x.clamp(-2.0 ** 31, 2147483520.0).to(torch.int32)
    return torch.where(x >= 2.0 ** 31, 2 ** 31 - 1, c)


def code_hits(codes: torch.Tensor, mask_words: torch.Tensor) -> torch.Tensor:
    """Membership of int32 ``codes`` (any shape) in a packed hit set.

    ``mask_words`` is i32[U] with bit ``c`` set iff dictionary value ``c``
    satisfies the predicate; codes outside [0, 32*U) are misses.
    """
    u = mask_words.shape[0]
    word = mask_words[torch.clamp(codes >> 5, 0, u - 1).long()]
    hit = ((word >> (codes & 31)) & 1).bool()
    return hit & (codes >= 0) & (codes.long() < 32 * u)


def dict_lookup_ref(col: torch.Tensor, bits_in: torch.Tensor,
                    mask_words: torch.Tensor) -> torch.Tensor:
    """Fused dictionary-membership test ∧ bits_in over blocked code columns.

    col:        f32[N, B]   int dictionary codes stored as f32 blocks
    bits_in:    i32[N, W]   packed record bitmap (W = B // 32)
    mask_words: i32[U]      packed hit set over code space
    returns     i32[N, W]   packed (D ∧ P) bitmap
    """
    hit = code_hits(codes_of(col), mask_words)
    return pack_u32(hit & unpack_u32(bits_in))


def dict_lookup_multi_ref(col: torch.Tensor, bits_in: torch.Tensor,
                          mask_words: torch.Tensor) -> torch.Tensor:
    """Q-stacked :func:`dict_lookup_ref`: the code test is computed once
    per block and ANDed into Q stacked record sets.

    col:        f32[N, B]      int dictionary codes stored as f32 blocks
    bits_in:    i32[Q, N, W]   Q packed record bitmaps
    mask_words: i32[U]         packed hit set over code space
    returns     i32[Q, N, W]   packed (D_q ∧ P) bitmaps
    """
    hit = code_hits(codes_of(col), mask_words)
    return pack_u32(hit[None] & unpack_u32(bits_in))


def bitmap_and_ref(a, b):
    return a & b


def bitmap_or_ref(a, b):
    return a | b


def bitmap_andnot_ref(a, b):
    return a & ~b


def popcount_ref(words: torch.Tensor) -> torch.Tensor:
    """int32[..., W] packed words -> int32 total popcount over the last
    axis."""
    return unpack_u32(words).sum(dim=-1, dtype=torch.int32)


def fused_chain_ref(cols: Sequence[torch.Tensor], bits_in: torch.Tensor,
                    values: Sequence[float], opcodes: Sequence[int],
                    conj: bool = True) -> torch.Tensor:
    """Multi-atom chain fused on the same record blocks (AND or OR combine).

    cols:    K tensors f32[N, B] (or one f32[K, N, B] tensor)
    bits_in: i32[N, W]
    values:  K constants (rounded through f32), or an f32[K] tensor
    opcodes: K opcodes
    """
    acc = None
    for k, op in enumerate(opcodes):
        c = compare(cols[k], values[k], int(op))
        acc = c if acc is None else (acc & c if conj else acc | c)
    return pack_u32(acc & unpack_u32(bits_in))
