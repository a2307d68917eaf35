"""Record-major entry points with the signatures of the reference's
``repro.kernels.ops`` wrappers (``predicate_blocks``,
``predicate_blocks_multi``, ``dict_lookup_blocks``, ``bitmap_op``,
``fused_chain_blocks``), so tests hold the two packages
against each other argument for argument.

Packed words are int32 tensors holding the reference's u32 bit patterns.
The block popcounts the kernels take for their dead-block skip are
computed here with the plain popcount unless the caller passes them: the
per-step block engine (``columnar.executor.BlockBackend``) already holds
them, so on the card its calls run no plain function.  Each call runs the
kernel on CUDA tensors and the plain version on CPU tensors.
"""
from __future__ import annotations

from typing import Optional, Sequence

import torch

from . import ref
from .bitmap_ops import bitmap_setop
from .dict_lookup import dict_lookup_scan
from .fused_chain import fused_chain_scan
from .predicate_scan import predicate_scan, predicate_scan_multi


def predicate_blocks(col: torch.Tensor, bits: torch.Tensor, value,
                     opcode: int, pops: Optional[torch.Tensor] = None
                     ) -> torch.Tensor:
    """Fused (col OP value) ∧ bits.  col: f32[N, B]; bits: i32[N, W];
    pops: i32[N], the exact per-block popcounts of ``bits`` (counted with
    the plain popcount when None)."""
    if pops is None:
        pops = ref.popcount_ref(bits)
    return predicate_scan(col, bits, pops, value, opcode)[0]


def predicate_blocks_multi(col: torch.Tensor, bits: torch.Tensor, value,
                           opcode: int, pops: Optional[torch.Tensor] = None
                           ) -> torch.Tensor:
    """Q-stacked :func:`predicate_blocks`: Q record sets against one column
    copy in one launch.  col: f32[N, B]; bits: i32[Q, N, W]; pops:
    i32[Q, N], the exact per-block popcounts of ``bits`` (counted with the
    plain popcount when None)."""
    q, n, w = bits.shape
    flat = bits.reshape(q * n, w)
    pops = ref.popcount_ref(flat) if pops is None else pops.reshape(q * n)
    return predicate_scan_multi(col, flat, pops, value,
                                opcode)[0].reshape(q, n, w)


def dict_lookup_blocks(col: torch.Tensor, bits: torch.Tensor,
                       mask_words: torch.Tensor) -> torch.Tensor:
    """Fused dictionary-membership lookup ∧ bits.  col: f32[N, B] codes;
    bits: i32[N, W]; mask_words: i32[U]."""
    return dict_lookup_scan(col, bits, ref.popcount_ref(bits),
                            mask_words)[0]


def bitmap_op(a: torch.Tensor, b: torch.Tensor, opcode: int,
              a_pops: Optional[torch.Tensor] = None,
              b_pops: Optional[torch.Tensor] = None):
    """Fused set op + per-row popcount.  a, b: i32[N, W]; a_pops, b_pops:
    i32[N] (counted with the plain popcount when None).

    K2 reads only whether a row's input popcount is 0 (a dead row reads no
    word), so a caller that does not know the popcounts may pass any
    nonzero count for every row: each row is then read and its output
    popcount is still exact.  The block engine's live-block scan does so
    (``bitmap_op(u, u, AND, ones, ones)``), whose output popcounts are
    what it asks for."""
    if a_pops is None:
        a_pops = ref.popcount_ref(a)
    if b_pops is None:
        b_pops = ref.popcount_ref(b)
    return bitmap_setop(a, b, opcode, a_pops, b_pops)


def fused_chain_blocks(cols: torch.Tensor, bits: torch.Tensor,
                       values: Sequence[float], opcodes: Sequence[int],
                       conj: bool = True) -> torch.Tensor:
    """Fused K-atom chain.  cols: f32[K, N, B]; bits: i32[N, W]."""
    return fused_chain_scan([c for c in cols], bits, ref.popcount_ref(bits),
                            [float(v) for v in values],
                            [int(o) for o in opcodes], conj)[0]
