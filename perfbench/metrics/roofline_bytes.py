"""The bytes the window's predicate work needs, counted from the program's
counters and the table's real record count, whatever kernel does the work.

Each input byte counts once and each output byte once.  A record set is a
packed bitmap of the table's real records (4 B a word, 32 records a word):
the block bucket's padding past the last record is never counted.

- An atom application reads its column's values (4 B a record) in every
  block it touches.  The program counts the blocks it touched (live blocks
  of the input set that the zone maps could not decide, each atom of a
  fused chain apart, once per stacked launch); padding blocks hold no live
  record and are never touched.  Its bitmap words (2 bits a record against
  the column's 32) are left out, so this side reads low by at most 1/16.
- A two-operand set operation reads two sets and writes one.
- A stacked AND of Q sets with one set reads Q + 1 sets and writes Q.
- An OR-reduce of Q sets reads Q sets and writes one (the stacked copy the
  kernel also writes is the implementation's, not the work's).
"""
from __future__ import annotations

from typing import Dict, Mapping

WORD = 32

#: published HBM bandwidth (bytes/s) by ``torch.cuda.get_device_name()``
#: (NVIDIA's data sheet, SXM part, at its 700 W limit)
PEAK_BYTES_PER_S: Dict[str, float] = {"NVIDIA H100 80GB HBM3": 3.35e12}


def set_bytes(n_records: float) -> float:
    """One packed record set over ``n_records`` real records."""
    return 4.0 * -(-int(n_records) // WORD)


def atom_bytes(blocks_touched: float, block: int, applications: float,
               n_records: float, value_bytes: int = 4) -> float:
    """Column values read by atom applications that touched
    ``blocks_touched`` blocks in all; no application reads more than the
    table's real records."""
    return value_bytes * min(blocks_touched * block,
                             applications * n_records)


def setop_bytes(n_records: float, inputs: float, outputs: float) -> float:
    return set_bytes(n_records) * (inputs + outputs)


def window_bytes(counters: Mapping, n_records: float, block: int,
                 value_bytes: int = 4) -> float:
    """The bytes of the window's work from its counter deltas:
    ``blocks_touched``, ``atom_applications``, ``setops`` (every set
    operation, a stacked AND's Q included) and ``launches_by_q`` (kernel ->
    Q -> launches, for the stacked set operations)."""
    by_q = counters.get("launches_by_q", {})
    inter = by_q.get("bitmap_inter_multi", {})
    union = by_q.get("bitmap_union_reduce", {})
    stacked_ands = sum(int(q) * k for q, k in inter.items())
    out = atom_bytes(counters.get("blocks_touched", 0.0), block,
                     counters.get("atom_applications", 0.0), n_records,
                     value_bytes)
    out += setop_bytes(n_records, 2, 1) * (counters.get("setops", 0)
                                           - stacked_ands)
    out += sum(setop_bytes(n_records, int(q) + 1, int(q)) * k
               for q, k in inter.items())
    out += sum(setop_bytes(n_records, int(q), 1) * k
               for q, k in union.items())
    return out
