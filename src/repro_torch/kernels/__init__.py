"""Hand-written CUDA kernels for the compiled-tape engine, with their plain
PyTorch versions.

predicate_scan.py — K1: (col OP value) ∧ D, dead-block skip, popcount;
                    K5: the same for Q stacked record sets
bitmap_ops.py     — K2: AND / OR / ANDNOT + popcount; the stacked AND and
                    OR-reduce of the lockstep executor
fused_chain.py    — K3: K comparisons under ∧ / ∨, then ∧ D
dict_lookup.py    — K4: dictionary-code membership in a packed hit set;
                    K6: the same for Q stacked record sets
ops.py            — record-major entry points with the reference's signatures
ref.py            — plain versions (the CPU path and the kernels' oracle)
_build.py         — nvcc build of csrc/*.cu at first use, launch counters
                    (and, for the stacked kernels, launches by Q)
"""
from . import ops, ref
from ._build import LAUNCHES, LAUNCHES_BY_Q, reset_launches
from .bitmap_ops import (AND, ANDNOT, OR, bitmap_inter_multi, bitmap_setop,
                         bitmap_union_reduce)
from .dict_lookup import dict_lookup_scan, dict_lookup_scan_multi
from .fused_chain import fused_chain_scan
from .predicate_scan import predicate_scan, predicate_scan_multi

__all__ = ["ops", "ref", "LAUNCHES", "LAUNCHES_BY_Q", "reset_launches",
           "AND", "OR", "ANDNOT", "bitmap_setop", "bitmap_inter_multi",
           "bitmap_union_reduce",
           "predicate_scan", "predicate_scan_multi", "fused_chain_scan",
           "dict_lookup_scan", "dict_lookup_scan_multi"]
