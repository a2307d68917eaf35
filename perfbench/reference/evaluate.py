"""Plain evaluation of the benchmark's predicate trees.

Every atom is one vectorised comparison over all records of the harness's
own column.  Nothing here reads the program's statistics, plans or
caches; nothing imports the program or JAX.

``dtype`` is the precision the comparisons run in: float32, the
configuration's, or a lower one for the control (bfloat16 rounds every
value and constant before comparing).
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

WORD = 32

_OPS = {
    "lt": torch.lt, "le": torch.le, "gt": torch.gt, "ge": torch.ge,
    "eq": torch.eq, "ne": torch.ne,
}


class Reference:
    """Evaluates plain trees over ``n`` records of ``columns`` (column
    name -> f32 or int32 values, host arrays)."""

    def __init__(self, columns: Dict[str, np.ndarray], device="cpu",
                 dtype: torch.dtype = torch.float32):
        self.columns = columns
        self.device = torch.device(device)
        self.dtype = dtype
        lens = {len(v) for v in columns.values()}
        if len(lens) != 1:
            raise ValueError("ragged reference columns")
        self.n = lens.pop()
        self._cols: Dict[str, torch.Tensor] = {}

    def _column(self, name: str) -> torch.Tensor:
        col = self._cols.get(name)
        if col is None:
            col = torch.from_numpy(np.ascontiguousarray(
                self.columns[name])).to(self.device)
            self._cols[name] = col
        return col

    def _atom(self, column: str, op: str, value) -> torch.Tensor:
        x = self._column(column).to(self.dtype)
        c = torch.tensor(float(value), dtype=torch.float32).to(self.dtype)
        return _OPS[op](x, c.to(self.device))

    def evaluate(self, tree) -> torch.Tensor:
        """``bool[n]``: the records that satisfy ``tree``."""
        if tree[0] == "atom":
            return self._atom(*tree[1:])
        parts = [self.evaluate(c) for c in tree[1]]
        out = parts[0].clone()
        for p in parts[1:]:
            if tree[0] == "and":
                out &= p
            else:
                out |= p
        return out

    def words(self, tree) -> np.ndarray:
        return pack_words(self.evaluate(tree))

    def release(self) -> None:
        self._cols.clear()


def pack_words(mask: torch.Tensor) -> np.ndarray:
    """``bool[n]`` -> ``uint32[ceil(n / 32)]``, record ``i`` at bit
    ``i % 32`` of word ``i // 32`` (least significant bit first)."""
    n = mask.numel()
    pad = (-n) % WORD
    if pad:
        mask = torch.cat([mask, mask.new_zeros(pad)])
    shifts = torch.arange(WORD, device=mask.device, dtype=torch.int64)
    w = (mask.view(-1, WORD).to(torch.int64) << shifts).sum(dim=1)
    return w.cpu().numpy().astype(np.uint32)


def _popcount(words: np.ndarray) -> int:
    return int(np.unpackbits(words.view(np.uint8)).sum())


def compare_answer(got: np.ndarray, ref: np.ndarray, n: int
                   ) -> Optional[int]:
    """None when ``got`` is exactly the reference's answer over the first
    ``n`` records, else the number of records that differ (a wrong length
    counts every record)."""
    nw = -(-n // WORD)
    got = np.asarray(got).view(np.uint32)
    if got.shape != (nw,):
        return n
    full, rem = divmod(n, WORD)
    want = ref[:nw].copy()
    if rem:
        want[-1] &= np.uint32((1 << rem) - 1)
    if np.array_equal(got, want):
        return None
    return max(_popcount(got ^ want), 1)
