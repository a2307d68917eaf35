"""Packed record-id bitmaps (numpy reference implementation).

Record sets are ``uint32`` arrays, 32 records per word, LSB-first.  These are
the column store's "lightweight index structures" (paper §2.1); set ops are
word-wise logical ops.  The torch mirrors live in ``repro_torch.kernels``
(ref.py / ops.py); tests assert equivalence against this module.
"""
from __future__ import annotations

import numpy as np

WORD = 32


def n_words(n_records: int) -> int:
    return (n_records + WORD - 1) // WORD


def pack_bits(mask: np.ndarray) -> np.ndarray:
    """bool[n] -> uint32[ceil(n/32)], LSB-first within each word."""
    mask = np.asarray(mask, dtype=bool)
    n = mask.shape[0]
    pad = (-n) % WORD
    if pad:
        mask = np.concatenate([mask, np.zeros(pad, dtype=bool)])
    b = np.packbits(mask.reshape(-1, WORD), axis=1, bitorder="little")
    return b.view(np.uint32).reshape(-1).copy()


def unpack_bits(words: np.ndarray, n_records: int) -> np.ndarray:
    """uint32[w] -> bool[n_records]."""
    b = np.unpackbits(words.view(np.uint8), bitorder="little")
    return b[:n_records].astype(bool)


def popcount(words: np.ndarray) -> int:
    return int(np.unpackbits(words.view(np.uint8), bitorder="little").sum())


#: popcount of every 16-bit value
_POP16 = np.unpackbits(np.arange(1 << 16, dtype=np.uint16).view(np.uint8)
                       .reshape(-1, 2), axis=1).sum(axis=1, dtype=np.int32)


def row_popcounts(words: np.ndarray) -> np.ndarray:
    """``uint32[..., W]`` -> ``int32[...]``: the popcount of each row (the
    per-block counts the kernels' dead-block skip reads)."""
    return (_POP16[words & 0xFFFF] + _POP16[words >> 16]).sum(
        axis=-1, dtype=np.int32)


def bitmap_full(n_records: int) -> np.ndarray:
    w = n_words(n_records)
    out = np.full(w, 0xFFFFFFFF, dtype=np.uint32)
    rem = n_records % WORD
    if rem:
        out[-1] = np.uint32((1 << rem) - 1)
    return out


def bitmap_empty(n_records: int) -> np.ndarray:
    return np.zeros(n_words(n_records), dtype=np.uint32)


def bitmap_and(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a & b


def bitmap_or(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    return a | b


def bitmap_andnot(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """a \\ b."""
    return a & ~b


def extend_bitmap(words: np.ndarray, old_n: int, delta_hits: np.ndarray,
                  new_n: int) -> np.ndarray:
    """Grow a packed bitmap over ``old_n`` records to ``new_n`` records,
    setting the bits of the appended rows from ``delta_hits``
    (``bool[new_n - old_n]``).  The streaming delta path: a cached
    full-table atom result stays valid for the untouched prefix and only the
    appended rows are (re)evaluated — this splices the two together without
    unpacking the prefix."""
    delta_hits = np.asarray(delta_hits, dtype=bool)
    if old_n + delta_hits.size != new_n:
        raise ValueError("delta length mismatch")
    out = np.zeros(n_words(new_n), dtype=np.uint32)
    out[: len(words)] = words
    if old_n % WORD == 0:
        # word-aligned prefix: the delta packs independently
        out[old_n // WORD:] = pack_bits(delta_hits)
    else:
        idx = old_n + np.flatnonzero(delta_hits)
        np.bitwise_or.at(out, idx >> 5,
                         np.uint32(1) << (idx & 31).astype(np.uint32))
    return out


def next_pow2(x: int) -> int:
    """Next power of two >= x — the block engines' shape bucket, so every
    table whose padded block count matches shares one kernel shape."""
    return 1 if x <= 1 else 1 << (x - 1).bit_length()


def live_block_count(words: np.ndarray, nblocks: int, wpb: int) -> int:
    """Number of blocks with any set bit in flat packed ``words`` — the
    block-granular touch count shared by every engine's host-fallback
    accounting (keeps the engines' cost reporting identical)."""
    padded = np.zeros(nblocks * wpb, dtype=np.uint32)
    padded[: len(words)] = words
    return int((padded.reshape(nblocks, wpb) != 0).any(axis=1).sum())
