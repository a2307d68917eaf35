"""The entry drivers: how a traffic mix's ``entry`` drives the program.

A mix's ``entry`` names a module of this package, ``drivers/<entry>.py``,
whose ``DRIVER`` class the harness builds, so that a new kind of entry is a
file of its own.  Each driver builds the program's table from the
harness's data, warms the shapes its traffic uses, and then runs one
closed-loop step at a time, noting every answer.  This package is the only
part of the benchmark that imports the program (``repro_torch``).
"""
from __future__ import annotations

import importlib
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional

import numpy as np

from ..cell import Answer
from ..queries import atoms_of

#: threads that fill the program's lazy column statistics and zone maps
#: during set-up (the host's cores; NumPy's sorts run without the GIL)
SETUP_THREADS = 8


def driver_class(entry: str):
    """``drivers/<entry>.py``'s ``DRIVER``."""
    return importlib.import_module(f"{__name__}.{entry}").DRIVER


def to_port(tree):
    """A plain tree as the program's predicate nodes."""
    from repro_torch.core.predicate import And, Atom, Or
    if tree[0] == "atom":
        _, column, op, value = tree
        return Atom(column, op, value)
    kids = [to_port(c) for c in tree[1]]
    return And(kids) if tree[0] == "and" else Or(kids)


def adapt(tree):
    """A plain tree as the program's normalized ``PredicateTree``."""
    from repro_torch.core.predicate import normalize
    return normalize(to_port(tree))


def warm_table(table, names, block: int) -> None:
    """Fill the program's lazy statistics and zone maps of the columns
    ``names``, several columns at a time."""
    def one(name):
        table.stats(name)
        table.zone_map(name, block)
    with ThreadPoolExecutor(SETUP_THREADS) as pool:
        list(pool.map(one, names))


def snapshot_launches() -> Dict:
    from repro_torch.kernels import LAUNCHES, LAUNCHES_BY_Q
    return {"launches": dict(LAUNCHES),
            "launches_by_q": {k: dict(v) for k, v in LAUNCHES_BY_Q.items()}}


class Driver:
    """One entry's closed loop.  ``answers`` and ``spans`` (host spans of
    the harness's calls into the program: name, start, end) grow with each
    :meth:`step`."""

    def __init__(self, ctx):
        self.ctx = ctx
        self.mix = ctx.mix
        self.answers: List[Answer] = []
        self.spans: List[tuple] = []
        self.times: Dict[str, float] = {}     # set-up phases, seconds
        self._kept: Dict[int, np.ndarray] = {}

    def note(self, index: int, words: Optional[np.ndarray],
             latency_ms: float) -> None:
        """Keeps a copy of the first answer to each query; a later answer
        is compared with it and dropped."""
        kept = self._kept.get(index)
        if words is None:
            self.answers.append(Answer(index, None, latency_ms))
        elif kept is None:
            kept = self._kept[index] = np.array(words, copy=True)
            self.answers.append(Answer(index, kept, latency_ms))
        else:
            self.answers.append(Answer(
                index, kept, latency_ms,
                agrees=bool(np.array_equal(words, kept))))

    def _config(self):
        from repro_torch.columnar import ExecConfig
        return ExecConfig(planner=self.mix["planner"], engine="tape",
                          device=self.ctx.device_name, telemetry=False,
                          trace=self.ctx.trace_setting)

    def _table(self):
        from repro_torch.columnar import Table
        t0 = time.perf_counter()
        table = Table(dict(self.ctx.data.columns))
        # the columns the cell's queries read, and no others
        used = sorted({a[1] for t in self.ctx.pool.trees
                       for a in atoms_of(t)})
        warm_table(table, used, self.ctx.cfg["block"])
        self.times["statistics"] = time.perf_counter() - t0
        return table

    def counters(self) -> Dict:
        """Lifetime counters now: the backend's and the kernel wrappers'."""
        be = self.backend()
        out = snapshot_launches()
        out.update(records_evaluated=float(be.stats.records_evaluated),
                   atom_applications=float(be.stats.atom_applications),
                   setops=float(be.stats.setops),
                   blocks_touched=float(be.blocks_touched),
                   graph_captures=float(be.graph_captures))
        return out
