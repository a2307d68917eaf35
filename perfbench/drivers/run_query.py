"""``run_query`` with one reused device backend: every call annotates its
tree's selectivities, plans it and compiles its tape, as a caller of
``run_query`` does."""
from __future__ import annotations

import time

from ..queries import epochs
from . import Driver, adapt


class RunQueryDriver(Driver):

    def setup(self) -> None:
        from repro_torch.columnar import (annotate_selectivities,
                                          resolve_backend, run_query)
        self.annotate, self.run_query = annotate_selectivities, run_query
        self.table = self._table()
        self.cfg = self._config()
        self.be = resolve_backend(self.table, self.cfg)
        for _ in range(2):           # capture every tape, then replay it
            for i in range(len(self.ctx.pool.trees)):
                self._query(i)
        self.order = epochs(len(self.ctx.pool.trees), self.ctx.seed)

    def backend(self):
        return self.be

    def _query(self, i: int):
        tree = self.annotate(adapt(self.ctx.pool.trees[i]), self.table)
        res, _, _ = self.run_query(tree, self.table, config=self.cfg,
                                   backend=self.be)
        return res

    def step(self) -> None:
        i = next(self.order)
        t0 = time.perf_counter()
        res = self._query(i)
        t1 = time.perf_counter()
        self.spans.append(("run_query", t0, t1))
        self.note(i, res, (t1 - t0) * 1e3)

    def close(self) -> None:
        self.be = self.table = None


DRIVER = RunQueryDriver
