"""Predicate-plan request routing.

``RequestRouter`` evaluates admission/routing *rule sets* over a
request-metadata column batch through the multi-query layer
(columnar.multiquery): the same ShallowFish/DeepFish plans used in the
data pipeline, served from a cross-call plan cache with per-batch atom
dedupe (e.g. "(tier = pro OR prompt_tokens < 2k) AND NOT flagged"
alongside its sibling routing rules).

The reference's batched generation engine (``ServeEngine``) is LM code and
is not part of this package yet.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np

from ..columnar.bitmap import unpack_bits
from ..columnar.config import ExecConfig
from ..columnar.multiquery import BatchResult, LRUPlanCache, QuerySession
from ..columnar.table import Table
from ..core import Node


class RequestRouter:
    """Route batches of requests through a *rule set* of predicate plans.

    A router holds one predicate per route/policy (admission tiers, replica
    targeting, abuse filters, ...) and evaluates the whole set against a
    request-metadata column batch in a single :class:`QuerySession` — plans
    are served from an LRU cache that persists across ``route`` calls, and
    atoms repeated across rules are evaluated once per batch.  The original
    single-expression ``admit`` API is kept (a request is admitted if any
    rule accepts it).
    """

    def __init__(self, exprs, planner: str = "auto", engine: str = "tape",
                 plan_cache: Optional[LRUPlanCache] = None,
                 share_threshold: int = 2, persistent: bool = False,
                 device: str = "cuda"):
        """``engine`` accepts every :class:`QuerySession` engine; with
        ``"tape"`` (the default) the rule set runs device-resident on
        ``device`` — the power-of-two shape bucketing in the device backend
        means routers seeing drifting batch sizes reuse device programs
        across calls.  ``"jax"`` / ``"pallas"`` (one path in the port)
        run the rules in lockstep on the per-step block engine, its
        kernels on ``device``.  The numpy oracle (the reference's default
        engine) runs on the host: ``engine="numpy", device="cpu"``.

        ``persistent=True`` turns the router into a *streaming* router: the
        request metadata accumulates in one append-only table (every
        ``route`` call is a :meth:`Table.append`), served by a single
        long-lived session — so per-call cost is proportional to the new
        requests, not the history: cached atom results splice in only the
        appended rows and device backends upload only dirty tail blocks.
        Each call still returns the route matrix for *its own* requests.
        """
        if isinstance(exprs, Node):
            exprs = [exprs]
        self.exprs = list(exprs)
        if not self.exprs:
            raise ValueError("RequestRouter needs at least one rule")
        self.planner = planner
        self.engine = engine
        self.device = device
        # explicit None-check: an empty LRUPlanCache is falsy (len == 0)
        self.plan_cache = plan_cache if plan_cache is not None else LRUPlanCache()
        self.share_threshold = share_threshold
        self.persistent = persistent
        self.table: Optional[Table] = None
        self._session: Optional[QuerySession] = None
        self.last_result: Optional[BatchResult] = None

    def route(self, requests: Dict[str, np.ndarray]) -> np.ndarray:
        """requests: columnar dict of per-request metadata arrays.
        Returns a (n_rules, n_requests) boolean route matrix."""
        arrays = {k: np.asarray(v) for k, v in requests.items()}
        cfg = ExecConfig(planner=self.planner, engine=self.engine,
                         plan_cache=self.plan_cache,
                         share_threshold=self.share_threshold,
                         device=self.device)
        if not self.persistent:
            table = Table(arrays)
            session = QuerySession(table, config=cfg)
            self.last_result = session.execute(self.exprs)
            return self.last_result.masks(table.n_records)
        if self.table is None:
            self.table = Table(arrays)
            self._session = QuerySession(self.table, config=cfg)
            start = 0
        else:
            start = self.table.append(arrays)
        self.last_result = self._session.execute(self.exprs)
        # unpack only this call's rows (word-sliced): per-call cost must
        # stay proportional to the batch, not the accumulated history
        n = self.table.n_records
        w0 = start // 32
        return np.stack([unpack_bits(bm[w0:], n - w0 * 32)[start - w0 * 32:]
                         for bm in self.last_result.bitmaps])

    def admit(self, requests: Dict[str, np.ndarray]) -> np.ndarray:
        """Boolean admit mask: requests accepted by at least one rule."""
        return self.route(requests).any(axis=0)
