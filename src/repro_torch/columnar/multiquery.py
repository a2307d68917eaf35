"""Multi-query batch execution: plan cache + cross-query atom sharing.

A serving system sees many concurrent queries against the *same* table,
where the dominant redundancy is cross-query: repeated plan shapes and
repeated ``(column, op, value)`` atoms.  :class:`QuerySession` exploits
both for a batch of predicate trees:

plan cache       an LRU keyed by :func:`~repro_torch.core.predicate.canonical_key`
                 (tree shape + quantized per-atom selectivity/cost buckets).
                 Plans are stored as *canonical positions* and remapped onto
                 any key-equal tree, so structurally identical queries over
                 drifting-but-in-bucket statistics replan for free.  A drift
                 past the bucket edge changes the key and misses naturally.

atom dedupe      atoms whose :func:`~repro_torch.core.predicate.atom_key` appears
                 in >= ``share_threshold`` queries of the batch are
                 evaluated on the full table exactly once; every further
                 application (any query, any plan position) reduces to a
                 set-AND against the cached bitmap — each unique shared atom
                 touches its column once per batch.

lockstep batching
                 with ``batched=True`` (default for the block engines) the
                 ordering-based plans are driven round-by-round through
                 :class:`~repro_torch.core.bestd.BestDMachine` (correct for any
                 ordering, Thm 4); requests for the same atom arriving in
                 the same round stack their per-query live-block bitmaps
                 into ONE fused kernel launch: ``predicate_scan_multi``
                 (K5) on the block engines, K5 or ``dict_lookup_scan_multi``
                 (K6) on the tape engine's :class:`~repro_torch.columnar.
                 device.DeviceTapeBackend`.

Correctness is engine-independent: an atom's record set does not depend on
the set it is applied to (``apply_atom(a, d) == apply_atom(a, full) & d``),
so shared results are bit-identical to per-query evaluation — the
differential tests sweep this against independent ``run_query`` calls.
"""
from __future__ import annotations

import time
from collections import Counter, OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence, Union

import numpy as np

from ..core import deepfish, nooropt, optimal_plan, shallowfish
from ..core.bestd import BestDMachine
from ..core.cost import CostModel, PerAtomCostModel
from ..core.feedback import FeedbackStore, qerror
from ..core.plan import Plan, execute_plan, finalize_plan
from ..core.predicate import (Atom, DICT_SEL_STEP, Node, PredicateTree,
                              atom_key, canonical_key, decode_column,
                              normalize, tree_copy)
from ..core.sets import SetBackend
from ..runtime import faults as _faults
from ..runtime.telemetry import (QERROR_BUCKETS, publish_scalars,
                                 resolve_registry, scalar_snapshot)
from .config import UNSET, ExecConfig, config_from_kwargs
from .executor import resolve_backend
from .table import Table, annotate_selectivities, rewrite_string_atoms
from .trace import backend_counters, null_span, resolve_tracer

_PLANNERS = {"shallowfish": shallowfish, "deepfish": deepfish,
             "optimal": optimal_plan, "nooropt": nooropt}
# planners whose Plan.order fully determines execution (BestD-compatible);
# only these are cacheable/lockstep-able — nooropt re-derives its own walk.
_ORDERED = ("shallowfish", "deepfish", "optimal")


# ---------------------------------------------------------------------------
# Plan cache
# ---------------------------------------------------------------------------

@dataclass
class PlanCacheStats:
    hits: int = 0
    misses: int = 0
    evictions: int = 0      # capacity (LRU) evictions only
    tape_hits: int = 0      # compiled host tapes served by rebinding
    # Q-Error feedback-loop accounting (distinct from LRU `evictions`):
    drift_evictions: int = 0   # entries evicted for realized-Q-Error drift
    sel_step_retunes: int = 0  # auto-tune sel_step adjustments

    @property
    def hit_rate(self) -> float:
        total = self.hits + self.misses
        return self.hits / total if total else 0.0

    def as_dict(self) -> Dict[str, float]:
        return scalar_snapshot(self, extra=("hit_rate",))

    def publish(self, registry, labels=None) -> None:
        publish_scalars(registry, "repro_plan_cache", self.as_dict(),
                        labels, help="LRU plan cache lifetime counters")


class LRUPlanCache:
    """LRU plan cache keyed by canonical tree shape + quantized statistics.

    ``sel_step`` / ``cost_step`` are the quantization buckets fed to
    :func:`canonical_key`; ``capacity`` bounds the entry count (least
    recently used evicted first).  One cache may serve many tables/batches:
    the key contains everything the planners consume.

    Entries optionally carry the compiled host-side
    :class:`~repro_torch.core.tape.PlanTape` (``with_tape=True``): a hit then
    skips the whole trace / chain-fusion / DCE / slot-allocation pipeline
    by *rebinding* the cached tape's atom ids onto the key-equal tree
    through the canonical atom permutation
    (:func:`~repro_torch.core.tape.rebind_tape`) — closing the remaining
    per-query host work on the tape engines.
    """

    def __init__(self, capacity: int = 256, sel_step: float = 0.05,
                 cost_step: float = 0.5,
                 dict_sel_step: Optional[float] = DICT_SEL_STEP,
                 drift_threshold: float = 2.0, drift_consecutive: int = 2,
                 auto_tune: bool = False):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self.sel_step = sel_step
        self.cost_step = cost_step
        # eviction-on-drift (the Q-Error feedback loop's cache contract):
        # an entry served with realized plan Q-Error > drift_threshold for
        # drift_consecutive consecutive servings is evicted, so the next
        # key-equal query replans against the *current* statistics instead
        # of riding a stale within-bucket ordering forever.  Distinct from
        # capacity eviction; counted in ``stats.drift_evictions``.
        self.drift_threshold = drift_threshold
        self.drift_consecutive = drift_consecutive
        # opt-in sel_step auto-tune: widen buckets when plans are healthy
        # but the hit rate is poor, tighten them when realized quality says
        # the buckets hide real drift.  Off by default — a step change
        # clears the cache, which sessions pinning hit-count contracts
        # (e.g. the streaming rebind gates) must not pay implicitly.
        self.auto_tune = auto_tune
        self._tune_window = 64
        self._tune_served = 0
        self._tune_bad = 0
        self._tune_hits0 = 0
        self._tune_misses0 = 0
        # dictionary-code atoms carry EXACT selectivities (computed from
        # code frequencies), so they get a much tighter bucket than the
        # generic sel_step; None buckets them coarsely like everything
        # else — the "dict_buckets" section of bench_multiquery.py
        # (--strings, default on) measures the tradeoff
        self.dict_sel_step = dict_sel_step
        # full_key -> {"cpos": plan order in canonical positions,
        #              "inv": aid -> canonical position for the tree the
        #                     cached tape was compiled against,
        #              "tape": PlanTape or None}
        self._entries: "OrderedDict[tuple, dict]" = OrderedDict()
        self.stats = PlanCacheStats()

    def __len__(self) -> int:
        return len(self._entries)

    def get_or_plan(self, tree: PredicateTree, planner: str,
                    model: Optional[CostModel] = None,
                    total_records: float = 1.0, with_tape: bool = False):
        """Serve a plan for ``tree`` from cache, planning on a miss.

        With ``with_tape=True`` returns ``(plan, tape)`` where ``tape`` is
        the compiled :class:`PlanTape` — rebound from the cached one on a
        hit, compiled (and cached) on a miss.
        """
        from ..core.tape import compile_tape, rebind_tape
        model = model or PerAtomCostModel()
        if planner not in _ORDERED:
            plan = _PLANNERS[planner](tree, model,
                                      total_records=total_records)
            return (plan, compile_tape(plan)) if with_tape else plan
        t0 = time.perf_counter()
        key, atom_order = canonical_key(tree, self.sel_step, self.cost_step,
                                        self.dict_sel_step)
        # repr of the (frozen dataclass) model pins its type + parameters:
        # plans found under one cost model must not serve another
        full_key = (planner, tree.n, repr(model), key)
        ent = self._entries.get(full_key)
        if ent is not None:
            self._entries.move_to_end(full_key)
            self.stats.hits += 1
            order = [atom_order[p] for p in ent["cpos"]]
            plan = finalize_plan(tree, order, planner, model, t0,
                                 total_records)
            plan.cache_key = full_key
            if not with_tape:
                return plan
            if ent["tape"] is None:
                # plan was cached tape-less (a non-tape engine filled it):
                # compile once, reuse by rebinding from here on
                ent["tape"] = compile_tape(plan)
                ent["inv"] = {aid: p for p, aid in enumerate(atom_order)}
                return plan, ent["tape"]
            self.stats.tape_hits += 1
            inv = ent["inv"]
            aid_map = [atom_order[inv[a]] for a in range(tree.n)]
            return plan, rebind_tape(ent["tape"], tree, aid_map)
        self.stats.misses += 1
        plan = _PLANNERS[planner](tree, model, total_records=total_records)
        plan.cache_key = full_key
        inv = {aid: p for p, aid in enumerate(atom_order)}
        tape = compile_tape(plan) if with_tape else None
        self._entries[full_key] = {
            "cpos": [inv[aid] for aid in plan.order],
            "inv": inv, "tape": tape, "bad": 0}
        if len(self._entries) > self.capacity:
            self._entries.popitem(last=False)
            self.stats.evictions += 1
        return (plan, tape) if with_tape else plan

    # -- Q-Error feedback (eviction-on-drift + sel_step auto-tune) -------------
    def record_served(self, full_key: Optional[tuple], qerr: float) -> bool:
        """Report the realized plan Q-Error of a serving of ``full_key``
        (recorded *after* execution — a serving always runs to completion).
        A streak of ``drift_consecutive`` servings above ``drift_threshold``
        evicts the entry so the next key-equal query replans on current
        statistics.  Returns True when this report evicted the entry."""
        evicted = False
        ent = self._entries.get(full_key) if full_key is not None else None
        if ent is not None:
            if qerr > self.drift_threshold:
                ent["bad"] = ent.get("bad", 0) + 1
                if ent["bad"] >= self.drift_consecutive:
                    del self._entries[full_key]
                    self.stats.drift_evictions += 1
                    evicted = True
            else:
                ent["bad"] = 0
        if self.auto_tune:
            self._maybe_retune(qerr)
        return evicted

    _SEL_STEP_MIN = 0.00625
    _SEL_STEP_MAX = 0.2

    def _maybe_retune(self, qerr: float) -> None:
        """Auto-tune ``sel_step`` from observed hit rate vs realized plan
        quality over a sliding window: buckets that hide drift (many bad
        servings) tighten, healthy-but-missing buckets widen.  Any change
        clears the cache — every cached position list was keyed under the
        old quantization."""
        self._tune_served += 1
        if qerr > self.drift_threshold:
            self._tune_bad += 1
        if self._tune_served < self._tune_window:
            return
        hits = self.stats.hits - self._tune_hits0
        misses = self.stats.misses - self._tune_misses0
        bad_rate = self._tune_bad / self._tune_served
        hit_rate = hits / (hits + misses) if (hits + misses) else 0.0
        new_step = self.sel_step
        if bad_rate > 0.25:
            new_step = max(self._SEL_STEP_MIN, self.sel_step / 2.0)
        elif bad_rate < 0.02 and hit_rate < 0.5:
            new_step = min(self._SEL_STEP_MAX, self.sel_step * 2.0)
        if new_step != self.sel_step:
            self.sel_step = new_step
            self._entries.clear()
            self.stats.sel_step_retunes += 1
        self._tune_served = self._tune_bad = 0
        self._tune_hits0 = self.stats.hits
        self._tune_misses0 = self.stats.misses


# ---------------------------------------------------------------------------
# Batch bookkeeping
# ---------------------------------------------------------------------------

@dataclass
class BatchStats:
    """Per-batch accounting for the two sharing dimensions."""

    n_queries: int = 0
    logical_atoms: int = 0       # atom applications the executors requested
    physical_atoms: int = 0      # column touches actually performed
    atom_cache_hits: int = 0     # applications served as a pure set-AND
    unique_atom_keys: int = 0
    shared_atom_keys: int = 0    # keys PROMOTED to the shared |R| cache
    # selective-sharing decision trail: candidates passed the census
    # (appear in >= share_threshold queries); a candidate promotes only
    # when the summed expected count(D)/|R| over its applications
    # (sharing_frac_sums[key], from the plans' own BestD estimates) clears
    # the session's share_margin — otherwise the |R| full-table touch
    # costs more than the applications it would replace
    shared_candidate_keys: int = 0
    shared_rejected_keys: int = 0
    sharing_frac_sums: Dict[tuple, float] = field(default_factory=dict)
    kernel_batches: int = 0      # grouped multi-bitmap kernel invocations
    plan_cache_hits: int = 0
    plan_cache_misses: int = 0
    tape_cache_hits: int = 0     # compiled tapes served by rebinding
    lockstep_rounds: int = 0
    # streaming-delta accounting: appended-row reuse of cached atom results
    atoms_delta_extended: int = 0   # cached atom bitmaps spliced, not redone
    delta_rows_evaluated: float = 0.0  # appended rows actually (re)evaluated
    delta_rows_reused: float = 0.0     # prefix rows served from cache
    upload_bytes: float = 0.0          # host->device column bytes this batch
    # Q-Error feedback loop: realized selectivities surfaced from the
    # engines' per-op popcounts (already paid for by cost accounting — no
    # extra syncs), compared against the planner's estimates
    feedback_observations: int = 0     # per-op (est, realized) pairs logged
    max_qerror: float = 0.0            # worst per-op Q-Error this batch
    mean_qerror: float = 0.0           # mean per-op Q-Error this batch
    atom_qerrors: Dict[tuple, float] = field(default_factory=dict)
    plan_qerrors: List[float] = field(default_factory=list)  # per query
    drift_evictions: int = 0           # plan-cache entries evicted for drift
    # per-batch engine counter deltas (observability PR): the backends keep
    # *lifetime* counters (a reused device backend accumulates forever);
    # execute() snapshots them around the batch so each BatchStats carries
    # a reset-safe per-batch view — host_syncs here IS the one-sync
    # contract readout for this batch
    host_syncs: int = 0
    device_dispatches: int = 0
    host_fallbacks: int = 0
    blocks_touched: float = 0.0
    blocks_pruned: float = 0.0
    records_evaluated: float = 0.0
    weighted_cost: float = 0.0
    # raw engine op log for this batch: (atom_keys, est, src, out) tuples,
    # drained EVERY batch — with feedback off the log previously sat
    # undrained until the cap, leaking stale observations into whichever
    # consumer drained next (explain_analyze reads these)
    op_observations: List[tuple] = field(default_factory=list, repr=False)

    @property
    def dedupe_ratio(self) -> float:
        """Logical / physical atom applications (> 1 means sharing paid)."""
        return (self.logical_atoms / self.physical_atoms
                if self.physical_atoms else 0.0)

    @property
    def plan_hit_rate(self) -> float:
        total = self.plan_cache_hits + self.plan_cache_misses
        return self.plan_cache_hits / total if total else 0.0

    @property
    def delta_reuse_ratio(self) -> float:
        """Fraction of cached-atom rows served without re-evaluation after
        appends (1.0 = only appended rows were touched)."""
        total = self.delta_rows_reused + self.delta_rows_evaluated
        return self.delta_rows_reused / total if total else 0.0

    def as_dict(self) -> Dict[str, float]:
        """Scalar snapshot (the shared stats protocol: field names are the
        metric suffixes; see :func:`repro_torch.runtime.telemetry.scalar_snapshot`)."""
        return scalar_snapshot(
            self, extra=("dedupe_ratio", "plan_hit_rate",
                         "delta_reuse_ratio"))

    def publish(self, registry, labels=None) -> None:
        """Increment per-batch counters + qerror histogram into
        ``registry`` (counters take deltas — BatchStats IS a per-batch
        delta, so everything monotone publishes as ``repro_batch_*_total``)."""
        if registry is None:
            return
        lb = dict(labels or {})
        d = self.as_dict()
        for name in _BATCH_COUNTER_FIELDS:
            v = d.get(name, 0)
            if v:
                registry.counter(f"repro_batch_{name}_total",
                                 _BATCH_COUNTER_FIELDS[name]).inc(v, **lb)
        registry.counter("repro_batches_total", "executed batches").inc(
            1, **lb)
        registry.counter("repro_queries_total", "executed queries").inc(
            self.n_queries, **lb)
        h = registry.histogram("repro_op_qerror", "per-op realized Q-Error",
                               buckets=QERROR_BUCKETS)
        for pq in self.plan_qerrors:
            registry.histogram(
                "repro_plan_qerror", "per-plan realized Q-Error",
                buckets=QERROR_BUCKETS).observe(pq, **lb)
        for keys, est, src, out in self.op_observations:
            if src > 0:
                h.observe(qerror(est, out / src), **lb)


#: BatchStats fields published as per-batch counter increments (name ->
#: help text); the rest of as_dict() is snapshot-only (gauges/ratios)
_BATCH_COUNTER_FIELDS: Dict[str, str] = {
    "logical_atoms": "atom applications requested by executors",
    "physical_atoms": "column touches actually performed",
    "atom_cache_hits": "applications served as a pure set-AND",
    "shared_atom_keys": "atom keys promoted to the shared |R| cache",
    "kernel_batches": "fused multi-bitmap kernel invocations",
    "plan_cache_hits": "plan cache hits",
    "plan_cache_misses": "plan cache misses",
    "tape_cache_hits": "compiled tapes served by rebinding",
    "lockstep_rounds": "lockstep executor rounds",
    "atoms_delta_extended": "cached atom bitmaps spliced after append",
    "delta_rows_evaluated": "appended rows (re)evaluated",
    "delta_rows_reused": "prefix rows served from cache",
    "upload_bytes": "host->device column bytes",
    "feedback_observations": "per-op (est, realized) pairs logged",
    "drift_evictions": "plan-cache entries evicted for drift",
    "host_syncs": "bundled device->host syncs",
    "device_dispatches": "device kernel dispatches",
    "host_fallbacks": "host gather fallbacks",
    "blocks_touched": "blocks touched by evaluations",
    "blocks_pruned": "blocks decided by zone maps alone",
    "records_evaluated": "records evaluated (the paper's cost metric)",
    "weighted_cost": "cost-factor weighted records evaluated",
}


@dataclass
class BatchResult:
    """Output of :meth:`QuerySession.execute`."""

    bitmaps: List[np.ndarray]
    plans: List[Plan]
    stats: BatchStats
    backend: Optional[SetBackend] = None
    wall_s: float = 0.0

    def masks(self, n_records: int) -> np.ndarray:
        """Unpack to a (n_queries, n_records) boolean matrix."""
        from .bitmap import unpack_bits
        return np.stack([unpack_bits(b, n_records) for b in self.bitmaps])


class _SharedAtomBackend(SetBackend):
    """Wraps an engine backend with an atom-result cache.

    Atoms whose key is in ``shared_keys`` are evaluated once on the full
    table; every application then reduces to a set-AND against the cached
    bitmap.  Exclusive atoms pass straight through to the engine's
    count(D) path.  Set algebra delegates to the engine unchanged, so the
    wrapper plugs into every existing executor.

    ``cache`` may be a session-owned dict that outlives the batch
    (cross-batch result reuse); entries cached in an earlier batch hit even
    for atoms below this batch's share threshold.
    """

    def __init__(self, inner: SetBackend, shared_keys: set,
                 bstats: BatchStats, cache: Optional[Dict] = None):
        self.inner = inner
        self.shared_keys = shared_keys
        self.bstats = bstats
        self.cache: Dict[tuple, object] = {} if cache is None else cache
        self.stats = inner.stats      # executors introspect .stats

    def full(self):
        return self.inner.full()

    def empty(self):
        return self.inner.empty()

    def inter(self, a, b):
        return self.inner.inter(a, b)

    def union(self, a, b):
        return self.inner.union(a, b)

    def diff(self, a, b):
        return self.inner.diff(a, b)

    def count(self, d) -> float:
        return self.inner.count(d)

    def apply_atom(self, atom, d):
        self.bstats.logical_atoms += 1
        key = atom_key(atom)
        sat = self.cache.get(key)
        if sat is None:
            if key not in self.shared_keys:
                return self.inner.apply_atom(atom, d)
            # first touch of a shared atom: pay |R| once, amortized over
            # every later application in the batch
            sat = self.inner.apply_atom(atom, self.inner.full())
            self.cache[key] = sat
        else:
            self.bstats.atom_cache_hits += 1
        return self.inner.inter(sat, d)


# ---------------------------------------------------------------------------
# The session
# ---------------------------------------------------------------------------

class QuerySession:
    """Executes batches of predicate queries against one table with
    cross-query plan + atom-result sharing.

    Parameters
    ----------
    The construction path is ``QuerySession(table,
    config=ExecConfig(...))`` — see :class:`~repro_torch.columnar.config.
    ExecConfig`.  Every kwarg below keeps working as a legacy spelling
    through the deprecation shim (one warning per kwarg name per process);
    mixing ``config=`` with legacy kwargs raises
    :class:`~repro_torch.columnar.config.ConfigError`.  ``shards > 1``
    runs the tape engine block-sharded
    (:class:`~repro_torch.columnar.shard.ShardedTapeBackend`), per query
    and in lockstep, with the same one host sync per batch.

    table:            the columnar table every query in a batch targets
    planner:          shallowfish | deepfish | optimal | nooropt | auto
                      (auto = shallowfish for depth <= 2, else deepfish)
    engine:           numpy | jax | pallas | tape | tape-pallas.  The block
                      engines (jax/pallas, two names for one path in the
                      port: :class:`~repro_torch.columnar.executor.
                      BlockBackend`) run one fused kernel per step with
                      host-resident bitmaps.  The numpy oracle needs
                      ``device="cpu"``.  The tape engines keep every bitmap
                      device-resident
                      (:class:`~repro_torch.columnar.device.DeviceTapeBackend`):
                      by default each plan compiles to a
                      :class:`~repro_torch.core.tape.PlanTape` executed as ONE
                      device program with one host sync per query, while
                      ``batched=True`` instead drives the lockstep executor
                      over device sets (fused multi-query atom kernels, one
                      bundled host sync per batch).
    plan_cache:       an :class:`LRUPlanCache`; persists across ``execute``
                      calls (and may be shared between sessions)
    share_threshold:  min queries an atom key must appear in to become a
                      sharing *candidate* (default 2); candidates then pass
                      the selective-sharing cost check (see share_margin)
    share_margin:     promote a candidate to the shared full-table cache
                      only when the summed expected count(D)/|R| over its
                      applications (the plans' BestD step estimates) is at
                      least this margin — the |R| touch must beat the
                      applications it replaces.  1.0 (default) is
                      break-even; None promotes every candidate (the
                      pre-heuristic census behavior).  The decision is
                      exposed in BatchStats.shared_candidate_keys /
                      shared_rejected_keys / sharing_frac_sums.
    zone_prune:       let the block/device backends prune NONE/ALL blocks
                      via the table's zone maps before paying the costed
                      column touch (default on; results are bit-identical
                      either way).  On the tape engines the per-atom
                      verdict masks reach the kernels as runtime data, so
                      appends rebuild nothing.
    batched:          True = lockstep multi-bitmap execution (device-
                      resident on the tape engines), False = sequential
                      per-query execution, "auto" = lockstep on jax/pallas,
                      per-query compiled tapes on the tape engines
    persist_atom_cache: keep shared-atom results across ``execute`` calls,
                      invalidated when ``table.version`` moves (any
                      ``set_column`` write)
    rewrite_strings:  rewrite dict-encodable string atoms into numeric
                      comparisons over dictionary codes before planning
                      (:func:`~repro_torch.columnar.table.rewrite_string_atoms`).
                      Applied before the atom census, so code-space atoms
                      share ``atom_key`` results across queries exactly
                      like native numeric atoms — and the tape engines keep
                      their one-sync contract on mixed plans.
    feedback:         the Q-Error feedback loop.  True (default) creates a
                      per-session :class:`~repro_torch.core.feedback.FeedbackStore`;
                      pass a store to share one across sessions, or False
                      to disable.  After every batch the engines' realized
                      per-op selectivities (from popcounts the cost
                      accounting already pays for — zero extra host syncs)
                      are compared against the planner estimates; per-plan
                      Q-Errors feed the plan cache's eviction-on-drift and
                      per-key traffic stats feed the sharing discount.
    feedback_absorb:  additionally merge observed truth back into the
                      *estimator*: full-truth observations update
                      per-atom-key selectivities blended into annotation,
                      and realized CDF anchors warp the table's mergeable
                      quantile sketches
                      (:func:`~repro_torch.columnar.ingest.absorb_cdf_anchor`).
                      Off by default — corrected estimates move atoms
                      across canonical-key buckets, i.e. key-equal repeats
                      deliberately *replan* on the better statistics, which
                      sessions pinning cache-hit contracts must opt into
                      (same posture as ``LRUPlanCache.auto_tune``).
                      Requires ``feedback``; only meaningful with
                      ``annotate=True``.
    """

    _ENGINES = ("numpy", "jax", "pallas", "tape", "tape-pallas")

    def __init__(self, table: Table, planner=UNSET, engine=UNSET,
                 model=UNSET, plan_cache=UNSET, share_threshold=UNSET,
                 batched=UNSET, block=UNSET, annotate=UNSET,
                 persist_atom_cache=UNSET, rewrite_strings=UNSET,
                 zone_prune=UNSET, share_margin=UNSET, feedback=UNSET,
                 feedback_absorb=UNSET,
                 config: Optional[ExecConfig] = None):
        cfg = config_from_kwargs(
            config, planner=planner, engine=engine, model=model,
            plan_cache=plan_cache, share_threshold=share_threshold,
            batched=batched, block=block, annotate=annotate,
            persist_atom_cache=persist_atom_cache,
            rewrite_strings=rewrite_strings, zone_prune=zone_prune,
            share_margin=share_margin, feedback=feedback,
            feedback_absorb=feedback_absorb)
        self.config = cfg
        self.table = table
        self.planner = cfg.planner
        self.engine = cfg.engine
        self.model = cfg.model or PerAtomCostModel()
        # explicit None-check: an empty LRUPlanCache is falsy (len == 0)
        self.plan_cache = (cfg.plan_cache if cfg.plan_cache is not None
                           else LRUPlanCache())
        self.share_threshold = cfg.share_threshold
        self.batched = cfg.batched
        self.block = cfg.block
        self.annotate = cfg.annotate
        self.persist_atom_cache = cfg.persist_atom_cache
        self.rewrite_strings = cfg.rewrite_strings
        self.zone_prune = cfg.zone_prune
        self.share_margin = cfg.share_margin
        if cfg.feedback is True:
            self.feedback: Optional[FeedbackStore] = FeedbackStore()
        elif cfg.feedback:
            self.feedback = cfg.feedback
        else:
            self.feedback = None
        self.feedback_absorb = (cfg.feedback_absorb
                                and self.feedback is not None)
        # observability plane: a registry to publish per-batch
        # deltas into and a tracer for host wall-clock spans; both None
        # when disabled — the hot path guards on None, not on flags
        self.telemetry = resolve_registry(cfg.telemetry)
        self.tracer = resolve_tracer(cfg.trace)
        self.last_result: Optional[BatchResult] = None
        self._atom_cache: Dict[tuple, object] = {}
        self._cache_version = self._table_fingerprint()
        self._backend: Optional[SetBackend] = None
        self._backend_version: Optional[tuple] = None

    # -- helpers --------------------------------------------------------------
    def _table_fingerprint(self) -> tuple:
        """Write detector for the session's caches: the ``version`` counter
        (``set_column`` writes) plus column-array identities, so the
        ``table.columns[name] = arr`` rebinding idiom also invalidates.
        In-place element writes (``table[name][:] = v``) are not detectable
        — use :meth:`Table.set_column` for those."""
        return (self.table.version,
                tuple((k, id(v)) for k, v in self.table.columns.items()))

    def _make_backend(self, appended_from: Optional[int] = None
                      ) -> SetBackend:
        if self.engine == "numpy":
            return resolve_backend(self.table, self.config)
        # the block/device engines hold uploaded columns: reuse one backend
        # across batches until a table write invalidates it; a *pure append*
        # (proven via Table.delta_since) refreshes the backend in place —
        # only the dirty tail blocks re-upload (shard-local on the sharded
        # backend)
        fp = self._table_fingerprint()
        if self._backend is not None:
            if self._backend_version == fp:
                return self._backend
            if appended_from is not None and hasattr(self._backend,
                                                     "refresh"):
                self._backend.refresh()
                self._backend_version = fp
                return self._backend
        be = resolve_backend(self.table, self.config)
        self._backend = be
        self._backend_version = fp
        return be

    def reset_backend(self) -> None:
        """Drop the engine backend and every backend-resident cache (the
        post-device-fault recovery hook: after a CUDA runtime error the
        backend's device buffers and pending counter queues are suspect).
        The next ``execute`` rebuilds from the table — a full re-upload,
        never wrong results."""
        self._backend = None
        self._backend_version = None
        self._atom_cache.clear()
        self._cache_version = self._table_fingerprint()

    def _extend_atom_cache(self, from_row: int, backend: SetBackend,
                           stats: BatchStats) -> None:
        """Splice appended rows into the persisted atom-result cache: each
        cached full-table bitmap stays valid for rows below ``from_row``
        (the append boundary, per the block-epoch contract), so only the
        delta evaluates — cost ∝ rows appended, not |R|."""
        n = self.table.n_records
        idx = np.arange(from_row, n)
        for key in list(self._atom_cache):
            col, op, value = key
            if isinstance(value, tuple) and value[:1] == ("fn",):
                del self._atom_cache[key]     # opaque UDF: can't re-evaluate
                continue
            atom = Atom(col, op, value)
            try:
                hits = self.table.eval_atom(atom, idx)
                self._atom_cache[key] = backend.extend_set(
                    self._atom_cache[key], from_row, hits)
            except (NotImplementedError, KeyError):
                del self._atom_cache[key]
                continue
            stats.atoms_delta_extended += 1
            stats.delta_rows_evaluated += len(idx)
            stats.delta_rows_reused += from_row

    def _resolve_planner(self, tree: PredicateTree) -> str:
        if self.planner == "auto":
            return "shallowfish" if tree.depth <= 2 else "deepfish"
        return self.planner

    def _promote_shared(self, trees: Sequence[PredicateTree],
                        plans: Sequence[Plan], candidates: set,
                        stats: BatchStats) -> set:
        """Cost-model the shared-evaluation promotion (ROADMAP's selective
        sharing policy): evaluating a shared atom costs one |R| full-table
        touch, while leaving it exclusive costs the sum of count(D) over
        its applications.  The plans already carry BestD's expected
        ``count(D_i)/|R|`` per step (``Plan.est_fracs``), so a candidate
        promotes iff its summed expected fraction clears ``share_margin``
        (1.0 = break-even; below it the |R| touch would *add* work — the
        classic mistake of sharing a highly-pruned atom).  Plans without
        step estimates (nooropt) count 1.0 per application, reproducing the
        census behavior; ``share_margin=None`` disables the heuristic
        entirely.  The decision trail lands in
        ``BatchStats.sharing_frac_sums``.

        With feedback enabled the margin is *traffic-aware*: the per-batch
        check is myopic for long-lived sessions, where a promoted atom's
        |R| touch amortizes across future batches at delta-splice cost.
        Each candidate's margin is discounted by its expected future
        repeats (``FeedbackStore.expected_repeats`` — cross-batch repeat
        rate times a bounded horizon), so hot keys promote on evidence
        while one-off atoms still face the full break-even bar.
        """
        if not candidates:
            return set()
        frac_sums: Dict[tuple, float] = {k: 0.0 for k in candidates}
        for t, p in zip(trees, plans):
            if p.order and p.est_fracs:
                for aid, frac in zip(p.order, p.est_fracs):
                    k = atom_key(t.atoms[aid])
                    if k in frac_sums:
                        frac_sums[k] += frac
            else:
                for a in t.atoms:
                    k = atom_key(a)
                    if k in frac_sums:
                        frac_sums[k] += 1.0
        stats.sharing_frac_sums = frac_sums
        if self.share_margin is None:
            return set(candidates)
        shared = set()
        for k, s in frac_sums.items():
            margin = self.share_margin
            if self.feedback is not None:
                margin = margin / (1.0 + self.feedback.expected_repeats(k))
            if s >= margin:
                shared.add(k)
        return shared

    # -- entry point ----------------------------------------------------------
    def execute(self, queries: Sequence[Union[Node, PredicateTree]]
                ) -> BatchResult:
        """Plan + execute a batch; returns per-query record bitmaps (in
        input order) plus the batch's sharing statistics."""
        tr = self.tracer
        if tr is None:
            return self._execute_impl(queries)
        with tr.span("batch.execute", queries=len(queries),
                     engine=self.engine):
            return self._execute_impl(queries)

    def _execute_impl(self, queries: Sequence[Union[Node, PredicateTree]]
                      ) -> BatchResult:
        t0 = time.perf_counter()
        tr = self.tracer
        sp = tr.span if tr is not None else null_span
        # fault-plane hook: a test can poison one query of the batch (the
        # stream layer's quarantine must fail only that query's future)
        if _faults.fault_plane().active:
            for i, q in enumerate(queries):
                _faults.trip("query.plan", index=i, query=q)
        with sp("batch.annotate"):
            if self.annotate:
                # work on private copies: annotation overwrites atom
                # selectivities, and caller-supplied trees (hand-set stats,
                # UDF atoms the table cannot estimate) must stay untouched
                trees = [normalize(tree_copy(q.root
                                             if isinstance(q, PredicateTree)
                                             else q)) for q in queries]
                fb = self.feedback if self.feedback_absorb else None
                for t in trees:
                    annotate_selectivities(t, self.table, feedback=fb)
            else:
                trees = [q if isinstance(q, PredicateTree)
                         else normalize(tree_copy(q)) for q in queries]
        if self.rewrite_strings:
            # after annotation: the rewrite stamps exact selectivities on
            # the code-space atoms from the dictionary value frequencies
            with sp("batch.rewrite_strings"):
                trees = [rewrite_string_atoms(t, self.table) for t in trees]
        stats = BatchStats(n_queries=len(trees))
        planners = [self._resolve_planner(t) for t in trees]
        # "auto": lockstep for the per-step block engines (their win is the
        # fused multi-query kernel); compiled whole-plan tapes for the
        # device engines (their win is one dispatch + one sync per query).
        # batched=True forces device-resident lockstep on any block engine.
        tape_engine = self.engine in ("tape", "tape-pallas")
        lockstep = ((self.batched is True
                     or (self.batched == "auto"
                         and self.engine in ("jax", "pallas")))
                    and all(pl in _ORDERED for pl in planners))
        use_tapes = tape_engine and not lockstep
        cs = self.plan_cache.stats
        h0, m0, th0 = cs.hits, cs.misses, cs.tape_hits
        tapes: Optional[List] = None
        with sp("batch.plan") as psp:
            if use_tapes:
                # per-query compiled tapes: plan-cache hits rebind the
                # cached host tape (no re-trace/DCE/slot-allocation)
                pairs = [self.plan_cache.get_or_plan(
                             t, pl, self.model,
                             total_records=self.table.n_records,
                             with_tape=True)
                         for t, pl in zip(trees, planners)]
                plans = [p for p, _ in pairs]
                tapes = [tp for _, tp in pairs]
            else:
                plans = [self.plan_cache.get_or_plan(
                             t, pl, self.model,
                             total_records=self.table.n_records)
                         for t, pl in zip(trees, planners)]
            stats.plan_cache_hits = cs.hits - h0
            stats.plan_cache_misses = cs.misses - m0
            stats.tape_cache_hits = cs.tape_hits - th0
            psp.set(hits=stats.plan_cache_hits,
                    misses=stats.plan_cache_misses,
                    tape_hits=stats.tape_cache_hits)

        # cross-query atom census (per-query *sets*: an atom repeated inside
        # one query does not make it shared)
        per_query = [set(atom_key(a) for a in t.atoms) for t in trees]
        census = Counter(k for keys in per_query for k in keys)
        stats.unique_atom_keys = len(census)
        candidates = {k for k, c in census.items()
                      if c >= self.share_threshold}
        stats.shared_candidate_keys = len(candidates)
        shared = self._promote_shared(trees, plans, candidates, stats)
        stats.shared_atom_keys = len(shared)
        stats.shared_rejected_keys = len(candidates) - len(shared)

        # cross-batch atom-result reuse: results persist across execute()
        # calls until a table write is detected.  A write explained as a
        # pure *append* (Table.delta_since, the block-epoch contract) keeps
        # every cached result: the backend refreshes in place (tail-block
        # upload only) and cached atom bitmaps splice in the delta rows
        # instead of re-evaluating the full table.
        fp = self._table_fingerprint()
        appended_from: Optional[int] = None
        if fp != self._cache_version:
            appended_from = self.table.delta_since(self._cache_version[0])
            if (appended_from is not None
                    and appended_from >= self.table.n_records):
                # version never moved yet arrays were rebound: treat as a
                # full rewrite (the rebind idiom bypasses the mutation log)
                appended_from = None
        up0 = (getattr(self._backend, "uploaded_bytes", 0)
               if self._backend is not None else 0)
        reuse_backend = self._backend
        # lifetime-counter snapshot for the per-batch delta view (the
        # backends never reset; BatchStats carries the reset-safe deltas)
        c0 = (backend_counters(reuse_backend)
              if reuse_backend is not None else None)
        with sp("batch.upload", appended_from=appended_from):
            inner = self._make_backend(appended_from)
            if fp != self._cache_version:
                if appended_from is None:
                    self._atom_cache.clear()
                elif appended_from < self.table.n_records:
                    self._extend_atom_cache(appended_from, inner, stats)
                self._cache_version = fp
        sb = _SharedAtomBackend(
            inner, shared, stats,
            cache=self._atom_cache if self.persist_atom_cache else None)
        base_applications = inner.stats.atom_applications
        base_records = inner.stats.records_evaluated
        base_cost = inner.stats.weighted_cost
        with sp("batch.dispatch", lockstep=lockstep, tapes=use_tapes):
            if lockstep:
                bitmaps = self._execute_lockstep(trees, plans, sb, stats)
            elif tape_engine:
                bitmaps = [inner.run_tape(tp) for tp in tapes]
                stats.logical_atoms += sum(len(p.tree.atoms) for p in plans)
            else:
                bitmaps = [execute_plan(p, sb) for p in plans]
        with sp("batch.sync"):
            if hasattr(inner, "materialize") and bitmaps and not isinstance(
                    bitmaps[0], np.ndarray):
                # device engines: ONE bundled host sync for the whole batch
                bitmaps = inner.materialize(bitmaps)
            lw = self.table.live_words()
            if lw is not None:
                # tombstone deletes: the engines evaluated over all
                # physical rows (their caches stay prefix-valid — deletes
                # never move rows); dead rows drop here, at materialize
                # time
                bitmaps = [b & lw for b in bitmaps]
        stats.physical_atoms = (inner.stats.atom_applications
                                - base_applications)
        stats.upload_bytes = (getattr(inner, "uploaded_bytes", 0)
                              - (up0 if inner is reuse_backend else 0))
        stats.records_evaluated = (inner.stats.records_evaluated
                                   - base_records)
        stats.weighted_cost = inner.stats.weighted_cost - base_cost
        c1 = backend_counters(inner)
        if inner is reuse_backend and c0 is not None:
            for k in c1:
                c1[k] -= c0[k]
        stats.host_syncs = int(c1["host_syncs"])
        stats.device_dispatches = int(c1["device_dispatches"]
                                      + c1["kernel_invocations"])
        stats.host_fallbacks = int(c1["host_fallbacks"])
        stats.blocks_touched = c1["blocks_touched"]
        stats.blocks_pruned = c1["blocks_pruned"]
        # drain the engine op log EVERY batch, not only under feedback:
        # with feedback off the log used to sit undrained until its cap,
        # leaking stale observations into whichever consumer drained next
        # (the never-reset-between-drains audit).  explain_analyze reads
        # these realized per-op popcounts off the BatchStats.
        stats.op_observations = (inner.drain_op_log()
                                 if hasattr(inner, "drain_op_log") else [])
        if self.feedback is not None:
            with sp("batch.feedback"):
                self._absorb_feedback(trees, plans, stats)
        result = BatchResult(bitmaps=bitmaps, plans=plans, stats=stats,
                             backend=inner,
                             wall_s=time.perf_counter() - t0)
        self.last_result = result
        if self.telemetry is not None:
            self._publish_batch(stats, inner, result.wall_s)
        return result

    def _publish_batch(self, stats: BatchStats, inner: SetBackend,
                       wall_s: float) -> None:
        """Publish the finished batch into the metrics registry: per-batch
        deltas as counters, lifetime collaborator state as gauges.  Host
        work only — every device number here already crossed on the
        batch's bundled sync."""
        reg = self.telemetry
        labels = {"engine": self.engine, "planner": self.planner,
                  "shards": self.config.shards}
        stats.publish(reg, labels)
        reg.histogram("repro_batch_wall_ms",
                      "QuerySession.execute wall clock").observe(
            wall_s * 1000.0, **labels)
        self.plan_cache.stats.publish(reg)
        inner.stats.publish(reg, labels)
        if self.feedback is not None:
            self.feedback.publish(reg)

    # -- the Q-Error feedback loop (runs after the batch's bundled sync) -------
    def _absorb_feedback(self, trees: Sequence[PredicateTree],
                         plans: Sequence[Plan], stats: BatchStats) -> None:
        """Close the loop on a finished batch: compare realized per-op
        selectivities (``stats.op_observations``, drained from the engine's
        op log — popcounts the cost accounting already computed, so zero
        extra syncs/dispatches) against the estimates, attribute Q-Errors
        to atom keys and plans, report servings to the plan cache's
        eviction-on-drift, and — with ``feedback_absorb`` — merge
        full-truth observations back into the estimator (per-key
        selectivities + quantile-sketch CDF anchors)."""
        fb = self.feedback
        n = self.table.n_records
        key_qerr: Dict[tuple, float] = {}
        qerrs: List[float] = []
        for keys, est, src, out in stats.op_observations:
            if src <= 0:
                continue
            if len(keys) == 1:
                qe = fb.observe(keys[0], est, src, out, n)
            else:
                # multi-atom fused group: realized truth is conditional on
                # the group connective — judge the estimate, do not absorb
                qe = qerror(est, out / src, weight=src)
                fb.observations += 1
            qerrs.append(qe)
            for k in keys:
                key_qerr[k] = max(key_qerr.get(k, 1.0), qe)
        stats.feedback_observations = len(qerrs)
        if qerrs:
            stats.max_qerror = max(qerrs)
            stats.mean_qerror = sum(qerrs) / len(qerrs)
        stats.atom_qerrors = key_qerr
        # cross-batch traffic: which keys showed up this batch (feeds the
        # repeat-rate share_margin discount on the next batch)
        fb.note_batch(k for t in trees for k in
                      set(atom_key(a) for a in t.atoms))
        # per-plan realized quality -> eviction-on-drift.  Recorded AFTER
        # execution: a served plan always runs to completion, the *next*
        # key-equal query replans when the streak trips.
        for t, p in zip(trees, plans):
            observed = [key_qerr[k] for k in
                        (atom_key(a) for a in t.atoms) if k in key_qerr]
            pq = max(observed) if observed else 1.0
            stats.plan_qerrors.append(pq)
            if p.cache_key is not None:
                if self.plan_cache.record_served(p.cache_key, pq):
                    stats.drift_evictions += 1
        if self.feedback_absorb:
            from .ingest import absorb_cdf_anchor
            for column, value, cdf, rows in fb.drain_anchors():
                if decode_column(column) is not None:
                    continue    # code-space estimates are already exact
                absorb_cdf_anchor(self.table, column, value, cdf, rows)

    # -- lockstep batched executor --------------------------------------------
    def _execute_lockstep(self, trees: List[PredicateTree],
                          plans: List[Plan], sb: _SharedAtomBackend,
                          stats: BatchStats) -> List[np.ndarray]:
        """Drive all plans through BestD machines one step per round; same-
        atom requests in a round run as one multi-bitmap kernel invocation.

        BestD is correct for *any* ordering (Thm 4), so every ordered plan —
        including ShallowFish's — executes here with identical results to
        its native executor (a few more set ops for the depth-first orders).
        """
        inner = sb.inner
        machines = [BestDMachine(t, sb) for t in trees]
        cursors = [0] * len(trees)
        while True:
            pending: List[tuple] = []
            for qi, (m, p) in enumerate(zip(machines, plans)):
                if cursors[qi] < len(p.order):
                    aid = p.order[cursors[qi]]
                    atom, d = m.begin_step(aid)
                    pending.append((qi, aid, atom, d))
            if not pending:
                break
            stats.lockstep_rounds += 1
            groups: "OrderedDict[tuple, list]" = OrderedDict()
            for req in pending:
                groups.setdefault(atom_key(req[2]), []).append(req)
            for key, reqs in groups.items():
                stats.logical_atoms += len(reqs)
                atom = reqs[0][2]
                sat_full = sb.cache.get(key)
                if sat_full is not None:
                    stats.atom_cache_hits += len(reqs)
                    # one stacked dispatch on device backends (not one
                    # setop per query): the cache hit must stay cheaper
                    # than the fused atom kernel it replaces
                    sats = inner.inter_multi(sat_full,
                                             [d for (_, _, _, d) in reqs])
                elif key in sb.shared_keys:
                    # one fused kernel invocation over the stacked live
                    # bitmaps, plus a full-table row seeding the atom cache
                    ds = [d for (_, _, _, d) in reqs] + [inner.full()]
                    outs = inner.apply_atom_multi(atom, ds)
                    sb.cache[key] = outs[-1]
                    sats = outs[:-1]
                    stats.kernel_batches += 1
                elif len(reqs) > 1:
                    stats.kernel_batches += 1
                    sats = inner.apply_atom_multi(
                        atom, [d for (_, _, _, d) in reqs])
                else:
                    sats = [inner.apply_atom(atom, reqs[0][3])]
                for (qi, aid, _, d), sat in zip(reqs, sats):
                    machines[qi].finish_step(aid, d, sat)
                    cursors[qi] += 1
        return [m.result() for m in machines]
