"""Async query admission over an append-only table, hardened for serving.

:class:`StreamSession` is the serving front of the streaming-ingest
subsystem: queries are *admitted* into an in-flight batch
(:meth:`submit` returns a :class:`StreamFuture` immediately) while rows
keep appending (:meth:`append`) and dying (:meth:`delete`), and batches
*drain* through a :class:`~repro_torch.columnar.multiquery.QuerySession` — by
default the device-resident lockstep tape executor, whose
one-bundled-host-sync-per-batch contract is untouched because a drain is
just one ``QuerySession.execute`` call.

Consistency contract — **snapshot-at-drain**: every query in a drained
batch evaluates against the table state at drain time (the paper's
optimality results are per-snapshot; interleaved appends/deletes move
which snapshot a query sees, never its correctness).  Each resolved
future records its snapshot (row count + live-row mask), so results stay
auditable after the table moves on.

Serving hardening on top of the cooperative layer:

* **Background drainer with SLOs** (``background=True``): a daemon
  thread (:class:`~repro_torch.columnar.drainer.BackgroundDrainer`) drains on
  deadlines — a batch goes when its oldest query exceeds the lane's wait
  target or total pending hits ``max_pending``.  Two priority lanes:
  ``interactive`` (short deadline, may drain alone, preempting) and
  ``bulk`` (long deadline; when due, waiting interactive queries ride
  along).  Admission past ``max_queue`` blocks (or raises
  :class:`StreamBackpressure` with ``overflow="raise"``).  Admit-to-
  result latency lands in ``stats.latency`` (p50/p99).
* **Graceful degradation**: a failed drain walks a recovery ladder —
  transient faults retry with exponential backoff; device faults reset
  the device backend and re-run the *whole batch* on a host (numpy)
  fallback session (bit-identical results, ``stats.degraded_batches``);
  anything still failing quarantines per query, so a poisoned plan fails
  only its own future (:class:`StreamQueryError`, original exception as
  ``__cause__``) while the rest of the batch resolves normally.  Drains
  never raise; failures surface through futures.
* **Warm restarts** (``cache_dir=...``): plan-cache entries, compiled
  tapes and the feedback store are loaded at construction and flushed at
  :meth:`close` (see :mod:`~repro_torch.columnar.persist`), so a
  restarted server's first drain rebinds cached tapes instead of
  replanning and recompiling (on the card each rebound tape's CUDA graph
  is captured once, at its first run).
* **Tombstone deletes**: :meth:`delete` marks rows dead without bumping
  ``table.version`` — atom caches, device uploads, and zone maps stay
  valid; the live mask is ANDed into every result at materialize time.
  ``auto_compact=<fraction>`` compacts when the dead fraction crosses
  the threshold (the only row-moving mutation; invalidates caches
  through the normal version/delta contract).
* **Durable ingest** (``durable=...``): every mutation is written to a
  checksummed write-ahead log and periodically folded into crash-
  consistent snapshots (see :mod:`~repro_torch.columnar.wal`).  The fsync
  policy is *group commit per drain* by default (``wal_sync="group"``):
  a drain fsyncs the whole buffered mutation suffix once, **before**
  resolving its futures — results handed to callers always describe a
  state that survives a crash — instead of paying an fsync per append
  (``wal_sync="always"`` does, for callers whose acknowledgement
  boundary is the ``append`` return).  Restart with ``table=None`` to
  recover: latest valid snapshot + WAL-tail replay, bit-identical, with
  recovery counters on the telemetry plane, ``/healthz``, and
  :attr:`recovery_info`.  Warm-restart caches are stamped with the data
  epoch and still hit on the recovered process.

Without ``background=True`` the layer stays cooperative exactly as
before: ``submit`` drains inline at ``max_pending`` and
``StreamFuture.result()`` drains the pending batch itself, so
single-threaded callers never deadlock.  With a drainer running,
``result()`` just waits — the thread owns draining.
"""
from __future__ import annotations

import os
import threading
import time
from collections import OrderedDict
from dataclasses import dataclass, field
from typing import Dict, List, NamedTuple, Optional, Tuple, Union

import numpy as np

from ..core.predicate import Node, PredicateTree
from ..runtime import faults as _faults
from ..runtime.telemetry import DURABILITY_BUCKETS_MS, LATENCY_BUCKETS_MS
from .bitmap import unpack_bits
from .config import UNSET, ExecConfig, config_from_kwargs
from .drainer import LANES, BackgroundDrainer, DrainPolicy, LatencyWindow
from .multiquery import BatchResult, BatchStats, QuerySession
from .table import Table
from .trace import ExplainReport, format_tree, null_span, report_from_batch


class StreamClosed(RuntimeError):
    """Raised by submit/append/delete after :meth:`StreamSession.close`."""


class StreamBackpressure(RuntimeError):
    """Raised by ``submit`` past ``max_queue`` under ``overflow="raise"``."""


class StreamQueryError(RuntimeError):
    """One query's failure, isolated from its batch.

    Every failed future gets its *own* instance wrapping the underlying
    error as ``__cause__`` — batch-mates never share an exception object,
    and a traceback always names the query's index and lane."""


class StreamFuture:
    """Handle for one admitted query; resolves when its batch drains."""

    def __init__(self, session: "StreamSession", lane: str = "bulk"):
        self._session = session
        self.lane = lane
        #: admission sequence number, unique per session — the key for
        #: :meth:`StreamSession.explain` / the server's ``/explain?id=``
        self.id: Optional[int] = None
        self._event = threading.Event()
        self._bitmap: Optional[np.ndarray] = None
        self._n_records = 0
        self._live_words: Optional[np.ndarray] = None
        self._exc: Optional[BaseException] = None

    def done(self) -> bool:
        return self._event.is_set()

    def _resolve(self, bitmap: np.ndarray, n_records: int,
                 live_words: Optional[np.ndarray] = None) -> None:
        self._bitmap = bitmap
        self._n_records = n_records
        self._live_words = live_words
        self._event.set()

    def _fail(self, exc: BaseException) -> None:
        self._exc = exc
        self._event.set()

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """The query's packed record bitmap (over the snapshot its batch
        drained against).  With a background drainer running this waits —
        up to ``timeout`` seconds — for the deadline drain; without one it
        drains the pending batch itself, so a single-threaded caller
        never blocks."""
        if not self._event.is_set():
            self._session._drain_for(self)
        if not self._event.wait(timeout):
            raise TimeoutError("stream query still pending")
        if self._exc is not None:
            raise self._exc
        return self._bitmap

    def mask(self, timeout: Optional[float] = None) -> np.ndarray:
        """The result as a boolean record mask."""
        return unpack_bits(self.result(timeout), self._n_records)

    @property
    def n_records(self) -> int:
        """Rows in the snapshot the query was evaluated against."""
        return self._n_records

    @property
    def snapshot(self) -> Tuple[int, Optional[np.ndarray]]:
        """``(n_records, live_words)`` at drain time — enough to replay
        this query against an append-only table and reproduce the bitmap
        bit-for-bit (live_words is None when nothing was tombstoned)."""
        return self._n_records, self._live_words


class _Pending(NamedTuple):
    query: Union[Node, PredicateTree]
    fut: StreamFuture
    t_admit: float


@dataclass
class StreamStats:
    """Lifetime accounting of one :class:`StreamSession`."""

    submitted: int = 0
    completed: int = 0
    batches: int = 0
    appends: int = 0
    appended_rows: int = 0
    max_batch: int = 0
    # tombstone deletes / compaction
    deletes: int = 0
    deleted_rows: int = 0
    compactions: int = 0
    compacted_rows: int = 0
    # degradation ladder
    retries: int = 0
    degraded_batches: int = 0
    quarantined_queries: int = 0
    failed: int = 0
    # admission control
    backpressure_waits: int = 0
    backpressure_rejects: int = 0
    # oldest still-pending bulk admit's age at the last drain (seconds) —
    # the bulk-lane starvation gauge; stays 0.0 while bulk keeps riding
    # along or the lane is empty
    bulk_starved_s: float = 0.0
    # admit-to-result latency (SLO readout; milliseconds)
    latency: LatencyWindow = field(default_factory=LatencyWindow,
                                   repr=False)
    # aggregated from the underlying QuerySession's per-batch stats
    atoms_delta_extended: int = 0
    delta_rows_evaluated: float = 0.0
    delta_rows_reused: float = 0.0
    upload_bytes: float = 0.0
    tape_cache_hits: int = 0
    # Q-Error feedback loop (aggregated across drains)
    feedback_observations: int = 0
    drift_evictions: int = 0
    max_qerror: float = 0.0
    last_batch: Optional[BatchStats] = field(default=None, repr=False)

    @property
    def mean_batch(self) -> float:
        return self.completed / self.batches if self.batches else 0.0

    @property
    def delta_reuse_ratio(self) -> float:
        total = self.delta_rows_reused + self.delta_rows_evaluated
        return self.delta_rows_reused / total if total else 0.0

    @property
    def latency_p50_ms(self) -> float:
        return self.latency.p50

    @property
    def latency_p99_ms(self) -> float:
        return self.latency.p99

    def absorb(self, bs: BatchStats) -> None:
        self.batches += 1
        self.completed += bs.n_queries
        self.max_batch = max(self.max_batch, bs.n_queries)
        self.atoms_delta_extended += bs.atoms_delta_extended
        self.delta_rows_evaluated += bs.delta_rows_evaluated
        self.delta_rows_reused += bs.delta_rows_reused
        self.upload_bytes += bs.upload_bytes
        self.tape_cache_hits += bs.tape_cache_hits
        self.feedback_observations += bs.feedback_observations
        self.drift_evictions += bs.drift_evictions
        self.max_qerror = max(self.max_qerror, bs.max_qerror)
        self.last_batch = bs

    def as_dict(self) -> Dict[str, float]:
        """Scalar snapshot (the shared stats protocol), including the
        derived latency percentiles and ratios."""
        from ..runtime.telemetry import scalar_snapshot
        return scalar_snapshot(self, extra=("mean_batch",
                                            "delta_reuse_ratio",
                                            "latency_p50_ms",
                                            "latency_p99_ms"))

    def publish(self, registry, labels=None) -> None:
        """Publish lifetime serving state as ``repro_stream_*`` gauges."""
        from ..runtime.telemetry import publish_scalars
        publish_scalars(registry, "repro_stream", self.as_dict(), labels,
                        help="stream session lifetime serving state")


class StreamSession:
    """Admit queries into an in-flight batch interleaved with appends
    and deletes.

    Execution is configured with ``config=ExecConfig(...)`` exactly like
    :class:`QuerySession`; the stream defaults differ (``engine="tape"`` +
    ``batched=True``: drains run the device-resident lockstep executor,
    one bundled host sync per batch).  Every legacy execution kwarg is an explicit
    parameter routed through the deprecation shim — the old blind
    ``**session_kwargs`` forwarding is gone, so a typo'd kwarg is a
    ``TypeError`` instead of silently reaching :class:`QuerySession`.
    Serving knobs:

    ``max_pending``
        in-flight batch bound; admission at it drains (inline without a
        drainer, immediately-by-deadline with one).
    ``background`` / ``policy``
        start a :class:`~repro_torch.columnar.drainer.BackgroundDrainer` with
        the given :class:`~repro_torch.columnar.drainer.DrainPolicy` (lane wait
        targets).
    ``max_queue`` / ``overflow``
        total-pending bound past which ``submit`` blocks (``"block"``,
        default) or raises :class:`StreamBackpressure` (``"raise"``).
        Defaults to ``8 * max_pending`` when a drainer runs, unbounded
        otherwise (inline drains already bound cooperative sessions).
    ``max_retries`` / ``retry_backoff_s``
        transient-fault retry budget for the degradation ladder.
    ``cache_dir``
        warm-restart directory (see :mod:`~repro_torch.columnar.persist`);
        loaded now, flushed at :meth:`close` / :meth:`flush_caches`.
    ``auto_compact``
        dead-row fraction above which :meth:`delete` triggers
        compaction (None = manual only).
    ``durable`` / ``wal_sync`` / ``snapshot_every``
        data-plane durability (see :mod:`~repro_torch.columnar.wal`).
        ``durable`` is the durability directory (or ``True`` for
        ``<cache_dir>/data``).  A fresh directory adopts ``table``; a
        directory with prior state requires ``table=None`` and is
        *recovered* (:attr:`recovery_info` carries the counters).
        ``wal_sync="group"`` (default) fsyncs once per drain before
        futures resolve; ``"always"`` fsyncs per mutation.
        ``snapshot_every`` bounds replay length: a snapshot is cut after
        that many logged mutations (checked at drains and mutations).
    """

    #: stream-flavored execution defaults (vs ExecConfig's conservative
    #: numpy/auto): drains lockstep the device tape engine
    DEFAULT_CONFIG = ExecConfig(planner="deepfish", engine="tape",
                                batched=True)

    def __init__(self, table: Optional[Table], planner=UNSET,
                 engine=UNSET, max_pending: int = 64,
                 batched=UNSET,
                 background: bool = False,
                 policy: Optional[DrainPolicy] = None,
                 max_queue: Optional[int] = None,
                 overflow: str = "block",
                 max_retries: int = 2, retry_backoff_s: float = 0.01,
                 cache_dir: Optional[str] = None,
                 auto_compact: Optional[float] = None,
                 durable: Union[bool, str, None] = None,
                 wal_sync: str = "group",
                 snapshot_every: Optional[int] = 512,
                 model=UNSET, plan_cache=UNSET, share_threshold=UNSET,
                 block=UNSET, annotate=UNSET, persist_atom_cache=UNSET,
                 rewrite_strings=UNSET, zone_prune=UNSET,
                 share_margin=UNSET, feedback=UNSET, feedback_absorb=UNSET,
                 config: Optional[ExecConfig] = None):
        if max_pending < 1:
            raise ValueError("max_pending must be >= 1")
        if overflow not in ("block", "raise"):
            raise ValueError("overflow must be 'block' or 'raise'")
        if max_queue is None and background:
            max_queue = 8 * max_pending
        if max_queue is not None and max_queue < max_pending:
            raise ValueError("max_queue must be >= max_pending")
        self._durability = None
        self.recovery_info: Optional[dict] = None
        if durable:
            from .wal import Durability
            if durable is True:
                if not cache_dir:
                    raise ValueError(
                        "durable=True needs cache_dir (data lands in "
                        "<cache_dir>/data), or pass durable=<directory>")
                durable = os.path.join(cache_dir, "data")
            if table is None:
                self._durability, table, self.recovery_info = \
                    Durability.recover(durable, sync=wal_sync,
                                       snapshot_every=snapshot_every)
            else:
                self._durability = Durability(
                    durable, sync=wal_sync, snapshot_every=snapshot_every)
                self._durability.attach(table)
        elif table is None:
            raise ValueError("table=None is only valid with durable=... "
                             "(recover from a durability directory)")
        self.table = table
        self.max_pending = max_pending
        self.max_queue = max_queue
        self.overflow = overflow
        self.max_retries = max_retries
        self.retry_backoff_s = retry_backoff_s
        self.auto_compact = auto_compact
        self.cache_dir = cache_dir
        # the QuerySession's share_margin default (break-even) applies
        # as-is: the margin is traffic-aware — the session's FeedbackStore
        # tracks cross-drain repeat rates per atom key and discounts the
        # break-even bar by each key's expected future appearances, so hot
        # streaming atoms promote on evidence (their |R| touch amortizes
        # across future drains at delta-splice cost) while one-off atoms
        # still face the full per-batch check.
        cfg = config_from_kwargs(
            config, defaults=self.DEFAULT_CONFIG,
            planner=planner, engine=engine, batched=batched, model=model,
            plan_cache=plan_cache, share_threshold=share_threshold,
            block=block, annotate=annotate,
            persist_atom_cache=persist_atom_cache,
            rewrite_strings=rewrite_strings, zone_prune=zone_prune,
            share_margin=share_margin, feedback=feedback,
            feedback_absorb=feedback_absorb)
        self.config = cfg
        self.session = QuerySession(table, config=cfg)
        # observability handles resolve once, on the inner session (the
        # stream publishes serving-layer state into the same registry /
        # tracer the drains publish batch state into)
        self.telemetry = self.session.telemetry
        self.tracer = self.session.tracer
        self.restore_info: Optional[dict] = None
        if cache_dir:
            from . import persist as _persist
            self.restore_info = _persist.load_session_caches(
                self.session, cache_dir, epoch=self._data_epoch())
        if self.recovery_info is not None:
            self._publish_recovery(self.recovery_info)
        self.stats = StreamStats()
        self.last_result: Optional[BatchResult] = None
        # two locks, strict order drain -> admit: _drain_lock serializes
        # everything that touches table state or executes (drain, append,
        # delete, close); _admit guards the pending lanes, stats, and the
        # backpressure/drainer condition.  Nothing executes while holding
        # _admit, so submit never stalls behind a running batch.
        self._drain_lock = threading.Lock()
        self._admit = threading.Condition(threading.Lock())
        self._lanes: Dict[str, List[_Pending]] = {ln: [] for ln in LANES}
        # explain retention: future.id -> ExplainReport, bounded LRU
        # (reports are host-side bookkeeping over numbers the drain
        # already paid for; _admit guards the dict)
        self._next_id = 0
        self.explain_capacity = 256
        # id -> ExplainReport, or the (res, index, query, n_records)
        # ingredients it is lazily built from on first explain()
        self._explains: "OrderedDict[int, object]" = OrderedDict()
        self._last_drain_at: Optional[float] = None     # time.monotonic()
        self._closed = False
        self._final_result: Optional[BatchResult] = None
        self._fallback_session: Optional[QuerySession] = None
        self._drainer: Optional[BackgroundDrainer] = None
        if background:
            self._drainer = BackgroundDrainer(self, policy or DrainPolicy())
            self._drainer.start()

    # -- durability ------------------------------------------------------------
    @property
    def durability(self):
        """The :class:`~repro_torch.columnar.wal.Durability` manager, or None
        for a non-durable session."""
        return self._durability

    def _data_epoch(self) -> Optional[str]:
        return self._durability.epoch if self._durability is not None \
            else None

    def sync(self) -> Optional[int]:
        """Force a WAL group commit now — every mutation admitted so far
        becomes crash-durable.  Returns the committed sequence number
        (None for a non-durable session).  Drains do this automatically;
        this is the explicit acknowledgement boundary for append-heavy
        callers between drains."""
        if self._durability is None:
            return None
        with self._drain_lock:
            ms = self._durability.commit()
            if ms is not None:
                self._observe_commit(ms)
            return self._durability.wal.committed_seq

    def _observe_commit(self, ms: float) -> None:
        if self.telemetry is not None:
            self.telemetry.histogram(
                "repro_wal_commit_ms",
                "WAL group-commit fsync wall time",
                buckets=DURABILITY_BUCKETS_MS).observe(ms)

    def _publish_recovery(self, info: dict) -> None:
        """Surface recovery on the telemetry plane: ``repro_recovery_*``
        gauges, the recovery-time histogram, and a trace event."""
        from ..runtime.telemetry import publish_scalars
        if self.telemetry is not None:
            scalars = {k: v for k, v in info.items()
                       if isinstance(v, (int, float))}
            publish_scalars(self.telemetry, "repro_recovery", scalars,
                            help="durable-ingest crash recovery state")
            self.telemetry.histogram(
                "repro_recovery_time_ms",
                "snapshot-load + WAL-replay wall time",
                buckets=DURABILITY_BUCKETS_MS
            ).observe(info["recovery_ms"])
        if self.tracer is not None:
            self.tracer.event(
                "recovery", snapshot_seq=info["snapshot_seq"],
                replayed_records=info["replayed_records"],
                truncated_records=info["truncated_records"],
                recovery_ms=round(info["recovery_ms"], 3))

    def _durable_after_mutation_locked(self) -> None:
        """Mutation-side durability policy, caller holds ``_drain_lock``:
        ``wal_sync="always"`` already committed inside the sink; here we
        only fold the accumulation into a snapshot when due, so append-
        only workloads (no drains) still bound their replay length."""
        if self._durability is not None:
            self._durability.maybe_snapshot()

    # -- introspection ---------------------------------------------------------
    @property
    def pending(self) -> int:
        with self._admit:
            return self._total_pending_locked()

    @property
    def pending_by_lane(self) -> Dict[str, int]:
        with self._admit:
            return {ln: len(pend) for ln, pend in self._lanes.items()}

    @property
    def closed(self) -> bool:
        with self._admit:
            return self._closed

    def _total_pending_locked(self) -> int:
        return sum(len(pend) for pend in self._lanes.values())

    # -- admission -------------------------------------------------------------
    def submit(self, query: Union[Node, PredicateTree],
               lane: str = "bulk") -> StreamFuture:
        """Admit a query into ``lane``; returns immediately with a future
        that resolves at the next drain of that lane.  Cooperative
        sessions drain inline at ``max_pending``; with a drainer the
        notify below re-arms its deadline instead (an interactive submit
        into an idle session drains within ``interactive_wait_ms``)."""
        if lane not in self._lanes:
            raise ValueError(f"unknown lane {lane!r} (expected one of "
                             f"{LANES})")
        fut = StreamFuture(self, lane)
        with self._admit:
            self._check_open_locked()
            if self.max_queue is not None:
                self._admission_control_locked()
            self.stats.submitted += 1
            fut.id = self._next_id
            self._next_id += 1
            self._lanes[lane].append(_Pending(query, fut,
                                              time.perf_counter()))
            inline = (self._drainer is None
                      and self._total_pending_locked() >= self.max_pending)
            self._admit.notify_all()
        if inline:
            self._drain_lanes(LANES)
        return fut

    def _check_open_locked(self) -> None:
        if self._closed:
            raise StreamClosed("stream session is closed")

    def _admission_control_locked(self) -> None:
        """Bounded admission: block (waking on drains) or raise when the
        total pending backlog is at ``max_queue``."""
        if self._total_pending_locked() < self.max_queue:
            return
        if self.overflow == "raise":
            self.stats.backpressure_rejects += 1
            raise StreamBackpressure(
                f"{self._total_pending_locked()} queries pending "
                f"(max_queue={self.max_queue})")
        self.stats.backpressure_waits += 1
        while self._total_pending_locked() >= self.max_queue:
            self._check_open_locked()
            # bounded wait guards against a lost notify; drains
            # notify_all after swapping the lanes out
            self._admit.wait(0.05)
        self._check_open_locked()

    def append(self, rows: Dict) -> int:
        """Interleave an append with admission: lands in the table as a
        block-aligned delta (see :meth:`Table.append`); queries draining
        *after* this call see the rows (snapshot-at-drain)."""
        with self._drain_lock:
            with self._admit:
                self._check_open_locked()
            start = self.table.append(rows)
            self._durable_after_mutation_locked()
            with self._admit:
                self.stats.appends += 1
                self.stats.appended_rows += self.table.n_records - start
            return start

    def delete(self, rows) -> int:
        """Tombstone rows (indices or a boolean mask — see
        :meth:`Table.delete`); queries draining *after* this call exclude
        them (snapshot-at-drain).  No caches are invalidated — the live
        mask applies at materialize time.  When ``auto_compact`` is set
        and the dead fraction crosses it, the table compacts (the
        version-bumping, cache-invalidating path).  Returns the number of
        rows newly tombstoned."""
        with self._drain_lock:
            with self._admit:
                self._check_open_locked()
            new = self.table.delete(rows)
            removed = 0
            if self.auto_compact is not None:
                removed = self.table.maybe_compact(self.auto_compact)
            self._durable_after_mutation_locked()
            with self._admit:
                self.stats.deletes += 1
                self.stats.deleted_rows += new
                if removed:
                    self.stats.compactions += 1
                    self.stats.compacted_rows += removed
            return new

    def compact(self) -> int:
        """Compact now (see :meth:`Table.compact`); returns rows removed."""
        with self._drain_lock:
            removed = self.table.compact()
            self._durable_after_mutation_locked()
            with self._admit:
                if removed:
                    self.stats.compactions += 1
                    self.stats.compacted_rows += removed
            return removed

    # -- draining --------------------------------------------------------------
    def drain(self) -> Optional[BatchResult]:
        """Execute everything in flight now (one ``QuerySession.execute``
        = one lockstep run, one bundled sync on the device engines);
        resolves every pending future.  Returns the primary batch result
        (the fallback's when the batch degraded, None when nothing was
        pending or the batch ended in per-query quarantine — failures
        surface through the futures, never from here)."""
        return self._drain_lanes(LANES)

    def _drain_for(self, fut: StreamFuture) -> None:
        if self._drainer is not None and self._drainer.running:
            return                      # the drainer's deadline owns it
        self._drain_lanes(LANES)

    def _drain_lanes(self, lanes: Tuple[str, ...]
                     ) -> Optional[BatchResult]:
        with self._drain_lock:
            with self._admit:
                batch: List[_Pending] = []
                for lane in lanes:
                    pend = self._lanes[lane]
                    if pend:
                        batch.extend(pend)
                        self._lanes[lane] = []
                if not batch:
                    return None
                # starvation gauge: age of the oldest bulk admit this
                # drain is leaving behind (0 when bulk drained or empty)
                left = self._lanes["bulk"]
                self.stats.bulk_starved_s = (
                    time.perf_counter() - left[0].t_admit if left else 0.0)
                self._admit.notify_all()    # backpressure waiters: space
            tr = self.tracer
            wait_ms = (time.perf_counter()
                       - min(p.t_admit for p in batch)) * 1000.0
            drain_span = (tr.span("stream.drain", queries=len(batch),
                                  lanes=",".join(lanes),
                                  queue_wait_ms=round(wait_ms, 3))
                          if tr is not None else null_span("stream.drain"))
            with drain_span:
                outcomes, res = self._execute_resilient(
                    [p.query for p in batch])
            # group commit: ONE fsync covers every mutation this batch's
            # snapshot saw, before any future resolves — results handed
            # to callers always describe crash-durable state
            if self._durability is not None:
                ms = self._durability.commit()
                if ms is not None:
                    self._observe_commit(ms)
            # snapshot stamped under _drain_lock: append/delete also hold
            # it, so n_records/live_words here are exactly what executed
            n = self.table.n_records
            lw = self.table.live_words()
            lw = lw.copy() if lw is not None else None
            # reports are retained BEFORE futures resolve, so a caller
            # returning from result() can explain() immediately (no race
            # against this drain thread)
            if res is not None:
                self._retain_explains(batch, res, n)
            now = time.perf_counter()
            latencies: List[Tuple[str, float]] = []
            with self._admit:
                ok = 0
                for p, out in zip(batch, outcomes):
                    if isinstance(out, BaseException):
                        p.fut._fail(out)
                        self.stats.failed += 1
                    else:
                        p.fut._resolve(out, n, lw)
                        lat = (now - p.t_admit) * 1000.0
                        self.stats.latency.add(lat)
                        latencies.append((p.fut.lane, lat))
                        ok += 1
                if res is not None:
                    self.stats.absorb(res.stats)
                    self.last_result = res
                else:
                    # quarantine drains have no single BatchStats
                    self.stats.batches += 1
                    self.stats.completed += ok
                    self.stats.max_batch = max(self.stats.max_batch,
                                               len(batch))
                self._last_drain_at = time.monotonic()
            if self._durability is not None:
                self._durability.maybe_snapshot()
            if self.telemetry is not None:
                self._publish_drain(latencies)
            return res

    def _retain_explains(self, batch: List[_Pending], res: BatchResult,
                         n_records: int) -> None:
        """Retain the ingredients for one :class:`ExplainReport` per
        drained query, keyed by future id in a bounded LRU — the
        ``/explain?id=`` backing store.  Reports are built lazily in
        :meth:`explain` (an operator action, off the drain hot path):
        everything stored here is a reference to state the drain already
        produced, so retention costs one dict insert per query."""
        if self.telemetry is None and self.tracer is None:
            return
        entries = [(p.fut.id, (res, i, p.query, n_records))
                   for i, p in enumerate(batch)]
        with self._admit:
            for fid, ing in entries:
                self._explains[fid] = ing
                self._explains.move_to_end(fid)
            while len(self._explains) > self.explain_capacity:
                self._explains.popitem(last=False)

    def _publish_drain(self, latencies: List[Tuple[str, float]]) -> None:
        """Per-drain registry publication: stream gauges, the per-future
        admit-to-result latency histogram, and drainer counters."""
        reg = self.telemetry
        labels = {"engine": self.config.engine,
                  "planner": self.config.planner,
                  "shards": self.config.shards}
        with self._admit:
            self.stats.publish(reg, labels)
        hist = reg.histogram(
            "repro_query_latency_ms",
            "admit-to-result latency per resolved future",
            buckets=LATENCY_BUCKETS_MS)
        for lane, lat in latencies:
            hist.observe(lat, lane=lane)
        d = self._drainer
        if d is not None:
            reg.gauge("repro_drainer_wakeups",
                      "background drainer deadline-loop wakeups"
                      ).set(d.wakeups)
            reg.gauge("repro_drainer_deadline_drains",
                      "drains initiated by the background drainer"
                      ).set(d.deadline_drains)
            reg.gauge("repro_drainer_bulk_force_drains",
                      "bulk drains forced by the starvation valve"
                      ).set(d.bulk_force_drains)
        if self._durability is not None:
            self._durability.publish(reg, labels)

    # -- observability readouts ------------------------------------------------
    def health(self) -> Dict[str, object]:
        """Liveness/degradation readout for a ``/healthz`` endpoint —
        lock-cheap, never executes anything.  ``ok`` means the session is
        accepting work and, when a background drainer was started, its
        thread is still alive."""
        now = time.monotonic()
        with self._admit:
            d = self._drainer
            drainer_alive = bool(d is not None and d.running)
            h = {
                "ok": not self._closed and (d is None or drainer_alive),
                "closed": self._closed,
                "drainer_alive": drainer_alive,
                "last_drain_age_s": (
                    now - self._last_drain_at
                    if self._last_drain_at is not None else None),
                "pending": self._total_pending_locked(),
                "degraded_batches": self.stats.degraded_batches,
                "quarantined_queries": self.stats.quarantined_queries,
                "retries": self.stats.retries,
                "failed": self.stats.failed,
                "bulk_starved_s": self.stats.bulk_starved_s,
            }
            dur = self._durability
            h["durable"] = dur is not None
            if dur is not None:
                h["wal"] = {"last_seq": dur.wal.last_seq,
                            "committed_seq": dur.wal.committed_seq,
                            "uncommitted": dur.wal.uncommitted,
                            "snapshots": dur.snapshots,
                            "records_since_snapshot":
                                dur.records_since_snapshot}
                # recovered=False means a fresh attach, not a failure;
                # the counters tell operators what the restart replayed
                h["recovery"] = (
                    {"recovered": True,
                     "snapshot_seq": self.recovery_info["snapshot_seq"],
                     "replayed_records":
                         self.recovery_info["replayed_records"],
                     "truncated_records":
                         self.recovery_info["truncated_records"],
                     "recovery_ms": self.recovery_info["recovery_ms"]}
                    if self.recovery_info is not None
                    else {"recovered": False})
            return h

    def explain(self, future_or_id) -> Optional[ExplainReport]:
        """The retained :class:`~repro_torch.columnar.trace.ExplainReport` for
        a drained future (or its ``.id``); None when unknown or evicted
        (retention is a bounded LRU of ``explain_capacity`` reports, and
        nothing is retained with both telemetry and trace off)."""
        fid = getattr(future_or_id, "id", future_or_id)
        with self._admit:
            entry = self._explains.get(fid)
            if entry is None:
                return None
            self._explains.move_to_end(fid)
        if isinstance(entry, ExplainReport):
            return entry
        # first ask for this id: build the report from the retained drain
        # state (outside _admit — report building is pure host work over
        # already-transferred popcounts), then memoize it
        res, i, query, n_records = entry
        counters = {k: getattr(res.stats, k) for k in
                    ("host_syncs", "device_dispatches", "host_fallbacks",
                     "blocks_touched", "blocks_pruned")}
        try:
            rep = report_from_batch(res, i, format_tree(query), n_records,
                                    self.config, counters=counters)
        except Exception:               # pragma: no cover - defensive
            return None
        with self._admit:
            if fid in self._explains:
                self._explains[fid] = rep
        return rep

    def explain_ids(self) -> List[int]:
        """Future ids with a retained report, oldest first."""
        with self._admit:
            return list(self._explains)

    # -- the degradation ladder ------------------------------------------------
    def _note_rung(self, rung: str, count: int = 1) -> None:
        """Record one degradation-ladder activation: a labeled counter in
        the registry plus an event on the current trace span, so every
        fault scenario is assertable from telemetry alone."""
        if self.telemetry is not None:
            self.telemetry.counter(
                "repro_degradation_total",
                "degradation-ladder rung activations"
            ).inc(count, rung=rung)
        if self.tracer is not None:
            self.tracer.event("degradation", rung=rung, count=count)

    def _fallback(self) -> QuerySession:
        """Lazily-built host execution path: numpy engine on the CPU (no
        device) over the same table, sharing the plan cache so degraded
        batches still reuse cached plan orders.  Feedback stays off — a
        degraded batch is an emergency serving, not a statistics
        source."""
        if self._fallback_session is None:
            fcfg = self.session.config.replace(
                engine="numpy", device="cpu", batched=False,
                feedback=False, shards=1, mesh=None,
                model=self.session.model,
                plan_cache=self.session.plan_cache)
            self._fallback_session = QuerySession(self.table, config=fcfg)
        return self._fallback_session

    def _execute_resilient(self, queries: list
                           ) -> Tuple[list, Optional[BatchResult]]:
        """Run a batch down the recovery ladder.  Returns
        ``(outcomes, result)`` where each outcome is a packed bitmap or a
        :class:`StreamQueryError`, and ``result`` is the successful
        :class:`BatchResult` (primary or fallback) or None after
        quarantine.

        Ladder: (1) primary execute, retrying transient faults with
        exponential backoff; (2) on a device fault, reset the device
        backend (so the *next* batch retries the device path) and re-run
        this batch on the host fallback — bit-identical, counted in
        ``stats.degraded_batches``; (3) anything else, or a fallback that
        also fails, quarantines per query on the host engine so one
        poisoned plan cannot take down its batch-mates."""
        delay = self.retry_backoff_s
        last: Optional[BaseException] = None
        for attempt in range(self.max_retries + 1):
            try:
                res = self.session.execute(queries)
                return list(res.bitmaps), res
            except BaseException as exc:
                last = exc
                if _faults.is_transient(exc) and attempt < self.max_retries:
                    with self._admit:
                        self.stats.retries += 1
                    self._note_rung("retry")
                    time.sleep(delay)
                    delay *= 2.0
                    continue
                break
        if _faults.is_device_fault(last):
            try:
                self.session.reset_backend()
            except Exception:
                pass            # a broken backend must not block recovery
            try:
                res = self._fallback().execute(queries)
                with self._admit:
                    self.stats.degraded_batches += 1
                self._note_rung("fallback")
                return list(res.bitmaps), res
            except BaseException:
                pass            # fall through to per-query quarantine
        outcomes: list = []
        quarantined = 0
        fb = self._fallback()
        for i, q in enumerate(queries):
            try:
                r = fb.execute([q])
                outcomes.append(r.bitmaps[0])
            except BaseException as qe:
                err = StreamQueryError(
                    f"query {i}/{len(queries)} failed in quarantine: "
                    f"{type(qe).__name__}: {qe}")
                err.__cause__ = qe
                outcomes.append(err)
                quarantined += 1
        with self._admit:
            self.stats.degraded_batches += 1
            self.stats.quarantined_queries += quarantined
        if quarantined:
            self._note_rung("quarantine", quarantined)
        return outcomes, None

    # -- persistence / lifecycle -----------------------------------------------
    def flush_caches(self) -> Optional[dict]:
        """Write warm-restart state to ``cache_dir`` now (also happens at
        :meth:`close`); returns persist counts, or None without a
        ``cache_dir``."""
        if not self.cache_dir:
            return None
        from . import persist as _persist
        return _persist.save_session_caches(self.session, self.cache_dir,
                                            epoch=self._data_epoch())

    def close(self) -> Optional[BatchResult]:
        """Shut the session down: stop the drainer, drain whatever is
        still in flight (resolving every admitted future), and flush
        warm-restart caches.  Idempotent — repeat calls return the final
        drain's result; submit/append/delete afterwards raise
        :class:`StreamClosed` (so do submits blocked on backpressure when
        close wakes them)."""
        with self._admit:
            if self._closed:
                return self._final_result
            self._closed = True
            self._admit.notify_all()    # fail blocked submits fast
        if self._drainer is not None:
            self._drainer.stop()
        self._final_result = self._drain_lanes(LANES)
        if self._durability is not None:
            # a clean shutdown leaves a snapshot covering the whole log:
            # the next start replays nothing and warm caches match the
            # exact recovered state
            with self._drain_lock:
                self._durability.commit()
                self._durability.snapshot()
                self._durability.close()
        if self.cache_dir:
            self.flush_caches()
            self._flush_metrics()
        return self._final_result

    def _flush_metrics(self) -> None:
        """Final observability snapshot (``metrics.json``) next to the
        warm-restart artifacts: stream + health state always, the full
        registry when telemetry is on."""
        from . import persist as _persist
        payload = {"stream": self.stats.as_dict(),
                   "health": self.health(),
                   "registry": (self.telemetry.snapshot()
                                if self.telemetry is not None else None)}
        _persist.save_metrics(payload, self.cache_dir)

    def __enter__(self) -> "StreamSession":
        return self

    def __exit__(self, exc_type, exc, tb) -> None:
        self.close()
