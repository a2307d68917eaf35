"""Per-query/per-batch trace spans and EXPLAIN ANALYZE.

Spans are host wall-clock only (``time.perf_counter``), nestable via a
thread-local stack, and land in a bounded ring buffer — a drained batch
costs a handful of clock reads and deque appends, cheap enough to leave on
in production.  The one rule that keeps tracing honest on the device
engines: **a span never forces a sync**.  Spans bracket the host-side
phases (plan, rewrite, upload, dispatch, the bundled materialize); every
device-side number they annotate was already fetched by the transfer the
query paid for anyway (the feedback plumbing — see docs/architecture.md
§8).

:func:`explain_analyze` joins the chosen plan with the realized per-op
selectivities drained from the engine op log, zone pruning, cache hits,
upload bytes and sync counts into one :class:`ExplainReport`.
"""
from __future__ import annotations

import threading
import time
from collections import deque
from dataclasses import dataclass, field
from typing import Any, Dict, List, Mapping, Optional, Sequence, Tuple

from ..core.feedback import qerror as _qerror

# ---------------------------------------------------------------------------
# Spans
# ---------------------------------------------------------------------------


@dataclass
class SpanRecord:
    """One completed span (host wall-clock, milliseconds)."""

    name: str
    t0: float                      # perf_counter at entry
    dur_ms: float = 0.0
    depth: int = 0
    seq: int = 0
    parent_seq: Optional[int] = None
    thread: str = ""
    attrs: Dict[str, Any] = field(default_factory=dict)
    events: List[Tuple[str, float, Dict[str, Any]]] = field(
        default_factory=list)     # (name, offset_ms, attrs)

    def as_dict(self) -> dict:
        return {"name": self.name, "dur_ms": self.dur_ms,
                "depth": self.depth, "seq": self.seq,
                "parent_seq": self.parent_seq, "thread": self.thread,
                "attrs": dict(self.attrs),
                "events": [{"name": n, "offset_ms": o, "attrs": dict(a)}
                           for n, o, a in self.events]}


class _NullSpan:
    """Shared no-op context manager: the disabled-tracer fast path."""

    __slots__ = ()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        return False

    def set(self, **attrs):
        return self


_NULL_SPAN = _NullSpan()

#: importable no-op span for "tracer is None" call sites
NULL_SPAN = _NULL_SPAN


def null_span(name: str, **attrs: Any) -> _NullSpan:
    """Signature-compatible stand-in for ``Tracer.span`` when disabled."""
    return _NULL_SPAN


class _ActiveSpan:
    __slots__ = ("_tracer", "_rec")

    def __init__(self, tracer: "Tracer", rec: SpanRecord):
        self._tracer = tracer
        self._rec = rec

    def set(self, **attrs) -> "_ActiveSpan":
        """Attach attributes mid-span (e.g. counts known only at exit)."""
        self._rec.attrs.update(attrs)
        return self

    def __enter__(self) -> "_ActiveSpan":
        self._tracer._push(self._rec)
        return self

    def __exit__(self, *exc) -> bool:
        self._tracer._pop(self._rec)
        return False


class Tracer:
    """Nestable host wall-clock spans in a bounded ring buffer.

    Thread-safe: each thread nests through its own stack (drainer threads
    and callers trace concurrently); completed spans append to one shared
    ring under a lock.  ``profiler=True`` additionally opens a
    ``torch.profiler.record_function`` range around :meth:`profile_span`
    sections (the drain path), so spans line up with the CUDA kernels'
    timeline when a profile is being captured — and costs nothing when one
    is not.
    """

    def __init__(self, capacity: int = 4096, enabled: bool = True,
                 profiler: bool = False):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.enabled = enabled
        self.profiler = profiler
        self._ring: "deque[SpanRecord]" = deque(maxlen=capacity)
        self._lock = threading.Lock()
        self._tls = threading.local()
        self._seq = 0

    # -- internals -------------------------------------------------------------
    def _stack(self) -> List[SpanRecord]:
        st = getattr(self._tls, "stack", None)
        if st is None:
            st = self._tls.stack = []
        return st

    def _push(self, rec: SpanRecord) -> None:
        st = self._stack()
        rec.depth = len(st)
        rec.parent_seq = st[-1].seq if st else None
        rec.t0 = time.perf_counter()
        st.append(rec)

    def _pop(self, rec: SpanRecord) -> None:
        end = time.perf_counter()
        st = self._stack()
        while st and st[-1] is not rec:   # tolerate unbalanced exits
            st.pop()
        if st:
            st.pop()
        rec.dur_ms = (end - rec.t0) * 1000.0
        with self._lock:
            self._ring.append(rec)

    # -- API -------------------------------------------------------------------
    def span(self, name: str, **attrs: Any):
        """Context manager timing one phase; nests under the thread's
        current span.  Returns a shared no-op when disabled."""
        if not self.enabled:
            return _NULL_SPAN
        with self._lock:
            self._seq += 1
            seq = self._seq
        return _ActiveSpan(self, SpanRecord(
            name=name, t0=0.0, seq=seq,
            thread=threading.current_thread().name, attrs=dict(attrs)))

    def event(self, name: str, **attrs: Any) -> None:
        """Attach a point event to the innermost active span (dropped when
        disabled or no span is open — events are annotations, not logs)."""
        if not self.enabled:
            return
        st = self._stack()
        if not st:
            return
        rec = st[-1]
        rec.events.append(
            (name, (time.perf_counter() - rec.t0) * 1000.0, dict(attrs)))

    def profile_span(self, name: str, **attrs: Any):
        """A span that also opens a ``torch.profiler.record_function``
        range when :attr:`profiler` is set — the bridge that makes drains
        visible inside captured PyTorch profiles."""
        if not self.enabled:
            return _NULL_SPAN
        sp = self.span(name, **attrs)
        if not self.profiler:
            return sp
        from torch.profiler import record_function
        outer = record_function(name)

        class _Both:
            def __enter__(self_b):
                outer.__enter__()
                return sp.__enter__()

            def __exit__(self_b, *exc):
                try:
                    sp.__exit__(*exc)
                finally:
                    outer.__exit__(*exc)
                return False

        return _Both()

    def drain(self) -> List[SpanRecord]:
        """Pop every completed span (oldest first)."""
        with self._lock:
            out = list(self._ring)
            self._ring.clear()
        return out

    def recent(self, n: Optional[int] = None) -> List[SpanRecord]:
        with self._lock:
            out = list(self._ring)
        return out if n is None else out[-n:]

    def __len__(self) -> int:
        with self._lock:
            return len(self._ring)


_GLOBAL_TRACER = Tracer()


def tracer() -> Tracer:
    """The process-global tracer (``ExecConfig(trace=True)``)."""
    return _GLOBAL_TRACER


def resolve_tracer(setting: Any) -> Optional[Tracer]:
    """Map an ``ExecConfig.trace`` setting to a tracer or None:
    False/None -> disabled, True -> the process-global tracer, else the
    caller's.  Identity checks, not truthiness — an *empty* Tracer is
    len() == 0 and must still be honored."""
    if setting is None or setting is False:
        return None
    if setting is True:
        return _GLOBAL_TRACER
    return setting


# ---------------------------------------------------------------------------
# EXPLAIN ANALYZE
# ---------------------------------------------------------------------------

#: per-backend lifetime counters the report snapshots as per-query deltas
#: (single source of names — the bench obs sections and §8 docs use it too)
BACKEND_COUNTERS: Tuple[str, ...] = (
    "host_syncs", "device_dispatches", "kernel_invocations",
    "host_fallbacks", "uploaded_bytes", "blocks_touched",
    "records_touched", "blocks_pruned")


def backend_counters(backend: Any) -> Dict[str, float]:
    """Snapshot the well-known lifetime counters a backend exposes (absent
    ones read 0 — the numpy oracle has no syncs to count)."""
    return {name: float(getattr(backend, name, 0) or 0)
            for name in BACKEND_COUNTERS}


def format_tree(query: Any) -> str:
    """Compact one-line rendering of a predicate tree / node for reports
    (``(a AND (b OR c))`` with the atoms' display names)."""
    from ..core.predicate import And, Atom, Not, Or
    root = query.root if hasattr(query, "root") else query

    def fmt(n):
        if isinstance(n, Atom):
            return n.name
        if isinstance(n, Not):
            return f"NOT {fmt(n.child)}"
        if isinstance(n, (And, Or)):
            j = " AND " if isinstance(n, And) else " OR "
            return "(" + j.join(fmt(c) for c in n.children) + ")"
        return repr(n)

    return fmt(root)


def _fmt_atom_key(key: tuple) -> str:
    col, op, value = key
    if isinstance(value, tuple):
        value = f"<{value[0]}>"
    return f"{col} {op} {value}"


@dataclass
class OpObservation:
    """One realized op from the engine op log: the estimate the planner
    used vs the popcounts the device already transferred."""

    atoms: Tuple[tuple, ...]       # atom keys (column, op, value)
    est: float                     # planner's conditional selectivity
    src: int                       # source-set popcount
    out: int                       # output-set popcount

    @property
    def realized(self) -> float:
        return self.out / self.src if self.src > 0 else 0.0

    @property
    def qerror(self) -> float:
        if self.src <= 0:
            return 1.0
        return _qerror(self.est, self.realized, weight=self.src)

    def as_dict(self) -> dict:
        return {"atoms": [_fmt_atom_key(k) for k in self.atoms],
                "est": self.est, "src": self.src, "out": self.out,
                "realized": self.realized, "qerror": self.qerror}


@dataclass
class ExplainReport:
    """EXPLAIN ANALYZE: the chosen plan joined with realized execution.

    Everything here was computed by the run itself — the report adds no
    syncs, no dispatches, and no retraces; it only *joins* what the
    engines already surfaced (op-log popcounts, zone verdict counts,
    cache hit deltas, the backend counter deltas)."""

    query: str
    engine: str
    planner: str
    shards: int
    n_records: int
    selected: int
    plan: str                      # Plan.describe()
    plan_order: List[str]          # atom names in execution order
    est_cost: float
    plan_cached: bool
    tape_cached: bool
    ops: List[OpObservation] = field(default_factory=list)
    max_qerror: float = 0.0
    mean_qerror: float = 0.0
    counters: Dict[str, float] = field(default_factory=dict)
    cache: Dict[str, float] = field(default_factory=dict)
    batch: Dict[str, float] = field(default_factory=dict)
    wall_ms: float = 0.0
    spans: List[dict] = field(default_factory=list)

    def as_dict(self) -> dict:
        d = {k: getattr(self, k) for k in (
            "query", "engine", "planner", "shards", "n_records", "selected",
            "plan", "plan_order", "est_cost", "plan_cached", "tape_cached",
            "max_qerror", "mean_qerror", "counters", "cache", "batch",
            "wall_ms", "spans")}
        d["ops"] = [o.as_dict() for o in self.ops]
        return d

    def render(self) -> str:
        """Readable multi-line report (the ``EXPLAIN ANALYZE`` output)."""
        frac = self.selected / self.n_records if self.n_records else 0.0
        lines = [
            f"EXPLAIN ANALYZE  engine={self.engine} planner={self.planner}"
            + (f" shards={self.shards}" if self.shards > 1 else ""),
            f"query: {self.query}",
            f"rows:  {self.selected} / {self.n_records} selected"
            f" ({frac:.2%})",
        ]
        lines.extend("  " + ln for ln in self.plan.splitlines())
        lines.append(
            "plan cache: "
            + ("hit" if self.plan_cached else "miss")
            + (", tape rebind hit" if self.tape_cached else "")
            + (f", atom-share hits {self.cache.get('atom_cache_hits', 0):g}"
               f" ({self.cache.get('shared_atom_keys', 0):g} shared keys)"
               if self.cache else ""))
        if self.ops:
            lines.append("realized ops (from the batch's bundled sync):")
            lines.append(f"  {'atoms':<42s} {'est':>8s} {'realized':>9s}"
                         f" {'q-err':>7s} {'src':>10s} {'out':>10s}")
            for o in self.ops:
                nm = " & ".join(_fmt_atom_key(k) for k in o.atoms)
                lines.append(
                    f"  {nm:<42s} {o.est:>8.4f} {o.realized:>9.4f}"
                    f" {o.qerror:>7.2f} {o.src:>10d} {o.out:>10d}")
            lines.append(f"q-error: max {self.max_qerror:.2f}"
                         f" mean {self.mean_qerror:.2f}")
        c = self.counters
        if c:
            lines.append(
                f"pruning: {c.get('blocks_pruned', 0):g} blocks zone-pruned,"
                f" {c.get('blocks_touched', 0):g} touched")
            lines.append(
                f"sync: host_syncs={c.get('host_syncs', 0):g}"
                f" device_dispatches={c.get('device_dispatches', 0):g}"
                f" host_fallbacks={c.get('host_fallbacks', 0):g}"
                f" upload={c.get('uploaded_bytes', 0):g} B")
        lines.append(f"wall: {self.wall_ms:.2f} ms")
        if self.spans:
            lines.append("spans:")
            for s in self.spans:
                lines.append(f"  {'  ' * s['depth']}{s['name']:<28s}"
                             f" {s['dur_ms']:>8.3f} ms")
        return "\n".join(lines)


def report_from_batch(res: Any, index: int, query_text: str,
                      n_records: int, config: Any,
                      counters: Optional[Mapping[str, float]] = None,
                      spans: Sequence[SpanRecord] = ()) -> ExplainReport:
    """Build one query's report out of a finished
    :class:`~repro_torch.columnar.multiquery.BatchResult` (used by
    :func:`explain_analyze` and the stream server's ``/explain?id=``).

    ``counters`` are the caller-snapshotted backend counter deltas for the
    batch; per-query numbers that only exist at batch granularity (sync
    counts, upload bytes) are reported at batch granularity — the point is
    the contract (*one* bundled sync), not false precision."""
    from .bitmap import popcount
    plan = res.plans[index]
    bs = res.stats
    ops = [OpObservation(tuple(keys), float(est), int(src), int(out))
           for keys, est, src, out in getattr(bs, "op_observations", ())]
    qerrs = [o.qerror for o in ops if o.src > 0]
    selected = int(popcount(res.bitmaps[index]))
    order = [plan.tree.atoms[a].name for a in plan.order]
    return ExplainReport(
        query=query_text,
        engine=config.engine, planner=plan.planner,
        shards=getattr(config, "shards", 1),
        n_records=n_records, selected=selected,
        plan=plan.describe(), plan_order=order,
        est_cost=plan.est_cost,
        plan_cached=bs.plan_cache_hits > 0,
        tape_cached=bs.tape_cache_hits > 0,
        ops=ops,
        max_qerror=max(qerrs) if qerrs else 0.0,
        mean_qerror=sum(qerrs) / len(qerrs) if qerrs else 0.0,
        counters=dict(counters or {}),
        cache={"plan_cache_hits": bs.plan_cache_hits,
               "plan_cache_misses": bs.plan_cache_misses,
               "tape_cache_hits": bs.tape_cache_hits,
               "atom_cache_hits": bs.atom_cache_hits,
               "shared_atom_keys": bs.shared_atom_keys},
        batch=bs.as_dict(),
        wall_ms=res.wall_s * 1000.0,
        spans=[s.as_dict() for s in spans])


def explain_analyze(query: Any, table: Any = None, *,
                    session: Any = None, config: Any = None
                    ) -> ExplainReport:
    """Run ``query`` once and return the joined plan/realized report.

    Pass an existing :class:`~repro_torch.columnar.multiquery.QuerySession` to
    explain against its caches (plan-cache hits show up as hits); or a
    ``table`` (+ optional :class:`~repro_torch.columnar.config.ExecConfig`) and
    a fresh session is built — device tape engine by default, so the
    report shows the one-sync contract in action.

    The query executes exactly as ``session.execute([query])`` would —
    same plan, same dispatches, same single bundled sync; the report is
    assembled from numbers that run already produced."""
    from .config import ExecConfig
    from .multiquery import QuerySession

    own_tracer = Tracer(capacity=256)
    borrowed = session is not None
    if not borrowed:
        if table is None:
            raise ValueError("explain_analyze needs a table or a session")
        cfg = config if config is not None else ExecConfig(
            planner="deepfish", engine="tape")
        cfg = cfg.replace(trace=own_tracer)
        session = QuerySession(table, config=cfg)
        restore = own_tracer
    else:
        restore = session.tracer
        session.tracer = own_tracer
    try:
        be = session._backend
        pre = backend_counters(be) if be is not None else {}
        res = session.execute([query])
        post = backend_counters(res.backend)
        deltas = {k: post[k] - pre.get(k, 0.0) for k in post}
        spans = own_tracer.drain()
    finally:
        session.tracer = restore
    return report_from_batch(res, 0, format_tree(query),
                             session.table.n_records,
                             session.config, counters=deltas, spans=spans)


__all__ = [
    "SpanRecord", "Tracer", "tracer", "resolve_tracer", "NULL_SPAN",
    "null_span", "BACKEND_COUNTERS", "backend_counters", "OpObservation",
    "ExplainReport", "report_from_batch", "explain_analyze",
    "format_tree",
]
