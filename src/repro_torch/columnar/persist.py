"""Warm restarts: plan/tape/feedback caches that survive the process.

A cold server pays stacked costs on its first drain: planning (trace /
chain-fusion / DCE / slot allocation per query shape), the tape's
compilation, and on the card the capture of each tape's CUDA graph.  The
first two are pure functions of inputs that survive restarts unchanged,
so they persist:

* **plan-cache entries** — each ``LRUPlanCache`` entry (canonical plan
  positions + the compiled :class:`~repro_torch.core.tape.PlanTape`) is
  keyed by ``(planner, n_atoms, repr(cost model), canonical_key)``.  Every
  part of that key is content-derived — ``canonical_key`` hashes tree
  shape + quantized statistics, never object identities — so a restarted
  process computes byte-equal keys for the same traffic and hits
  immediately (``tape_cache_hits > 0`` on the first drain).  Tapes are
  stored as ``(root node, ops, ...)`` and the :class:`PredicateTree` is
  re-derived on load: the tree's internal indices are ``id()``-keyed and
  must never be pickled.  Entries whose trees hold opaque UDF callables
  are skipped.
* **the FeedbackStore** — per-key EWMA selectivities and traffic stats,
  so corrected estimates and the share-margin discount survive restarts
  instead of relearning from scratch.

What does not persist: a CUDA graph cannot be serialised, so the device
backend's ``_TapeProgram`` captures each tape key's graph again at its
first run in the new process (one capture per key).  The CUDA kernels
themselves persist on their own: the library is built once into
``build/repro_torch_kernels/``, named by a hash of the sources
(:mod:`repro_torch.kernels._build`), and a restarted process loads it
without running ``nvcc``.

Loads are best-effort by design: a corrupt/stale/foreign cache file must
never take a serving process down, so every reader validates a format
tag, a CRC32 over the pickled payload (truncation and bit flips
cold-start instead of raising mid-unpickle), the quantization
parameters, and — for durable sessions — the **data epoch**: cache files
are stamped with the UUID of the durable data lineage they were derived
from (:attr:`~repro_torch.columnar.wal.Durability.epoch`), and a reader
expecting a different epoch silently cold-starts.  Plan/feedback keys
are content-derived, so same-lineage caches still hit on a *recovered*
table (it is bit-identical to the state they were learned on); the epoch
guards against pointing a durable directory's caches at someone else's
data.  Files or readers without an epoch (non-durable sessions, legacy
artifacts) skip the check.  Every read unpickles through
:func:`~repro_torch.columnar.wal.restricted_loads`: a cache written by
another package names that package's classes, and is refused like a
corrupt file (a clean cold start).
"""
from __future__ import annotations

import json
import os
import pickle
import zlib
from typing import Optional

from ..core.feedback import FeedbackStore
from ..core.predicate import PredicateTree
from ..core.tape import PlanTape
from .multiquery import LRUPlanCache, QuerySession
from .wal import restricted_loads

#: bump when the entry layout changes — old files then cold-start cleanly
#: (2: payload CRC + data-epoch token wrap every pickled artifact)
FORMAT = 2

PLAN_CACHE_FILE = "plan_cache.pkl"
FEEDBACK_FILE = "feedback.pkl"
METRICS_FILE = "metrics.json"


def _dump_checked(obj, path: str, epoch: Optional[str] = None) -> None:
    """Atomically write ``obj`` wrapped in the checked envelope: format
    tag, CRC32 of the pickled blob, and the optional data-epoch token.
    tmp + fsync + ``os.replace`` — a crash never leaves a half-written
    artifact at ``path``."""
    blob = pickle.dumps(obj, protocol=pickle.HIGHEST_PROTOCOL)
    payload = {"format": FORMAT, "crc": zlib.crc32(blob), "epoch": epoch,
               "blob": blob}
    tmp = path + ".tmp"
    with open(tmp, "wb") as f:
        pickle.dump(payload, f, protocol=pickle.HIGHEST_PROTOCOL)
        f.flush()
        os.fsync(f.fileno())
    os.replace(tmp, path)


def _load_checked(path: str, epoch: Optional[str] = None):
    """The wrapped object, or None on *any* defect — missing file,
    truncation, bit flip (CRC mismatch), format drift, or a data-epoch
    token that contradicts the expected one.  Never raises."""
    try:
        with open(path, "rb") as f:
            payload = restricted_loads(f.read())
    except Exception:       # corrupt/foreign file: cold start, never crash
        return None
    if not isinstance(payload, dict) or payload.get("format") != FORMAT:
        return None
    blob = payload.get("blob")
    if not isinstance(blob, bytes) or zlib.crc32(blob) != payload.get("crc"):
        return None
    fe = payload.get("epoch")
    if fe is not None and epoch is not None and fe != epoch:
        return None         # derived from a different data lineage
    try:
        return restricted_loads(blob)
    except Exception:
        return None


def _tape_state(tape: PlanTape) -> Optional[dict]:
    """Picklable form of a compiled tape, or None when it cannot persist
    (opaque UDF callables).  The tree is stored as its root node only —
    ``PredicateTree``'s lookup tables are ``id()``-keyed and meaningless
    in another process; reload re-indexes the root, reassigning the same
    tree-order atom ids the ops reference."""
    if any(a.fn is not None for a in tape.tree.atoms):
        return None
    return {"root": tape.tree.root, "ops": tape.ops, "result": tape.result,
            "n_slots": tape.n_slots, "planner": tape.planner}


def _tape_from_state(st: dict) -> PlanTape:
    return PlanTape(tree=PredicateTree(st["root"]), ops=st["ops"],
                    result=st["result"], n_slots=st["n_slots"],
                    planner=st["planner"])


def save_plan_cache(cache: LRUPlanCache, path: str,
                    epoch: Optional[str] = None) -> int:
    """Serialize the cache's entries (LRU order preserved); returns the
    number written.  Entries that cannot pickle (UDF trees) are skipped —
    they re-plan on first touch after restart, exactly like a miss."""
    entries = []
    for full_key, ent in cache._entries.items():
        tape_st = _tape_state(ent["tape"]) if ent["tape"] is not None \
            else None
        if ent["tape"] is not None and tape_st is None:
            continue
        try:
            blob = pickle.dumps(
                (full_key, ent["cpos"], ent["inv"], tape_st),
                protocol=pickle.HIGHEST_PROTOCOL)
        except Exception:
            continue                    # unpicklable key/value: skip entry
        entries.append(blob)
    payload = {"sel_step": cache.sel_step, "cost_step": cache.cost_step,
               "dict_sel_step": cache.dict_sel_step, "entries": entries}
    _dump_checked(payload, path, epoch)
    return len(entries)


def load_plan_cache(cache: LRUPlanCache, path: str,
                    epoch: Optional[str] = None) -> int:
    """Load persisted entries into ``cache``; returns the number loaded
    (0 on any mismatch — missing/truncated/bit-flipped file, format bump,
    foreign data epoch, different quantization parameters: keys computed
    under another bucketing would never match, so the load degrades to a
    clean cold start)."""
    payload = _load_checked(path, epoch)
    if (not isinstance(payload, dict)
            or payload.get("sel_step") != cache.sel_step
            or payload.get("cost_step") != cache.cost_step
            or payload.get("dict_sel_step") != cache.dict_sel_step):
        return 0
    loaded = 0
    for blob in payload.get("entries", []):
        try:
            full_key, cpos, inv, tape_st = restricted_loads(blob)
            tape = _tape_from_state(tape_st) if tape_st is not None else None
        except Exception:
            continue
        cache._entries[full_key] = {"cpos": cpos, "inv": inv, "tape": tape,
                                    "bad": 0}
        loaded += 1
        if len(cache._entries) > cache.capacity:
            cache._entries.popitem(last=False)
    return loaded


def save_feedback(store: FeedbackStore, path: str,
                  epoch: Optional[str] = None) -> int:
    """Persist the feedback store's learned state; returns keys written."""
    _dump_checked(store, path, epoch)
    return len(store._keys)


def load_feedback(path: str,
                  epoch: Optional[str] = None) -> Optional[FeedbackStore]:
    """The persisted store, or None when absent/unreadable/stale/foreign."""
    store = _load_checked(path, epoch)
    return store if isinstance(store, FeedbackStore) else None


def enable_compilation_cache(cache_dir: str) -> bool:
    """Whether the CUDA kernel library of the current sources is already
    built on disk, so that this process loads it without compiling.

    The reference wires JAX's persistent compilation cache here; the port
    has no XLA programs to persist.  Its kernels persist on their own, in
    ``build/repro_torch_kernels/`` keyed by a hash of the sources, and its
    CUDA graphs cannot be serialised (each tape key is captured again at
    its first run).  So this only reports; it never runs ``nvcc`` and
    writes nothing.  ``cache_dir`` is kept for the reference's signature."""
    from ..kernels import _build
    return _build.library_path().exists()


def save_session_caches(session: QuerySession, cache_dir: str,
                        epoch: Optional[str] = None) -> dict:
    """Flush a session's warm state to ``cache_dir`` (stamped with the
    data ``epoch`` when the session serves a durable table); returns
    counts."""
    os.makedirs(cache_dir, exist_ok=True)
    out = {"plans": save_plan_cache(
        session.plan_cache, os.path.join(cache_dir, PLAN_CACHE_FILE),
        epoch)}
    if session.feedback is not None:
        out["feedback_keys"] = save_feedback(
            session.feedback, os.path.join(cache_dir, FEEDBACK_FILE),
            epoch)
    return out


def save_metrics(payload: dict, cache_dir: str) -> str:
    """Write the final observability snapshot (``metrics.json``) next to
    the warm-restart artifacts; returns the path.  Unlike the pickled
    caches this is JSON — it is an audit/debug artifact for humans and
    scrapers, never loaded back by the engine."""
    os.makedirs(cache_dir, exist_ok=True)
    path = os.path.join(cache_dir, METRICS_FILE)
    with open(path, "w") as f:
        json.dump(payload, f, indent=2, sort_keys=True, default=str)
    return path


def load_session_caches(session: QuerySession, cache_dir: str,
                        compilation_cache: bool = True,
                        epoch: Optional[str] = None) -> dict:
    """Warm a fresh session from ``cache_dir``; returns counts (with
    ``compilation_cache``: whether the kernel library is already built,
    see :func:`enable_compilation_cache`).  Safe on an empty/missing
    directory — everything cold-starts.  ``epoch`` is the expected data
    lineage: files stamped with a *different* one are refused (clean cold
    start) instead of warming the session with foreign-table state."""
    out = {"plans": load_plan_cache(
        session.plan_cache, os.path.join(cache_dir, PLAN_CACHE_FILE),
        epoch)}
    fb = load_feedback(os.path.join(cache_dir, FEEDBACK_FILE), epoch)
    if fb is not None and session.feedback is not None:
        session.feedback.__dict__.update(fb.__dict__)
        out["feedback_keys"] = len(fb._keys)
    if compilation_cache:
        out["compilation_cache"] = enable_compilation_cache(cache_dir)
    return out
