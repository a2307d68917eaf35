"""Column-store substrate of the port: packed bitmaps, columnar tables,
synthetic data, selectivity stats, and the plan executors (numpy oracle,
compiled-tape engine and per-step block engine on the CUDA kernels).

Single-query path: ``run_query(tree, table, config=ExecConfig(engine=
"tape"))`` rewrites dictionary-encodable string atoms, plans with one of
the paper's planners, compiles the plan to a tape and runs it through
:class:`DeviceTapeBackend` with one host sync (block-sharded over a mesh
of devices by :class:`ShardedTapeBackend` under ``ExecConfig(shards=S)``).
``ExecConfig(engine="numpy", device="cpu")`` runs the
:class:`BitmapBackend` oracle on the host instead;
``engine="jax"`` (or ``"pallas"``, the same path) the per-step
:class:`BlockBackend`, one device step and two host syncs per atom
application.

Multi-query path: a :class:`QuerySession` executes a batch of trees with a
plan cache and cross-query atom sharing; with ``batched=True`` on the tape
engine it drives every plan in lockstep over device-resident sets, one
stacked kernel launch per shared atom and round, one host sync per batch.
A :class:`StreamSession` admits queries between appends and drains them
through that lockstep session; with ``durable=`` its table is crash-safe
(:class:`Durability`: a checksummed write-ahead log and snapshots,
:mod:`.wal`), and with ``cache_dir=`` its plan and tape caches survive a
restart (:mod:`.persist`).
"""
from .bitmap import (WORD, bitmap_and, bitmap_andnot, bitmap_empty,
                     bitmap_full, bitmap_or, extend_bitmap, pack_bits,
                     popcount, unpack_bits)
from .config import ConfigError, ExecConfig
from .device import DeviceTapeBackend
from .drainer import BackgroundDrainer, DrainPolicy, LatencyWindow
from .executor import (BitmapBackend, BlockBackend, resolve_backend,
                       run_query)
from .forest import make_forest_table
from .ingest import ZoneMap
from .multiquery import (BatchResult, BatchStats, LRUPlanCache, PlanCacheStats,
                         QuerySession)
from .queries import random_query_suite, random_tree
from .shard import ShardedTapeBackend
from .stream import (StreamBackpressure, StreamClosed, StreamFuture,
                     StreamQueryError, StreamSession, StreamStats)
from .table import (DictColumn, Table, annotate_selectivities,
                    empirical_selectivity, rewrite_string_atoms)
from .trace import (ExplainReport, OpObservation, SpanRecord, Tracer,
                    explain_analyze, tracer)
from .wal import Durability, DurabilityError, WriteAheadLog

__all__ = [
    "pack_bits", "unpack_bits", "popcount", "bitmap_and", "bitmap_or",
    "bitmap_andnot", "bitmap_full", "bitmap_empty", "extend_bitmap", "WORD",
    "Table", "DictColumn", "annotate_selectivities", "empirical_selectivity",
    "rewrite_string_atoms", "make_forest_table",
    "BitmapBackend", "BlockBackend", "DeviceTapeBackend",
    "ShardedTapeBackend", "run_query", "resolve_backend",
    "ExecConfig", "ConfigError",
    "ZoneMap", "random_tree", "random_query_suite",
    "QuerySession", "LRUPlanCache", "BatchResult", "BatchStats",
    "PlanCacheStats", "StreamFuture", "StreamSession", "StreamStats",
    "StreamQueryError", "StreamClosed", "StreamBackpressure",
    "BackgroundDrainer", "DrainPolicy", "LatencyWindow",
    "Tracer", "tracer", "SpanRecord", "explain_analyze", "ExplainReport",
    "OpObservation",
    "Durability", "DurabilityError", "WriteAheadLog",
]
