"""PyTorch / CUDA port of the predicate-planning column engine.

The paper's planners (BestD/Update, ShallowFish, DeepFish) plan a
predicate tree over a columnar table; the plan compiles to a tape that
runs on an NVIDIA GPU through hand-written CUDA kernels
(``kernels/csrc``), with one host sync per query (the per-step block
engine, ``engine="jax"``, makes one device step per atom instead);
batches of queries run in lockstep through a ``QuerySession`` or a
``StreamSession``, with one host sync per batch; a ``StreamSession`` can
be durable (write-ahead log and snapshots, ``columnar.wal``) and
warm-restartable (``columnar.persist``), and ``launch.serve`` serves it.
``ExecConfig(shards=S)`` shards the tape engine's blocks over a mesh of
devices (``columnar.shard``, ``launch.mesh``), driven from one process.
Every entry point runs on the card unless the caller asks for the CPU
(``device="cpu"``), where the kernels' plain PyTorch versions run
instead.

The package imports ``torch`` and ``numpy`` and keeps its own copies of
the framework-free modules (planners, tape compiler, table, ingest).
"""
from .columnar import (BitmapBackend, BlockBackend, ConfigError,
                       DeviceTapeBackend, ExecConfig, QuerySession,
                       ShardedTapeBackend, StreamSession, Table,
                       make_forest_table, random_query_suite, random_tree,
                       run_query)
from .convert import table_from_arrays

__all__ = ["run_query", "ExecConfig", "ConfigError", "Table",
           "DeviceTapeBackend", "ShardedTapeBackend", "BitmapBackend",
           "BlockBackend",
           "QuerySession", "StreamSession", "make_forest_table", "random_tree",
           "random_query_suite", "table_from_arrays"]
