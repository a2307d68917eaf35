"""Token pipeline fronted by the paper's predicate-evaluation engine.

A trillion-token trainer selects documents with complex boolean predicates
over *metadata columns* (quality, language, dedup, toxicity, source,
length): exactly the workload the paper optimizes.  The filter expression
is planned by ShallowFish (depth <= 2) or DeepFish (deeper), executed by
the host columnar engine (``BitmapBackend``, as in the reference) into a
record bitmap, and the surviving document ids drive deterministic,
step-keyed batch synthesis (replayable after restart).  The numpy random
calls are the reference's, so both packages make the same columns,
document ids and batches.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Dict, Optional

import numpy as np

from ..columnar.bitmap import unpack_bits
from ..columnar.executor import BitmapBackend
from ..columnar.table import Table, annotate_selectivities
from ..core import (Atom, Node, PerAtomCostModel, deepfish, execute_plan,
                    normalize, shallowfish)


def make_corpus_metadata(n_docs: int = 200_000, seed: int = 0) -> Table:
    """Synthetic corpus metadata columns (one row per document)."""
    rng = np.random.default_rng(seed)
    lang = rng.choice(8, size=n_docs, p=[.45, .15, .10, .08, .08, .06, .05, .03])
    return Table({
        "quality_score": rng.beta(4, 2, n_docs).astype(np.float32),
        "toxicity": rng.beta(1.2, 14, n_docs).astype(np.float32),
        "lang_id": lang.astype(np.int32),
        "dedup_cluster_size": rng.geometric(0.6, n_docs).astype(np.int32),
        "n_tokens": np.clip(rng.lognormal(6.2, 1.1, n_docs), 32,
                            65536).astype(np.int32),
        "source_id": rng.choice(16, size=n_docs).astype(np.int32),
        "perplexity": np.clip(rng.lognormal(2.8, 0.6, n_docs), 2,
                              2000).astype(np.float32),
    })


def default_quality_filter() -> Node:
    """A realistic mixed AND/OR filter (depth 3 => DeepFish territory):
    (high-quality AND non-toxic AND deduped) AND
    (main-lang OR (short-enough AND low-perplexity))."""
    return (
        Atom("quality_score", "gt", 0.5)
        & Atom("toxicity", "lt", 0.2)
        & Atom("dedup_cluster_size", "le", 2)
        & (Atom("lang_id", "eq", 0)
           | (Atom("n_tokens", "lt", 8192) & Atom("perplexity", "lt", 80.0)))
    )


@dataclass
class CorpusMetadata:
    table: Table
    plan_stats: Optional[dict] = None


class PredicateFilteredDataset:
    """Step-keyed batch source: filter once, then deterministic sampling.

    ``data_fn(step)`` contract of runtime.TrainLoop: same step => same batch
    (bit-exact replay after checkpoint restart, regardless of restarts).
    Each data-parallel host passes ``shard_id``/``n_shards`` to take a
    disjoint stride of every batch.  Batches are numpy arrays on the host.
    """

    def __init__(self, table: Table, filter_expr: Node, seq_len: int,
                 global_batch: int, vocab: int, seed: int = 0,
                 shard_id: int = 0, n_shards: int = 1,
                 planner: str = "auto"):
        tree = normalize(filter_expr)
        annotate_selectivities(tree, table)
        model = PerAtomCostModel()
        if planner == "auto":
            planner = "shallowfish" if tree.depth <= 2 else "deepfish"
        plan = (shallowfish if planner == "shallowfish" else deepfish)(
            tree, model, total_records=table.n_records)
        backend = BitmapBackend(table)
        bitmap = execute_plan(plan, backend)
        mask = unpack_bits(bitmap, table.n_records)
        self.doc_ids = np.nonzero(mask)[0]
        if len(self.doc_ids) == 0:
            raise ValueError("filter selected zero documents")
        self.plan = plan
        self.filter_stats = {
            "planner": plan.planner,
            "selected": int(mask.sum()),
            "total": table.n_records,
            "records_evaluated": backend.stats.records_evaluated,
            "plan_est_cost": plan.est_cost,
            "plan_time_s": plan.plan_time_s,
        }
        self.seq_len = seq_len
        self.global_batch = global_batch
        self.vocab = vocab
        self.seed = seed
        self.shard_id = shard_id
        self.n_shards = n_shards
        if global_batch % n_shards:
            raise ValueError("global_batch must divide by n_shards")

    def __call__(self, step: int) -> Dict[str, np.ndarray]:
        """Batch for ``step`` (local shard slice): {"tokens": (B_local, S+1)}."""
        rng = np.random.default_rng((self.seed, step))
        ids = rng.choice(self.doc_ids, size=self.global_batch, replace=True)
        local = ids[self.shard_id::self.n_shards]
        toks = np.stack([self._doc_tokens(int(i)) for i in local])
        return {"tokens": toks}

    def _doc_tokens(self, doc_id: int) -> np.ndarray:
        rng = np.random.default_rng((self.seed, 7919, doc_id))
        return rng.integers(0, self.vocab, size=self.seq_len + 1,
                            dtype=np.int32)
