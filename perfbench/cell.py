"""A cell's parts, found by name, and what a run makes from its seed before
the program is touched: the spec's entries, the configuration, the traffic
mix, the data and the query pool; and the check of answers against the
plain reference.  Imports neither the program nor
JAX."""
from __future__ import annotations

import json
from dataclasses import dataclass
from pathlib import Path
from typing import Dict, List, Optional

import numpy as np

from .data import make_table_data
from .queries import make_pool
from .reference import Reference, compare_answer

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_spec(root: Path = ROOT) -> dict:
    return load_json(root / "BENCHMARK.json")


def find(items: List[dict], name: str, what: str) -> dict:
    for it in items:
        if it["name"] == name:
            return it
    raise KeyError(f"no {what} named {name!r} in BENCHMARK.json")


def cell_parts(spec: dict, workload: str):
    """The cell's entry, its configuration's file and its traffic mix."""
    cell = find(spec["workloads"], workload, "workload")
    conf = find(spec["configs"], cell["config"], "configuration")
    cfg = load_json(ROOT / conf["file"])
    mix = load_json(HERE / "traffic" / f"{cell['traffic']}.json")
    return cell, cfg, mix


@dataclass
class Answer:
    """One answer of the window.  A driver keeps the first answer of each
    query and hands a repeat the kept array, with ``agrees`` saying
    whether the repeat was equal to it, so that a window holds one array a
    query and every answer is still judged."""

    index: int                     # the pool query
    words: Optional[np.ndarray]    # the program's packed answer (None: none)
    latency_ms: float
    agrees: bool = True


@dataclass
class Context:
    """What a driver is handed."""

    cfg: dict
    mix: dict
    data: object
    pool: object
    seed: int
    device_name: str
    tracer: object = None

    @property
    def trace_setting(self):
        """``ExecConfig.trace``: the run's tracer, or off.  (A tracer with
        no spans yet is falsy, so never ``tracer or False``.)"""
        return self.tracer if self.tracer is not None else False


def make_context(workload: str, seed: int, device: str,
                 records: Optional[int] = None,
                 mix_overrides: Optional[dict] = None):
    """The cell's spec entry, data and query pool: everything a run makes
    from its seed before the program is touched.  ``records`` and
    ``mix_overrides`` shrink a cell for the CPU tests."""
    import torch
    spec = load_spec()
    cell, cfg, mix = cell_parts(spec, workload)
    mix = dict(mix, **(mix_overrides or {}))
    data = make_table_data(cfg, seed, torch.device(device), records=records)
    pool = make_pool(mix, data.attrs, cfg["duplicates"], data.constant)
    return spec, cell, Context(cfg=cfg, mix=mix, data=data, pool=pool,
                               seed=seed, device_name=device)


def check_answers(answers, trees, reference: Reference) -> Dict:
    """Every answer against the reference's over all records.  An answer
    counts as wrong when it is missing, when it differs from the first
    answer the run gave to the same query, or when any record differs."""
    judged: Dict[int, Optional[int]] = {}
    missing = disagree = differ = records = 0
    for a in answers:
        if a.words is None:
            missing += 1
            continue
        if not a.agrees:
            disagree += 1
            continue
        key = id(a.words)
        if key not in judged:
            judged[key] = compare_answer(a.words,
                                         reference.words(trees[a.index]),
                                         reference.n)
        bad = judged[key]
        if bad is not None:
            differ += 1
            records += bad
    return {"wrong_answers": missing + disagree + differ,
            "missing": missing, "disagreeing": disagree,
            "differing": differ, "differing_records": records,
            "distinct_queries": len(judged)}
