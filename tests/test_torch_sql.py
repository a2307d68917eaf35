"""The port's SQL front end against the reference's, on the CPU.

``repro_torch.columnar.sql.parse_select`` must give the reference's
projection, table name and predicate tree (its ``pretty()`` rendering and
atoms) on ``tests/test_sql.py``'s statements, and raise on its malformed
inputs.  A parsed statement runs end to end on the port's per-step block
engine (``device="cpu"``) equal to the numpy oracle.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

import repro.core as RC
from repro.columnar.sql import parse_select as ref_parse
from repro_torch import ExecConfig, Table, run_query
from repro_torch.columnar import unpack_bits
from repro_torch.columnar.sql import parse_select
from repro_torch.core import normalize

STATEMENTS = [
    "SELECT a, b FROM t WHERE a < 1 AND (b > 0 OR c = 2)",
    "SELECT a FROM t WHERE NOT a < 0 AND b <= 1 OR c != 3",
    "SELECT a FROM t WHERE c IN (1, 2, 4)",
    "SELECT a FROM t WHERE (a < 0.5 AND b > -0.5) OR (c = 1 AND NOT b > 1.0)",
    "SELECT a FROM t WHERE NOT c = 1 OR c = 2",
    "SELECT a FROM t WHERE NOT (c = 1 OR c = 2) AND a < 0",
    "SELECT a FROM t WHERE c IN (3)",
    "SELECT name FROM t WHERE name ILIKE '%lic%'",
    "SELECT a FROM t WHERE c <> 2 AND name IN ('x', 'y')",
    "SELECT a FROM t",
]
MALFORMED = ["SELECT FROM t", "SELECT a FROM t WHERE a <",
             "SELECT a FROM t WHERE a < 1 AND (b > 0",
             "SELECT a FROM t WHERE c IN 1", "SELECT a FROM t WHERE a ~ 1"]


def _atoms(tree):
    return [(a.column, a.op, a.value) for a in tree.atoms]


@pytest.mark.parametrize("sql", STATEMENTS)
def test_parse_select_matches_reference(sql):
    cols, tab, expr = parse_select(sql)
    rcols, rtab, rexpr = ref_parse(sql)
    assert (cols, tab) == (rcols, rtab)
    if rexpr is None:
        assert expr is None
        return
    tree, rtree = normalize(expr), RC.normalize(rexpr)
    assert tree.pretty() == rtree.pretty()
    assert _atoms(tree) == _atoms(rtree)
    assert (tree.n, tree.depth) == (rtree.n, rtree.depth)


@pytest.mark.parametrize("sql", MALFORMED)
def test_malformed_statements_raise_like_reference(sql):
    with pytest.raises(ValueError):
        ref_parse(sql)
    with pytest.raises(ValueError):
        parse_select(sql)


def test_statement_runs_on_the_block_engine_like_the_oracle():
    rng = np.random.default_rng(0)
    n = 10_000
    table = Table({"a": rng.normal(size=n).astype(np.float32),
                   "b": rng.normal(size=n).astype(np.float32),
                   "c": rng.choice(5, n).astype(np.int32)})
    _, _, expr = parse_select(
        "SELECT a FROM t WHERE (a < 0.5 AND b > -0.5) "
        "OR (c = 1 AND NOT b > 1.0) OR c IN (3, 4)")
    tree = normalize(expr)
    got, _, be = run_query(tree, table, config=ExecConfig(
        engine="jax", device="cpu", block=1024, planner="deepfish"))
    want, _, _ = run_query(tree, table, config=ExecConfig(
        engine="numpy", device="cpu", planner="deepfish"))
    assert np.array_equal(got, want)
    assert be.kernel_invocations > 0
    a, b, c = table["a"], table["b"], table["c"]
    mask = (((a < 0.5) & (b > -0.5)) | ((c == 1) & ~(b > 1.0))
            | np.isin(c, (3, 4)))
    assert np.array_equal(unpack_bits(got, n), mask)
