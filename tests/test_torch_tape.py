"""The port's slice as a whole against the reference package, on the CPU.

The same seeds must give the same tables and trees in both packages, the
same plans must compile to the same tapes, and ``run_query`` on the port's
tape engine (``device="cpu"``: the kernels' plain versions) must give the
reference tape engine's result bitmap, ``Stats``, block counters,
sync / dispatch / fallback counts and drained ``op_log`` exactly.  Tables
cross from the reference to the port through
``repro_torch.convert.table_from_arrays``.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import repro.columnar as R
import repro.core as RC
import repro_torch.columnar as T
import repro_torch.core as TC
from repro.core.predicate import atom_key as ref_atom_key
from repro_torch.convert import table_from_arrays
from repro_torch.core.predicate import atom_key as port_atom_key

BLOCK = 1024
STATS = ("records_evaluated", "weighted_cost", "atom_applications", "setops")
COUNTERS = ("blocks_touched", "blocks_pruned", "records_touched",
            "host_syncs", "device_dispatches", "host_fallbacks")


def _run_both(ref_table, port_table, ref_tree, port_tree, **cfg):
    cfg.setdefault("planner", "deepfish")
    cfg.setdefault("block", BLOCK)
    r_res, _, r_be = R.run_query(ref_tree, ref_table, config=R.ExecConfig(
        engine="tape", **cfg))
    p_res, _, p_be = T.run_query(port_tree, port_table, config=T.ExecConfig(
        engine="tape", device="cpu", **cfg))
    o_res, _, _ = T.run_query(port_tree, port_table, config=T.ExecConfig(
        engine="numpy", device="cpu", **cfg))
    ro_res, _, _ = R.run_query(ref_tree, ref_table, config=R.ExecConfig(
        engine="numpy", **cfg))
    np.testing.assert_array_equal(p_res, r_res)
    np.testing.assert_array_equal(p_res, o_res)
    np.testing.assert_array_equal(p_res, ro_res)
    for f in STATS:
        assert getattr(p_be.stats, f) == getattr(r_be.stats, f), f
    for f in COUNTERS:
        assert getattr(p_be, f) == getattr(r_be, f), f
    assert p_be.drain_op_log() == r_be.drain_op_log()
    return p_be


def _pair(ref_node, port_node):
    return RC.normalize(ref_node), TC.normalize(port_node)


def _build(mod, spec):
    """A tree from a nested spec: ("and"|"or", [children]) or an Atom
    argument tuple, built with package ``mod`` (repro.core or
    repro_torch.core)."""
    kind, body = spec
    if kind in ("and", "or"):
        cls = mod.And if kind == "and" else mod.Or
        return cls([_build(mod, c) for c in body])
    return mod.Atom(*body[0], **body[1])


def _both(spec):
    return _pair(_build(RC, spec), _build(TC, spec))


def _atom(col, op, value, **kw):
    return ("atom", ((col, op, value), kw))


# -- the same seeds give the same data and trees ------------------------------

@pytest.mark.parametrize("strings", [False, True])
def test_forest_tables_identical(strings):
    ref = R.make_forest_table(5000, n_dup=2, seed=7, strings=strings)
    port = T.make_forest_table(5000, n_dup=2, seed=7, strings=strings)
    assert list(port.columns) == list(ref.columns)
    for name, col in ref.columns.items():
        assert port.columns[name].dtype == col.dtype, name
        np.testing.assert_array_equal(port.columns[name], col, err_msg=name)


def test_query_suites_identical(forest, string_forest):
    for ref_table, n_atoms, depth in ((forest, 16, 3),
                                      (string_forest, 10, 3)):
        port_table = table_from_arrays(ref_table.columns)
        ref_trees = R.random_query_suite(ref_table, 6, n_atoms, depth, seed=3)
        port_trees = T.random_query_suite(port_table, 6, n_atoms, depth,
                                          seed=3)
        for rt, pt in zip(ref_trees, port_trees):
            assert ([ref_atom_key(a) for a in rt.atoms]
                    == [port_atom_key(a) for a in pt.atoms])
            assert ([a.selectivity for a in rt.atoms]
                    == [a.selectivity for a in pt.atoms])
            assert RC.canonical_key(rt)[0] == TC.canonical_key(pt)[0]


@pytest.mark.parametrize("planner", ["deepfish", "shallowfish", "nooropt",
                                     "optimal"])
def test_compile_tape_identical(forest, planner):
    port_table = table_from_arrays(forest.columns)
    n_atoms = 7 if planner == "optimal" else 16
    ref_trees = R.random_query_suite(forest, 3, n_atoms, 3, seed=5)
    port_trees = T.random_query_suite(port_table, 3, n_atoms, 3, seed=5)
    ref_plan = getattr(RC, planner if planner != "optimal" else "optimal_plan")
    port_plan = getattr(TC, planner if planner != "optimal"
                        else "optimal_plan")
    for rt, pt in zip(ref_trees, port_trees):
        ra = ref_plan(rt, RC.PerAtomCostModel(),
                      total_records=forest.n_records)
        pa = port_plan(pt, TC.PerAtomCostModel(),
                       total_records=forest.n_records)
        assert ra.order == pa.order
        r_tape, p_tape = RC.compile_tape(ra), TC.compile_tape(pa)
        assert p_tape.key == r_tape.key
        assert ([dataclasses.astuple(op) for op in p_tape.ops]
                == [dataclasses.astuple(op) for op in r_tape.ops])
        assert (p_tape.result, p_tape.n_slots) == (r_tape.result,
                                                   r_tape.n_slots)


# -- run_query(engine="tape", device="cpu") against the reference -------------

def test_numeric_forest_tape_matches_reference(forest):
    port_table = table_from_arrays(forest.columns)
    ref_trees = R.random_query_suite(forest, 4, 16, 3, seed=0)
    port_trees = T.random_query_suite(port_table, 4, 16, 3, seed=0)
    for rt, pt in zip(ref_trees, port_trees):
        be = _run_both(forest, port_table, rt, pt)
        assert be.host_syncs == 1 and be.device_dispatches == 1
        assert be.host_fallbacks == 0
        assert any(op.kind == "CHAIN" for op in be.last_tape.ops)


@pytest.mark.parametrize("planner", ["shallowfish", "nooropt", "auto"])
def test_other_planners_tape_matches_reference(forest, planner):
    port_table = table_from_arrays(forest.columns)
    rt = R.random_query_suite(forest, 1, 9, 2, seed=11)[0]
    pt = T.random_query_suite(port_table, 1, 9, 2, seed=11)[0]
    _run_both(forest, port_table, rt, pt, planner=planner)


def test_string_forest_tape_matches_reference(string_forest):
    port_table = table_from_arrays(string_forest.columns)
    ref_trees = R.random_query_suite(string_forest, 3, 10, 3, seed=2)
    port_trees = T.random_query_suite(port_table, 3, 10, 3, seed=2)
    for rt, pt in zip(ref_trees, port_trees):
        be = _run_both(string_forest, port_table, rt, pt)
        assert be.host_fallbacks == 0 and be.host_syncs == 1


def test_unrewritten_strings_fall_back_like_reference(string_forest):
    port_table = table_from_arrays(string_forest.columns)
    rt, pt = _both(("and", [
        _atom("elevation_0", "lt", 2800.0, selectivity=0.5),
        ("or", [_atom("cover_0", "eq", "pine", selectivity=0.2),
                _atom("slope_0", "gt", 10.0, selectivity=0.6)])]))
    be = _run_both(string_forest, port_table, rt, pt,
                   rewrite_strings=False)
    assert be.host_fallbacks > 0


def _fragmented_spec(table):
    """String atoms whose dictionary hit sets fragment (contains-LIKE,
    scattered IN) plus numeric atoms at fixed selectivities."""
    def num(col, g):
        return _atom(col, "lt", table.value_at_selectivity(col, g),
                     selectivity=g)
    return ("or", [
        ("and", [_atom("cover_0", "like", "%e%"), num("elevation_0", 0.5),
                 num("slope_0", 0.6)]),
        ("and", [_atom("cover_0", "in", ("aspen", "cedar", "hemlock",
                                          "maple", "pine", "willow")),
                 num("h_dist_road_0", 0.4)]),
        ("and", [_atom("district_0", "in",
                       tuple(f"district_{i:02d}"
                             for i in (1, 4, 7, 11, 15, 19, 22))),
                 num("hillshade_noon_0", 0.6), num("aspect_0", 0.5)]),
    ])


def test_fragmented_strings_tape_matches_reference(string_forest):
    port_table = table_from_arrays(string_forest.columns)
    rt, pt = _both(_fragmented_spec(string_forest))
    R.annotate_selectivities(rt, string_forest)
    T.annotate_selectivities(pt, port_table)
    be = _run_both(string_forest, port_table, rt, pt)
    assert be.host_fallbacks == 0 and be.host_syncs == 1
    rtree = T.rewrite_string_atoms(pt, port_table)
    assert any(a.op == "in" for a in rtree.atoms)     # a lookup atom


def _zone_table(n=20_000, block=2048, seed=0):
    """Ingest-ordered table: a sorted column and a block-constant shard id
    (the layouts zone maps decide outright) plus unclustered noise."""
    rng = np.random.default_rng(seed)
    return {
        "ts": np.sort(rng.uniform(0, 100, n)).astype(np.float32),
        "shard": (np.arange(n) // block).astype(np.float32),
        "x": rng.normal(size=n).astype(np.float32),
        "y": rng.normal(size=n).astype(np.float32),
    }


def test_zone_pruned_tape_matches_reference():
    cols = _zone_table()
    ref_table = R.Table({k: v.copy() for k, v in cols.items()})
    port_table = table_from_arrays(cols)
    hi = float(cols["ts"].max())
    specs = [
        ("and", [_atom("ts", "ge", hi * 0.9, selectivity=0.1),
                 ("or", [_atom("x", "gt", 0.0, selectivity=0.5),
                         _atom("y", "lt", -1.0, selectivity=0.2)])]),
        ("and", [_atom("shard", "eq", 2.0, selectivity=0.1),
                 _atom("y", "lt", 0.5, selectivity=0.7)]),
        ("and", [_atom("ts", "ge", -1.0, selectivity=0.999),
                 _atom("x", "lt", 0.0, selectivity=0.5)]),
        ("or", [("and", [_atom("ts", "lt", hi * 0.1, selectivity=0.1),
                         _atom("x", "lt", 0.3, selectivity=0.6)]),
                ("and", [_atom("shard", "le", 1.0, selectivity=0.2),
                         _atom("y", "gt", -0.5, selectivity=0.7)])]),
    ]
    pruned = 0.0
    for spec in specs:
        rt, pt = _both(spec)
        be = _run_both(ref_table, port_table, rt, pt, block=2048)
        pruned += be.blocks_pruned
        rt, pt = _both(spec)
        _run_both(ref_table, port_table, rt, pt, block=2048,
                  zone_prune=False)
    assert pruned > 0


def test_tombstoned_tape_matches_reference(forest):
    rng = np.random.default_rng(9)
    dead = rng.random(forest.n_records) < 0.3
    ref_table = R.Table({k: v.copy() for k, v in forest.columns.items()})
    ref_table.delete(dead)
    port_table = table_from_arrays(forest.columns, deleted=dead)
    assert port_table.n_deleted == ref_table.n_deleted
    rt = R.random_query_suite(ref_table, 1, 12, 3, seed=4)[0]
    pt = T.random_query_suite(port_table, 1, 12, 3, seed=4)[0]
    _run_both(ref_table, port_table, rt, pt)


def test_udf_host_fallback_matches_reference(forest):
    port_table = table_from_arrays(forest.columns)
    fn = lambda v: np.abs(v - 2750.0) < 300.0  # noqa: E731
    spec = ("and", [_atom("slope_0", "lt", 15.0, selectivity=0.6),
                    ("or", [_atom("elevation_0", "udf", None, fn=fn,
                                  selectivity=0.5),
                            _atom("aspect_0", "gt", 300.0,
                                  selectivity=0.15)])])
    rt, pt = _both(spec)
    be = _run_both(forest, port_table, rt, pt)
    assert be.host_fallbacks == 1 and be.host_syncs == 2


def test_backend_reuse_keeps_columns_and_counts(forest):
    """A reused port backend accumulates counters like the reference's."""
    port_table = table_from_arrays(forest.columns)
    ref_trees = R.random_query_suite(forest, 2, 8, 2, seed=8)
    port_trees = T.random_query_suite(port_table, 2, 8, 2, seed=8)
    r_be = p_be = None
    for rt, pt in zip(ref_trees, port_trees):
        r_res, _, r_be = R.run_query(rt, forest, backend=r_be, config=R.
                                     ExecConfig(engine="tape", block=BLOCK))
        p_res, _, p_be = T.run_query(pt, port_table, backend=p_be,
                                     config=T.ExecConfig(engine="tape",
                                                         block=BLOCK,
                                                         device="cpu"))
        np.testing.assert_array_equal(p_res, r_res)
    assert p_be.host_syncs == r_be.host_syncs == 2
    assert p_be.uploaded_bytes == r_be.uploaded_bytes
    assert p_be.stats.records_evaluated == r_be.stats.records_evaluated


def test_block_engines_build_and_sharding_raises(forest):
    """The per-step block engines build under both names; sharding builds
    a ShardedTapeBackend on the tape engine and still raises on the block
    engine, as in the reference; an unknown device raises."""
    port_table = table_from_arrays(forest.columns)
    tree = T.random_query_suite(port_table, 1, 4, 2, seed=1)[0]
    for eng in ("jax", "pallas"):
        _, _, be = T.run_query(tree, port_table, config=T.ExecConfig(
            engine=eng, device="cpu"))
        assert isinstance(be, T.BlockBackend) and be.engine == eng
    _, _, be = T.run_query(tree, port_table, config=T.ExecConfig(
        engine="tape", shards=2, device="cpu"))
    assert isinstance(be, T.ShardedTapeBackend) and be.shards == 2
    with pytest.raises(T.ConfigError, match="requires engine='tape'"):
        T.ExecConfig(engine="jax", shards=2, device="cpu")
    with pytest.raises(T.ConfigError):
        T.ExecConfig(device="tpu")
