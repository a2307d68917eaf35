"""The port's lockstep ``QuerySession`` against the reference's, on the CPU.

``QuerySession(ExecConfig(engine="tape", batched=True, device="cpu"))``
drives every plan through BestD machines in lockstep over the port's
``DeviceTapeBackend`` (the kernels' plain versions, K5 / K6 included).  On
the same numpy-seeded tables and trees it must give the reference lockstep
session's bitmaps, ``BatchStats`` counters and per-op observations exactly,
over numeric, string and fragmented batches, zone-pruned or not, with and
without shared atoms, and across two batches (the atom-cache hit path).
The backend's ``materialize``, ``refresh`` and ``extend_set`` are held
against the reference backend directly.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

import repro.columnar as R
import repro.core as RC
import repro_torch.columnar as T
import repro_torch.core as TC
from repro.columnar.device import DeviceTapeBackend as RefBackend
from repro_torch.columnar.device import DeviceTapeBackend as PortBackend
import repro_torch.columnar.device as port_device
from repro_torch.convert import table_from_arrays
from repro_torch.kernels import ref as tref

BLOCK = 1024
#: BatchStats fields that must be equal, field for field
BATCH_FIELDS = ("host_syncs", "device_dispatches", "kernel_batches",
                "atom_cache_hits", "lockstep_rounds", "logical_atoms",
                "physical_atoms", "records_evaluated", "blocks_touched",
                "blocks_pruned")


def _sessions(ref_table, port_table, **cfg):
    cfg = dict(dict(planner="deepfish", engine="tape", batched=True,
                    block=BLOCK), **cfg)
    return (R.QuerySession(ref_table, config=R.ExecConfig(**cfg)),
            T.QuerySession(port_table, config=T.ExecConfig(device="cpu",
                                                           **cfg)))


def _same_batch(ref_res, port_res):
    assert len(port_res.bitmaps) == len(ref_res.bitmaps)
    for r, p in zip(ref_res.bitmaps, port_res.bitmaps):
        assert np.array_equal(p, r)
    for f in BATCH_FIELDS:
        assert getattr(port_res.stats, f) == getattr(ref_res.stats, f), f
    assert port_res.stats.op_observations == ref_res.stats.op_observations


#: the stacked set operations, which take their Q sets as (bits, pops)
#: pairs in their last argument
ROW_WRAPPERS = ("bitmap_inter_multi", "bitmap_union_reduce")


@pytest.fixture
def calls(monkeypatch):
    """Counts of the port backend's calls into the stacked kernels' wrappers
    (on CPU tensors they run the plain versions and launch nothing).  A
    stacked set operation must get its Q >= 2 sets as (bits i32[N, W],
    pops i32[N]) pairs, never a stacked tensor."""
    counts = {}
    for name in ("predicate_scan_multi", "dict_lookup_scan_multi",
                 *ROW_WRAPPERS):
        fn = getattr(port_device, name)
        counts[name] = 0

        def spy(*args, _fn=fn, _name=name):
            counts[_name] += 1
            if _name in ROW_WRAPPERS:
                rows = args[-1]
                assert len(rows) >= 2
                for bits, pops in rows:
                    assert bits.dim() == 2 and bits.dtype == torch.int32
                    assert tuple(pops.shape) == tuple(bits.shape[:1])
            return _fn(*args)
        monkeypatch.setattr(port_device, name, spy)
    return counts


def _draw(ref_trees, port_trees, n, seed):
    """``n`` queries drawn with replacement from the templates."""
    pick = np.random.default_rng(seed).integers(0, len(ref_trees), size=n)
    return [ref_trees[i] for i in pick], [port_trees[i] for i in pick]


def _run_batches(ref_table, port_table, rq, pq, batches=2, **cfg):
    rs, ps = _sessions(ref_table, port_table, **cfg)
    out = []
    for _ in range(batches):
        a, b = rs.execute(rq), ps.execute(pq)
        _same_batch(a, b)
        out.append(b)
    return out


# -- whole batches ------------------------------------------------------------

@pytest.mark.parametrize("share", [True, False])
def test_numeric_lockstep_batches_match_reference(forest, share, calls):
    port_table = table_from_arrays(forest.columns)
    rq, pq = _draw(R.random_query_suite(forest, 4, 10, 3, seed=0),
                   T.random_query_suite(port_table, 4, 10, 3, seed=0),
                   12, seed=1)
    cfg = {} if share else {"share_threshold": 10 ** 6}
    first, second = _run_batches(forest, port_table, rq, pq, **cfg)
    assert first.stats.host_syncs == second.stats.host_syncs == 1
    assert first.stats.kernel_batches > 0
    assert calls["predicate_scan_multi"] > 0
    assert calls["bitmap_union_reduce"] > 0
    if share:
        assert first.stats.shared_atom_keys > 0
        assert second.stats.atom_cache_hits > 0
        assert calls["bitmap_inter_multi"] > 0
    else:
        assert first.stats.shared_atom_keys == 0
        assert second.stats.atom_cache_hits == 0


def test_lockstep_matches_the_host_lockstep_and_oracle(forest):
    """records_evaluated is engine-independent: the port's tape lockstep
    equals its numpy lockstep, and every bitmap equals run_query's."""
    port_table = table_from_arrays(forest.columns)
    trees = T.random_query_suite(port_table, 3, 8, 3, seed=4) * 3
    cfg = dict(planner="deepfish", batched=True, block=BLOCK, device="cpu")
    tape = T.QuerySession(port_table, config=T.ExecConfig(engine="tape",
                                                          **cfg))
    host = T.QuerySession(port_table, config=T.ExecConfig(engine="numpy",
                                                          **cfg))
    a, b = tape.execute(trees), host.execute(trees)
    assert a.stats.records_evaluated == b.stats.records_evaluated
    for tree, got, want in zip(trees, a.bitmaps, b.bitmaps):
        assert np.array_equal(got, want)
        oracle, _, _ = T.run_query(tree, port_table, config=T.ExecConfig(
            engine="numpy", device="cpu", planner="deepfish"))
        assert np.array_equal(got, oracle)


def test_string_lockstep_batches_match_reference(string_forest):
    port_table = table_from_arrays(string_forest.columns)
    rq, pq = _draw(R.random_query_suite(string_forest, 4, 8, 3, seed=2),
                   T.random_query_suite(port_table, 4, 8, 3, seed=2),
                   10, seed=3)
    first, _ = _run_batches(string_forest, port_table, rq, pq)
    assert first.stats.host_fallbacks == 0


def _fragmented_pair(ref_table, port_table):
    """The fragmented-strings tree (contains-LIKE, scattered IN), built in
    both packages and annotated against each package's table."""
    def spec(mod, table):
        def num(col, g):
            return mod.Atom(col, "lt", table.value_at_selectivity(col, g),
                            selectivity=g)
        return mod.normalize(mod.Or([
            mod.And([mod.Atom("cover_0", "like", "%e%"),
                     num("elevation_0", 0.5), num("slope_0", 0.6)]),
            mod.And([mod.Atom("cover_0", "in", ("aspen", "cedar", "hemlock",
                                                "maple", "pine", "willow")),
                     num("h_dist_road_0", 0.4)]),
            mod.And([mod.Atom("district_0", "in",
                              tuple(f"district_{i:02d}"
                                    for i in (1, 4, 7, 11, 15, 19, 22))),
                     num("hillshade_noon_0", 0.6), num("aspect_0", 0.5)]),
        ]))
    rt, pt = spec(RC, ref_table), spec(TC, port_table)
    R.annotate_selectivities(rt, ref_table)
    T.annotate_selectivities(pt, port_table)
    return rt, pt


@pytest.mark.parametrize("share", [True, False])
def test_fragmented_lockstep_reaches_the_stacked_lookup(string_forest, share,
                                                       calls):
    """Several copies of the fragmented tree in one batch: its lookup atoms
    run Q-stacked through K6 (or, shared, once with the full row)."""
    port_table = table_from_arrays(string_forest.columns)
    rt, pt = _fragmented_pair(string_forest, port_table)
    others_r = R.random_query_suite(string_forest, 2, 6, 2, seed=5)
    others_p = T.random_query_suite(port_table, 2, 6, 2, seed=5)
    rq, pq = [rt, rt] + others_r + [rt], [pt, pt] + others_p + [pt]
    cfg = {} if share else {"share_threshold": 10 ** 6}
    first, _ = _run_batches(string_forest, port_table, rq, pq, **cfg)
    assert first.stats.host_fallbacks == 0
    assert calls["dict_lookup_scan_multi"] > 0


def _zone_columns(n=24_000, block=2048, seed=0):
    rng = np.random.default_rng(seed)
    return {
        "ts": np.sort(rng.uniform(0, 100, n)).astype(np.float32),
        "shard": (np.arange(n) // block).astype(np.float32),
        "x": rng.normal(size=n).astype(np.float32),
        "y": rng.normal(size=n).astype(np.float32),
    }


def _zone_trees(mod, hi):
    A = mod.Atom
    return [mod.normalize(t) for t in (
        mod.And([A("ts", "ge", hi * 0.9, selectivity=0.1),
                 mod.Or([A("x", "gt", 0.0, selectivity=0.5),
                         A("y", "lt", -1.0, selectivity=0.2)])]),
        mod.And([A("shard", "eq", 2.0, selectivity=0.1),
                 A("y", "lt", 0.5, selectivity=0.7)]),
        mod.And([A("ts", "lt", hi * 0.3, selectivity=0.3),
                 A("x", "lt", 0.0, selectivity=0.5)]),
        mod.Or([mod.And([A("ts", "lt", hi * 0.1, selectivity=0.1),
                         A("x", "lt", 0.3, selectivity=0.6)]),
                mod.And([A("shard", "le", 1.0, selectivity=0.2),
                         A("y", "gt", -0.5, selectivity=0.7)])]),
    )]


@pytest.mark.parametrize("zone_prune", [True, False])
def test_zone_pruned_lockstep_batches_match_reference(zone_prune):
    cols = _zone_columns()
    ref_table = R.Table({k: v.copy() for k, v in cols.items()})
    port_table = table_from_arrays(cols)
    hi = float(cols["ts"].max())
    rq, pq = _draw(_zone_trees(RC, hi), _zone_trees(TC, hi), 10, seed=6)
    first, _ = _run_batches(ref_table, port_table, rq, pq, block=2048,
                            zone_prune=zone_prune)
    if zone_prune:
        assert first.stats.blocks_pruned > 0
    else:
        assert first.stats.blocks_pruned == 0


def test_udf_atoms_fall_back_in_lockstep_like_reference(forest):
    port_table = table_from_arrays(forest.columns)
    fn = lambda v: np.abs(v - 2750.0) < 300.0  # noqa: E731

    def tree(mod):
        return mod.normalize(mod.And([
            mod.Atom("slope_0", "lt", 15.0, selectivity=0.6),
            mod.Or([mod.Atom("elevation_0", "udf", None, fn=fn,
                             selectivity=0.5),
                    mod.Atom("aspect_0", "gt", 300.0, selectivity=0.15)])]))
    rq, pq = [tree(RC) for _ in range(3)], [tree(TC) for _ in range(3)]
    first, _ = _run_batches(forest, port_table, rq, pq)
    assert first.stats.host_fallbacks > 0


def _delete_steps(extra):
    """delete, append, delete, compact: each applied to both tables."""
    return [lambda t: t.delete(np.arange(100, 1600)),
            lambda t: t.append({k: v[:1500].copy()
                                for k, v in extra.columns.items()}),
            lambda t: t.delete(np.arange(5200, 5900)),
            lambda t: t.compact()]


@pytest.mark.parametrize("batched", [True, False])
def test_deletes_in_sessions_match_reference(batched):
    """Tombstone deletes between batches of a tape QuerySession, batched
    (lockstep) and per query, on a 6,000-row Forest table through delete,
    append, delete and compact: bitmaps, BatchStats counters and
    op_observations equal the reference session's after every step."""
    ref_table = R.make_forest_table(6000, n_dup=1, seed=7)
    port_table = table_from_arrays(ref_table.columns)
    extra = R.make_forest_table(3000, n_dup=1, seed=9)
    rq, pq = _draw(R.random_query_suite(ref_table, 4, 8, 3, seed=5),
                   T.random_query_suite(port_table, 4, 8, 3, seed=5),
                   10, seed=6)
    rs, ps = _sessions(ref_table, port_table, batched=batched)
    _same_batch(rs.execute(rq), ps.execute(pq))
    for step in _delete_steps(extra):
        step(ref_table)
        step(port_table)
        got = ps.execute(pq)
        _same_batch(rs.execute(rq), got)
        assert port_table.n_records == ref_table.n_records
    assert port_table.n_deleted == 0 and port_table.n_records == 5300


def test_numpy_session_needs_the_cpu(forest):
    port_table = table_from_arrays(forest.columns)
    with pytest.raises(T.ConfigError, match="device='cpu'"):
        T.QuerySession(port_table, config=T.ExecConfig(engine="numpy"))


# -- the backend directly -----------------------------------------------------

def _backends(ref_table, port_table, block=BLOCK):
    return (RefBackend(ref_table, block=block),
            PortBackend(port_table, block=block, device="cpu"))


def _atom_pair(col, op, value):
    return (RC.Atom(col, op, value, selectivity=0.5),
            TC.Atom(col, op, value, selectivity=0.5))


def test_materialize_mixes_single_and_stacked_observations(forest):
    """Scalar observations (one set) and stacked ``[Q]`` ones (Q sets) in
    one batch: one transfer, the reference's op log in the same order."""
    port_table = table_from_arrays(forest.columns)
    rb, pb = _backends(forest, port_table)
    a1, p1 = _atom_pair("elevation_0", "lt", 2800.0)
    a2, p2 = _atom_pair("slope_0", "gt", 12.0)
    a3, p3 = _atom_pair("aspect_0", "le", 180.0)
    r_sets, p_sets = [], []
    for be, x1, x2, x3, sets in ((rb, a1, a2, a3, r_sets),
                                 (pb, p1, p2, p3, p_sets)):
        s1 = be.apply_atom(x1, be.full())                    # scalar
        s2 = be.apply_atom_multi(x2, [s1, be.full(), s1])    # stacked [3]
        s3 = be.apply_atom(x3, s2[1])                        # scalar
        s4 = be.apply_atom_multi(x1, [s3, s2[0]])            # stacked [2]
        sets.extend([s1, *s2, s3, *s4])
    r_flats, p_flats = rb.materialize(r_sets), pb.materialize(p_sets)
    for r, p in zip(r_flats, p_flats):
        assert np.array_equal(p, r)
    assert pb.host_syncs == rb.host_syncs == 1
    log = pb.drain_op_log()
    assert log == rb.drain_op_log()
    assert len(log) == 1 + 3 + 1 + 2
    assert pb.device_dispatches == rb.device_dispatches
    assert pb.stats.records_evaluated == rb.stats.records_evaluated
    assert pb.blocks_touched == rb.blocks_touched


@pytest.mark.parametrize("appended", [1500, 30_000])
def test_refresh_and_extend_set_match_reference(appended):
    """An append inside the power-of-two block bucket (1500 rows) and one
    that crosses it (30,000 rows: the bucket of 32 blocks of 1024 grows to
    64): the same
    bytes upload, and cached sets spliced with the delta equal the
    reference's and a fresh evaluation."""
    base = R.make_forest_table(20_000, n_dup=1, seed=7)
    extra = R.make_forest_table(appended, n_dup=1, seed=9)
    ref_table = R.Table({k: v.copy() for k, v in base.columns.items()})
    port_table = table_from_arrays(base.columns)
    rb, pb = _backends(ref_table, port_table)
    atoms = [_atom_pair("elevation_0", "lt", 2800.0),
             _atom_pair("slope_0", "ge", 9.0)]
    r_cached = [rb.apply_atom(a, rb.full()) for a, _ in atoms]
    p_cached = [pb.apply_atom(p, pb.full()) for _, p in atoms]
    assert pb.uploaded_bytes == rb.uploaded_bytes
    old_n = ref_table.n_records
    rows = {k: extra.columns[k] for k in base.columns}
    ref_table.append(rows)
    port_table.append({k: v.copy() for k, v in rows.items()})
    assert pb.refresh() == rb.refresh()
    assert pb.uploaded_bytes == rb.uploaded_bytes
    assert pb.nblocks == rb.nblocks
    idx = np.arange(old_n, ref_table.n_records)
    r_ext = [rb.extend_set(s, old_n, ref_table.eval_atom(a, idx))
             for s, (a, _) in zip(r_cached, atoms)]
    p_ext = [pb.extend_set(s, old_n, port_table.eval_atom(p, idx))
             for s, (_, p) in zip(p_cached, atoms)]
    fresh = [pb.apply_atom(p, pb.full()) for _, p in atoms]
    assert pb.device_dispatches == rb.device_dispatches + len(atoms)
    got = pb.materialize(p_ext + fresh)
    want = rb.materialize(r_ext)
    for j in range(len(atoms)):
        assert np.array_equal(got[j], want[j])
        assert np.array_equal(got[j], got[len(atoms) + j])
    for s in p_ext:
        assert s.bits.shape == (pb.nblocks, pb.wpb)
        assert torch.equal(s.pops, tref.popcount_ref(s.bits))


def test_refresh_uploads_only_the_dirty_tail():
    base = R.make_forest_table(10_000, n_dup=1, seed=7)
    port_table = table_from_arrays(base.columns)
    pb = PortBackend(port_table, block=BLOCK, device="cpu")
    _, p = _atom_pair("elevation_0", "lt", 2800.0)
    pb.apply_atom(p, pb.full())
    pb.materialize([])
    extra = R.make_forest_table(700, n_dup=1, seed=9)
    dirty = port_table.n_records // BLOCK
    port_table.append({k: extra.columns[k].copy() for k in base.columns})
    up = pb.refresh()
    n_blocks = pb.nblocks
    assert up == (n_blocks - dirty) * BLOCK * 4       # one resident column
    col = pb._col_recmajor("elevation_0")
    want = np.zeros(n_blocks * BLOCK, dtype=np.float32)
    want[: port_table.n_records] = port_table.columns["elevation_0"]
    assert np.array_equal(col.reshape(-1).numpy(), want)
