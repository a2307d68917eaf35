"""The port's block-sharded tape engine on host shards, on the CPU.

``ShardedTapeBackend`` (``ExecConfig(engine="tape", shards=S,
device="cpu")``) splits the block axis over S host shards, each running
the kernels' plain versions over its block rows.  Sharding changes no
answer and no counter, so on the same numpy-seeded tables and trees every
result must equal the numpy oracle, and every counter and op log the
reference's *unsharded* ``DeviceTapeBackend`` (and, at S = 1, the
reference's own ``ShardedTapeBackend(shards=1)``): per query, per lockstep
batch and per stream drain, across appends inside and past the block
bucket, deletes and a UDF host fallback; with one host sync per query and
per batch, a small append re-uploading one shard, and no program made
again inside the bucket.  The sizes are the reference's own sharding tests'
(``tests/test_shard.py``, ``tests/test_telemetry.py``).
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

import repro.columnar as R
import repro.core as RC
import repro_torch.columnar as T
import repro_torch.core as TC
from repro_torch.columnar.executor import resolve_backend
from repro_torch.convert import table_from_arrays
from repro_torch.launch.mesh import ShardMesh, make_shard_mesh
from repro_torch.runtime.telemetry import MetricsRegistry

BLOCK = 4096
SHARDS = (1, 2, 8)
STATS = ("records_evaluated", "weighted_cost", "atom_applications", "setops")
COUNTERS = ("blocks_touched", "blocks_pruned", "records_touched",
            "host_syncs", "device_dispatches", "host_fallbacks")
#: BatchStats fields a sharded lockstep batch shares with an unsharded one
BATCH_FIELDS = ("host_syncs", "device_dispatches", "kernel_batches",
                "atom_cache_hits", "lockstep_rounds", "logical_atoms",
                "physical_atoms", "records_evaluated", "blocks_touched",
                "blocks_pruned")


def _tables(n=50_000, n_dup=2, strings=False):
    ref = R.make_forest_table(n, n_dup=n_dup, seed=7, strings=strings)
    return ref, table_from_arrays(ref.columns)


def _trees(ref_table, port_table, seeds=(1, 2, 4), n=6, depth=3):
    return ([R.random_tree(ref_table, n, depth, np.random.default_rng(s))
             for s in seeds],
            [T.random_tree(port_table, n, depth, np.random.default_rng(s))
             for s in seeds])


@pytest.fixture(scope="module")
def forest50k():
    return _tables()


def _oracle(tree, table, planner="deepfish"):
    return T.run_query(tree, table, config=T.ExecConfig(
        planner=planner, engine="numpy", device="cpu"))[0]


def _same_backends(r_be, p_be):
    for f in STATS:
        assert getattr(p_be.stats, f) == getattr(r_be.stats, f), f
    for f in COUNTERS:
        assert getattr(p_be, f) == getattr(r_be, f), f
    assert p_be.drain_op_log() == r_be.drain_op_log()


def _run_pair(rt, pt, ref_table, port_table, r_be, p_be, shards,
              planner="deepfish"):
    """One query through the reference's unsharded tape engine and the
    port's sharded one: results equal to each other and the oracle, one
    host sync on the port; returns the backends."""
    r_res, _, r_be = R.run_query(rt, ref_table, backend=r_be, config=R.
                                 ExecConfig(planner=planner, engine="tape",
                                            block=BLOCK))
    s0 = p_be.host_syncs if p_be is not None else 0
    p_res, _, p_be = T.run_query(pt, port_table, backend=p_be, config=T.
                                 ExecConfig(planner=planner, engine="tape",
                                            block=BLOCK, shards=shards,
                                            device="cpu"))
    assert isinstance(p_be, T.ShardedTapeBackend) or shards == 1
    np.testing.assert_array_equal(p_res, r_res)
    np.testing.assert_array_equal(p_res, _oracle(pt, port_table, planner))
    assert p_be.host_syncs - s0 == 1 + (p_be.host_fallbacks > 0)
    return r_be, p_be


def _near_2750(v):
    return np.abs(v - 2750.0) < 300.0


def _udf_tree(mod):
    """A tree with a UDF atom (the host fallback); both packages' trees
    share the function, which their atom keys name."""
    return mod.normalize(mod.And([
        mod.Atom("slope_0", "lt", 15.0, selectivity=0.6),
        mod.Or([mod.Atom("elevation_0", "udf", fn=_near_2750,
                         selectivity=0.5),
                mod.Atom("aspect_0", "gt", 300.0, selectivity=0.15)])]))


# -- per query: the oracle, the reference's unsharded engine ------------------

@pytest.mark.parametrize("shards", SHARDS)
@pytest.mark.parametrize("planner", ["shallowfish", "deepfish"])
def test_sharded_queries_match_oracle_and_unsharded_reference(
        forest50k, planner, shards):
    ref_table, port_table = forest50k
    p_be = T.ShardedTapeBackend(port_table, block=BLOCK, shards=shards,
                                device="cpu")
    assert p_be.shards == shards and p_be.nblocks == 16
    r_be = None
    for rt, pt in zip(*_trees(ref_table, port_table)):
        r_be, p_be = _run_pair(rt, pt, ref_table, port_table, r_be, p_be,
                               shards, planner)
        _same_backends(r_be, p_be)
    # one program per shard and tape, each shard's over its block rows
    assert p_be.tape_programs == len(p_be._programs) == 3 * shards
    assert {p.zrows.shape[1] if p.zrows is not None else 16 // shards
            for p in p_be._programs.values()} == {16 // shards}
    assert p_be.uploaded_bytes == r_be.uploaded_bytes


def test_single_shard_matches_reference_sharded_backend(forest50k):
    """S = 1 against the reference's in-process ShardedTapeBackend."""
    ref_table, port_table = forest50k
    r_be = R.ShardedTapeBackend(ref_table, block=BLOCK, shards=1)
    p_be = T.ShardedTapeBackend(port_table, block=BLOCK, shards=1,
                                device="cpu")
    for rt, pt in zip(*_trees(ref_table, port_table)):
        r_res, _, _ = R.run_query(rt, ref_table, backend=r_be, config=R.
                                  ExecConfig(planner="deepfish",
                                             engine="tape", block=BLOCK))
        p_res, _, _ = T.run_query(pt, port_table, backend=p_be, config=T.
                                  ExecConfig(planner="deepfish",
                                             engine="tape", block=BLOCK,
                                             device="cpu"))
        np.testing.assert_array_equal(p_res, r_res)
        _same_backends(r_be, p_be)
    assert r_be.shards == p_be.shards == 1
    assert p_be.host_syncs == r_be.host_syncs == 3


def test_udf_host_fallback_under_two_shards(forest50k):
    """A mixed tape: the UDF atom's gather joins the two shards in block
    order and its scatter splits them back."""
    ref_table, port_table = forest50k
    p_be = T.ShardedTapeBackend(port_table, block=BLOCK, shards=2,
                                device="cpu")
    r_be, p_be = _run_pair(_udf_tree(RC), _udf_tree(TC), ref_table,
                           port_table, None, p_be, 2)
    _same_backends(r_be, p_be)
    assert p_be.host_fallbacks == 1 and p_be.host_syncs == 2
    assert p_be.tape_programs == 0


# -- lockstep -----------------------------------------------------------------

@pytest.mark.parametrize("batch,shards", [("paper", 2), ("paper", 8),
                                          ("udf", 2)])
def test_lockstep_batches_one_sync_match_unsharded_reference(forest50k,
                                                             batch, shards):
    """Two lockstep batches (the second serves cached shared atoms through
    the stacked AND): bitmaps, BatchStats and per-op observations equal to
    the reference's unsharded session, one host sync per batch; a batch
    with a UDF atom gathers its union across the shards on the host."""
    ref_table, port_table = forest50k
    if batch == "paper":
        rq, pq = _trees(ref_table, port_table)
        rq, pq = rq * 2, pq * 2       # shared atoms: the stacked kernels
    else:
        rq = [_udf_tree(RC) for _ in range(3)]
        pq = [_udf_tree(TC) for _ in range(3)]
    cfg = dict(planner="deepfish", engine="tape", batched=True, block=BLOCK)
    rs = R.QuerySession(ref_table, config=R.ExecConfig(**cfg))
    ps = T.QuerySession(port_table, config=T.ExecConfig(
        shards=shards, device="cpu", **cfg))
    got = []
    for _ in range(2):
        a, b = rs.execute(rq), ps.execute(pq)
        got.append(b)
        for r, p, q in zip(a.bitmaps, b.bitmaps, pq):
            np.testing.assert_array_equal(p, r)
            np.testing.assert_array_equal(p, _oracle(q, port_table))
        for f in BATCH_FIELDS + ("host_fallbacks",):
            assert getattr(b.stats, f) == getattr(a.stats, f), f
        assert b.stats.op_observations == a.stats.op_observations
    be = b.backend
    assert isinstance(be, T.ShardedTapeBackend) and be.shards == shards
    if batch == "udf":                # the second batch hits the cache
        assert got[0].stats.host_fallbacks > 0
        return
    assert b.stats.host_syncs == 1
    assert b.stats.atom_cache_hits > 0 and b.stats.kernel_batches > 0
    # one grouped set-operation launch per level and shard
    assert be.setop_launches % shards == 0 and be.setop_launches > 0


# -- appends, deletes, the bucket ---------------------------------------------

def test_small_append_lands_on_one_shard_then_delete():
    """S = 8: a 900-row append inside the bucket re-uploads one shard's
    blocks and makes no program; a delete after it stays equal to the
    oracle and the unsharded reference."""
    ref_table, port_table = _tables()
    rq, pq = _trees(ref_table, port_table)
    p_be = T.ShardedTapeBackend(port_table, block=BLOCK, shards=8,
                                device="cpu")
    r_be = None
    for rt, pt in zip(rq, pq):
        r_be, p_be = _run_pair(rt, pt, ref_table, port_table, r_be, p_be, 8)
    programs, full = p_be.tape_programs, p_be.full()
    rows = {k: np.asarray(v)[:900] for k, v in ref_table.columns.items()}
    ref_table.append(rows)
    port_table.append({k: v.copy() for k, v in rows.items()})
    r_up = r_be.refresh()
    u0, m0 = p_be.uploaded_bytes, p_be.transferred_bytes
    up = p_be.refresh()
    assert p_be.delta_upload_shards == 1
    n_cols = len([c for c in p_be._cols.values() if c is not False])
    # the count is the reference's: blocks 12-15, to the end of the bucket
    assert up == r_up == p_be.uploaded_bytes - u0 == n_cols * 4 * BLOCK * 4
    assert p_be.uploaded_bytes == r_be.uploaded_bytes
    # what moved is the real dirty tail only: block 12 of 13, per column
    assert p_be.transferred_bytes - m0 == n_cols * BLOCK * 4
    for rt, pt in zip(rq, pq):
        r_be, p_be = _run_pair(rt, pt, ref_table, port_table, r_be, p_be, 8)
    ref_table.delete(np.arange(0, 5000, 7))
    port_table.delete(np.arange(0, 5000, 7))
    for rt, pt in zip(rq, pq):
        r_be, p_be = _run_pair(rt, pt, ref_table, port_table, r_be, p_be, 8)
    _same_backends(r_be, p_be)
    assert p_be.tape_programs == programs and p_be.full() is full


def test_append_past_the_bucket_repartitions():
    """An append that grows the bucket from 16 to 32 blocks changes the
    partition: the prefix moves shard to shard, the programs are made
    again, and the results and counters stay the reference's."""
    ref_table, port_table = _tables()
    rq, pq = _trees(ref_table, port_table)
    p_be = T.ShardedTapeBackend(port_table, block=BLOCK, shards=2,
                                device="cpu")
    r_be = None
    for rt, pt in zip(rq, pq):
        r_be, p_be = _run_pair(rt, pt, ref_table, port_table, r_be, p_be, 2)
    old = dict(p_be._programs)
    extra = R.make_forest_table(20_000, n_dup=2, seed=8)
    rows = {k: extra.columns[k] for k in ref_table.columns}
    ref_table.append(rows)
    port_table.append({k: v.copy() for k, v in rows.items()})
    r_be.refresh()
    p_be.refresh()
    assert p_be.nblocks == r_be.nblocks == 32
    # the tail, blocks 12-17 of 32: 12-15 on shard 0, 16-17 on shard 1
    assert p_be.delta_upload_shards == 2
    for rt, pt in zip(rq, pq):
        r_be, p_be = _run_pair(rt, pt, ref_table, port_table, r_be, p_be, 2)
    _same_backends(r_be, p_be)
    assert not set(old) & set(p_be._programs)
    assert all(c[0].shape == (16, BLOCK) for c in p_be._cols.values()
               if c is not False)


def test_stream_with_appends_and_deletes_matches_unsharded_reference():
    """A StreamSession at S = 2 against the reference's unsharded stream:
    drains between a delete, appends inside and past the block bucket
    (cached atoms spliced, then repartitioned) and a compact."""
    ref_table, port_table = _tables(6000, n_dup=1, strings=True)
    extra = R.make_forest_table(6000, n_dup=1, seed=9, strings=True)
    cfg = dict(block=1024)
    rs = R.StreamSession(ref_table, config=R.StreamSession.DEFAULT_CONFIG
                         .replace(**cfg))
    ps = T.StreamSession(port_table, config=T.StreamSession.DEFAULT_CONFIG
                         .replace(shards=2, device="cpu", **cfg))
    rt = R.random_query_suite(ref_table, 4, 8, 3, seed=4)
    pt = T.random_query_suite(port_table, 4, 8, 3, seed=4)
    pick = np.random.default_rng(4).integers(0, 4, size=10)
    rq, pq = [rt[i] for i in pick], [pt[i] for i in pick]
    steps = [lambda s: s.delete(np.arange(100, 1600)),
             lambda s: s.append({k: v[:1500].copy()
                                 for k, v in extra.columns.items()}),
             lambda s: s.append({k: v[1500:].copy()
                                 for k, v in extra.columns.items()}),
             lambda s: s.delete(np.arange(5200, 5900)),
             lambda s: s.compact()]
    seen = []
    for step in [None] + steps:
        if step is not None:
            assert step(ps) == step(rs)
        rf, pf = [rs.submit(q) for q in rq], [ps.submit(q) for q in pq]
        a, b = rs.drain(), ps.drain()
        for x, y in zip(rf, pf):
            np.testing.assert_array_equal(y.result(), x.result())
        assert b.stats.host_syncs == a.stats.host_syncs == 1
        assert b.stats.op_observations == a.stats.op_observations
        for f in ("records_evaluated", "device_dispatches", "blocks_touched",
                  "atoms_delta_extended"):
            assert getattr(b.stats, f) == getattr(a.stats, f), f
        assert isinstance(b.backend, T.ShardedTapeBackend)
        seen.append((b.backend.nblocks, b.backend.delta_upload_shards))
    # 6 blocks in a bucket of 8; the first append lands on shard 1 inside
    # it, the second grows it to 16 and lands on both shards; the compact
    # rewrites the table and the session builds a new backend
    assert seen == [(8, 0), (8, 0), (8, 1), (16, 3), (16, 3), (16, 0)]
    assert ps.stats.degraded_batches == rs.stats.degraded_batches == 0
    assert ps.stats.atoms_delta_extended == rs.stats.atoms_delta_extended > 0


def test_stream_upload_bytes_match_unsharded_reference():
    """A StreamSession at S = 2 counts ``upload_bytes`` as the reference's
    unsharded stream does (each resident column from the dirty block to the
    end of the bucket), across an append inside the bucket and one past
    it, while ``transferred_bytes`` counts the real dirty tail that moved
    (12,500 rows, block 1,024: 13 blocks in a bucket of 16)."""
    ref_table, port_table = _tables(12_500, n_dup=1)
    extra = R.make_forest_table(6000, n_dup=1, seed=9)
    cfg = dict(block=1024)
    rs = R.StreamSession(ref_table, config=R.StreamSession.DEFAULT_CONFIG
                         .replace(**cfg))
    ps = T.StreamSession(port_table, config=T.StreamSession.DEFAULT_CONFIG
                         .replace(shards=2, device="cpu", **cfg))
    rq = R.random_query_suite(ref_table, 4, 8, 3, seed=4)
    pq = T.random_query_suite(port_table, 4, 8, 3, seed=4)
    seen = []
    for lo, hi in [(0, 0), (0, 900), (900, 6000)]:
        if hi:
            rows = {k: v[lo:hi] for k, v in extra.columns.items()}
            rs.append({k: v.copy() for k, v in rows.items()})
            ps.append({k: v.copy() for k, v in rows.items()})
        rf, pf = [rs.submit(q) for q in rq], [ps.submit(q) for q in pq]
        a, b = rs.drain(), ps.drain()
        for x, y in zip(rf, pf):
            np.testing.assert_array_equal(y.result(), x.result())
        be = b.backend
        assert isinstance(be, T.ShardedTapeBackend)
        assert b.stats.upload_bytes == a.stats.upload_bytes
        assert be.uploaded_bytes == a.backend.uploaded_bytes
        seen.append((be.nblocks, be.transferred_bytes))
    n_cols = len([c for c in be._cols.values() if c is not False])
    per_block = n_cols * 1024 * 4
    first = seen[0][1]
    assert first == n_cols * 16 * 1024 * 4   # the first upload: the bucket
    # inside the bucket blocks 12-13 of 16 move, on shard 1; past it
    # blocks 13-18 (the real tail, not the 19 to the end of a bucket of 32)
    assert seen[1] == (16, first + 2 * per_block)
    assert seen[2] == (32, first + 2 * per_block + 6 * per_block)


# -- construction -------------------------------------------------------------

def test_config_routes_to_sharded_backend(forest50k):
    _, port_table = forest50k
    tree = T.random_tree(port_table, 6, 3, np.random.default_rng(1))
    cfg = T.ExecConfig(engine="tape", shards=2, device="cpu", block=BLOCK)
    res, _, be = T.run_query(tree, port_table, config=cfg)
    assert type(be) is T.ShardedTapeBackend and be.shards == 2
    assert be.mesh.devices == (torch.device("cpu"),) * 2
    np.testing.assert_array_equal(res, _oracle(tree, port_table,
                                               "shallowfish"))
    assert resolve_backend(port_table, cfg, reuse=be) is be
    with pytest.raises(T.ConfigError, match="ShardedTapeBackend"):
        resolve_backend(port_table, cfg, reuse=T.DeviceTapeBackend(
            port_table, block=BLOCK, device="cpu"))
    mesh = make_shard_mesh(4, device="cpu")
    be4 = resolve_backend(port_table, T.ExecConfig(
        engine="tape", mesh=mesh, device="cpu"))
    assert be4.shards == 4 and be4.mesh is mesh


class _ForeignMesh:
    """A mesh without a "shards" axis."""

    axis_names = ("data",)
    devices = (torch.device("cpu"),) * 2
    size = 2


#: each way to ask for sharding that the reference refuses too
BAD_SHARDING = {
    "not_pow2_config": lambda t: T.ExecConfig(engine="tape", shards=3,
                                              device="cpu"),
    "not_pow2_mesh": lambda t: T.ShardedTapeBackend(
        t, mesh=ShardMesh(["cpu"] * 3)),
    "mesh_size": lambda t: T.ShardedTapeBackend(
        t, shards=4, mesh=make_shard_mesh(2, device="cpu")),
    "no_shards_axis": lambda t: T.ShardedTapeBackend(t, mesh=_ForeignMesh()),
    "too_few_cards": lambda t: make_shard_mesh(
        max(2, torch.cuda.device_count() + 1), device="cuda"),
    "tape_pallas": lambda t: T.ExecConfig(engine="tape-pallas", shards=2,
                                          device="cpu"),
    "jax": lambda t: T.ExecConfig(engine="jax", shards=2, device="cpu"),
    # host shards under a config that asks for the card
    "mesh_device": lambda t: resolve_backend(t, T.ExecConfig(
        engine="tape", mesh=make_shard_mesh(2, device="cpu"))),
}


@pytest.mark.parametrize("case", sorted(BAD_SHARDING))
def test_sharding_config_errors(forest50k, case):
    with pytest.raises(T.ConfigError):
        BAD_SHARDING[case](forest50k[1])


def test_explicit_mesh_may_repeat_a_device(forest50k):
    _, port_table = forest50k
    mesh = ShardMesh(["cpu", "cpu"])
    be = T.ShardedTapeBackend(port_table, block=BLOCK, mesh=mesh)
    assert be.shards == 2 and be.devices == [torch.device("cpu")] * 2
    assert mesh.size == 2 and mesh.axis_names == ("shards",)


# -- telemetry and explain (the reference's tests/test_telemetry.py) ----------

def test_sharded_telemetry_and_explain():
    _, t = _tables(20_000, n_dup=1, strings=True)
    trees = [T.random_tree(t, 4, 2, np.random.default_rng(s))
             for s in (1, 2)]
    reg, tr = MetricsRegistry(), T.Tracer()
    cfg = T.ExecConfig(planner="deepfish", engine="tape", batched=True,
                       shards=2, device="cpu")
    on = T.QuerySession(t, config=cfg.replace(telemetry=reg, trace=tr))
    off = T.QuerySession(t, config=cfg.replace(telemetry=False, trace=False))
    r_on, r_off = on.execute(trees), off.execute(trees)
    for a, b, q in zip(r_on.bitmaps, r_off.bitmaps, trees):
        np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(a, _oracle(q, t))
    assert [r_on.stats.host_syncs, r_off.stats.host_syncs] == [1, 1]
    t.append({name: col[:1024] for name, col in t.columns.items()})
    r2 = on.execute(trees)
    assert r2.stats.host_syncs == 1 and r2.backend is r_on.backend
    assert "batch.sync" in {s.name for s in tr.drain()}
    med = float(np.median(t.columns["elevation_0"]))
    q = (TC.Atom("cover_0", "eq", "pine")
         | TC.Atom("elevation_0", "lt", med)) & TC.Atom("slope_0", "ge", 0.0)
    rep = T.explain_analyze(q, t, config=T.ExecConfig(
        planner="deepfish", engine="tape", shards=2, device="cpu"))
    assert rep.shards == 2 and rep.counters["host_syncs"] == 1
    assert rep.max_qerror >= 1.0
    text = rep.render()
    assert "EXPLAIN ANALYZE" in text and "shards=2" in text
