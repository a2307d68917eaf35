"""The port's per-step block engine against the reference's, on the CPU.

``BlockBackend`` (``engine="jax"`` / ``"pallas"``, one path in the port)
on ``device="cpu"`` runs the kernels' plain versions; the reference's
``JaxBlockBackend`` runs its jnp reference (``"jax"``) or its Pallas
kernels in interpret mode (``"pallas"``).  On the same numpy-seeded
tables (carried across with ``convert.table_from_arrays``) and trees the
two must agree exactly: bitmaps (``np.array_equal``), ``Stats``, every
block counter (``blocks_touched``, ``records_touched``, ``blocks_pruned``,
``kernel_invocations``, ``host_syncs``, ``uploaded_bytes``) and the op
log, through ``run_query``, ``apply_atom_multi``, zone pruning, the host
fallback, ``refresh`` after an append, tombstone deletes, the
``QuerySession`` and the ``StreamSession``.  The engine on the card is
held against the CPU in ``tests/test_torch_cuda.py``, which imports
neither JAX nor the reference package.
"""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import repro.columnar as R
import repro.core as RC
import repro_torch.columnar as T
import repro_torch.columnar.executor as port_executor
import repro_torch.core as TC
from repro.columnar.executor import JaxBlockBackend
from repro_torch.columnar.executor import BlockBackend
from repro_torch.convert import table_from_arrays
from repro_torch.kernels import ops as tops
from repro_torch.kernels import ref as tref

BLOCK = 1024
ENGINES = ("jax", "pallas")
PLANNERS = ("deepfish", "shallowfish", "nooropt")
COUNTERS = ("blocks_touched", "records_touched", "blocks_pruned",
            "kernel_invocations", "host_syncs", "uploaded_bytes")
#: BatchStats fields a session of each package must agree on
BATCH_FIELDS = ("host_syncs", "device_dispatches", "kernel_batches",
                "atom_cache_hits", "lockstep_rounds", "logical_atoms",
                "physical_atoms", "records_evaluated", "blocks_touched",
                "blocks_pruned", "host_fallbacks", "upload_bytes")


def _tables(n=6000, strings=False, seed=7):
    ref = R.make_forest_table(n, n_dup=1, seed=seed, strings=strings)
    return ref, table_from_arrays(ref.columns)


def _same_backend(rb, pb):
    for k in COUNTERS:
        assert getattr(pb, k) == getattr(rb, k), k
    assert dataclasses.asdict(pb.stats) == dataclasses.asdict(rb.stats)
    assert pb.drain_op_log() == rb.drain_op_log()


def _backends(ref_table, port_table, engine="jax", **kw):
    kw.setdefault("block", BLOCK)
    return (JaxBlockBackend(ref_table, engine=engine, **kw),
            BlockBackend(port_table, engine=engine, device="cpu", **kw))


def _run_both(ref_table, port_table, ref_trees, port_trees, engine,
              **cfg):
    """Each tree through ``run_query`` on one reused backend per package;
    every bitmap equal, then the backends' counters and op logs."""
    cfg = dict(dict(planner="deepfish", block=BLOCK), **cfg)
    rb = pb = None
    for rt, pt in zip(ref_trees, port_trees):
        r, _, rb = R.run_query(rt, ref_table, backend=rb,
                               config=R.ExecConfig(engine=engine, **cfg))
        p, _, pb = T.run_query(pt, port_table, backend=pb,
                               config=T.ExecConfig(engine=engine,
                                                   device="cpu", **cfg))
        assert np.array_equal(p, r)
    assert isinstance(pb, BlockBackend) and pb.engine == engine
    _same_backend(rb, pb)
    return rb, pb


@pytest.fixture
def steps(monkeypatch):
    """Counts of the engine's calls into the kernel entry points.  Every
    call must pass the popcounts it holds (the plain popcount never runs
    on the card path) and, for the live-block scan, the union twice."""
    counts = {"bitmap_op": 0, "predicate_blocks": 0,
              "predicate_blocks_multi": 0}

    def spy(name):
        fn = getattr(tops, name)

        def call(*args, **kw):
            counts[name] += 1
            if name == "bitmap_op":
                a, b, opcode, a_pops, b_pops = args
                assert a is b and opcode == 0
                assert a_pops is not None and b_pops is not None
                assert bool((a_pops == 1).all())
            else:
                assert kw.get("pops") is not None
                bits = args[1]
                assert kw["pops"].shape == bits.shape[:-1]
                assert torch.equal(kw["pops"], tref.popcount_ref(bits))
                assert bits.shape[-2] & (bits.shape[-2] - 1) == 0  # pow2
            return fn(*args, **kw)
        return call

    for name in counts:
        monkeypatch.setattr(port_executor.kops, name, spy(name))
    return counts


# -- run_query ----------------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("planner", PLANNERS)
def test_run_query_matches_reference(forest, planner, engine, steps):
    port_table = table_from_arrays(forest.columns)
    n = 3 if engine == "jax" else 2
    rb, pb = _run_both(forest, port_table,
                       R.random_query_suite(forest, n, 8, 3, seed=2),
                       T.random_query_suite(port_table, n, 8, 3, seed=2),
                       engine, planner=planner)
    assert pb.kernel_invocations > 0
    # the per-step identity: one live-block scan per numeric application
    # (its fetch a sync), one K1 / K5 per application with a live block
    assert steps["predicate_blocks"] + steps["predicate_blocks_multi"] \
        == pb.kernel_invocations
    assert steps["bitmap_op"] == pb.host_syncs - pb.kernel_invocations
    assert pb.staged_bytes > 0 and pb.fetched_bytes > 0


def test_block_engine_matches_the_oracle(forest):
    port_table = table_from_arrays(forest.columns)
    trees = T.random_query_suite(port_table, 3, 10, 3, seed=5)
    for tree in trees:
        got, _, be = T.run_query(tree, port_table, config=T.ExecConfig(
            engine="jax", device="cpu", planner="deepfish"))
        want, _, ob = T.run_query(tree, port_table, config=T.ExecConfig(
            engine="numpy", device="cpu", planner="deepfish"))
        assert np.array_equal(got, want)
        assert be.stats.records_evaluated == ob.stats.records_evaluated
        assert be.nblocks == -(-port_table.n_records // be.block)


# -- apply_atom_multi ---------------------------------------------------------

@pytest.mark.parametrize("engine", ENGINES)
@pytest.mark.parametrize("q", [1, 2, 5])
def test_apply_atom_multi_matches_reference(forest, q, engine, steps):
    port_table = table_from_arrays(forest.columns)
    rb, pb = _backends(forest, port_table, engine=engine)
    rng = np.random.default_rng(q)
    fracs = (0.02, 0.5, 1.0, 0.3, 0.0)[:q]
    ds = [R.pack_bits(rng.random(forest.n_records) < f) for f in fracs]
    if q > 2:
        ds[2][: 3 * BLOCK // 32] = 0        # dead blocks in one set
    value = forest.value_at_selectivity("slope_0", 0.4)
    got = pb.apply_atom_multi(TC.Atom("slope_0", "lt", value), ds)
    want = rb.apply_atom_multi(RC.Atom("slope_0", "lt", value), ds)
    for g, w in zip(got, want):
        assert np.array_equal(g, w)
    _same_backend(rb, pb)
    assert pb.kernel_invocations == 1 and pb.host_syncs == 2
    assert steps["predicate_blocks_multi" if q > 1
                 else "predicate_blocks"] == 1
    singles = [pb.apply_atom(TC.Atom("slope_0", "lt", value), d)
               for d in ds]
    for s, g in zip(singles, got):
        assert np.array_equal(s, g)


def test_an_empty_set_scans_and_launches_no_predicate(forest, steps):
    port_table = table_from_arrays(forest.columns)
    rb, pb = _backends(forest, port_table)
    atom = ("elevation_0", "lt", 2800.0)
    got = pb.apply_atom(TC.Atom(*atom), pb.empty())
    want = rb.apply_atom(RC.Atom(*atom), rb.empty())
    assert np.array_equal(got, want) and not got.any()
    _same_backend(rb, pb)
    assert pb.host_syncs == 1 and pb.kernel_invocations == 0
    assert steps == {"bitmap_op": 1, "predicate_blocks": 0,
                     "predicate_blocks_multi": 0}


# -- zone pruning -------------------------------------------------------------

def _zone_tables(n=24_000, block=2048, seed=0):
    rng = np.random.default_rng(seed)
    cols = {"ts": np.sort(rng.uniform(0, 100, n)).astype(np.float32),
            "shard": (np.arange(n) // block).astype(np.float32),
            "x": rng.normal(size=n).astype(np.float32),
            "y": rng.normal(size=n).astype(np.float32)}
    return R.Table({k: v.copy() for k, v in cols.items()}), \
        table_from_arrays(cols)


def _zone_trees(mod):
    A = mod.Atom
    return [mod.normalize(t) for t in (
        # ts < 30 decides most blocks ALL or NONE; x / y stay MAYBE
        mod.And([A("ts", "lt", 30.0, selectivity=0.3),
                 A("x", "lt", 0.0, selectivity=0.5)]),
        mod.And([A("shard", "eq", 2.0, selectivity=0.1),
                 A("y", "lt", 0.5, selectivity=0.7)]),
        mod.Or([mod.And([A("ts", "ge", 90.0, selectivity=0.1),
                         A("x", "gt", 0.3, selectivity=0.4)]),
                mod.And([A("shard", "le", 1.0, selectivity=0.2),
                         A("y", "gt", -0.5, selectivity=0.7)])]),
    )]


@pytest.mark.parametrize("zone_prune", [True, False])
@pytest.mark.parametrize("engine", ENGINES)
def test_zone_sorted_table_prunes_like_reference(zone_prune, engine):
    ref_table, port_table = _zone_tables()
    rb, pb = _run_both(ref_table, port_table, _zone_trees(RC),
                       _zone_trees(TC), engine, block=2048,
                       zone_prune=zone_prune)
    if zone_prune:
        assert pb.blocks_pruned > 0
    else:
        assert pb.blocks_pruned == 0


def test_zone_all_blocks_pass_their_bits_through():
    """``ts < 50`` on a sorted column: the blocks below the cut are ALL
    (their input bits pass through, no kernel row), the blocks above NONE;
    only the boundary block runs K1."""
    ref_table, port_table = _zone_tables()
    rb, pb = _backends(ref_table, port_table, block=2048)
    d = R.pack_bits(np.random.default_rng(1).random(ref_table.n_records)
                    < 0.5)
    got = pb.apply_atom(TC.Atom("ts", "lt", 50.0), d)
    want = rb.apply_atom(RC.Atom("ts", "lt", 50.0), d)
    assert np.array_equal(got, want)
    _same_backend(rb, pb)
    assert pb.blocks_touched == 1
    assert pb.blocks_pruned == pb.nblocks - 1
    mask = R.unpack_bits(d, ref_table.n_records)
    ts = ref_table.columns["ts"]
    assert np.array_equal(R.unpack_bits(got, ref_table.n_records),
                          mask & (ts < 50.0))


# -- the host fallback ----------------------------------------------------------

@pytest.mark.parametrize("rewrite", [True, False])
def test_string_atoms_match_reference(string_forest, rewrite):
    """String trees (equality / IN / LIKE / ranges): rewritten atoms run
    the kernels over their code columns, the rest (and every string atom
    without the rewrite) take the host gather."""
    port_table = table_from_arrays(string_forest.columns)
    _run_both(string_forest, port_table,
              R.random_query_suite(string_forest, 3, 8, 3, seed=4),
              T.random_query_suite(port_table, 3, 8, 3, seed=4), "jax",
              rewrite_strings=rewrite)


@pytest.mark.parametrize("engine", ENGINES)
def test_like_udf_and_in_atoms_take_the_host_gather(string_forest, engine,
                                                    steps):
    port_table = table_from_arrays(string_forest.columns)
    fn = lambda v: np.abs(v - 2750.0) < 300.0  # noqa: E731

    def tree(mod):
        A = mod.Atom
        return mod.normalize(mod.Or([
            mod.And([A("cover_0", "like", "%e%", selectivity=0.5),
                     A("slope_0", "lt", 15.0, selectivity=0.6)]),
            mod.And([A("elevation_0", "udf", None, fn=fn, selectivity=0.4),
                     A("aspect_0", "gt", 200.0, selectivity=0.4)]),
            mod.And([A("cover_0", "in", ("aspen", "pine", "willow"),
                       selectivity=0.3),
                     A("district_0", "in", ("district_01", "district_07"),
                       selectivity=0.1)])]))
    rb, pb = _run_both(string_forest, port_table, [tree(RC)], [tree(TC)],
                       engine, rewrite_strings=False)
    # one live-block scan per kernel-path application: the rest gathered
    assert pb.stats.atom_applications > steps["bitmap_op"] > 0
    assert steps["bitmap_op"] == pb.host_syncs - pb.kernel_invocations


def test_zone_pruned_in_fallback_keeps_exact_verdicts():
    """The host gather evaluates in float64, so its zone verdicts must
    too: 16777217 rounds to 16777216 in f32 (the reference's regression
    case)."""
    n = 2048
    col = np.full(n, 16777216, dtype=np.int64)
    col[1024:] = 16777217
    cols = {"c": col, "x": np.arange(n, dtype=np.float32)}
    ref_table = R.Table({k: v.copy() for k, v in cols.items()})
    port_table = table_from_arrays(cols)

    def tree(mod):
        return mod.normalize(mod.And([mod.Atom("c", "in", (16777216,)),
                                      mod.Atom("x", "ge", 0.0,
                                               selectivity=0.9)]))
    _run_both(ref_table, port_table, [tree(RC)], [tree(TC)], "jax")
    want, _, _ = T.run_query(tree(TC), port_table, config=T.ExecConfig(
        engine="numpy", device="cpu", planner="deepfish"))
    got, _, _ = T.run_query(tree(TC), port_table, config=T.ExecConfig(
        engine="jax", device="cpu", planner="deepfish", block=1024))
    assert np.array_equal(got, want)


# -- appends and deletes -------------------------------------------------------

@pytest.mark.parametrize("appended", [700, 5000])
def test_refresh_after_append_matches_reference(appended):
    """An append inside the boundary block and one that adds blocks: the
    same dirty-tail bytes upload, and later applications agree."""
    ref_table, port_table = _tables(10_000)
    extra = R.make_forest_table(appended, n_dup=1, seed=9)
    rb, pb = _backends(ref_table, port_table)
    atoms = [("elevation_0", "lt", 2800.0), ("slope_0", "ge", 9.0)]
    for a in atoms:
        assert np.array_equal(pb.apply_atom(TC.Atom(*a), pb.full()),
                              rb.apply_atom(RC.Atom(*a), rb.full()))
    dirty = ref_table.n_records // BLOCK
    rows = {k: extra.columns[k] for k in ref_table.columns}
    ref_table.append(rows)
    port_table.append({k: v.copy() for k, v in rows.items()})
    up = pb.refresh()
    assert up == rb.refresh()
    assert up == len(atoms) * (pb.nblocks - dirty) * BLOCK * 4
    assert pb.nblocks == rb.nblocks == -(-ref_table.n_records // BLOCK)
    assert pb.refresh() == 0
    for name in ("elevation_0", "slope_0"):
        want = np.zeros(pb.nblocks * BLOCK, dtype=np.float32)
        want[: port_table.n_records] = port_table.columns[name]
        assert np.array_equal(pb._cols[name].reshape(-1).numpy(), want)
    for a in atoms + [("aspect_0", "le", 180.0)]:
        assert np.array_equal(pb.apply_atom(TC.Atom(*a), pb.full()),
                              rb.apply_atom(RC.Atom(*a), rb.full()))
    _same_backend(rb, pb)


@pytest.mark.parametrize("engine", ENGINES)
def test_tombstone_deletes_match_reference(engine):
    ref_table, port_table = _tables(4000)
    dead = np.random.default_rng(3).random(ref_table.n_records) < 0.3
    ref_table.delete(dead)
    port_table.delete(dead)
    n = 3 if engine == "jax" else 1
    rng_r, rng_p = np.random.default_rng(1), np.random.default_rng(1)
    rt = [R.random_tree(ref_table, 6, 3, rng_r) for _ in range(n)]
    pt = [T.random_tree(port_table, 6, 3, rng_p) for _ in range(n)]
    _run_both(ref_table, port_table, rt, pt, engine)
    for tree in pt:
        res, _, _ = T.run_query(tree, port_table, config=T.ExecConfig(
            engine=engine, device="cpu", planner="deepfish", block=BLOCK))
        assert not R.unpack_bits(res, port_table.n_records)[dead].any()


def test_interleaved_append_delete_matches_reference():
    ref_table, port_table = _tables(3000, seed=5)
    extra = R.make_forest_table(3000, n_dup=1, seed=9)
    for t in (ref_table, port_table):
        t.delete(np.arange(0, 1000))
        t.append({k: extra.columns[k][:1500].copy() for k in t.columns})
        t.delete(np.arange(3200, 3400))
    rt = [R.random_tree(ref_table, 6, 3, np.random.default_rng(2))]
    pt = [T.random_tree(port_table, 6, 3, np.random.default_rng(2))]
    _run_both(ref_table, port_table, rt, pt, "jax")


# -- sessions ------------------------------------------------------------------

def _same_batch(a, b):
    assert len(b.bitmaps) == len(a.bitmaps)
    for r, p in zip(a.bitmaps, b.bitmaps):
        assert np.array_equal(p, r)
    for f in BATCH_FIELDS:
        assert getattr(b.stats, f) == getattr(a.stats, f), f
    assert b.stats.op_observations == a.stats.op_observations


@pytest.mark.parametrize("batched", [True, False, "auto"])
def test_query_session_matches_reference(forest, batched, steps):
    port_table = table_from_arrays(forest.columns)
    rt = R.random_query_suite(forest, 4, 8, 3, seed=0)
    pt = T.random_query_suite(port_table, 4, 8, 3, seed=0)
    pick = np.random.default_rng(1).integers(0, 4, size=10)
    cfg = dict(planner="deepfish", engine="jax", batched=batched,
               block=BLOCK)
    rs = R.QuerySession(forest, config=R.ExecConfig(**cfg))
    ps = T.QuerySession(port_table, config=T.ExecConfig(device="cpu", **cfg))
    for _ in range(2):
        a = rs.execute([rt[i] for i in pick])
        b = ps.execute([pt[i] for i in pick])
        _same_batch(a, b)
        assert isinstance(b.backend, BlockBackend)
    _same_backend(a.backend, b.backend)
    if batched is not False:        # "auto" runs lockstep on jax / pallas
        assert b.stats.lockstep_rounds > 0 and b.stats.kernel_batches > 0
        assert steps["predicate_blocks_multi"] > 0
    else:
        assert b.stats.lockstep_rounds == 0


def test_lockstep_session_matches_host_lockstep_and_oracle(forest):
    port_table = table_from_arrays(forest.columns)
    trees = T.random_query_suite(port_table, 3, 8, 3, seed=4) * 3
    cfg = dict(planner="deepfish", batched=True, block=BLOCK, device="cpu")
    blk = T.QuerySession(port_table, config=T.ExecConfig(engine="jax",
                                                         **cfg))
    host = T.QuerySession(port_table, config=T.ExecConfig(engine="numpy",
                                                          **cfg))
    a, b = blk.execute(trees), host.execute(trees)
    assert a.stats.records_evaluated == b.stats.records_evaluated
    for tree, got, want in zip(trees, a.bitmaps, b.bitmaps):
        assert np.array_equal(got, want)


def test_session_append_refreshes_the_backend_in_place(forest):
    ref_table, port_table = _tables(8000)
    extra = R.make_forest_table(900, n_dup=1, seed=9)
    rt = R.random_query_suite(ref_table, 3, 8, 3, seed=6)
    pt = T.random_query_suite(port_table, 3, 8, 3, seed=6)
    cfg = dict(planner="deepfish", engine="jax", batched=True, block=BLOCK)
    rs = R.QuerySession(ref_table, config=R.ExecConfig(**cfg))
    ps = T.QuerySession(port_table, config=T.ExecConfig(device="cpu", **cfg))
    _same_batch(rs.execute(rt), ps.execute(pt))
    be = ps._backend
    rows = {k: extra.columns[k] for k in ref_table.columns}
    ref_table.append(rows)
    port_table.append({k: v.copy() for k, v in rows.items()})
    a, b = rs.execute(rt), ps.execute(pt)
    _same_batch(a, b)
    assert ps._backend is be and b.stats.upload_bytes > 0
    assert b.stats.atoms_delta_extended == a.stats.atoms_delta_extended


def test_stream_session_with_appends_matches_reference():
    ref_table, port_table = _tables(8000, strings=True)
    rcfg = R.StreamSession.DEFAULT_CONFIG.replace(engine="jax", block=BLOCK)
    rs = R.StreamSession(ref_table, config=rcfg)
    ps = T.StreamSession(port_table, config=T.StreamSession.DEFAULT_CONFIG
                         .replace(engine="jax", block=BLOCK, device="cpu"))
    rt = R.random_query_suite(ref_table, 3, 6, 3, seed=1)
    pt = T.random_query_suite(port_table, 3, 6, 3, seed=1)
    pick = np.random.default_rng(2).integers(0, 3, size=8)
    be = None
    for rnd in range(3):
        if rnd:
            extra = R.make_forest_table(500 * rnd, n_dup=1, seed=10 + rnd,
                                        strings=True)
            rows = {k: extra.columns[k] for k in ref_table.columns}
            rs.append(rows)
            ps.append({k: v.copy() for k, v in rows.items()})
        rf = [rs.submit(rt[i]) for i in pick]
        pf = [ps.submit(pt[i]) for i in pick]
        a, b = rs.drain(), ps.drain()
        for x, y in zip(rf, pf):
            assert np.array_equal(y.result(), x.result())
        _same_batch(a, b)
        if rnd:
            assert b.backend is be                  # refreshed in place
            assert b.stats.atoms_delta_extended > 0
        be = b.backend
    r, p = rs.stats.as_dict(), ps.stats.as_dict()
    for f in ("batches", "appends", "appended_rows", "atoms_delta_extended",
              "delta_rows_evaluated", "delta_rows_reused", "upload_bytes",
              "degraded_batches", "retries"):
        assert p[f] == r[f], f
    assert isinstance(be, BlockBackend) and ps.stats.degraded_batches == 0
    rs.close()
    ps.close()


# -- resolve_backend ---------------------------------------------------------

def test_resolve_backend_reuse_errors_match_reference(forest):
    port_table = table_from_arrays(forest.columns)
    other = table_from_arrays(forest.columns)
    tree = T.random_query_suite(port_table, 1, 4, 2, seed=1)[0]
    cfg = dict(planner="deepfish", block=BLOCK, device="cpu")
    _, _, jb = T.run_query(tree, port_table,
                           config=T.ExecConfig(engine="jax", **cfg))
    _, _, tb = T.run_query(tree, port_table,
                           config=T.ExecConfig(engine="tape", **cfg))
    assert isinstance(jb, BlockBackend) and jb.engine == "jax"
    assert T.resolve_backend(port_table, T.ExecConfig(engine="jax", **cfg),
                             reuse=jb) is jb
    for eng, reuse, what in (("pallas", jb, "matching BlockBackend"),
                             ("jax", tb, "matching BlockBackend"),
                             ("tape", jb, "DeviceTapeBackend")):
        with pytest.raises(T.ConfigError, match=what):
            T.resolve_backend(port_table, T.ExecConfig(engine=eng, **cfg),
                              reuse=reuse)
    with pytest.raises(T.ConfigError, match="different table"):
        T.resolve_backend(other, T.ExecConfig(engine="jax", **cfg), reuse=jb)
    # the reference refuses the same reuse
    ref_tree = R.random_query_suite(forest, 1, 4, 2, seed=1)[0]
    _, _, rjb = R.run_query(ref_tree, forest, config=R.ExecConfig(
        engine="jax", planner="deepfish", block=BLOCK))
    with pytest.raises(R.ConfigError, match="matching JaxBlockBackend"):
        R.resolve_backend(forest, R.ExecConfig(engine="pallas"), reuse=rjb)


def test_block_engine_defaults_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device runs there")
    ref_table, port_table = _tables(2000)
    tree = T.random_query_suite(port_table, 1, 4, 2, seed=1)[0]
    for eng in ENGINES:
        assert T.ExecConfig(engine=eng).device == "cuda"
        with pytest.raises(RuntimeError, match="no CUDA device"):
            T.run_query(tree, port_table, config=T.ExecConfig(engine=eng))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        BlockBackend(port_table)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        T.QuerySession(port_table, config=T.ExecConfig(engine="jax")
                       ).execute([tree])


# -- the kernel entry points' popcount arguments -------------------------------

def _ops_inputs(rng, q, n, w):
    col = torch.from_numpy(rng.normal(size=(n, 32 * w)).astype(np.float32))
    bits = rng.integers(0, 2 ** 32, size=(q, n, w), dtype=np.uint32)
    bits[:, 1] = 0                                       # a dead block
    return col, torch.from_numpy(bits.view(np.int32))


def test_ops_popcount_arguments_match_the_defaults():
    rng = np.random.default_rng(0)
    col, bits = _ops_inputs(rng, 3, 4, 8)
    pops = tref.popcount_ref(bits)
    for op in range(6):
        assert torch.equal(
            tops.predicate_blocks(col, bits[0], 0.1, op, pops=pops[0]),
            tops.predicate_blocks(col, bits[0], 0.1, op))
        assert torch.equal(
            tops.predicate_blocks_multi(col, bits, 0.1, op, pops=pops),
            tops.predicate_blocks_multi(col, bits, 0.1, op))
    ones = torch.ones(4, dtype=torch.int32)
    got = tops.bitmap_op(bits[0], bits[0], 0, ones, ones)
    want = tops.bitmap_op(bits[0], bits[0], 0)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    assert torch.equal(got[1], pops[0])
