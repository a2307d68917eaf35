"""Recovery and warm restarts of the port, on the CPU, held against the
reference.

A recovered process must be indistinguishable from one that never
crashed: every planner x engine combination of the port (the numpy oracle
and the tape engine's plain kernels) answers queries on the recovered
table bit-identically to the pre-crash table, to a naive full-scan oracle
and to the reference on the same directory; the tape engine's execution
contracts — one bundled host sync per drain, no new device program on an
append inside the block bucket (``tape_programs`` / ``graph_captures``) —
hold on the recovered process as on a live one.  Warm restarts from a
``cache_dir`` give the reference's plan-cache and tape-cache hits.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.columnar as R
import repro_torch.columnar as T
from repro_torch.columnar import (Durability, ExecConfig, StreamSession,
                                  Table, make_forest_table, pack_bits,
                                  run_query)
from repro_torch.columnar.queries import random_tree
from repro_torch.core import Atom

PLANNERS = ["shallowfish", "deepfish", "nooropt", "optimal"]
ENGINES = ["numpy", "tape"]


def _cfg(**kw):
    return ExecConfig(device="cpu", **kw)


def _rows_like(table, n, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for name, col in table.columns.items():
        if col.dtype.kind in "iu":
            out[name] = rng.integers(col.min(), col.max() + 1, size=n
                                     ).astype(col.dtype)
        elif col.dtype.kind == "f":
            out[name] = rng.uniform(col.min(), col.max(), size=n
                                    ).astype(col.dtype)
        else:
            out[name] = rng.choice(np.unique(col), size=n)
    return out


def _apply_history(table, flavor, checkpoint=lambda: None):
    """Interleaved mutation history; ``flavor`` picks the shape.
    ``checkpoint`` fires mid-history so recoveries exercise snapshot +
    tail replay rather than a pure log replay."""
    rng = np.random.default_rng(sum(map(ord, flavor)))
    if flavor == "append-compact":
        table.append(_rows_like(table, 700, seed=1))
        table.delete(rng.integers(0, table.n_records, size=300))
        table.compact()                 # rows moved mid-history
        checkpoint()
        table.append(_rows_like(table, 500, seed=2))
        table.delete(rng.integers(0, table.n_records, size=120))
    else:                               # "delete-heavy": live tombstones
        for i in range(3):
            table.append(_rows_like(table, 300, seed=10 + i))
            if i == 1:
                checkpoint()
            table.delete(rng.integers(0, table.n_records, size=150))


def _oracle(table, tree):
    """Naive full-scan evaluation + live mask, shared with no engine."""
    from repro_torch.core.predicate import And, Atom as PAtom

    def mask(node):
        if isinstance(node, PAtom):
            return table.eval_atom(node, None)
        combine = np.logical_and if isinstance(node, And) \
            else np.logical_or
        out = None
        for c in node.children:
            m = mask(c)
            out = m if out is None else combine(out, m)
        return out

    m = mask(tree.root)
    if table._tombstones is not None:
        live = np.ones(table.n_records, dtype=bool)
        live[: len(table._tombstones)] &= ~table._tombstones
        m = m & live
    return pack_bits(m)


@pytest.mark.parametrize("flavor", ["append-compact", "delete-heavy"])
def test_recovered_table_differential_all_planners_engines(tmp_path,
                                                           flavor):
    live = make_forest_table(4000, n_dup=1, seed=11)
    directory = str(tmp_path / flavor)
    dur = Durability(directory, snapshot_every=None)
    dur.attach(live)
    _apply_history(live, flavor, checkpoint=dur.snapshot)
    dur.commit()
    dur.close()

    dur2, recovered, info = Durability.recover(directory)
    assert info["n_records"] == live.n_records
    assert info["version"] == live.version
    # the mid-history checkpoint makes this a real snapshot + tail
    # replay, not a pure log replay
    assert info["snapshot_seq"] > 0 and info["replayed_records"] > 0
    rdur, ref_recovered, rinfo = R.Durability.recover(directory)
    rdur.close()
    for k in ("snapshot_seq", "replayed_records", "last_seq", "n_records",
              "version"):
        assert rinfo[k] == info[k], k

    trees = [random_tree(recovered, 5, 2, np.random.default_rng(s))
             for s in range(2)]
    ref_trees = [R.random_tree(ref_recovered, 5, 2,
                               np.random.default_rng(s)) for s in range(2)]
    for tree, ref_tree in zip(trees, ref_trees):
        want = _oracle(live, tree)
        for planner in PLANNERS:
            ref, _, _ = R.run_query(ref_tree, ref_recovered,
                                    config=R.ExecConfig(planner=planner,
                                                        engine="numpy"))
            np.testing.assert_array_equal(ref, want)
            for engine in ENGINES:
                cfg = _cfg(planner=planner, engine=engine)
                got, _, _ = run_query(tree, recovered, config=cfg)
                np.testing.assert_array_equal(
                    got, want,
                    err_msg=f"{planner}/{engine} diverged on recovery "
                            f"({flavor})")
                pre, _, _ = run_query(tree, live, config=cfg)
                np.testing.assert_array_equal(got, pre)
    dur2.close()


def test_recovered_stream_one_bundled_sync_per_drain(tmp_path):
    """The bundled-sync contract, gated on a RECOVERED process: a tape
    drain on the recovered session pays exactly one host sync."""
    data_dir = str(tmp_path / "data")
    t = make_forest_table(8000, n_dup=1, seed=7)
    trees = [random_tree(t, 4, 2, np.random.default_rng(i))
             for i in range(4)]
    s1 = StreamSession(t, config=_cfg(planner="deepfish", engine="numpy"),
                       max_pending=64, durable=data_dir)
    s1.append(_rows_like(t, 500, seed=3))
    s1.sync()
    s1.close()

    s2 = StreamSession(None, config=StreamSession.DEFAULT_CONFIG.replace(
        device="cpu", block=4096), max_pending=64, durable=data_dir)
    assert s2.recovery_info is not None and s2.table.n_records == 8500
    futs = [s2.submit(tr) for tr in trees]
    s2.drain()
    be = s2.session._backend
    assert be.host_syncs == 1                   # one bundled sync
    s2.append(_rows_like(s2.table, 600, seed=4))
    futs2 = [s2.submit(tr) for tr in trees]
    s2.drain()
    assert be.host_syncs == 2                   # still one per drain
    for f in futs + futs2:
        assert f.result(timeout=60) is not None
    for f, tr in zip(futs2, trees):
        np.testing.assert_array_equal(f.result(), _oracle(s2.table, tr))
    s2.close()


def test_recovered_stream_no_new_programs_on_append(tmp_path):
    """Warm plan/tape caches survive recovery (same data epoch), and an
    append inside the block bucket on the recovered process makes ZERO new
    device programs (on the card: captures no new CUDA graph) — the
    block-delta contract holds after replay.  9,000 rows in blocks of
    2,048 fill 5 of a bucket of 8, so the 700 appended rows stay inside
    it."""
    data_dir = str(tmp_path / "data")
    cache_dir = str(tmp_path / "warm")
    t = make_forest_table(9000, n_dup=1, seed=7)
    trees = [random_tree(t, 5, 3, np.random.default_rng(i))
             for i in range(3)]
    cfg = _cfg(planner="deepfish", engine="tape", batched="auto",
               block=2048)
    s1 = StreamSession(t, config=cfg, max_pending=64, durable=data_dir,
                       cache_dir=cache_dir)
    futs = [s1.submit(tr) for tr in trees]
    s1.drain()
    baseline = [f.result(timeout=60) for f in futs]
    s1.close()

    s2 = StreamSession(None, config=cfg, max_pending=64, durable=data_dir,
                       cache_dir=cache_dir)
    assert s2.recovery_info is not None
    assert s2.table.n_records == 9000
    assert s2.restore_info["plans"] >= 3        # same epoch: warm caches

    futs2 = [s2.submit(tr) for tr in trees]
    res = s2.drain()
    assert res.stats.tape_cache_hits >= 3       # rebound, not recompiled
    assert res.stats.plan_cache_hits >= 3
    for f, base in zip(futs2, baseline):
        # bit-identical to the pre-crash results
        np.testing.assert_array_equal(f.result(timeout=60), base)
    be = s2.session._backend
    programs, nblocks = be.tape_programs, be.nblocks
    assert programs == len(trees)               # one per tape key
    assert be.graph_captures == 0               # no graphs on the CPU

    # appends on the recovered process: delta splice, zero new programs
    s2.append(_rows_like(s2.table, 700, seed=4))
    futs3 = [s2.submit(tr) for tr in trees]
    s2.drain()
    for f, tr in zip(futs3, trees):
        np.testing.assert_array_equal(f.result(timeout=60),
                                      _oracle(s2.table, tr))
    assert s2.session._backend is be and be.nblocks == nblocks
    assert be.tape_programs == programs, \
        "append after recovery made new device programs"
    assert be.graph_captures == 0
    s2.close()


def test_recovered_delete_then_engines_agree(tmp_path):
    """Tombstones created BEFORE the crash and AFTER recovery compose:
    every engine masks both, bit-identically."""
    t = Table({"x": np.arange(3000, dtype=np.int64),
               "y": np.arange(3000, dtype=np.float64) / 7.0})
    cfg = _cfg(planner="deepfish", engine="numpy")
    s = StreamSession(t, config=cfg, durable=str(tmp_path / "d"))
    s.delete(np.arange(0, 3000, 5))
    s.sync()
    s.close()

    s2 = StreamSession(None, config=cfg, durable=str(tmp_path / "d"))
    s2.delete(np.arange(0, 3000, 7))
    tree = random_tree(s2.table, 4, 2, np.random.default_rng(1))
    want = _oracle(s2.table, tree)
    for engine in ENGINES:
        got, _, _ = run_query(tree, s2.table,
                              config=_cfg(planner="deepfish",
                                          engine=engine))
        np.testing.assert_array_equal(got, want, err_msg=engine)
    s2.close()


# -- warm restarts, against the reference --------------------------------------

def _forest(pkg, seed):
    return pkg.make_forest_table(4000, n_dup=1, seed=seed)


def test_warm_restart_reloads_plans_and_tapes_like_reference(tmp_path):
    """Two processes' worth of sessions per package: the restart reloads
    the same number of plans and feedback keys as the reference's, and its
    first drain gets the reference's plan-cache and tape-cache hits."""
    got = {}
    for name, mod, cfg in (
            ("reference", R, R.ExecConfig(planner="deepfish", engine="tape",
                                          batched="auto", block=2048)),
            ("port", T, _cfg(planner="deepfish", engine="tape",
                             batched="auto", block=2048))):
        cache_dir = str(tmp_path / name)
        t1 = _forest(mod, 3)
        trees = [mod.random_tree(t1, 5, 3, np.random.default_rng(i))
                 for i in range(3)]
        s1 = mod.StreamSession(t1, config=cfg, max_pending=64,
                               cache_dir=cache_dir)
        futs = [s1.submit(tr) for tr in trees]
        s1.drain()
        baseline = [np.asarray(f.result()) for f in futs]
        assert s1.stats.tape_cache_hits == 0    # cold: everything compiled
        s1.close()

        # "restart": identical data, brand-new process-level state
        t2 = _forest(mod, 3)
        trees2 = [mod.random_tree(t2, 5, 3, np.random.default_rng(i))
                  for i in range(3)]
        s2 = mod.StreamSession(t2, config=cfg, max_pending=64,
                               cache_dir=cache_dir)
        info = dict(s2.restore_info)
        assert info["plans"] >= 3
        assert info.get("feedback_keys", 0) > 0
        futs2 = [s2.submit(tr) for tr in trees2]
        res = s2.drain()
        assert res.stats.tape_cache_hits >= 3   # rebound, not recompiled
        assert res.stats.plan_cache_hits >= 3
        for f, base in zip(futs2, baseline):
            np.testing.assert_array_equal(np.asarray(f.result()), base)
        got[name] = (info["plans"], info["feedback_keys"],
                     res.stats.plan_cache_hits, res.stats.tape_cache_hits,
                     baseline)
        s2.close()
    ref, port = got["reference"], got["port"]
    assert port[:4] == ref[:4]
    for a, b in zip(port[4], ref[4]):
        np.testing.assert_array_equal(a, b)


def test_warm_restart_corrupt_cache_cold_starts(tmp_path):
    from repro_torch.columnar import persist
    cache_dir = tmp_path / "warm"
    cache_dir.mkdir()
    (cache_dir / persist.PLAN_CACHE_FILE).write_bytes(b"not a pickle")
    (cache_dir / persist.FEEDBACK_FILE).write_bytes(b"\x80garbage")
    cfg = _cfg(planner="deepfish", engine="numpy")
    s = StreamSession(_forest(T, 7), config=cfg, max_pending=64,
                      cache_dir=str(cache_dir))
    assert s.restore_info["plans"] == 0         # degraded to cold start
    fut = s.submit(Atom("elevation_0", "lt", 3000.0))
    s.drain()
    assert fut.done()
    s.close()                                   # flush overwrites the junk
    s3 = StreamSession(_forest(T, 7), config=cfg, max_pending=64,
                       cache_dir=str(cache_dir))
    assert s3.restore_info["plans"] >= 1
    s3.close()
