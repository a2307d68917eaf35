"""The port's write-ahead log, snapshots, recovery and warm-restart caches,
on the CPU, held against the reference's.

The cases of ``tests/test_wal.py`` run on ``repro_torch.columnar`` (record
framing and group-commit accounting, truncate-at-first-torn-record, the
sequence floor across rotation, snapshot atomicity and corruption
fallback, replay of every mutation kind, the checked cache envelope and
its data epoch).  Then the two packages meet on disk: a durability
directory written by either is recovered by both, into equal tables that
give equal bitmaps; and a cache directory written by the reference, whose
pickles name the reference's classes, gives the port a clean cold start,
because the port unpickles only its own classes, numpy's and the
builtins (``wal.restricted_loads``).
"""
import os
import pickle
import zlib

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import repro.columnar as R
import repro_torch.columnar as T
from repro.core import Atom as RefAtom
from repro_torch.columnar import (Durability, DurabilityError, ExecConfig,
                                  StreamSession, Table, WriteAheadLog,
                                  persist, run_query)
from repro_torch.columnar.queries import random_tree
from repro_torch.columnar.wal import restricted_loads

CFG = ExecConfig(planner="deepfish", engine="numpy", device="cpu")
REF_CFG = R.ExecConfig(planner="deepfish", engine="numpy")


def _columns(n=200, seed=0):
    rng = np.random.default_rng(seed)
    return {"a": rng.normal(size=n),
            "b": rng.integers(0, 50, size=n).astype(np.int64),
            "s": rng.choice(np.array(["ash", "oak", "pine"]), size=n)}


def _table(n=200, seed=0):
    return Table(_columns(n, seed))


def _assert_same_table(got, want):
    assert set(got.columns) == set(want.columns)
    assert got.n_records == want.n_records
    assert got.version == want.version
    for name, col in want.columns.items():
        assert got.columns[name].dtype == col.dtype
        np.testing.assert_array_equal(got.columns[name], col)
    gt = np.zeros(got.n_records, bool)
    wt = np.zeros(want.n_records, bool)
    if got._tombstones is not None:
        gt[: len(got._tombstones)] = got._tombstones
    if want._tombstones is not None:
        wt[: len(want._tombstones)] = want._tombstones
    np.testing.assert_array_equal(gt, wt)


# -- the log ------------------------------------------------------------------

def test_wal_log_commit_replay_roundtrip(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal"))
    recs = [("append", {"rows": {"a": np.arange(3)}}),
            ("delete", {"rows": np.array([1])}),
            ("compact", {})]
    for kind, payload in recs:
        wal.log(kind, payload)
    assert wal.uncommitted == 3 and wal.committed_seq == 0
    assert wal.commit() is not None
    assert wal.uncommitted == 0 and wal.committed_seq == 3
    assert wal.commit() is None                 # idle commit is free
    wal.close()

    wal2 = WriteAheadLog(str(tmp_path / "wal"))
    assert wal2.last_seq == 3 == wal2.committed_seq
    replayed = list(wal2.replay())
    assert [(s, k) for s, k, _ in replayed] == \
        [(1, "append"), (2, "delete"), (3, "compact")]
    np.testing.assert_array_equal(replayed[0][2]["rows"]["a"], np.arange(3))
    assert list(wal2.replay(after_seq=2)) == replayed[2:]
    wal2.close()


def test_wal_sync_policies(tmp_path):
    always = WriteAheadLog(str(tmp_path / "a"), sync="always")
    always.log("compact", {})
    assert always.uncommitted == 0 and always.commits == 1
    always.close()
    grouped = WriteAheadLog(str(tmp_path / "g"), sync="group",
                            group_max_records=4)
    for _ in range(3):
        grouped.log("compact", {})
    assert grouped.uncommitted == 3             # below the cap: buffered
    grouped.log("compact", {})                  # cap reached: auto-commit
    assert grouped.uncommitted == 0
    grouped.close()
    with pytest.raises(ValueError):
        WriteAheadLog(str(tmp_path / "x"), sync="fsync-sometimes")


def test_wal_truncates_torn_tail(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal"))
    for i in range(4):
        wal.log("append", {"i": i})
    wal.commit()
    path = wal._tail_path
    wal.close()
    with open(path, "ab") as f:                 # torn final frame
        f.write(b"\x01\x02\x03garbage")
    wal2 = WriteAheadLog(str(tmp_path / "wal"))
    assert wal2.last_seq == 4
    assert wal2.truncated_records == 1 and wal2.truncated_bytes > 0
    assert [s for s, _, _ in wal2.replay()] == [1, 2, 3, 4]
    # the torn tail was physically removed: reopening is clean
    wal2.log("append", {"i": 4})
    wal2.commit()
    wal2.close()
    wal3 = WriteAheadLog(str(tmp_path / "wal"))
    assert wal3.last_seq == 5 and wal3.truncated_records == 0
    wal3.close()


def test_wal_bitflip_drops_suffix(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal"))
    for i in range(6):
        wal.log("append", {"i": i})
    wal.commit()
    path = wal._tail_path
    wal.close()
    data = bytearray(open(path, "rb").read())
    data[len(data) // 2] ^= 0xFF                # flip a bit mid-log
    open(path, "wb").write(bytes(data))
    wal2 = WriteAheadLog(str(tmp_path / "wal"))
    seqs = [s for s, _, _ in wal2.replay()]
    assert wal2.truncated_records == 1
    assert seqs == list(range(1, len(seqs) + 1))    # a clean prefix
    assert wal2.last_seq == (seqs[-1] if seqs else 0) < 6
    wal2.close()


def test_wal_rotation_pins_sequence_floor(tmp_path):
    wal = WriteAheadLog(str(tmp_path / "wal"))
    for i in range(5):
        wal.log("append", {"i": i})
    wal.rotate(covered_seq=5)                   # old segment GC'd
    assert wal.segments_gced == 1
    wal.close()
    # the surviving segment is empty, but its NAME pins the floor
    wal2 = WriteAheadLog(str(tmp_path / "wal"))
    assert wal2.last_seq == 5
    assert wal2.log("append", {"i": 5}) == 6
    wal2.close()


def test_wal_record_naming_a_foreign_module_is_torn(tmp_path):
    """A record whose body names a class outside the port (here the
    reference's ``Atom``) passes its CRC, so the open-time scan keeps it;
    recovery's replay refuses it and truncates the log there, like at a
    torn frame, so nothing after it can be acknowledged on top of it."""
    t = _table()
    dur = Durability(str(tmp_path / "d"), snapshot_every=None)
    dur.attach(t)                                           # seq 1: create
    rows = {"a": np.ones(8), "b": np.arange(8), "s": np.array(["oak"] * 8)}
    t.append(rows)                                          # seq 2
    dur.wal.log("append", {"atom": RefAtom("a", "lt", 1.0)})  # seq 3
    t.append(rows)                                          # seq 4
    dur.close()
    wal = WriteAheadLog(str(tmp_path / "d" / "wal"))
    assert wal.last_seq == 4 and wal.truncated_records == 0
    wal.close()
    d2, t2, info = Durability.recover(str(tmp_path / "d"))
    assert info["last_seq"] == 2 and info["truncated_records"] == 1
    assert info["replayed_records"] == 2 and t2.n_records == 208
    assert [s for s, _, _ in d2.wal.replay()] == [1, 2]
    t2.append(rows)
    assert d2.wal.last_seq == 3                 # re-sequenced past the cut
    d2.close()
    assert Durability.recover(str(tmp_path / "d"))[2]["last_seq"] == 3


def test_recover_failing_to_decode_leaves_the_directory_as_it_was(
        tmp_path, monkeypatch):
    """A record that passes its CRC but fails to decode for any reason
    other than a refused module (here a MemoryError) is not torn: recovery
    raises, the open-time scan never decodes, and no byte on disk
    changes."""
    import repro_torch.columnar.wal as wal_mod
    t = _table()
    dur = Durability(str(tmp_path / "d"), snapshot_every=None)
    dur.attach(t)
    t.append({"a": np.ones(8), "b": np.arange(8),
              "s": np.array(["oak"] * 8)})
    dur.close()

    def files():
        root = tmp_path / "d"
        return {str(f.relative_to(root)): f.read_bytes()
                for f in sorted(root.rglob("*")) if f.is_file()}

    before = files()

    def fail(body):
        raise MemoryError("decoding a record")

    monkeypatch.setattr(wal_mod, "restricted_loads", fail)
    wal = WriteAheadLog(str(tmp_path / "d" / "wal"))
    assert wal.last_seq == 2 and wal.truncated_records == 0
    wal.close()
    with pytest.raises(MemoryError):
        Durability.recover(str(tmp_path / "d"))
    assert files() == before
    monkeypatch.undo()
    _, t2, info = Durability.recover(str(tmp_path / "d"))
    assert info["last_seq"] == 2 and t2.n_records == 208


def test_restricted_loads_refuses_other_modules():
    from repro_torch.core import Atom
    port = Atom("a", "lt", 1.0)
    assert restricted_loads(pickle.dumps(port)).column == "a"
    arr = np.arange(6, dtype=np.int32).reshape(2, 3)
    np.testing.assert_array_equal(restricted_loads(pickle.dumps(arr)), arr)
    for foreign in (RefAtom("a", "lt", 1.0), getattr, pytest.raises):
        with pytest.raises(pickle.UnpicklingError):
            restricted_loads(pickle.dumps(foreign))


# -- snapshots + recovery -----------------------------------------------------

def test_recover_snapshot_plus_tail(tmp_path):
    t = _table()
    dur = Durability(str(tmp_path / "d"), snapshot_every=None)
    dur.attach(t)
    t.append({"a": np.ones(8), "b": np.arange(8),
              "s": np.array(["oak"] * 8)})
    dur.snapshot()
    t.delete(np.arange(4))
    t.compact()
    dur.commit()
    dur.close()
    dur2, t2, info = Durability.recover(str(tmp_path / "d"))
    assert info["snapshot_seq"] == 2            # create + append covered
    assert info["replayed_records"] == 2        # delete + compact tail
    assert info["epoch"] == dur.epoch
    _assert_same_table(t2, t)
    dur2.close()


def test_recover_skips_corrupt_snapshot(tmp_path):
    t = _table()
    dur = Durability(str(tmp_path / "d"), snapshot_every=None,
                     keep_snapshots=2)
    dur.attach(t)
    t.append({"a": np.ones(4), "b": np.arange(4),
              "s": np.array(["ash"] * 4)})
    dur.snapshot()
    t.delete([0, 1])
    newest = dur.snapshot()
    dur.close()
    blob = bytearray(open(os.path.join(newest, "state.pkl"), "rb").read())
    blob[10] ^= 0x40                            # bit flip: CRC mismatch
    open(os.path.join(newest, "state.pkl"), "wb").write(bytes(blob))
    dur2, t2, info = Durability.recover(str(tmp_path / "d"))
    assert info["snapshots_skipped"] == 1       # fell back one snapshot
    assert info["replayed_records"] == 1        # ... and replayed further
    _assert_same_table(t2, t)
    dur2.close()
    # manifest format drift is refused the same way
    with open(os.path.join(newest, "manifest.json"), "w") as f:
        f.write('{"format": 999}')
    dur3, t3, info3 = Durability.recover(str(tmp_path / "d"))
    assert info3["snapshots_skipped"] == 1
    _assert_same_table(t3, t)
    dur3.close()


def test_recover_skips_snapshot_naming_a_foreign_module(tmp_path):
    """A snapshot whose state names a class outside the port is skipped
    like a corrupt one, even with a valid manifest CRC: the older snapshot
    and a longer replay serve."""
    import json
    t = _table()
    dur = Durability(str(tmp_path / "d"), snapshot_every=None)
    dur.attach(t)
    t.append({"a": np.ones(4), "b": np.arange(4),
              "s": np.array(["ash"] * 4)})
    dur.snapshot()
    t.delete([0, 1])
    newest = dur.snapshot()
    dur.close()
    foreign = R.Table(dict(t.columns))
    blob = pickle.dumps({"columns": foreign})
    with open(os.path.join(newest, "state.pkl"), "wb") as f:
        f.write(blob)
    path = os.path.join(newest, "manifest.json")
    manifest = json.load(open(path))
    manifest.update(crc=zlib.crc32(blob), size=len(blob))
    json.dump(manifest, open(path, "w"))
    dur2, t2, info = Durability.recover(str(tmp_path / "d"))
    assert info["snapshots_skipped"] == 1
    assert info["replayed_records"] == 1
    _assert_same_table(t2, t)
    dur2.close()


def test_recover_rebuilds_dicts_and_set_column(tmp_path):
    t = _table(seed=3)
    assert t.dict_column("s") is not None       # built dictionary state
    dur = Durability(str(tmp_path / "d"), snapshot_every=None)
    dur.attach(t)
    t.append({"a": np.zeros(6), "b": np.arange(6),
              "s": np.array(["elm", "oak", "elm", "ash", "elm", "fir"])})
    t.set_column("b", np.arange(t.n_records).astype(np.int64))
    dur.snapshot()
    dur.close()
    dur2, t2, _ = Durability.recover(str(tmp_path / "d"))
    _assert_same_table(t2, t)
    d1, d2 = t.dict_column("s"), t2.dict_column("s")
    np.testing.assert_array_equal(d1.codes, d2.codes)
    np.testing.assert_array_equal(d1.values, d2.values)
    assert d1.sorted_n == d2.sorted_n           # same merge state
    # and queries agree bit-for-bit on the recovered table
    rng = np.random.default_rng(0)
    tree = random_tree(t, 4, 2, rng)
    np.testing.assert_array_equal(run_query(tree, t, config=CFG)[0],
                                  run_query(tree, t2, config=CFG)[0])
    dur2.close()


def test_delete_is_wal_logged_but_not_mutlogged(tmp_path):
    t = _table()
    v0 = t.version
    dur = Durability(str(tmp_path / "d"), snapshot_every=None)
    dur.attach(t)
    t.delete([1, 2, 3])
    # tombstones never invalidate prefix caches: delta_since still
    # answers for the pre-delete version (version bump, rows untouched)
    assert t.delta_since(v0) is not None
    assert all(kind != "delete" for _, kind, _ in t._mutlog)
    dur.commit()
    dur.close()
    _, t2, info = Durability.recover(str(tmp_path / "d"))
    assert info["replayed_records"] == 2        # create + delete
    _assert_same_table(t2, t)


def test_lifecycle_misuse_raises(tmp_path):
    d = str(tmp_path / "d")
    dur = Durability(d, snapshot_every=None)
    dur.attach(_table())
    dur.close()
    with pytest.raises(DurabilityError):        # split-brain guard
        Durability(d).attach(_table())
    with pytest.raises(DurabilityError):        # nothing recoverable
        Durability.recover(str(tmp_path / "empty"))
    with pytest.raises(ValueError):             # recover needs durable=
        StreamSession(None, config=CFG)
    with pytest.raises(ValueError):             # durable=True needs cache_dir
        StreamSession(_table(), config=CFG, durable=True)


# -- the stream acknowledgement boundary --------------------------------------

def test_stream_group_commit_per_drain(tmp_path):
    t = _table(1000, seed=1)
    s = StreamSession(t, config=CFG, durable=str(tmp_path / "d"))
    wal = s.durability.wal
    commits0 = wal.commits
    for i in range(5):
        s.append({"a": np.ones(4) * i, "b": np.arange(4),
                  "s": np.array(["oak"] * 4)})
    assert wal.uncommitted == 5                 # buffered, no fsync yet
    assert wal.commits == commits0
    fut = s.submit(random_tree(t, 4, 2, np.random.default_rng(2)))
    s.drain()
    fut.result(timeout=30)
    # ONE fsync covered all five appends, before the future resolved
    assert wal.uncommitted == 0
    assert wal.commits == commits0 + 1
    s.append({"a": np.zeros(2), "b": np.arange(2),
              "s": np.array(["ash", "elm"])})
    assert s.sync() == wal.last_seq             # explicit boundary
    assert wal.uncommitted == 0
    h = s.health()
    assert h["durable"] and h["wal"]["uncommitted"] == 0
    assert h["recovery"] == {"recovered": False}
    s.close()
    # close() snapshots: restart replays nothing
    s2 = StreamSession(None, config=CFG, durable=str(tmp_path / "d"))
    assert s2.recovery_info["replayed_records"] == 0
    _assert_same_table(s2.table, t)
    s2.close()


def test_stream_group_commit_on_the_tape_engine(tmp_path):
    """The default lockstep tape engine (on the CPU): the drain's group
    commit happens once, before the futures resolve, and the drain keeps
    its one bundled host sync."""
    t = _table(3000, seed=4)
    cfg = StreamSession.DEFAULT_CONFIG.replace(device="cpu", block=1024)
    s = StreamSession(t, config=cfg, durable=str(tmp_path / "d"))
    wal = s.durability.wal
    trees = [random_tree(t, 4, 2, np.random.default_rng(i))
             for i in range(3)]
    for rnd in range(3):
        s.append({"a": np.ones(40) * rnd, "b": np.arange(40),
                  "s": np.array(["oak"] * 40)})
        c0 = wal.commits
        futs = [s.submit(tr) for tr in trees]
        res = s.drain()
        assert res.stats.host_syncs == 1
        assert wal.commits == c0 + 1 and wal.uncommitted == 0
        for f, tr in zip(futs, trees):
            np.testing.assert_array_equal(
                f.result(), run_query(tr, t, config=CFG)[0])
    s.close()


def test_stream_wal_sync_always_commits_each_mutation(tmp_path):
    t = _table(300, seed=2)
    s = StreamSession(t, config=CFG, durable=str(tmp_path / "d"),
                      wal_sync="always")
    wal = s.durability.wal
    for i in range(3):
        s.append({"a": np.ones(2) * i, "b": np.arange(2),
                  "s": np.array(["oak", "ash"])})
        assert wal.uncommitted == 0             # fsync per mutation
    s.close()


# -- persist hardening (checked envelope + data epoch) ------------------------

def _warm_session(cache_dir):
    t = _table(2000, seed=5)
    s = StreamSession(t, config=CFG, cache_dir=cache_dir)
    futs = [s.submit(random_tree(t, 4, 2, np.random.default_rng(i)))
            for i in range(3)]
    s.drain()
    for f in futs:
        f.result(timeout=30)
    s.close()                                   # flushes checked caches


@pytest.mark.parametrize("damage", ["truncate", "bitflip", "empty"])
def test_persist_corrupt_cache_cold_starts(tmp_path, damage):
    cache_dir = str(tmp_path / "warm")
    _warm_session(cache_dir)
    for name in (persist.PLAN_CACHE_FILE, persist.FEEDBACK_FILE):
        path = os.path.join(cache_dir, name)
        data = open(path, "rb").read()
        assert len(data) > 64
        if damage == "truncate":
            open(path, "wb").write(data[: len(data) // 2])
        elif damage == "bitflip":
            flipped = bytearray(data)
            flipped[len(flipped) // 2] ^= 0x10
            open(path, "wb").write(bytes(flipped))
        else:
            open(path, "wb").write(b"")
    s = StreamSession(_table(2000, seed=5), config=CFG,
                      cache_dir=cache_dir)
    assert s.restore_info["plans"] == 0         # clean cold start
    assert s.restore_info.get("feedback_keys", 0) == 0
    fut = s.submit(random_tree(s.table, 4, 2, np.random.default_rng(0)))
    s.drain()
    assert fut.result(timeout=30) is not None   # ... and still serves
    s.close()


def test_persist_epoch_token(tmp_path):
    from repro_torch.columnar.persist import _dump_checked, _load_checked
    path = str(tmp_path / "cache.pkl")
    _dump_checked({"x": 1}, path, epoch="lineage-A")
    assert _load_checked(path, epoch="lineage-A") == {"x": 1}
    assert _load_checked(path, epoch="lineage-B") is None   # foreign data
    # one-sided epochs stay compatible (legacy files / non-durable runs)
    assert _load_checked(path, epoch=None) == {"x": 1}
    _dump_checked({"x": 2}, path, epoch=None)
    assert _load_checked(path, epoch="lineage-A") == {"x": 2}


def test_persist_format_drift_refused(tmp_path):
    from repro_torch.columnar.persist import FORMAT, _load_checked
    path = str(tmp_path / "cache.pkl")
    blob = pickle.dumps({"x": 1})
    with open(path, "wb") as f:
        pickle.dump({"format": FORMAT - 1, "crc": zlib.crc32(blob),
                     "epoch": None, "blob": blob}, f)
    assert _load_checked(path) is None


def test_persist_compilation_cache_reports_the_kernel_library(tmp_path):
    """``compilation_cache`` keeps the reference's key; in the port it says
    whether the kernel library of the current sources is already built (no
    build is started, nothing is written to ``cache_dir``)."""
    from repro_torch.kernels import _build
    info = persist.load_session_caches(
        T.QuerySession(_table(), config=CFG), str(tmp_path / "c"))
    assert info["compilation_cache"] is _build.library_path().exists()
    assert not (tmp_path / "c").exists()


def test_durable_stream_caches_survive_recovery_same_epoch(tmp_path):
    """Caches persisted by a durable session warm the RECOVERED session
    (same lineage) — and are refused by a session over different data."""
    cache_dir = str(tmp_path / "warm")
    data_dir = str(tmp_path / "data")
    t = _table(2000, seed=6)
    s = StreamSession(t, config=CFG, durable=data_dir,
                      cache_dir=cache_dir)
    futs = [s.submit(random_tree(t, 4, 2, np.random.default_rng(i)))
            for i in range(3)]
    s.drain()
    for f in futs:
        f.result(timeout=30)
    s.close()

    s2 = StreamSession(None, config=CFG, durable=data_dir,
                       cache_dir=cache_dir)
    assert s2.recovery_info is not None
    assert s2.restore_info["plans"] >= 3        # same epoch: warm start
    s2.close()

    other = StreamSession(_table(2000, seed=6), config=CFG,
                          durable=str(tmp_path / "other"),
                          cache_dir=cache_dir)
    assert other.restore_info["plans"] == 0     # different lineage: cold
    other.close()


# -- the two packages on one disk ---------------------------------------------

PKGS = {"reference": R, "port": T}


def _eq(x, y) -> bool:
    """Deep equality over the snapshot state's numpy arrays and builtins."""
    if isinstance(x, np.ndarray) or isinstance(y, np.ndarray):
        return (isinstance(x, np.ndarray) and isinstance(y, np.ndarray)
                and x.dtype == y.dtype and x.shape == y.shape
                and np.array_equal(x, y))
    if isinstance(x, (list, tuple)):
        return (type(x) is type(y) and len(x) == len(y)
                and all(_eq(a, b) for a, b in zip(x, y)))
    if isinstance(x, dict):
        return (isinstance(y, dict) and x.keys() == y.keys()
                and all(_eq(x[k], y[k]) for k in x))
    return type(x) is type(y) and x == y


def _assert_same_state(a, b):
    """Every field the snapshot state carries: columns and dtypes,
    version, the mutation log, tombstones, the built dictionaries and the
    zone-map / sketch stamps (re-keyed to each table's own arrays)."""
    _assert_same_table(a, b)
    assert _eq(a._mutlog, b._mutlog)
    assert a._mutlog_base == b._mutlog_base
    assert a.tombstone_epoch == b.tombstone_epoch
    assert a._dicts.keys() == b._dicts.keys()
    for name in a._dicts:
        da, db = a._dicts[name][1], b._dicts[name][1]
        assert a._dicts[name][0] is a.columns[name]
        assert b._dicts[name][0] is b.columns[name]
        for f in ("values", "codes", "counts", "freqs"):
            assert _eq(getattr(da, f), getattr(db, f)), (name, f)
        assert da.sorted_n == db.sorted_n
    assert a._zones.keys() == b._zones.keys()
    for key, (ver, cid, zm) in a._zones.items():
        ver_b, cid_b, zm_b = b._zones[key]
        assert ver == ver_b
        # stamped on the same array in both (the snapshot's, or the
        # current one when no replayed record replaced it)
        assert (cid == id(a.column_data(key[0]))) == \
            (cid_b == id(b.column_data(key[0])))
        assert _eq(vars(zm), vars(zm_b))
    assert a._qsketch.keys() == b._qsketch.keys()
    for name, (ver, cid, sk) in a._qsketch.items():
        ver_b, cid_b, sk_b = b._qsketch[name]
        assert ver == ver_b
        assert (cid == id(a.column_data(name))) == \
            (cid_b == id(b.column_data(name)))
        assert _eq(vars(sk), vars(sk_b))


def _write_history(pkg, directory):
    """Every record kind, derived state built before the snapshot, and a
    tail of every kind past it; returns the live table."""
    cols = _columns(3000, seed=8)
    t = pkg.Table(cols)
    dur = pkg.Durability(directory, snapshot_every=None)
    dur.attach(t)
    extra = _columns(700, seed=9)
    extra["s"] = np.array(["elm", "oak", "fir", "ash"])[
        np.arange(700) % 4]
    t.append(extra)
    t.dict_column("s")                          # streaming-merge state
    t.zone_map("a", 256)
    t.zone_map("s#codes", 256)
    t.stats("a")
    t.stats("b")
    dur.snapshot()
    t.delete(np.arange(0, 3700, 9))
    t.set_column("b", (np.arange(t.n_records) % 97).astype(np.int64))
    t.append(_columns(300, seed=10))
    t.delete(np.arange(5, 400, 3))
    dur.commit()
    dur.close()
    return t


def _trees(pkg, table, n=4):
    return [pkg.random_tree(table, 5, 2, np.random.default_rng(s))
            for s in range(n)]


@pytest.mark.parametrize("writer", ["reference", "port"])
def test_durability_directory_recovers_in_either_package(tmp_path, writer):
    directory = str(tmp_path / "d")
    live = _write_history(PKGS[writer], directory)
    rd, rt, rinfo = R.Durability.recover(directory)
    rd.close()
    td, tt, tinfo = T.Durability.recover(directory)
    td.close()
    assert isinstance(tt, T.Table) and isinstance(rt, R.Table)
    for k in ("snapshot_seq", "snapshots_skipped", "replayed_records",
              "truncated_records", "last_seq", "n_records", "version",
              "epoch"):
        assert tinfo[k] == rinfo[k], k
    assert tinfo["snapshot_seq"] == 2 and tinfo["replayed_records"] == 4
    _assert_same_state(tt, rt)
    _assert_same_table(tt, live)
    # unpickled arrays stay writable: an upload may wrap them without copy
    assert all(c.flags.writeable for c in tt.columns.values())
    assert all(dc.codes.flags.writeable for _, dc in tt._dicts.values())
    # the same trees give the same bitmaps through both packages, and the
    # port's lockstep tape engine (plain kernels) equals the oracle
    for rtree, ttree in zip(_trees(R, rt), _trees(T, tt)):
        want = R.run_query(rtree, rt, config=REF_CFG)[0]
        np.testing.assert_array_equal(
            run_query(ttree, tt, config=CFG)[0], want)
        np.testing.assert_array_equal(
            run_query(ttree, tt, config=ExecConfig(
                planner="deepfish", engine="tape", device="cpu",
                block=1024))[0], want)


def test_reference_cache_dir_cold_starts_the_port(tmp_path):
    """The reference's compiled tapes and feedback store name the
    reference's classes: the port refuses them (a clean cold start),
    serves, and then writes caches of its own classes only, which warm
    its next start."""
    import io
    cache_dir = str(tmp_path / "warm")
    cols = _columns(2000, seed=5)
    rt = R.Table({k: v.copy() for k, v in cols.items()})
    rs = R.StreamSession(rt, config=R.ExecConfig(
        planner="deepfish", engine="tape", batched="auto", block=1024),
        cache_dir=cache_dir)
    rf = [rs.submit(q) for q in _trees(R, rt, 3)]
    rs.drain()
    rs.close()
    assert os.path.exists(os.path.join(cache_dir, persist.FEEDBACK_FILE))

    cfg = ExecConfig(planner="deepfish", engine="tape", batched="auto",
                     block=1024, device="cpu")
    tt = Table({k: v.copy() for k, v in cols.items()})
    ts = StreamSession(tt, config=cfg, cache_dir=cache_dir)
    assert ts.restore_info["plans"] == 0        # refused: cold start
    assert "feedback_keys" not in ts.restore_info
    assert len(ts.session.plan_cache) == 0
    tf = [ts.submit(q) for q in _trees(T, tt, 3)]
    res = ts.drain()
    assert res.stats.plan_cache_hits == 0
    for a, b in zip(tf, rf):
        np.testing.assert_array_equal(a.result(), b.result())
    ts.close()

    seen = set()

    class Recorder(pickle.Unpickler):
        def find_class(self, module, name):
            seen.add(module)
            return super().find_class(module, name)

    payload = persist._load_checked(
        os.path.join(cache_dir, persist.PLAN_CACHE_FILE))
    assert payload["entries"]
    for blob in payload["entries"]:
        Recorder(io.BytesIO(blob)).load()
    assert "repro_torch.core.tape" in seen
    assert not [m for m in seen if m.split(".")[0] == "repro"]
    ts2 = StreamSession(Table(cols), config=cfg, cache_dir=cache_dir)
    assert ts2.restore_info["plans"] >= 3       # the port's own: warm
    assert ts2.restore_info["feedback_keys"] > 0
    ts2.close()
