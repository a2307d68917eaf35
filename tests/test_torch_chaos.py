"""Crash-chaos harness for the port: SIGKILL a durable port ingest worker
at randomized points, recover, and verify against an independent numpy
oracle.

This file is its own worker: ``python tests/test_torch_chaos.py worker
SEED DATA_DIR ACK_FILE KILL_AT KILL_MODE N_OPS WAL_SYNC MODULES_FILE``
runs the schedule of ``tests/chaos_worker.py`` (its numpy-only generators
``gen_ops``, ``initial_columns``, ``append_batch``, ``delete_rows``)
against the port's durable :class:`StreamSession` (numpy engine on the
CPU) and dies by ``kill -9``: at an op boundary (``before`` / ``after``),
from a background timer (``timer``), at the WAL's torn-record failpoint
(``torn``), or just before / after a snapshot's rename (``snap_pre`` /
``snap_post``).  After each commit boundary it fsyncs the committed
sequence to the ack file, and after each op it writes the modules of
``jax`` and ``repro`` it has loaded (none may be) to ``MODULES_FILE``.

The parent recovers the directory with the port and checks the
reference harness's three contracts: prefix consistency (the recovered
state equals the numpy oracle's replay of exactly ``last_seq - 1``
mutation records), zero acknowledged loss, and query equivalence.  The
rounds cycle through the six kill modes under both ``wal_sync``
policies; 12 rounds by default (``CHAOS_ROUNDS``), each a fresh
interpreter that imports torch.
"""
import json
import os
import signal
import subprocess
import sys
import threading

import numpy as np

from chaos_worker import (append_batch, delete_rows, gen_ops,
                          initial_columns)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

N_OPS = 36
ROUNDS = int(os.environ.get("CHAOS_ROUNDS", "12"))
MODES = ("timer", "before", "after", "torn", "snap_pre", "snap_post")


# -- the worker (a subprocess: imports the port only) -------------------------

def _loaded_forbidden():
    return sorted(m for m in sys.modules
                  if m.split(".")[0] in ("jax", "repro"))


def _die():
    os.kill(os.getpid(), signal.SIGKILL)


def worker(argv) -> None:
    seed, data_dir, ack_file = int(argv[0]), argv[1], argv[2]
    kill_at, kill_mode = int(argv[3]), argv[4]
    n_ops, wal_sync, modules_file = int(argv[5]), argv[6], argv[7]

    from repro_torch.columnar import (ExecConfig, StreamSession, Table,
                                      random_tree)

    table = Table(initial_columns(seed))
    sess = StreamSession(
        table, config=ExecConfig(planner="deepfish", engine="numpy",
                                 device="cpu"),
        durable=data_dir, wal_sync=wal_sync, snapshot_every=48)

    def ack():
        with open(ack_file, "a") as f:
            f.write(json.dumps(
                {"seq": sess.durability.wal.committed_seq}) + "\n")
            f.flush()
            os.fsync(f.fileno())

    def modules():
        # written aside and renamed: a kill inside the write must leave
        # the last complete list, not an empty file
        tmp = modules_file + ".tmp"
        with open(tmp, "w") as f:
            json.dump(_loaded_forbidden(), f)
        os.replace(tmp, modules_file)

    modules()
    for i, (kind, arg) in enumerate(gen_ops(seed, n_ops)):
        if i == kill_at:
            if kill_mode == "before":
                _die()
            elif kill_mode == "torn":
                # next record write emits a partial frame, fsyncs it, dies
                sess.durability.wal._test_torn_bytes = (seed % 19) + 1
            elif kill_mode == "snap_pre":
                sess.durability._test_crash_point = "snapshot_pre_rename"
            elif kill_mode == "snap_post":
                sess.durability._test_crash_point = "snapshot_post_rename"
            elif kill_mode == "timer":
                delay = float(np.random.default_rng(arg).uniform(
                    0.001, 0.08))
                threading.Timer(delay, _die).start()
        if kind == "append":
            sess.append(append_batch(arg))
        elif kind == "delete":
            sess.delete(delete_rows(arg, table.n_records))
        elif kind == "compact":
            sess.compact()
        elif kind == "query":
            fut = sess.submit(random_tree(
                table, 4, 2, np.random.default_rng(arg)))
            sess.drain()
            fut.result(timeout=30)
            ack()
        elif kind == "snapshot":
            sess.durability.snapshot()
            ack()
        if wal_sync == "always":
            ack()
        modules()
        if i == kill_at and kill_mode == "after":
            _die()
    # survived every failpoint (e.g. a snapshot hook armed but never hit):
    # still die hard — no round ends with a clean close
    import time
    time.sleep(0.3)
    _die()


if __name__ == "__main__" and sys.argv[1:2] == ["worker"]:
    worker(sys.argv[2:])
    raise SystemExit(1)                  # unreachable: the worker dies


# -- the parent (the test process) --------------------------------------------

import pytest  # noqa: E402

torch = pytest.importorskip("torch")

from repro_torch.columnar import (Durability, ExecConfig,  # noqa: E402
                                  StreamSession, Table, run_query)
from repro_torch.columnar.queries import random_tree  # noqa: E402

NUMPY_CFG = ExecConfig(planner="deepfish", engine="numpy", device="cpu")


def _round_params():
    out = []
    for i in range(ROUNDS):
        mode = MODES[i % len(MODES)]
        wal_sync = ("group", "always")[(i // len(MODES)) % 2]
        out.append(pytest.param(i, mode, wal_sync,
                                id=f"r{i:02d}-{mode}-{wal_sync}"))
    return out


def _run_worker(seed, data_dir, ack_file, kill_at, mode, wal_sync,
                modules_file):
    env = dict(os.environ)
    env["PYTHONPATH"] = os.path.join(ROOT, "src")
    proc = subprocess.run(
        [sys.executable, os.path.abspath(__file__), "worker", str(seed),
         data_dir, ack_file, str(kill_at), mode, str(N_OPS), wal_sync,
         modules_file],
        capture_output=True, text=True, timeout=120, env=env)
    assert proc.returncode == -9, (
        f"worker must die by SIGKILL, got rc={proc.returncode}\n"
        f"stdout={proc.stdout}\nstderr={proc.stderr}")
    with open(modules_file) as f:
        assert json.load(f) == [], "the port's worker loaded jax or repro"


def _check_recovered(table, info, seed, acked):
    from test_chaos import oracle_after
    assert acked <= info["last_seq"], (
        f"acknowledged seq {acked} lost: recovery landed at "
        f"{info['last_seq']}")
    applied = info["last_seq"] - 1          # seq 1 is the create record
    assert applied >= 0
    cols, tomb = oracle_after(seed, applied)

    assert set(table.columns) == set(cols)
    assert table.n_records == len(cols["a"])
    for name, exp in cols.items():
        got = table.columns[name]
        assert got.dtype == exp.dtype, name
        assert np.array_equal(got, exp), (
            f"column {name!r} diverged from oracle after {applied} records")
    got_tomb = np.zeros(table.n_records, dtype=bool)
    if table._tombstones is not None:
        got_tomb[: len(table._tombstones)] = table._tombstones
    assert np.array_equal(got_tomb, tomb), "tombstone mask diverged"

    # query equivalence: oracle table built from scratch, no WAL involved
    oracle = Table({k: v.copy() for k, v in cols.items()})
    if tomb.any():
        oracle.delete(np.flatnonzero(tomb))
    rng = np.random.default_rng(seed ^ 0x5EED)
    for _ in range(2):
        tree = random_tree(oracle, 4, 2, rng)
        want, _, _ = run_query(tree, oracle, config=NUMPY_CFG)
        got, _, _ = run_query(tree, table, config=NUMPY_CFG)
        assert np.array_equal(want, got), "recovered query result diverged"
    return applied


_SEEN = []


@pytest.mark.parametrize("rnd,mode,wal_sync", _round_params())
def test_chaos_round(rnd, mode, wal_sync, tmp_path):
    from test_chaos import _max_acked
    seed = 1000 + rnd
    data_dir = str(tmp_path / "data")
    ack_file = str(tmp_path / "acks.jsonl")
    # snapshot-phase kills need a snapshot op after the failpoint arms:
    # arm early for those modes
    rng = np.random.default_rng(seed)
    hi = 10 if mode in ("snap_pre", "snap_post") else N_OPS
    kill_at = int(rng.integers(2, hi))

    _run_worker(seed, data_dir, ack_file, kill_at, mode, wal_sync,
                str(tmp_path / "modules.json"))
    acked = _max_acked(ack_file)

    if rnd % 2 == 0:
        # full serving-layer recovery (epoch wiring, health surface)
        sess = StreamSession(None, durable=data_dir, config=NUMPY_CFG)
        try:
            info = sess.recovery_info
            assert info is not None
            applied = _check_recovered(sess.table, info, seed, acked)
            health = sess.health()
            assert health["durable"] is True
            assert health["recovery"]["recovered"] is True
            assert health["recovery"]["replayed_records"] == \
                info["replayed_records"]
            # the recovered process keeps serving: mutate + query + sync
            sess.append(append_batch(seed ^ 0xA11CE))
            fut = sess.submit(random_tree(
                sess.table, 4, 2, np.random.default_rng(seed)))
            sess.drain()
            assert fut.result(timeout=30) is not None
            assert sess.sync() == sess.durability.wal.last_seq
            assert sess.durability.wal.uncommitted == 0
        finally:
            sess.close()
    else:
        dur, table, info = Durability.recover(data_dir)
        try:
            applied = _check_recovered(table, info, seed, acked)
        finally:
            dur.close()
        # recovery is re-entrant: a second recovery of the same (now
        # closed) directory lands on the identical state
        dur2, table2, info2 = Durability.recover(data_dir)
        try:
            assert info2["last_seq"] >= info["last_seq"]
            for name, col in table.columns.items():
                assert np.array_equal(table2.columns[name], col)
        finally:
            dur2.close()

    _SEEN.append((mode, wal_sync, applied, info.get("snapshot_seq", 0),
                  info.get("truncated_records", 0)))


def test_chaos_matrix_coverage():
    """Runs after the rounds: the matrix must have exercised every kill
    mechanism and both fsync policies, recovered from at least one
    snapshot, replayed at least one WAL tail, and truncated at least one
    torn record."""
    if len(_SEEN) < min(ROUNDS, len(MODES)):
        pytest.skip("rounds did not run (filtered?)")
    modes = {m for m, _, _, _, _ in _SEEN}
    syncs = {s for _, s, _, _, _ in _SEEN}
    assert modes == set(MODES), f"kill modes not all exercised: {modes}"
    assert syncs == {"group", "always"}
    assert any(a > 0 for _, _, a, _, _ in _SEEN), "no round applied records"
    assert any(sn > 0 for _, _, _, sn, _ in _SEEN), \
        "no round recovered from a snapshot"
    assert any(a > sn for _, _, a, sn, _ in _SEEN), \
        "no round replayed a WAL tail past its snapshot"
    assert any(t > 0 for _, _, _, _, t in _SEEN), \
        "no round truncated a torn record"
