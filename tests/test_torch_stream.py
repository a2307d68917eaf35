"""The port's ``StreamSession`` against the reference's, on the CPU.

Both sessions take the same numpy-seeded table, queries and interleaved
appends; the port runs its default lockstep tape engine on ``device="cpu"``
(the kernels' plain versions).  Every drain must resolve the same bitmaps
with one host sync, and the delta path (tail-block refresh, cached atoms
spliced with the appended rows) must count the same.  An injected
``DeviceFault`` must walk the degradation ladder exactly as in the
reference, and the port's fault classifier must recognise CUDA runtime
errors.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

import repro.columnar as R
import repro.runtime.faults as RF
import repro_torch.columnar as T
import repro_torch.runtime.faults as TF
from repro_torch.convert import table_from_arrays

BLOCK = 1024
#: StreamStats fields the two sessions must agree on
STREAM_FIELDS = ("submitted", "completed", "batches", "appends",
                 "appended_rows", "max_batch", "retries", "degraded_batches",
                 "quarantined_queries", "failed", "atoms_delta_extended",
                 "delta_rows_evaluated", "delta_rows_reused", "upload_bytes",
                 "tape_cache_hits", "feedback_observations",
                 "drift_evictions", "max_qerror", "delta_reuse_ratio")


@pytest.fixture(autouse=True)
def _clean_planes():
    RF.fault_plane().clear()
    TF.fault_plane().clear()
    yield
    RF.fault_plane().clear()
    TF.fault_plane().clear()


def _streams(ref_table, port_table, **kw):
    ref = R.StreamSession(ref_table, config=R.StreamSession.DEFAULT_CONFIG
                          .replace(block=BLOCK), **kw)
    port = T.StreamSession(port_table, config=T.StreamSession.DEFAULT_CONFIG
                           .replace(block=BLOCK, device="cpu"), **kw)
    return ref, port


def _tables(n=8000, strings=True):
    ref = R.make_forest_table(n, n_dup=1, seed=7, strings=strings)
    return ref, table_from_arrays(ref.columns)


def _queries(ref_table, port_table, n, seed, n_templates=4):
    rt = R.random_query_suite(ref_table, n_templates, 8, 3, seed=seed)
    pt = T.random_query_suite(port_table, n_templates, 8, 3, seed=seed)
    pick = np.random.default_rng(seed).integers(0, n_templates, size=n)
    return [rt[i] for i in pick], [pt[i] for i in pick]


def _append_both(rs, ps, ref_table, n, seed):
    extra = R.make_forest_table(n, n_dup=1, seed=seed,
                                strings="cover_0" in ref_table.columns)
    rows = {k: extra.columns[k] for k in ref_table.columns}
    rs.append(rows)
    ps.append({k: v.copy() for k, v in rows.items()})


def _drain_both(rs, ps, rq, pq):
    rf = [rs.submit(q) for q in rq]
    pf = [ps.submit(q) for q in pq]
    a, b = rs.drain(), ps.drain()
    for x, y in zip(rf, pf):
        assert np.array_equal(y.result(), x.result())
        assert y.n_records == x.n_records
    return a, b


def _same_stats(rs, ps):
    r, p = rs.stats.as_dict(), ps.stats.as_dict()
    for f in STREAM_FIELDS:
        assert p[f] == r[f], f


@pytest.mark.parametrize("strings", [False, True])
def test_stream_with_interleaved_appends_matches_reference(strings):
    ref_table, port_table = _tables(strings=strings)
    rs, ps = _streams(ref_table, port_table)
    rq, pq = _queries(ref_table, port_table, 12, seed=1)
    be = None
    for rnd in range(4):
        if rnd:
            _append_both(rs, ps, ref_table, 600 * rnd, seed=10 + rnd)
        a, b = _drain_both(rs, ps, rq, pq)
        assert b.stats.host_syncs == a.stats.host_syncs == 1
        assert b.stats.op_observations == a.stats.op_observations
        assert b.stats.upload_bytes == a.stats.upload_bytes
        assert b.stats.records_evaluated == a.stats.records_evaluated
        if rnd:
            assert b.stats.atoms_delta_extended > 0
            assert b.stats.delta_reuse_ratio == a.stats.delta_reuse_ratio
            assert b.backend is be               # refreshed in place
        be = b.backend
    _same_stats(rs, ps)
    assert ps.stats.degraded_batches == 0 and ps.stats.retries == 0
    assert ps.session.config.device == "cpu"


def test_device_fault_mid_drain_degrades_like_reference():
    ref_table, port_table = _tables(6000, strings=False)
    rs, ps = _streams(ref_table, port_table)
    rq, pq = _queries(ref_table, port_table, 8, seed=2)
    _drain_both(rs, ps, rq, pq)
    RF.fault_plane().arm("device.dispatch", exc=RF.DeviceFault, times=1)
    TF.fault_plane().arm("device.dispatch", exc=TF.DeviceFault, times=1)
    a, b = _drain_both(rs, ps, rq, pq)
    assert ps.stats.degraded_batches == rs.stats.degraded_batches == 1
    # the degraded batch ran on the host fallback session, on the CPU
    assert b.backend.__class__.__name__ == "BitmapBackend"
    assert ps._fallback_session.config.device == "cpu"
    assert ps._fallback_session.config.engine == "numpy"
    # the next drain retries (and succeeds on) the device path
    a, b = _drain_both(rs, ps, rq, pq)
    assert b.backend.__class__.__name__ == "DeviceTapeBackend"
    assert b.stats.host_syncs == 1
    _same_stats(rs, ps)
    assert ps.stats.quarantined_queries == 0 and ps.stats.failed == 0


def test_upload_fault_on_append_refresh_degrades_like_reference():
    ref_table, port_table = _tables(6000, strings=False)
    rs, ps = _streams(ref_table, port_table)
    rq, pq = _queries(ref_table, port_table, 6, seed=3)
    _drain_both(rs, ps, rq, pq)
    _append_both(rs, ps, ref_table, 900, seed=21)
    RF.fault_plane().arm("device.upload", exc=RF.DeviceFault, times=1)
    TF.fault_plane().arm("device.upload", exc=TF.DeviceFault, times=1)
    _drain_both(rs, ps, rq, pq)
    assert ps.stats.degraded_batches == rs.stats.degraded_batches == 1
    assert port_table.n_records == 6900
    _drain_both(rs, ps, rq, pq)
    _same_stats(rs, ps)


def test_transient_faults_retry_in_place_like_reference():
    ref_table, port_table = _tables(6000, strings=False)
    rs, ps = _streams(ref_table, port_table, retry_backoff_s=0.001)
    rq, pq = _queries(ref_table, port_table, 6, seed=4)
    _drain_both(rs, ps, rq, pq)
    RF.fault_plane().arm("device.dispatch", exc=RF.TransientFault, times=2)
    TF.fault_plane().arm("device.dispatch", exc=TF.TransientFault, times=2)
    _drain_both(rs, ps, rq, pq)
    assert ps.stats.retries == rs.stats.retries == 2
    assert ps.stats.degraded_batches == 0
    _same_stats(rs, ps)


def test_cuda_runtime_errors_are_device_faults():
    assert TF.is_device_fault(TF.DeviceFault("injected"))
    assert TF.is_device_fault(TF.TransientFault("injected"))
    assert TF.is_device_fault(torch.cuda.OutOfMemoryError(
        "CUDA out of memory. Tried to allocate 2.00 GiB"))
    assert TF.is_device_fault(RuntimeError(
        "CUDA error: an illegal memory access was encountered"))
    assert TF.is_device_fault(torch.AcceleratorError(
        "CUDA error: unspecified launch failure"))
    assert TF.is_device_fault(RuntimeError(
        "CUDA error 700: kernel predicate_scan failed to launch"))
    assert not TF.is_device_fault(RuntimeError("shape mismatch"))
    assert not TF.is_device_fault(ValueError("CUDA error in a value"))
    assert not TF.is_device_fault(KeyError("x"))


def test_a_cuda_error_mid_drain_degrades_to_the_host():
    """A real CUDA runtime error (not the injected fault type) takes the
    same rung of the ladder: the batch re-runs on the host fallback."""
    ref_table, port_table = _tables(6000, strings=False)
    _, ps = _streams(ref_table, port_table)
    _, pq = _queries(ref_table, port_table, 4, seed=5)
    want = [f.result() for f in [ps.submit(q) for q in pq]]
    TF.fault_plane().arm("device.dispatch", exc=lambda: RuntimeError(
        "CUDA error: an illegal memory access was encountered"), times=1)
    futs = [ps.submit(q) for q in pq]
    ps.drain()
    for f, w in zip(futs, want):
        assert np.array_equal(f.result(), w)
    assert ps.stats.degraded_batches == 1
    assert ps.stats.quarantined_queries == 0


def test_non_durable_session_members_match_reference():
    """durability, sync() and flush_caches() of a non-durable session
    without a cache_dir give the reference's results (all None), before
    and after a drain and after close."""
    ref_table, port_table = _tables(2000, strings=False)
    rs, ps = _streams(ref_table, port_table)
    rq, pq = _queries(ref_table, port_table, 4, seed=3)
    for when in ("fresh", "drained", "closed"):
        if when == "drained":
            _drain_both(rs, ps, rq, pq)
        elif when == "closed":
            rs.close()
            ps.close()
        for member in ("sync", "flush_caches"):
            want = getattr(rs, member)()
            assert want is None
            assert getattr(ps, member)() is want
        assert rs.durability is None and ps.durability is None


def test_stream_deletes_match_reference():
    """Deletes between drains of the default StreamSession, on a
    6,000-row Forest table through delete, append, delete and compact:
    every drain resolves the reference's bitmaps with the same batch
    counters and op_observations, and the stream stats agree."""
    ref_table, port_table = _tables(6000, strings=False)
    extra = R.make_forest_table(3000, n_dup=1, seed=9)
    rs, ps = _streams(ref_table, port_table)
    rq, pq = _queries(ref_table, port_table, 10, seed=4)
    steps = [lambda s: s.delete(np.arange(100, 1600)),
             lambda s: s.append({k: v[:1500].copy()
                                 for k, v in extra.columns.items()}),
             lambda s: s.delete(np.arange(5200, 5900)),
             lambda s: s.compact()]
    for step in [None] + steps:
        if step is not None:
            assert step(ps) == step(rs)
        a, b = _drain_both(rs, ps, rq, pq)
        assert b.stats.host_syncs == a.stats.host_syncs == 1
        assert b.stats.op_observations == a.stats.op_observations
        assert b.stats.records_evaluated == a.stats.records_evaluated
        assert b.stats.device_dispatches == a.stats.device_dispatches
        assert b.stats.blocks_touched == a.stats.blocks_touched
    _same_stats(rs, ps)
    assert port_table.n_deleted == ref_table.n_deleted == 0
    assert ps.stats.degraded_batches == 0


def _durable_streams(ref_table, port_table, tmp_path, **kw):
    ref = R.StreamSession(ref_table, config=R.StreamSession.DEFAULT_CONFIG
                          .replace(block=BLOCK),
                          durable=str(tmp_path / "ref"), **kw)
    port = T.StreamSession(port_table, config=T.StreamSession.DEFAULT_CONFIG
                           .replace(block=BLOCK, device="cpu"),
                           durable=str(tmp_path / "port"), **kw)
    return ref, port


def test_durable_sessions_match_reference(tmp_path):
    """One schedule of appends, deletes, drains and explicit syncs through
    a durable session of each package (the default stream engine, the
    port on the CPU): every sync() returns the reference's committed
    sequence, health()["wal"] and health()["recovery"] agree after each
    step and each drain, and so do a restart's recovery counters (the
    wall time and the data epoch aside) and its drains."""
    ref_table, port_table = _tables(4000, strings=True)
    rs, ps = _durable_streams(ref_table, port_table, tmp_path,
                              snapshot_every=4)
    rq, pq = _queries(ref_table, port_table, 8, seed=6)
    extra = R.make_forest_table(900, n_dup=1, seed=12, strings=True)

    def same_health(a, b):
        ha, hb = a.health(), b.health()
        assert hb["durable"] is ha["durable"] is True
        assert hb["wal"] == ha["wal"]
        assert hb["recovery"].keys() == ha["recovery"].keys()
        for k, v in ha["recovery"].items():
            if k != "recovery_ms":
                assert hb["recovery"][k] == v, k

    steps = [lambda s: s.append({k: v[:300].copy()
                                 for k, v in extra.columns.items()}),
             lambda s: s.sync(),
             lambda s: s.delete(np.arange(50, 400)),
             lambda s: s.append({k: v[300:].copy()
                                 for k, v in extra.columns.items()}),
             lambda s: s.sync(),
             lambda s: s.compact()]
    for step in steps:
        assert step(ps) == step(rs)
        same_health(rs, ps)
        _drain_both(rs, ps, rq, pq)
        same_health(rs, ps)
    assert ps.sync() == rs.sync() == ps.durability.wal.last_seq
    assert ps.durability.snapshots == rs.durability.snapshots > 0
    _same_stats(rs, ps)
    rs.close()
    ps.close()

    rs2, ps2 = _durable_streams(None, None, tmp_path)
    for k, v in rs2.recovery_info.items():
        if k not in ("recovery_ms", "epoch"):
            assert ps2.recovery_info[k] == v, k
    same_health(rs2, ps2)
    _drain_both(rs2, ps2, rq, pq)
    same_health(rs2, ps2)
    rs2.close()
    ps2.close()
