"""Deferred set operations in the port's ``DeviceTapeBackend``, on the CPU.

``inter`` / ``union`` / ``diff`` queue their operation and return the
output set at once; the queue is flushed, one grouped launch per
dependency level (``bitmap_setop_grouped``, whose plain version runs on
CPU tensors), when a method reads a pending set.  A lockstep batch must
keep the reference's counters while its grouped launches stay few; a
pending set's inputs must outlive the flush; and no reader may read a
pending set before the flush.
"""
import gc
import weakref

import pytest

torch = pytest.importorskip("torch")

import numpy as np

import repro.columnar as R
import repro_torch.columnar as T
import repro_torch.core as TC
import repro_torch.columnar.device as port_device
from repro_torch.columnar.device import DeviceTapeBackend
from repro_torch.convert import table_from_arrays

BLOCK = 1024


def _atom(table, col, g, op="lt"):
    return TC.Atom(col, op, table.value_at_selectivity(col, g),
                   selectivity=g)


def _host(table, atom):
    return table.eval_atom(atom, None)


def _pack(mask):
    from repro_torch.columnar.bitmap import pack_bits
    return pack_bits(mask)


@pytest.fixture
def grouped_calls(monkeypatch):
    """The levels of every grouped call the backend makes."""
    calls = []
    fn = port_device.bitmap_setop_grouped

    def spy(levels):
        calls.append([len(lv) for lv in levels])
        return fn(levels)
    monkeypatch.setattr(port_device, "bitmap_setop_grouped", spy)
    return calls


def test_lockstep_batch_groups_its_set_operations(forest, grouped_calls):
    """A 12-query lockstep batch: at most one grouped launch per ten set
    operations, while device_dispatches equals the reference session's
    and the bitmaps equal its bitmaps."""
    port_table = table_from_arrays(forest.columns)
    pick = np.random.default_rng(1).integers(0, 4, size=12)
    rtrees = R.random_query_suite(forest, 4, 10, 3, seed=0)
    ptrees = T.random_query_suite(port_table, 4, 10, 3, seed=0)
    cfg = dict(planner="deepfish", engine="tape", batched=True, block=BLOCK)
    rs = R.QuerySession(forest, config=R.ExecConfig(**cfg))
    ps = T.QuerySession(port_table, config=T.ExecConfig(device="cpu", **cfg))
    want = rs.execute([rtrees[i] for i in pick])
    got = ps.execute([ptrees[i] for i in pick])
    for r, p in zip(want.bitmaps, got.bitmaps):
        assert np.array_equal(p, r)
    assert got.stats.device_dispatches == want.stats.device_dispatches
    be = got.backend
    assert be.stats.setops > 0
    assert be.setops_deferred > 0
    assert 0 < be.setop_launches <= be.stats.setops / 10
    assert be.setop_launches == sum(len(c) for c in grouped_calls)
    assert be.setop_flushes == len(grouped_calls)
    assert be.setop_level_max == max(max(c) for c in grouped_calls)
    assert be.setops_deferred == sum(sum(c) for c in grouped_calls)
    assert not be._setop_queue and not be._pending


def test_inputs_dropped_before_the_flush_stay_alive(forest):
    """A set whose inputs Python has dropped still comes out right: the
    queue holds the inputs' tensors until the flush, and lets go after."""
    port_table = table_from_arrays(forest.columns)
    be = DeviceTapeBackend(port_table, block=BLOCK, device="cpu")
    x, y = _atom(port_table, "elevation_0", 0.5), _atom(port_table,
                                                        "slope_0", 0.4)
    a = be.apply_atom(x, be.full())
    b = be.apply_atom(y, be.full())
    u = be.union(a, b)
    c = be.diff(u, b)                      # level 2: reads a pending set
    refs = [weakref.ref(t) for t in (a.bits, a.pops, b.bits, b.pops,
                                     u.bits, u.pops)]
    del a, b, u
    gc.collect()
    assert all(r() is not None for r in refs)
    assert [lv for lv, _ in be._setop_queue] == [1, 2]
    got = be.materialize([c])[0]
    gc.collect()
    assert all(r() is None for r in refs)
    hx, hy = _host(port_table, x), _host(port_table, y)
    assert np.array_equal(got, _pack(hx & ~hy))


def _poisoned_pending(be, table):
    """(settled sets s1, s2, a pending s1 | s2 whose output memory holds
    garbage a premature read would see, an unrelated pending op, the host
    masks of s1 and s2)."""
    x, y = _atom(table, "elevation_0", 0.5), _atom(table, "aspect_0", 0.3)
    s1 = be.apply_atom(x, be.full())
    s2 = be.apply_atom(y, be.full())
    pending = be.union(s1, s2)
    other = be.inter(s1, s2)
    pending.bits.fill_(0)
    pending.pops.fill_(12345)
    assert id(pending.bits) in be._pending
    return s1, s2, pending, other, _host(table, x), _host(table, y)


READERS = ["count", "extend_set", "materialize", "apply_atom",
           "apply_atom_multi", "inter_multi"]


@pytest.mark.parametrize("reader", READERS)
def test_readers_flush_before_reading_a_pending_set(forest, reader):
    """Each reader of a pending set flushes the queue first: its answer is
    the flushed set's, never the output memory's earlier contents."""
    port_table = table_from_arrays(forest.columns)
    be = DeviceTapeBackend(port_table, block=BLOCK, device="cpu")
    s1, s2, pending, other, h1, h2 = _poisoned_pending(be, port_table)
    z = _atom(port_table, "h_dist_road_0", 0.6)
    hz = _host(port_table, z)
    union = h1 | h2
    if reader == "count":
        assert be.count(pending) == float(union.sum())
    elif reader == "extend_set":
        ext = be.extend_set(pending, port_table.n_records,
                            np.zeros(0, dtype=bool))
        assert np.array_equal(be.materialize([ext])[0], _pack(union))
    elif reader == "materialize":
        assert np.array_equal(be.materialize([pending])[0], _pack(union))
    elif reader == "apply_atom":
        out = be.apply_atom(z, pending)
        assert np.array_equal(be.materialize([out])[0], _pack(union & hz))
    elif reader == "apply_atom_multi":
        outs = be.apply_atom_multi(z, [pending, s1])
        got = be.materialize(outs)
        assert np.array_equal(got[0], _pack(union & hz))
        assert np.array_equal(got[1], _pack(h1 & hz))
    else:
        outs = be.inter_multi(s2, [pending, s1])
        got = be.materialize(outs)
        assert np.array_equal(got[0], _pack(union & h2))
        assert np.array_equal(got[1], _pack(h1 & h2))
    assert not be._setop_queue and be.setop_flushes >= 1
    assert np.array_equal(be.materialize([other])[0], _pack(h1 & h2))


def test_readers_of_settled_sets_leave_the_queue(forest):
    """A reader whose own inputs are settled does not flush pending work."""
    port_table = table_from_arrays(forest.columns)
    be = DeviceTapeBackend(port_table, block=BLOCK, device="cpu")
    s1, s2, pending, _, h1, h2 = _poisoned_pending(be, port_table)
    z = _atom(port_table, "h_dist_road_0", 0.6)
    assert be.count(s1) == float(h1.sum())
    be.apply_atom(z, s1)
    be.apply_atom_multi(z, [s1, s2])
    be.inter_multi(s1, [s2, s1])
    assert len(be._setop_queue) == 2 and be.setop_flushes == 0
    assert be.materialize([pending])[0] is not None
    assert be.setop_flushes == 1 and be.setop_launches == 1
