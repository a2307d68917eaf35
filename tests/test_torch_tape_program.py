"""The port's whole-tape programs against the reference package, on the CPU.

An all-device tape runs as one ``_TapeProgram`` of the port's
``DeviceTapeBackend``: static buffers for the tape's constants, lookup
masks and zone rows, keyed like the reference's jitted whole-tape programs
(structure, pruning shape, runtime-input shapes) plus the identity of the
tensors a CUDA graph would read by address.  On ``device="cpu"`` the same
object runs the op loop eagerly over those buffers, so these tests reach
the keying and the buffer binding.  Every query is held bit for bit
against the reference's ``run_query(engine="tape")`` (a fresh reference
backend) and the numpy oracle: the result bitmap, the per-query deltas of
``Stats`` and of the block / sync / dispatch counters of the reused port
backend, and the drained per-op popcounts.
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

import repro.columnar as R
import repro.core as RC
import repro_torch.columnar as T
import repro_torch.columnar.device as port_device
import repro_torch.core as TC
from repro.kernels import ops as kops
from repro_torch.convert import table_from_arrays
from repro_torch.core.predicate import ZONE_ALL
from repro_torch.kernels import _build
from repro_torch.kernels import ref as tref
from repro_torch.kernels.bitmap_ops import bitmap_setop, bitmap_setop_plain
from repro_torch.kernels.fused_chain import (fused_chain_scan,
                                             fused_chain_scan_plain)
from repro_torch.kernels.predicate_scan import predicate_scan

BLOCK = 256
STATS = ("records_evaluated", "weighted_cost", "atom_applications", "setops")
COUNTERS = ("blocks_touched", "blocks_pruned", "records_touched",
            "host_syncs", "device_dispatches", "host_fallbacks")


def _snap(be):
    if be is None:
        return {f: 0 for f in STATS + COUNTERS}
    out = {f: getattr(be.stats, f) for f in STATS}
    out.update({f: getattr(be, f) for f in COUNTERS})
    return out


def _check(ref_table, port_table, rt, pt, pbe, **cfg):
    """Run ``pt`` on the reused port backend ``pbe`` (None: a new one) and
    ``rt`` on a fresh reference backend; hold result, counters and op log
    against each other and the oracles.  Returns the port backend."""
    cfg.setdefault("planner", "deepfish")
    cfg.setdefault("block", BLOCK)
    before = _snap(pbe)
    p_res, _, pbe = T.run_query(pt, port_table, backend=pbe,
                                config=T.ExecConfig(engine="tape",
                                                    device="cpu", **cfg))
    r_res, _, rbe = R.run_query(rt, ref_table,
                                config=R.ExecConfig(engine="tape", **cfg))
    o_res = T.run_query(pt, port_table, config=T.ExecConfig(
        engine="numpy", device="cpu", **cfg))[0]
    ro_res = R.run_query(rt, ref_table, config=R.ExecConfig(
        engine="numpy", **cfg))[0]
    np.testing.assert_array_equal(p_res, r_res)
    np.testing.assert_array_equal(p_res, o_res)
    np.testing.assert_array_equal(p_res, ro_res)
    after = _snap(pbe)
    want = _snap(rbe)
    for f in STATS + COUNTERS:
        assert after[f] - before[f] == want[f], f
    assert pbe.drain_op_log() == rbe.drain_op_log()
    return pbe


def _build_tree(mod, spec):
    kind, body = spec
    if kind in ("and", "or"):
        cls = mod.And if kind == "and" else mod.Or
        return cls([_build_tree(mod, c) for c in body])
    return mod.Atom(*body[0], **body[1])


def _both(spec):
    return (RC.normalize(_build_tree(RC, spec)),
            TC.normalize(_build_tree(TC, spec)))


def _atom(col, op, value, **kw):
    return ("atom", ((col, op, value), kw))


def _numeric_spec(table, shift):
    """A 6-atom tree whose constants sit at the selectivities ``gs +
    shift`` while the atoms keep the annotated ``gs``: the plan, and so the
    tape's structure, is the same for every ``shift``."""
    gs = {"elevation_0": 0.5, "slope_0": 0.3, "aspect_0": 0.4,
          "h_dist_road_0": 0.6, "hillshade_noon_0": 0.5, "h_dist_fire_0": 0.7}

    def num(col, op="lt"):
        v = table.value_at_selectivity(col, min(gs[col] + shift, 0.95))
        return _atom(col, op, float(v), selectivity=gs[col])
    return ("and", [num("elevation_0"),
                    ("or", [num("slope_0"), num("aspect_0"),
                            ("and", [num("h_dist_road_0"),
                                     num("hillshade_noon_0", "ge")])]),
                    num("h_dist_fire_0")])


def test_key_equal_numeric_tapes_share_one_program(forest):
    port_table = table_from_arrays(forest.columns)
    be = None
    tapes = []
    for shift in (0.0, 0.1, -0.2):
        rt, pt = _both(_numeric_spec(forest, shift))
        be = _check(forest, port_table, rt, pt, be)
        tapes.append(be.last_tape)
    assert tapes[0].key == tapes[1].key == tapes[2].key
    assert any(op.kind == "CHAIN" for op in tapes[0].ops)
    assert any(op.kind == "SETOP" for op in tapes[0].ops)
    assert be.tape_programs == 1 and len(be._programs) == 1
    assert be.graph_captures == be.graph_replays == 0      # no graph on CPU
    # the program's static constants are the last run's, rounded to f32
    (prog,) = be._programs.values()
    want = [np.float32(a.value) for op in tapes[2].costed_ops()
            for a in (tapes[2].tree.atoms[i] for i in op.aids)]
    assert prog.values.tolist() == [float(v) for v in want]


def _lookup_spec(districts, covers):
    """Scattered (fragmented) IN sets, left as dictionary lookups by the
    string rewrite, beside numeric atoms."""
    return ("or", [
        ("and", [_atom("cover_0", "in", covers, selectivity=0.4),
                 _atom("elevation_0", "lt", 2900.0, selectivity=0.5)]),
        ("and", [_atom("district_0", "in", districts, selectivity=0.3),
                 _atom("slope_0", "lt", 12.0, selectivity=0.6),
                 _atom("aspect_0", "gt", 100.0, selectivity=0.5)]),
    ])


def test_key_equal_lookup_tapes_share_one_program(string_forest):
    port_table = table_from_arrays(string_forest.columns)
    be = None
    # the rewrite annotates each lookup with its dictionary frequency:
    # these district sets keep the plan's order, so its structure
    covers = ("aspen", "cedar", "hemlock", "maple", "pine", "willow")
    keys = []
    for ids in ((1, 4, 7, 11, 15, 19, 22), (2, 5, 8, 12, 16, 20, 23)):
        districts = tuple(f"district_{i:02d}" for i in ids)
        rt, pt = _both(_lookup_spec(districts, covers))
        be = _check(string_forest, port_table, rt, pt, be)
        keys.append(be.last_tape.key)
        rewritten = T.rewrite_string_atoms(pt, port_table)
        assert any(a.op == "in" for a in rewritten.atoms)
    assert keys[0] == keys[1]
    assert be.tape_programs == 1
    (prog,) = be._programs.values()
    assert prog.lmasks is not None and prog.lmasks.shape[0] >= 1


def _zone_cols(n, seed, start=0.0):
    """A sorted timestamp (zone maps decide its blocks outright) and two
    unclustered columns."""
    rng = np.random.default_rng(seed)
    return {"ts": (start + np.sort(rng.uniform(0, 100, n))).astype(
                np.float32),
            "x": rng.normal(size=n).astype(np.float32),
            "y": rng.normal(size=n).astype(np.float32)}


def _zone_spec(hi):
    return ("and", [_atom("ts", "ge", hi, selectivity=0.2),
                    ("or", [_atom("x", "gt", 0.0, selectivity=0.5),
                            _atom("y", "lt", -0.5, selectivity=0.3)])])


def test_zone_rows_change_after_an_append_in_the_bucket():
    """An append inside the block bucket keeps the columns and ``full`` in
    place, so the program survives it; its zone rows are runtime inputs
    and turn the appended blocks from NONE (padding) to ALL."""
    cols = _zone_cols(3000, 0)
    ref_table = R.Table({k: v.copy() for k, v in cols.items()})
    port_table = table_from_arrays(cols)
    spec = _zone_spec(80.0)
    be = _check(ref_table, port_table, *_both(spec), None)
    assert be.blocks_pruned > 0
    (prog,) = be._programs.values()
    rows0 = prog.zrows.clone()
    nblocks, full_bits = be.nblocks, be.full().bits
    extra = _zone_cols(500, 1, start=100.0)
    ref_table.append({k: v.copy() for k, v in extra.items()})
    port_table.append({k: v.copy() for k, v in extra.items()})
    be.refresh()
    assert be.nblocks == nblocks and be.full().bits is full_bits
    _check(ref_table, port_table, *_both(spec), be)
    assert be.tape_programs == 1 and list(be._programs.values()) == [prog]
    assert not torch.equal(prog.zrows, rows0)
    real = (port_table.n_records + BLOCK - 1) // BLOCK
    assert (prog.zrows[0, 12:real] == ZONE_ALL).all()


def test_bucket_growth_on_refresh_drops_the_programs():
    cols = _zone_cols(3000, 2)
    ref_table = R.Table({k: v.copy() for k, v in cols.items()})
    port_table = table_from_arrays(cols)
    spec = _zone_spec(50.0)
    be = _check(ref_table, port_table, *_both(spec), None)
    old = next(iter(be._programs.values()))
    extra = _zone_cols(2000, 3, start=100.0)
    ref_table.append({k: v.copy() for k, v in extra.items()})
    port_table.append({k: v.copy() for k, v in extra.items()})
    be.refresh()
    assert be.nblocks == 32 and not be._programs
    _check(ref_table, port_table, *_both(spec), be)
    (prog,) = be._programs.values()
    assert prog is not old and be.tape_programs == 2
    assert all(c.shape[0] == 32 for c in prog.cols)
    assert prog.full.bits is be.full().bits


def _dict_cols(n, seed, values):
    rng = np.random.default_rng(seed)
    return {"s": np.asarray(values)[rng.integers(0, len(values), n)],
            "x": rng.normal(size=n).astype(np.float32),
            "y": rng.normal(size=n).astype(np.float32)}


def test_dictionary_growth_changes_u_and_the_program():
    """Appended values past 32 grow the dictionary's padded word count U:
    the lookup masks' shape is part of the key, so the tape gets a new
    program, and the result takes the new codes."""
    old_vals = [f"v{i:02d}" for i in range(30)]
    cols = _dict_cols(3000, 4, old_vals)
    ref_table = R.Table({k: v.copy() for k, v in cols.items()})
    port_table = table_from_arrays(cols)
    spec = ("and", [_atom("s", "in", tuple(f"v{i:02d}" for i in
                                            (1, 4, 7, 11, 15, 19, 22, 33,
                                             37)), selectivity=0.3),
                    ("or", [_atom("x", "gt", 0.0, selectivity=0.5),
                            _atom("y", "lt", 0.5, selectivity=0.7)])])
    be = _check(ref_table, port_table, *_both(spec), None)
    (prog0,) = be._programs.values()
    assert prog0.lmasks.shape[1] == 1
    extra = _dict_cols(600, 5, [f"v{i:02d}" for i in range(30, 40)])
    ref_table.append({k: v.copy() for k, v in extra.items()})
    port_table.append({k: v.copy() for k, v in extra.items()})
    be.refresh()
    assert port_table.dict_column("s").n == 40
    _check(ref_table, port_table, *_both(spec), be)
    assert be.tape_programs == 2
    prog1 = next(reversed(be._programs.values()))
    assert prog1 is not prog0 and prog1.lmasks.shape[1] == 2


def test_program_cache_is_lru_bounded(forest, monkeypatch):
    monkeypatch.setattr(port_device, "_TAPE_PROGRAM_CAP", 2)
    port_table = table_from_arrays(forest.columns)
    ref_trees = R.random_query_suite(forest, 3, 8, 2, seed=21)
    port_trees = T.random_query_suite(port_table, 3, 8, 2, seed=21)
    be = None
    keys = []
    for rt, pt in zip(ref_trees, port_trees):
        be = _check(forest, port_table, rt, pt, be)
        keys.append(be.last_tape.key)
    assert len(set(keys)) == 3
    assert be.tape_programs == 3 and len(be._programs) == 2
    be = _check(forest, port_table, ref_trees[2], port_trees[2], be)
    assert be.tape_programs == 3                 # the newest is kept
    be = _check(forest, port_table, ref_trees[0], port_trees[0], be)
    assert be.tape_programs == 4 and len(be._programs) == 2   # was dropped


def test_mixed_tape_makes_no_program(forest):
    port_table = table_from_arrays(forest.columns)
    fn = lambda v: np.abs(v - 2750.0) < 300.0  # noqa: E731
    spec = ("and", [_atom("slope_0", "lt", 15.0, selectivity=0.6),
                    ("or", [_atom("elevation_0", "udf", None, fn=fn,
                                  selectivity=0.5),
                            _atom("aspect_0", "gt", 300.0,
                                  selectivity=0.15)])])
    be = _check(forest, port_table, *_both(spec), None)
    assert be.host_fallbacks == 1 and be.host_syncs == 2
    assert be.tape_programs == 0 and not be._programs


@pytest.mark.parametrize("opcode", [0, 1, 2])
def test_bitmap_setop_takes_dead_row_pops(opcode):
    """The per-op K2's CPU path takes the input popcounts and ignores them
    (its plain version): with dead rows in either input it equals the
    reference's bitmap_setop (the Pallas kernel in interpret mode) and the
    rules by which the kernel skips dead rows."""
    rng = np.random.default_rng(60 + opcode)
    n, w = 8, 16
    a = rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint32)
    a[[0, 1, 4]] = 0
    b[[0, 2, 5]] = 0
    at = torch.from_numpy(a.view(np.int32))
    bt = torch.from_numpy(b.view(np.int32))
    ap, bp = tref.popcount_ref(at), tref.popcount_ref(bt)
    out, pops = bitmap_setop(at, bt, opcode, ap, bp)
    plain = bitmap_setop_plain(at, bt, opcode)
    assert torch.equal(out, plain[0]) and torch.equal(pops, plain[1])
    want, want_pops = kops.bitmap_op(a, b, opcode, interpret=True)
    np.testing.assert_array_equal(out.numpy().view(np.uint32),
                                  np.asarray(want))
    np.testing.assert_array_equal(pops.numpy(),
                                  np.asarray(want_pops).reshape(-1))
    read_a = (ap > 0) & (bp > 0) if opcode == 0 else ap > 0
    read_b = bp > 0 if opcode == 1 else (ap > 0) & (bp > 0)
    x = torch.where(read_a[:, None], at, 0)
    y = torch.where(read_b[:, None], bt, 0)
    assert torch.equal(out, (x & y, x | y, x & ~y)[opcode])


def test_plain_versions_take_device_constants():
    """The value-pointer form the program uses (an f32 tensor of
    constants) gives the plain versions' results for host constants."""
    rng = np.random.default_rng(70)
    n, b = 3, 256
    cols = [torch.from_numpy(rng.normal(size=(n, b)).astype(np.float32))
            for _ in range(9)]
    bits = torch.from_numpy(rng.integers(0, 2 ** 32, size=(n, b // 32),
                                         dtype=np.uint32).view(np.int32))
    pops = tref.popcount_ref(bits)
    vals = [0.1, -0.2, float("nan"), 0.7, 1e-45, 0.0, -1.0, 0.3, 0.05]
    dvals = torch.tensor(vals, dtype=torch.float32)
    for op in range(6):
        for j, v in enumerate(vals):
            got = predicate_scan(cols[0], bits, pops, dvals[j], op)
            want = predicate_scan(cols[0], bits, pops, v, op)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])
    ops = [j % 6 for j in range(9)]
    for k in (3, 9):
        for conj in (True, False):
            got = fused_chain_scan(cols[:k], bits, pops, dvals[:k], ops[:k],
                                   conj, table=None)
            want = fused_chain_scan_plain(cols[:k], bits, pops, vals[:k],
                                          ops[:k], conj)
            assert torch.equal(got[0], want[0])
            assert torch.equal(got[1], want[1])


def test_capture_launch_counts_move_to_the_replays():
    """A capture's wrapper counts are taken back out and each replay adds
    them, so LAUNCHES counts what ran."""
    before = dict(_build.LAUNCHES)
    _build.count_launch("bitmap_setop")
    _build.count_launch("bitmap_setop")
    _build.count_launch("predicate_scan")
    delta = _build.take_launches(before)
    assert delta == {"bitmap_setop": 2, "predicate_scan": 1}
    assert _build.LAUNCHES == before
    for _ in range(3):
        _build.add_launches(delta)
    assert _build.LAUNCHES["bitmap_setop"] == before["bitmap_setop"] + 6
    assert _build.LAUNCHES["predicate_scan"] == before["predicate_scan"] + 3
    _build.LAUNCHES.update(before)
