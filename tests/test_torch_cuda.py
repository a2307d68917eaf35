"""The port's CUDA kernels on the card: each against its plain PyTorch
version (exact), and the tape and per-step block engines on the card
against the same engines on the CPU.  Marked ``cuda``; every test skips without a GPU.  This file
imports neither JAX nor the reference package, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda \
        tests/test_torch_cuda.py

(``--noconftest``: ``tests/conftest.py`` imports the reference package.)
"""
from collections import Counter

import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch import ExecConfig, make_forest_table, random_query_suite, run_query
import repro_torch.columnar.device as port_device
from repro_torch.columnar.device import DeviceTapeBackend
from repro_torch.core import And, Atom, Or, normalize
from repro_torch.kernels import LAUNCHES, LAUNCHES_BY_Q, ref, reset_launches
from repro_torch.kernels.bitmap_ops import (SetOp, bitmap_inter_multi,
                                            bitmap_inter_multi_plain,
                                            bitmap_setop,
                                            bitmap_setop_grouped,
                                            bitmap_setop_plain,
                                            bitmap_union_reduce,
                                            bitmap_union_reduce_plain)
from repro_torch.kernels.dict_lookup import (dict_lookup_scan,
                                             dict_lookup_scan_multi,
                                             dict_lookup_scan_multi_plain,
                                             dict_lookup_scan_plain)
from repro_torch.kernels.fused_chain import (fused_chain_scan,
                                             fused_chain_scan_plain,
                                             fused_chain_table)
from repro_torch.kernels.predicate_scan import (predicate_scan,
                                                predicate_scan_multi,
                                                predicate_scan_multi_plain,
                                                predicate_scan_plain)

# W = 1, 3 and 9 (the last three) take the stacked kernels' 4-byte row
# loads and end a warp's 32 words inside a group of 4
SHAPES = [(1, 256), (3, 1024), (4, 8192), (7, 2048), (1024, 8192), (2, 32),
          (3, 96), (5, 288)]

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU: the CUDA kernels run only there")
    return torch.device("cuda", torch.cuda.current_device())


def _equal(got, want):
    for g, w in zip(got, want):
        assert torch.equal(g.cpu(), w.cpu())


def _inputs(rng, n, b, dev):
    w = b // 32
    col = rng.normal(size=(n, b)).astype(np.float32)
    col.reshape(-1)[:4] = [np.nan, 1e-45, -0.0, np.inf]   # NaN, denormal
    bits = rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint32)
    bits[:, 0] |= np.uint32(1 << 31)
    bits[:, 2::7] = 0                    # zero words inside groups of 4
    if n > 1:
        bits[1] = 0                                      # a dead block
    bits = torch.from_numpy(bits.view(np.int32)).to(dev)
    pops = ref.popcount_ref(bits)
    if n > 2:
        pops[2] = 0                         # masked block with bits set
    return torch.from_numpy(col).to(dev), bits, pops


@pytest.mark.parametrize("n,b", SHAPES)
def test_cuda_kernels_match_plain(cuda_device, n, b):
    dev = cuda_device
    rng = np.random.default_rng(n + b)
    col, bits, pops = _inputs(rng, n, b, dev)
    before = dict(LAUNCHES)
    for op in range(6):
        for v in (0.0, 1e-45, 0.3):
            _equal(predicate_scan(col, bits, pops, v, op),
                   predicate_scan_plain(col, bits, pops, v, op))
    other = bits.flip(0).contiguous()
    exact, other_pops = ref.popcount_ref(bits), ref.popcount_ref(other)
    for op in range(3):
        _equal(bitmap_setop(bits, other, op, exact, other_pops),
               bitmap_setop_plain(bits, other, op))
    cols = [torch.from_numpy(rng.normal(size=(n, b)).astype(np.float32))
            .to(dev) for _ in range(5)]
    for k in (2, 3, 5):
        for conj in (True, False):
            vals = [float(x) for x in rng.normal(size=k)]
            ops = [int(x) for x in rng.integers(0, 6, size=k)]
            _equal(fused_chain_scan(cols[:k], bits, pops, vals, ops, conj),
                   fused_chain_scan_plain(cols[:k], bits, pops, vals, ops,
                                          conj))
    for u in (1, 2, 64):
        codes = rng.integers(-40, 32 * u + 40, size=(n, b)).astype(np.float32)
        codes.reshape(-1)[:3] = [np.nan, -0.5, 3.75]
        codes = torch.from_numpy(codes).to(dev)
        mask = torch.from_numpy(rng.integers(0, 2 ** 32, size=u,
                                             dtype=np.uint32)
                                .view(np.int32)).to(dev)
        _equal(dict_lookup_scan(codes, bits, pops, mask),
               dict_lookup_scan_plain(codes, bits, pops, mask))
    torch.cuda.synchronize()
    assert LAUNCHES["predicate_scan"] == before["predicate_scan"] + 18
    assert LAUNCHES["bitmap_setop"] == before["bitmap_setop"] + 3
    assert LAUNCHES["fused_chain_scan"] == before["fused_chain_scan"] + 6
    assert LAUNCHES["dict_lookup_scan"] == before["dict_lookup_scan"] + 3


# codes at the ends of the f32 -> int32 conversion (NaN is code 0; the
# rest saturate, or truncate toward zero)
EDGE_CODES = [np.nan, -0.5, 3.75, np.inf, -np.inf, 1e10, -1e10, 2.0 ** 31,
              31.9, -0.9]


def _lookup(rng, n, b, u, dev):
    """A code column with misses on both sides of [0, 32*U), EDGE_CODES at
    the start of block 0 and of the last block, and a mask of U words
    that holds code 0."""
    codes = rng.integers(-40, 32 * u + 40, size=(n, b)).astype(np.float32)
    codes[0, :len(EDGE_CODES)] = EDGE_CODES
    codes[-1, :len(EDGE_CODES)] = EDGE_CODES
    mask = rng.integers(0, 2 ** 32, size=u, dtype=np.uint32)
    mask[0] |= np.uint32(1)
    return (torch.from_numpy(codes).to(dev),
            torch.from_numpy(mask.view(np.int32)).to(dev))


@pytest.mark.parametrize("w", [1, 5, 8, 256])
@pytest.mark.parametrize("u", [1, 2, 64, 16384])
def test_cuda_dict_lookup_matches_plain(cuda_device, w, u):
    """K4 at W = 1, 5, 8 and 256 words a block and U = 1, 2, 64 and 16384
    mask words (16384 words are past the 48 KiB of shared memory: the
    mask is read from global memory), on the conversion's edge cases,
    with a dead block, a masked block (bits set, popcount 0), zero words
    and an all-ones word; and a column of dead blocks only."""
    dev = cuda_device
    rng = np.random.default_rng(w * 100 + u)
    n, b = 7, 32 * w
    _, bits, pops = _inputs(rng, n, b, dev)
    bits[0, 0] = -1                              # under the edge codes
    bits[n - 1, 0] = -1
    pops = torch.where(pops > 0, ref.popcount_ref(bits), 0)
    codes, mask = _lookup(rng, n, b, u, dev)
    before = LAUNCHES["dict_lookup_scan"]
    _equal(dict_lookup_scan(codes, bits, pops, mask),
           dict_lookup_scan_plain(codes, bits, pops, mask))
    zero = torch.zeros_like(pops)
    _equal(dict_lookup_scan(codes, bits, zero, mask),
           dict_lookup_scan_plain(codes, bits, zero, mask))
    torch.cuda.synchronize()
    assert LAUNCHES["dict_lookup_scan"] == before + 2


@pytest.mark.parametrize("q", [1, 3, 8, 65, 129])
@pytest.mark.parametrize("w", [1, 5, 256])
def test_cuda_dict_lookup_multi_matches_plain(cuda_device, q, w):
    """K6 at Q = 1, 3, 8, 65 and 129 and W = 1, 5 and 256, U = 1, 64 and
    16384 (past the shared memory: the mask read from global memory), on
    the conversion's edge cases, dead and masked rows, a block dead in
    every row, zero words; one launch per call."""
    dev = cuda_device
    rng = np.random.default_rng(q * 10 + w)
    n, b = 5, 32 * w
    bits, pops = _stacked(rng, q, n, w, dev)
    bits[0] = -1                           # set 0, block 0: every bit
    pops[0] = 32 * w
    for u in (1, 64, 16384):
        codes, mask = _lookup(rng, n, b, u, dev)
        before = LAUNCHES["dict_lookup_scan_multi"]
        _equal(dict_lookup_scan_multi(codes, bits, pops, mask),
               dict_lookup_scan_multi_plain(codes, bits, pops, mask))
        assert LAUNCHES["dict_lookup_scan_multi"] == before + 1
    torch.cuda.synchronize()


def _stacked(rng, q, n, w, dev):
    """Q stacked bitmaps i32[Q*N, W] with dead rows (all-zero bits), masked
    rows (bits set, popcount given as 0), zero words, one block dead in
    every row and one live in one row only."""
    bits = rng.integers(0, 2 ** 32, size=(q, n, w), dtype=np.uint32)
    bits[:, :, 0] |= np.uint32(1 << 31)
    bits[:, :, 2::5] = 0                                 # zero words
    bits[q // 2, 0] = 0                                  # a dead row
    if n > 1:
        bits[:, n - 1] = 0                               # dead in every row
    if n > 2:
        bits[:q - 1, 1] = 0                              # live in one row
    bits = torch.from_numpy(bits.reshape(q * n, w).view(np.int32)).to(dev)
    pops = ref.popcount_ref(bits)
    pops[q * n // 3] = 0                                 # a masked row
    return bits, pops


def _at_offset(x):
    """A contiguous copy of ``x`` that starts 4 bytes past a 16-byte
    boundary (as a view into a larger buffer)."""
    flat = torch.empty(x.numel() + 1, dtype=x.dtype, device=x.device)
    flat[1:] = x.reshape(-1)
    return flat[1:].view(x.shape)


def _set_rows(stack, pops, unaligned):
    """The Q sets of ``stack`` as (bits, exact pops) pairs, each a view of
    the stack, or with ``unaligned`` every other set a copy at an offset
    that is not 16-byte aligned."""
    return [(_at_offset(stack[j]) if unaligned and j % 2 else stack[j],
             pops[j]) for j in range(stack.shape[0])]


@pytest.mark.parametrize("n,b,q", [
    (n, b, q) for n, b in ((1, 256), (3, 1024), (7, 2048), (2, 32), (3, 96),
                           (5, 288))
    for q in (1, 2, 8, 65)] + [(1024, 8192, 1), (1024, 8192, 8),
                               (3, 96, 130), (7, 2048, 130)])
def test_cuda_stacked_kernels_match_plain(cuda_device, n, b, q):
    """K5 and K6 on Q stacked sets, and the stacked set operations on Q
    sets passed by pointer: views of one stack or copies at unaligned
    offsets, dead sets and blocks, a block of ``a`` dead, and Q above the
    128 rows one launch takes (two launches)."""
    dev = cuda_device
    rng = np.random.default_rng(q * 1000 + n + b)
    w = b // 32
    col, _, _ = _inputs(rng, n, b, dev)
    bits, pops = _stacked(rng, q, n, w, dev)
    before = dict(LAUNCHES)
    before_q = {k: dict(v) for k, v in LAUNCHES_BY_Q.items()}
    for op in range(6):
        for v in (0.0, 1e-45, 0.3, float("nan")):
            _equal(predicate_scan_multi(col, bits, pops, v, op),
                   predicate_scan_multi_plain(col, bits, pops, v, op))
    for u in (1, 2, 64):
        codes = rng.integers(-40, 32 * u + 40, size=(n, b)).astype(np.float32)
        codes.reshape(-1)[:3] = [np.nan, -0.5, 3.75]
        codes = torch.from_numpy(codes).to(dev)
        mask = torch.from_numpy(rng.integers(0, 2 ** 32, size=u,
                                             dtype=np.uint32)
                                .view(np.int32)).to(dev)
        _equal(dict_lookup_scan_multi(codes, bits, pops, mask),
               dict_lookup_scan_multi_plain(codes, bits, pops, mask))
    stack = bits.reshape(q, n, w)
    exact = ref.popcount_ref(stack)
    a = stack[0].flip(0).contiguous()
    if n > 1:
        a[n // 2] = 0                                    # a dead block of a
    a_pops = ref.popcount_ref(a)
    for unaligned in (False, True):
        rows = _set_rows(stack, exact, unaligned)
        for x in (a, _at_offset(a)):
            _equal(bitmap_inter_multi(x, a_pops, rows),
                   bitmap_inter_multi_plain(x, a_pops, rows))
        got = bitmap_union_reduce(rows)
        _equal(got, bitmap_union_reduce_plain(rows))
        _equal(got[2:], (stack, exact))            # the stack is the input
    torch.cuda.synchronize()
    chunks = Counter(min(128, q - j) for j in range(0, q, 128))
    set_ops = {"bitmap_inter_multi": 4, "bitmap_union_reduce": 2}
    want = {"predicate_scan_multi": Counter({q: 24}),
            "dict_lookup_scan_multi": Counter({q: 3}),
            **{k: Counter({c: m * v for c, m in chunks.items()})
               for k, v in set_ops.items()}}
    for name, by_q in want.items():
        assert LAUNCHES[name] - before[name] == sum(by_q.values())
        got_q = Counter(LAUNCHES_BY_Q[name])
        got_q.subtract(before_q[name])
        assert +got_q == by_q, name


@pytest.mark.parametrize("n,b", SHAPES)
@pytest.mark.parametrize("g", [1, 2, 65])
def test_cuda_grouped_setop_matches_plain(cuda_device, n, b, g):
    """Two dependent levels of G set operations each in two launches:
    shared inputs, ``a is b``, dead rows, the empty and the full set; each
    output equals the per-op plain version run one by one."""
    dev = cuda_device
    rng = np.random.default_rng(g * 7 + n + b)
    w = b // 32
    _, bits, _ = _inputs(rng, n, b, dev)
    sets = [bits, bits.flip(0).contiguous(),
            torch.zeros_like(bits), torch.full_like(bits, -1)]
    pops = [ref.popcount_ref(x) for x in sets]
    want_sets = list(sets)
    levels = []
    for level in range(2):
        ops = []
        for j in range(g):
            ia = int(rng.integers(len(sets)))
            ib = ia if j % 5 == 0 else int(rng.integers(len(sets)))
            op = SetOp(sets[ia], pops[ia], sets[ib], pops[ib],
                       torch.empty_like(bits),
                       torch.empty(n, dtype=torch.int32, device=dev),
                       int(rng.integers(3)))
            ops.append((op, ia, ib))
        levels.append([op for op, _, _ in ops])
        for op, ia, ib in ops:
            want_sets.append(bitmap_setop_plain(want_sets[ia], want_sets[ib],
                                                op.opcode)[0])
            sets.append(op.out)
            pops.append(op.out_pops)
    before = LAUNCHES["bitmap_setop_grouped"]
    bitmap_setop_grouped(levels)
    torch.cuda.synchronize()
    assert LAUNCHES["bitmap_setop_grouped"] == before + 2
    for got, want, p in zip(sets[4:], want_sets[4:], pops[4:]):
        _equal((got, p), (want, ref.popcount_ref(want)))


@pytest.mark.parametrize("n,b", [(1, 256), (3, 1024), (7, 2048),
                                 (1024, 8192), (3, 96), (5, 288)])
@pytest.mark.parametrize("k", [1, 2, 3, 5, 8, 9])
def test_cuda_fused_chain_every_width(cuda_device, n, b, k):
    """K3 at the compiled widths 1..8 and past them (9): both connectives,
    NaN in the columns and as a constant, zero words, dead and masked
    blocks."""
    dev = cuda_device
    rng = np.random.default_rng(k * 100 + n)
    _, bits, pops = _inputs(rng, n, b, dev)
    bits[:, 1::5] = 0                                    # zero words
    cols = []
    for _ in range(k):
        c = rng.normal(size=(n, b)).astype(np.float32)
        c.reshape(-1)[::97] = np.nan
        cols.append(torch.from_numpy(c).to(dev))
    for conj in (True, False):
        for nan_value in (False, True):
            vals = [float(x) for x in rng.normal(size=k)]
            if nan_value:
                vals[0] = float("nan")
            ops = [int(x) for x in rng.integers(0, 6, size=k)]
            _equal(fused_chain_scan(cols, bits, pops, vals, ops, conj),
                   fused_chain_scan_plain(cols, bits, pops, vals, ops, conj))


def test_wrappers_reject_bad_inputs(cuda_device):
    dev = cuda_device
    col = torch.zeros((2, 256), device=dev)
    bits = torch.zeros((2, 8), dtype=torch.int32, device=dev)
    pops = torch.zeros(2, dtype=torch.int32, device=dev)
    with pytest.raises(TypeError):
        predicate_scan(col.double(), bits, pops, 0.0, 0)
    with pytest.raises(ValueError):
        predicate_scan(col[:, :128], bits, pops, 0.0, 0)
    with pytest.raises(ValueError):
        predicate_scan(col.t().contiguous().t(), bits, pops, 0.0, 0)
    with pytest.raises(ValueError):
        predicate_scan(col, bits, pops, 0.0, 6)
    with pytest.raises(ValueError):
        bitmap_setop(bits, bits.cpu(), 0, pops, pops)
    with pytest.raises(ValueError):
        bitmap_setop(bits, bits, 0, pops[:1], pops)
    with pytest.raises(ValueError):
        predicate_scan_multi(col, torch.zeros((3, 8), dtype=torch.int32,
                                              device=dev),
                             torch.zeros(3, dtype=torch.int32, device=dev),
                             0.0, 0)
    with pytest.raises(ValueError):
        dict_lookup_scan_multi(col, bits, pops, pops[:0])
    flat = torch.zeros(2 * 256 + 1, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        fused_chain_scan([flat[1:].view(2, 256)], bits, pops, [0.0], [0])
    with pytest.raises(ValueError, match="aligned"):
        predicate_scan(flat[1:].view(2, 256), bits, pops, 0.0, 0)
    with pytest.raises(ValueError, match="aligned"):
        predicate_scan_multi(flat[1:].view(2, 256), bits, pops, 0.0, 0)
    mask = torch.ones(1, dtype=torch.int32, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        dict_lookup_scan(flat[1:].view(2, 256), bits, pops, mask)
    with pytest.raises(ValueError, match="aligned"):
        dict_lookup_scan_multi(flat[1:].view(2, 256), bits, pops, mask)
    with pytest.raises(ValueError):
        bitmap_inter_multi(bits, pops, [(bits, pops), (bits.cpu(), pops)])
    with pytest.raises(ValueError):
        bitmap_inter_multi(bits, pops, [(bits, pops[:1])])
    with pytest.raises(TypeError):
        bitmap_inter_multi(bits, pops, [(bits.long(), pops)])
    with pytest.raises(ValueError):
        bitmap_inter_multi(bits, pops, [])
    with pytest.raises(ValueError):
        bitmap_union_reduce([(bits, pops), (bits[:1], pops[:1])])
    with pytest.raises(ValueError):
        bitmap_union_reduce([(bits, pops), (bits.t().contiguous().t(),
                                            pops)])
    with pytest.raises(ValueError):
        bitmap_union_reduce([])
    with pytest.raises(ValueError):
        bitmap_setop_grouped([[SetOp(bits, pops, bits, pops, bits[:1],
                                     pops, 0)]])
    with pytest.raises(ValueError):
        bitmap_setop_grouped([[SetOp(bits, pops, bits, pops, bits, pops,
                                     3)]])


def test_tape_on_the_card_matches_the_cpu(cuda_device):
    table = make_forest_table(50_000, n_dup=2, seed=7, strings=True)
    trees = random_query_suite(table, 4, 12, 3, seed=1)
    for tree in trees:
        got, _, gbe = run_query(tree, table, config=ExecConfig(
            engine="tape", planner="deepfish", block=2048))
        want, _, wbe = run_query(tree, table, config=ExecConfig(
            engine="tape", planner="deepfish", block=2048, device="cpu"))
        np.testing.assert_array_equal(got, want)
        assert gbe.device.type == "cuda"
        assert gbe.host_syncs == wbe.host_syncs == 1
        assert gbe.stats.records_evaluated == wbe.stats.records_evaluated
        assert gbe.blocks_touched == wbe.blocks_touched
        assert gbe.drain_op_log() == wbe.drain_op_log()


@pytest.mark.parametrize("n,b", SHAPES)
def test_cuda_setop_and_device_constants_match_plain(cuda_device, n, b):
    """The per-op K2 with the inputs' popcounts (dense, half its rows
    dead, the empty set, ``a is b``), and K1's and K3's device-constant
    entries (K3 at K = 3 and at K = 9 with a prebuilt table), each against
    its plain version."""
    dev = cuda_device
    rng = np.random.default_rng(3 * n + b)
    col, bits, pops = _inputs(rng, n, b, dev)
    half = bits.clone()
    half[::2] = 0
    sets = [bits, bits.flip(0).contiguous(), half, torch.zeros_like(bits)]
    for x in sets:
        for y in sets:
            for op in range(3):
                _equal(bitmap_setop(x, y, op, ref.popcount_ref(x),
                                    ref.popcount_ref(y)),
                       bitmap_setop_plain(x, y, op))
    vals = torch.tensor([0.0, 1e-45, 0.3, float("nan"), -0.2, 0.7, 0.1,
                         -1.0, 0.05], dtype=torch.float32, device=dev)
    for op in range(6):
        for j in range(4):
            _equal(predicate_scan(col, bits, pops, vals[j], op),
                   predicate_scan_plain(col, bits, pops, vals[j], op))
    cols = [torch.from_numpy(rng.normal(size=(n, b)).astype(np.float32))
            .to(dev) for _ in range(9)]
    ops = [int(x) for x in rng.integers(0, 6, size=9)]
    for k in (3, 9):
        table = fused_chain_table(cols[:k], ops[:k]) if k > 8 else None
        for conj in (True, False):
            _equal(fused_chain_scan(cols[:k], bits, pops, vals[:k], ops[:k],
                                    conj, table=table),
                   fused_chain_scan_plain(cols[:k], bits, pops, vals[:k],
                                          ops[:k], conj))


def _graph_trees(table):
    """Paper trees plus a wide chain (K = 9 siblings: the generic path with
    its prebuilt table)."""
    trees = random_query_suite(table, 4, 12, 3, seed=1)

    def num(col, g):
        return Atom(col, "lt", table.value_at_selectivity(col, g),
                    selectivity=g)
    cols = [c for c in table.columns if c.endswith("_0")][:9]
    trees.append(normalize(And([num("elevation_1", 0.8),
                                Or([num(c, 0.2) for c in cols])])))
    return trees


def test_graph_replay_matches_the_eager_loop_and_the_cpu(cuda_device):
    table = make_forest_table(50_000, n_dup=2, seed=7, strings=True)
    cfg = ExecConfig(engine="tape", planner="deepfish", block=2048)
    be = DeviceTapeBackend(table, block=2048)
    for tree in _graph_trees(table):
        got, _, be = run_query(tree, table, backend=be, config=cfg)
        want, _, wbe = run_query(tree, table, config=cfg.replace(
            device="cpu"))
        np.testing.assert_array_equal(got, want)
        assert be.drain_op_log() == wbe.drain_op_log()
        prog = next(reversed(be._programs.values()))
        m = len(be.last_tape.costed_ops())
        k = 4 * m + (table.n_records + 31) // 32
        eager = prog._forward()
        assert torch.equal(eager[:k].cpu(), prog.out[:k].cpu())
    assert any(op.kind == "CHAIN" and len(op.aids) > 8
               for op in be.last_tape.ops)
    assert be.graph_captures == be.tape_programs == len(be._programs)
    assert be.graph_replays == len(_graph_trees(table))


def test_replays_add_the_captured_launches(cuda_device):
    table = make_forest_table(50_000, n_dup=2, seed=7)
    tree = random_query_suite(table, 1, 16, 3, seed=3)[0]
    cfg = ExecConfig(engine="tape", planner="deepfish", block=2048)
    be = DeviceTapeBackend(table, block=2048)
    torch.cuda.synchronize()
    before = dict(LAUNCHES)
    first, _, _ = run_query(tree, table, backend=be, config=cfg)
    (prog,) = be._programs.values()
    delta = prog.launches
    assert delta and delta.get("bitmap_setop", 0) > 0
    for _ in range(4):
        res, _, _ = run_query(tree, table, backend=be, config=cfg)
        np.testing.assert_array_equal(res, first)
    assert be.graph_captures == 1 and be.graph_replays == 5
    assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == {
        k: 5 * delta.get(k, 0) for k in LAUNCHES}


def test_failing_capture_raises(cuda_device, monkeypatch):
    table = make_forest_table(20_000, n_dup=1, seed=7)
    tree = random_query_suite(table, 1, 8, 2, seed=4)[0]
    cfg = ExecConfig(engine="tape", planner="deepfish", block=2048)
    be = DeviceTapeBackend(table, block=2048)
    real = port_device._tape_forward

    def broken(*args, **kwargs):
        real(*args, **kwargs)
        raise RuntimeError("broken forward")
    monkeypatch.setattr(port_device, "_tape_forward", broken)
    before = dict(LAUNCHES)
    with pytest.raises(RuntimeError, match="broken forward"):
        run_query(tree, table, backend=be, config=cfg)
    assert not be._programs and be.graph_captures == 0
    assert dict(LAUNCHES) == before
    monkeypatch.setattr(port_device, "_tape_forward", real)
    got, _, _ = run_query(tree, table, backend=be, config=cfg)
    want, _, _ = run_query(tree, table, config=cfg.replace(device="cpu"))
    np.testing.assert_array_equal(got, want)
    assert be.graph_captures == be.graph_replays == 1


def test_graphs_across_refresh_on_the_card(cuda_device):
    """An append inside the block bucket keeps the program (its zone rows
    and constants are runtime inputs); one that grows the bucket drops
    every program, and the next capture takes a fresh memory pool.  Each
    result equals the CPU run on the same table."""
    table = make_forest_table(20_000, n_dup=1, seed=7)
    extra = make_forest_table(30_000, n_dup=1, seed=9)
    tree = random_query_suite(table, 1, 12, 3, seed=6)[0]
    cfg = ExecConfig(engine="tape", planner="deepfish", block=1024)
    be = DeviceTapeBackend(table, block=1024)

    def check_run():
        got, _, _ = run_query(tree, table, backend=be, config=cfg)
        want, _, _ = run_query(tree, table, config=cfg.replace(device="cpu"))
        np.testing.assert_array_equal(got, want)
    check_run()
    for rows, programs in ((1000, 1), (28_000, 2)):
        table.append({k: v[:rows].copy() for k, v in extra.columns.items()})
        be.refresh()
        check_run()
        assert be.tape_programs == be.graph_captures == programs
    assert be.nblocks == 64 and len(be._programs) == 1


# -- the per-step block engine ---------------------------------------------------

BLOCK_COUNTERS = ("blocks_touched", "records_touched", "blocks_pruned",
                  "kernel_invocations", "host_syncs", "uploaded_bytes",
                  "staged_bytes", "fetched_bytes")


@pytest.mark.parametrize("engine", ["jax", "pallas"])
def test_block_engine_on_the_card_matches_the_cpu(cuda_device, engine):
    """Numeric and string trees (code comparisons on K1, ``in`` / LIKE on
    the host gather), then an append: every result, counter and op log of
    the card equals the CPU's, K1 + K5 launches equal
    ``kernel_invocations`` and K2 launches ``host_syncs`` less them."""
    table = make_forest_table(20_000, n_dup=2, seed=7, strings=True)
    trees = random_query_suite(table, 3, 8, 3, seed=2)
    cfg = ExecConfig(engine=engine, planner="deepfish", block=1024)
    cb = gb = None
    reset_launches()
    for rnd in range(2):
        if rnd:
            extra = make_forest_table(1500, n_dup=2, seed=9, strings=True)
            table.append({k: extra.columns[k] for k in table.columns})
            assert gb.refresh() == cb.refresh() > 0
        for tree in trees:
            want, _, cb = run_query(tree, table, backend=cb,
                                    config=cfg.replace(device="cpu"))
            got, _, gb = run_query(tree, table, backend=gb, config=cfg)
            np.testing.assert_array_equal(got, want)
    assert gb.device.type == "cuda" and gb.engine == engine
    for k in BLOCK_COUNTERS:
        assert getattr(gb, k) == getattr(cb, k), k
    assert gb.drain_op_log() == cb.drain_op_log()
    assert gb.kernel_invocations > 0
    assert LAUNCHES["predicate_scan"] + LAUNCHES["predicate_scan_multi"] \
        == gb.kernel_invocations
    assert LAUNCHES["bitmap_setop"] == gb.host_syncs - gb.kernel_invocations


def test_block_lockstep_on_the_card_warns_once_per_host_sync(cuda_device):
    """A lockstep batch on the card: the CPU's bitmaps and counters, K5
    launched, and as many synchronizing CUDA calls (sync debug mode) as
    the backend's ``host_syncs``."""
    import warnings

    from repro_torch import QuerySession
    table = make_forest_table(20_000, n_dup=2, seed=7)
    trees = random_query_suite(table, 3, 8, 3, seed=4) * 3
    cfg = ExecConfig(engine="jax", planner="deepfish", block=1024,
                     batched="auto")
    host = QuerySession(table, config=cfg.replace(device="cpu"))
    sess = QuerySession(table, config=cfg)
    for s in (host, sess):
        s.execute(trees)                # uploads, fills the atom caches
    want = host.execute(trees)
    reset_launches()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            got = sess.execute(trees)
        finally:
            torch.cuda.set_sync_debug_mode(0)
    syncs = [w for w in caught
             if "called a synchronizing CUDA operation" in str(w.message)]
    for g, w in zip(got.bitmaps, want.bitmaps):
        np.testing.assert_array_equal(g, w)
    assert got.stats.records_evaluated == want.stats.records_evaluated
    assert len(syncs) == got.stats.host_syncs > 0
    assert LAUNCHES["predicate_scan_multi"] > 0


def test_ops_popcount_arguments_on_the_card(cuda_device):
    """The entry points' popcount arguments reach the kernels: the given
    counts equal the plain popcount's results, and K2 with every row
    marked live (ones) still returns the exact output popcounts."""
    from repro_torch.kernels import ops
    rng = np.random.default_rng(1)
    col = torch.from_numpy(rng.normal(size=(4, 8192)).astype(np.float32))
    bits = rng.integers(0, 2 ** 32, size=(3, 4, 256), dtype=np.uint32)
    bits[:, 1] = 0                                       # a dead block
    bits = torch.from_numpy(bits.view(np.int32))
    pops = ref.popcount_ref(bits)
    dev = cuda_device
    for op in range(6):
        got = ops.predicate_blocks(col.to(dev), bits[0].to(dev), 0.1, op,
                                   pops=pops[0].to(dev))
        assert torch.equal(got.cpu(), ops.predicate_blocks(col, bits[0],
                                                           0.1, op))
        got = ops.predicate_blocks_multi(col.to(dev), bits.to(dev), 0.1, op,
                                         pops=pops.to(dev))
        assert torch.equal(got.cpu(), ops.predicate_blocks_multi(
            col, bits, 0.1, op))
    ones = torch.ones(4, dtype=torch.int32, device=dev)
    out, got = ops.bitmap_op(bits[0].to(dev), bits[0].to(dev), 0, ones, ones)
    assert torch.equal(out.cpu(), bits[0]) and torch.equal(got.cpu(),
                                                           pops[0])


# -- block-sharded execution -----------------------------------------------------

def _shard_mesh(shards, distinct):
    """``shards`` shards on the first cards (``distinct``), or all on
    cuda:0, which an explicit mesh may name more than once."""
    from repro_torch.launch.mesh import ShardMesh, make_shard_mesh
    if distinct:
        if torch.cuda.device_count() < shards:
            pytest.skip(f"needs {shards} GPUs")
        return make_shard_mesh(shards)
    return ShardMesh(["cuda:0"] * shards)


def _sync_warnings(fn):
    """``fn()`` and the synchronizing CUDA calls it made (sync debug
    mode)."""
    import warnings
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter("always")
        torch.cuda.set_sync_debug_mode("warn")
        try:
            out = fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    return out, sum("called a synchronizing CUDA operation" in str(w.message)
                    for w in caught)


@pytest.mark.parametrize("shards,distinct", [(1, False), (2, False),
                                             (2, True), (4, True)])
def test_sharded_tape_on_the_card_matches_the_cpu(cuda_device, shards,
                                                   distinct):
    """Paper, string and wide-chain trees on S shards of the card, cold and
    warm: each result, counter and op log equal to the same sharded engine
    on host shards; each warm query one sync-debug warning, S graph
    replays and S times the unsharded card engine's launches."""
    from repro_torch import ShardedTapeBackend
    mesh = _shard_mesh(shards, distinct)
    table = make_forest_table(50_000, n_dup=2, seed=7, strings=True)
    trees = _graph_trees(table)
    cfg = ExecConfig(engine="tape", planner="deepfish", block=2048)
    be = ShardedTapeBackend(table, block=2048, mesh=mesh)
    cpu = ShardedTapeBackend(table, block=2048, shards=shards, device="cpu")
    one = DeviceTapeBackend(table, block=2048)
    for tree in trees:
        got, _, be = run_query(tree, table, backend=be, config=cfg.replace(
            mesh=mesh))
        want, _, cpu = run_query(tree, table, backend=cpu,
                                 config=cfg.replace(shards=shards,
                                                    device="cpu"))
        run_query(tree, table, backend=one, config=cfg)
        np.testing.assert_array_equal(got, want)
    for k in ("host_syncs", "device_dispatches", "blocks_touched",
              "blocks_pruned", "host_fallbacks"):
        assert getattr(be, k) == getattr(cpu, k), k
    assert be.stats.records_evaluated == cpu.stats.records_evaluated
    assert be.drain_op_log() == cpu.drain_op_log()
    assert be.graph_captures == be.tape_programs == shards * len(trees)
    assert len(be._pools) == shards
    for tree in trees:
        run_query(tree, table, backend=one, config=cfg)
        torch.cuda.synchronize()
        before = dict(LAUNCHES)
        run_query(tree, table, backend=one, config=cfg)
        torch.cuda.synchronize()
        need = {k: shards * (LAUNCHES[k] - before[k]) for k in LAUNCHES}
        r0 = be.graph_replays
        before = dict(LAUNCHES)
        (got, _, _), warned = _sync_warnings(lambda: run_query(
            tree, table, backend=be, config=cfg.replace(mesh=mesh)))
        torch.cuda.synchronize()
        want, _, _ = run_query(tree, table, backend=cpu, config=cfg.replace(
            shards=shards, device="cpu"))
        np.testing.assert_array_equal(got, want)
        assert warned == 1 and be.graph_replays - r0 == shards
        assert {k: LAUNCHES[k] - before[k] for k in LAUNCHES} == need


@pytest.mark.parametrize("shards,distinct", [(2, False), (2, True),
                                             (4, True)])
def test_sharded_lockstep_on_the_card_warns_once(cuda_device, shards,
                                                 distinct):
    """A lockstep batch on S shards of the card: the host shards'
    bitmaps and counters, one sync-debug warning for the batch."""
    from repro_torch import QuerySession
    mesh = _shard_mesh(shards, distinct)
    table = make_forest_table(20_000, n_dup=2, seed=7, strings=True)
    trees = random_query_suite(table, 3, 8, 3, seed=4) * 3
    cfg = ExecConfig(engine="tape", planner="deepfish", block=1024,
                     batched=True)
    host = QuerySession(table, config=cfg.replace(shards=shards,
                                                  device="cpu"))
    sess = QuerySession(table, config=cfg.replace(mesh=mesh))
    for s in (host, sess):
        s.execute(trees)                # uploads, fills the atom caches
    want = host.execute(trees)
    got, warned = _sync_warnings(lambda: sess.execute(trees))
    for g, w in zip(got.bitmaps, want.bitmaps):
        np.testing.assert_array_equal(g, w)
    for k in ("records_evaluated", "blocks_touched", "device_dispatches",
              "atom_cache_hits"):
        assert getattr(got.stats, k) == getattr(want.stats, k), k
    assert got.stats.op_observations == want.stats.op_observations
    assert warned == got.stats.host_syncs == 1
    assert got.backend.shards == shards


def test_sharded_graph_pools_keep_each_shards_output(cuda_device):
    """Two key-distinct tapes replayed in turn on two shards of one card:
    every shard's replay comes before the gather reads any output, so a
    pool shared between the shards would hand one shard's output buffer
    to the other's graph.  Each result must stay the oracle's."""
    from repro_torch import ShardedTapeBackend
    mesh = _shard_mesh(2, False)
    table = make_forest_table(50_000, n_dup=2, seed=7)
    a, b = random_query_suite(table, 2, 12, 3, seed=5)
    cfg = ExecConfig(engine="tape", planner="deepfish", block=2048,
                     mesh=mesh)
    be = ShardedTapeBackend(table, block=2048, mesh=mesh)
    want = [run_query(t, table, config=ExecConfig(
        engine="numpy", planner="deepfish", device="cpu"))[0] for t in (a, b)]
    keys = set()
    for _ in range(3):
        for tree, w in zip((a, b), want):
            got, _, _ = run_query(tree, table, backend=be, config=cfg)
            np.testing.assert_array_equal(got, w)
            keys.add(be.last_tape.key)
    assert len(keys) == 2 and be.graph_captures == 4
    assert be.graph_replays == 12 and len(be._pools) == 2


# -- LM serving ----------------------------------------------------------------

@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen3-moe-30b-a3b",
                                  "rwkv6-1.6b", "zamba2-1.2b",
                                  "whisper-base", "llama-3.2-vision-11b"])
def test_lm_smoke_logits_on_the_card_match_the_cpu(cuda_device, arch):
    """The same SMOKE parameters (made on the CPU, copied to the card):
    prefill logits and 4 decode steps within 0.15 of the CPU's on the
    first ``vocab`` columns (bf16: cuBLAS sums in another order)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import api
    from repro_torch.models.common import tree_map
    cfg = get_smoke(arch)
    cpu = api.init(cfg, 0, "cpu")
    card = tree_map(lambda t: t.to(cuda_device), cpu)
    rng = np.random.default_rng(0)
    b, s = 2, 8
    batch = {"tokens": torch.from_numpy(rng.integers(0, cfg.vocab, (b, s)))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32))
    if cfg.family == "vlm":
        batch["vision"] = torch.from_numpy(rng.standard_normal(
            (b, cfg.img_seq, cfg.d_model)).astype(np.float32))
    got = {}
    for dev, params in (("cpu", cpu), (cuda_device, card)):
        with torch.inference_mode():
            bt = {k: v.to(dev) for k, v in batch.items()}
            last, _ = api.prefill(cfg, params, bt)
            cache = api.init_cache(cfg, b, cfg.max_seq, str(dev))
            if cfg.family in ("encdec", "vlm"):
                _, pre = api.prefill(cfg, params, bt)
                cache["cross_k"], cache["cross_v"] = (
                    pre["cross_k"].to(torch.bfloat16),
                    pre["cross_v"].to(torch.bfloat16))
            steps = []
            for i in range(4):
                lg, cache = api.decode(cfg, params, bt["tokens"][:, i:i + 1],
                                       cache, i)
                steps.append(lg[:, 0])
            got[str(dev)] = [t.float().cpu().numpy()[..., :cfg.vocab]
                             for t in [last] + steps]
    for a, c in zip(got["cpu"], got[str(cuda_device)]):
        assert np.isfinite(c).all()
        assert np.abs(a - c).max() < 0.15


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen3-moe-30b-a3b",
                                  "whisper-base"])
def test_serve_engine_on_the_card_matches_manual_decode(cuda_device, arch):
    from repro_torch.configs import get_smoke
    from repro_torch.models import api
    from repro_torch.serve import ServeEngine
    cfg = get_smoke(arch)
    b, plen, gen = 2, 12, 5
    params = api.init(cfg, 0, "cuda")
    prompts = np.random.default_rng(0).integers(
        0, cfg.vocab, (b, plen)).astype(np.int32)
    extras = None
    if cfg.family == "encdec":
        extras = {"frames": np.random.default_rng(1).standard_normal(
            (b, cfg.enc_seq, cfg.d_model)).astype(np.float32)}
    eng = ServeEngine(cfg, params, batch_size=b, max_seq=cfg.max_seq)
    out = eng.generate(prompts, gen, batch_extras=extras)
    assert out.shape == (b, gen) and ((out >= 0) & (out < cfg.vocab)).all()
    assert all(t > 0 for t in eng.timings["step_ms"])
    with torch.inference_mode():
        cache = api.init_cache(cfg, b, cfg.max_seq)
        toks = torch.from_numpy(prompts).long().to(cuda_device)
        if extras is not None:
            _, pre = api.prefill(cfg, params, {
                "tokens": toks, "frames": torch.from_numpy(
                    extras["frames"]).to(cuda_device)})
            cache["cross_k"], cache["cross_v"] = pre["cross_k"], pre["cross_v"]
        for i in range(plen):
            logits, cache = api.decode(cfg, params, toks[:, i:i + 1], cache, i)
        manual = []
        for i in range(gen):
            tok = torch.argmax(logits[:, -1], dim=-1).reshape(b, 1)
            manual.append(tok)
            if i < gen - 1:
                logits, cache = api.decode(cfg, params, tok, cache, plen + i)
    manual = torch.cat(manual, dim=1).cpu().numpy()
    assert (out == manual).mean() >= 0.8, (out, manual)


# -- LM training ---------------------------------------------------------------

def _train_batch(cfg, b=4, s=16, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab, (b, s + 1), generator=g)}


@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen3-moe-30b-a3b",
                                  "deepseek-v3-671b", "rwkv6-1.6b"])
def test_train_step_on_the_card_matches_the_cpu(cuda_device, arch):
    """One SMOKE step (microbatch 2) from the same parameters and batch:
    the loss and metrics within 5e-3 of the CPU's, the gradient norm
    within 1 %, every parameter within 1e-2 (an Adam step at lr 1e-3
    moves one by about lr; bf16 products sum in another order on each)."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import api
    from repro_torch.models.common import tree_items, tree_map
    from repro_torch.train import make_train_step
    cfg = get_smoke(arch).replace(microbatch=2)
    cpu = api.init(cfg, 0, "cpu")
    card = tree_map(lambda t: t.to(cuda_device), cpu)
    batch = _train_batch(cfg)
    out = {}
    for dev, params in (("cpu", cpu), ("cuda", card)):
        step = make_train_step(cfg, lr=1e-3)
        p, st, m = step(params, step.init_state(params),
                        {k: v.to(dev) for k, v in batch.items()})
        out[dev] = (dict(tree_items(p)), {k: float(v) for k, v in m.items()})
        assert int(st["opt"]["step"]) == 1
    (pc, mc), (pg, mg) = out["cpu"], out["cuda"]
    for k in mc:
        tol = 1e-2 * mc[k] if k == "grad_norm" else 5e-3
        assert abs(mc[k] - mg[k]) < tol, (k, mc[k], mg[k])
    for k, t in pc.items():
        assert pg[k].is_cuda and pg[k].dtype == t.dtype
        assert float((pg[k].cpu().float() - t.float()).abs().max()) < 1e-2


def test_train_loop_restart_on_the_card_is_bit_exact(cuda_device, tmp_path):
    """A crash at step 4 with checkpoints every 2 steps (the async writer):
    the restore puts the tree back on the card and the run replays to the
    same parameters, optimizer state and losses, bit for bit."""
    from repro_torch.ckpt import CheckpointManager
    from repro_torch.configs import get_smoke
    from repro_torch.models import api
    from repro_torch.models.common import tree_items
    from repro_torch.runtime import FailureInjector, TrainLoop
    from repro_torch.train import make_train_step
    cfg = get_smoke("granite-3-8b").replace(microbatch=1)
    runs = []
    for name, fail in (("a", ()), ("b", (4,))):
        params = api.init(cfg, 0, "cuda")
        step = make_train_step(cfg, lr=1e-3)
        loop = TrainLoop(
            step_fn=step,
            data_fn=lambda i: {k: v.to(cuda_device) for k, v in
                               _train_batch(cfg, 2, 32, 1000 + i).items()},
            ckpt=CheckpointManager(str(tmp_path / name), keep=3),
            ckpt_every=2, injector=FailureInjector(fail) if fail else None)
        runs.append(loop.run(params, step.init_state(params), n_steps=6))
        loop.ckpt.async_ckpt.close()
    (p1, s1, h1), (p2, s2, h2) = runs
    for (_, a), (_, b) in zip(tree_items({"p": p1, "s": s1}),
                              tree_items({"p": p2, "s": s2})):
        assert b.is_cuda and torch.equal(a, b)
    assert [h["loss"] for h in h1] == [h["loss"] for h in h2]


def test_card_checkpoint_loads_on_the_cpu(cuda_device, tmp_path):
    from repro_torch.ckpt import load_pytree, save_pytree
    from repro_torch.configs import get_smoke
    from repro_torch.models import api
    from repro_torch.models.common import tree_items
    from repro_torch.train import make_train_step
    cfg = get_smoke("granite-3-8b").replace(optimizer="adafactor")
    params = api.init(cfg, 0, "cuda")
    step = make_train_step(cfg, lr=1e-3, grad_compression="int8")
    params, state, _ = step(params, step.init_state(params),
                            {k: v.to(cuda_device) for k, v in
                             _train_batch(cfg).items()})
    tree = {"params": params, "opt": state}
    save_pytree(tree, str(tmp_path), 1)
    back, _ = load_pytree(str(tmp_path))
    got = dict(tree_items(back))
    assert set(got) == set(dict(tree_items(tree)))
    for k, v in tree_items(tree):
        assert got[k].device.type == "cpu" and got[k].dtype == v.dtype
        assert torch.equal(got[k], v.cpu()), k
    on_card, _ = load_pytree(str(tmp_path), device="cuda")
    assert all(t.is_cuda for _, t in tree_items(on_card))
