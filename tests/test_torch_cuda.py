"""The port's CUDA kernels on the card: each against its plain PyTorch
version (exact), and the tape engine on the card against the same engine
on the CPU.  Marked ``cuda``; every test skips without a GPU.  This file
imports neither JAX nor the reference package, so it runs on a machine
that has only PyTorch:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py
"""
import pytest

torch = pytest.importorskip("torch")

import numpy as np

from repro_torch import ExecConfig, make_forest_table, random_query_suite, run_query
from repro_torch.kernels import LAUNCHES, ref
from repro_torch.kernels.bitmap_ops import (bitmap_inter_multi,
                                            bitmap_inter_multi_plain,
                                            bitmap_setop, bitmap_setop_plain,
                                            bitmap_union_reduce,
                                            bitmap_union_reduce_plain)
from repro_torch.kernels.dict_lookup import (dict_lookup_scan,
                                             dict_lookup_scan_multi,
                                             dict_lookup_scan_multi_plain,
                                             dict_lookup_scan_plain)
from repro_torch.kernels.fused_chain import fused_chain_scan, fused_chain_scan_plain
from repro_torch.kernels.predicate_scan import (predicate_scan,
                                                predicate_scan_multi,
                                                predicate_scan_multi_plain,
                                                predicate_scan_plain)

SHAPES = [(1, 256), (3, 1024), (4, 8192), (7, 2048), (1024, 8192)]

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
    for op in range(3):
        _equal(bitmap_setop(bits, other, op),
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


def _stacked(rng, q, n, w, dev):
    """Q stacked bitmaps i32[Q*N, W] with dead rows (all-zero bits), masked
    rows (bits set, popcount given as 0) and one block dead in every row."""
    bits = rng.integers(0, 2 ** 32, size=(q, n, w), dtype=np.uint32)
    bits[:, :, 0] |= np.uint32(1 << 31)
    bits[q // 2, 0] = 0                                  # a dead row
    if n > 1:
        bits[:, n - 1] = 0                               # dead in every row
    bits = torch.from_numpy(bits.reshape(q * n, w).view(np.int32)).to(dev)
    pops = ref.popcount_ref(bits)
    pops[q * n // 3] = 0                                 # a masked row
    return bits, pops


@pytest.mark.parametrize("n,b,q", [
    (n, b, q) for n, b in ((1, 256), (3, 1024), (7, 2048))
    for q in (1, 2, 8, 65)] + [(1024, 8192, 1), (1024, 8192, 8)])
def test_cuda_stacked_kernels_match_plain(cuda_device, n, b, q):
    dev = cuda_device
    rng = np.random.default_rng(q * 1000 + n + b)
    w = b // 32
    col, _, _ = _inputs(rng, n, b, dev)
    bits, pops = _stacked(rng, q, n, w, dev)
    before = dict(LAUNCHES)
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
    a = stack[0].flip(0).contiguous()
    _equal(bitmap_inter_multi(a, stack), bitmap_inter_multi_plain(a, stack))
    _equal(bitmap_union_reduce(stack), bitmap_union_reduce_plain(stack))
    torch.cuda.synchronize()
    assert LAUNCHES["predicate_scan_multi"] == before[
        "predicate_scan_multi"] + 24
    assert LAUNCHES["dict_lookup_scan_multi"] == before[
        "dict_lookup_scan_multi"] + 3
    assert LAUNCHES["bitmap_inter_multi"] == before["bitmap_inter_multi"] + 1
    assert LAUNCHES["bitmap_union_reduce"] == before[
        "bitmap_union_reduce"] + 1


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
        bitmap_setop(bits, bits.cpu(), 0)
    with pytest.raises(ValueError):
        predicate_scan_multi(col, torch.zeros((3, 8), dtype=torch.int32,
                                              device=dev),
                             torch.zeros(3, dtype=torch.int32, device=dev),
                             0.0, 0)
    with pytest.raises(ValueError):
        dict_lookup_scan_multi(col, bits, pops, pops[:0])


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
