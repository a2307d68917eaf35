"""The port's kernels (K1-K6, the grouped K2 and the stacked set
operations) and pack/unpack/popcount against the reference package.

On the CPU each port wrapper runs its plain PyTorch version; those are held
against the reference's jnp oracles (``repro.kernels.ref``) and its Pallas
kernels in interpret mode (``repro.kernels.ops``), on the same numpy-seeded
inputs.  Every comparison is exact: both sides compare in float32 and pack
bits, so any difference is a bug.  The CUDA kernels are held against
these plain versions on the card by ``tests/test_torch_cuda.py``.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.columnar.bitmap import pack_bits, popcount
from repro.kernels import ops as kops, ref as kref
from repro_torch.kernels import ops as tops, ref as tref
from repro_torch.kernels.predicate_scan import predicate_scan

# (blocks, block_size); W = 1, 3 and 9 end a warp's words inside a group
# of 4 and take the stacked kernels' 4-byte row loads on the card
SHAPES = [(1, 256), (3, 1024), (4, 8192), (7, 2048), (2, 32), (3, 96),
          (5, 288)]
OPS = list(range(6))


def _t(a: np.ndarray) -> torch.Tensor:
    """numpy -> CPU tensor; u32 words travel as their int32 view."""
    a = np.ascontiguousarray(a)
    if a.dtype == np.uint32:
        a = a.view(np.int32)
    return torch.from_numpy(a)


def _u32(t: torch.Tensor) -> np.ndarray:
    return t.numpy().view(np.uint32)


def _column(rng, n, b):
    col = rng.normal(size=(n, b)).astype(np.float32)
    col.reshape(-1)[:4] = [np.nan, 1e-45, -0.0, np.inf]   # NaN, denormal
    return col


def _bits(rng, n, w, dead=1):
    bits = rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint32)
    bits[:, 0] |= np.uint32(1 << 31)            # bit 31 set in every row
    if n > 1:
        bits[dead] = 0                          # a dead block
    return bits


# -- pack / unpack / popcount -------------------------------------------------

def test_pack_unpack_popcount_match_reference_with_bit31():
    rng = np.random.default_rng(2)
    mask = rng.random(4096) < 0.37
    mask[31::32] = True                          # bit 31 of every word
    words = _u32(tref.pack_u32(torch.from_numpy(mask)))
    np.testing.assert_array_equal(words, pack_bits(mask))
    np.testing.assert_array_equal(words,
                                  np.asarray(kref.pack_u32(jnp.asarray(mask))))
    back = tref.unpack_u32(_t(words)).numpy()
    np.testing.assert_array_equal(back, mask)
    w2 = words.reshape(8, -1)
    np.testing.assert_array_equal(
        tref.popcount_ref(_t(w2)).numpy(),
        np.asarray(kref.popcount_ref(jnp.asarray(w2))))
    assert int(tref.popcount_ref(_t(words)).item()) == popcount(words)


# -- K1 predicate_scan --------------------------------------------------------

@pytest.mark.parametrize("n,b", SHAPES)
@pytest.mark.parametrize("opcode", OPS)
def test_predicate_scan_plain_matches_reference(n, b, opcode):
    rng = np.random.default_rng(opcode * 100 + n)
    col = _column(rng, n, b)
    bits = _bits(rng, n, b // 32)
    bits[:, 2::7] = 0                       # zero words inside groups of 4
    value = float(rng.normal())
    got = _u32(tops.predicate_blocks(_t(col), _t(bits), value, opcode))
    want = np.asarray(kref.predicate_blocks_ref(jnp.asarray(col),
                                                jnp.asarray(bits), value,
                                                opcode))
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(kops.predicate_blocks(jnp.asarray(col),
                                              jnp.asarray(bits), value,
                                              opcode, interpret=True))
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("opcode", OPS)
def test_predicate_scan_dead_blocks_match_pallas_kernel(opcode):
    """Blocks whose *given* popcount is 0 come back zero even when their
    bits are not (the zone-masked call): the raw reference kernel agrees."""
    from repro.kernels.predicate_scan import predicate_scan as ref_scan
    rng = np.random.default_rng(40 + opcode)
    n, b = 4, 1024
    w = b // 32
    col = _column(rng, n, b)
    bits = _bits(rng, n, w, dead=2)
    pops = np.array(kref.popcount_ref(jnp.asarray(bits)), dtype=np.int32)
    pops[1] = 0                                   # masked, bits still set
    value = np.float32(0.25)
    out, out_pops = predicate_scan(_t(col), _t(bits), _t(pops), value,
                                   opcode)
    col_bm = col.reshape(n, w, 32).transpose(0, 2, 1)
    want = np.asarray(ref_scan(
        jnp.asarray(col_bm), jnp.asarray(bits), jnp.asarray(pops),
        jnp.asarray([value]), opcode, interpret=True))
    np.testing.assert_array_equal(_u32(out), want)
    assert not want[1].any()
    np.testing.assert_array_equal(
        out_pops.numpy(), np.asarray(kref.popcount_ref(jnp.asarray(want))))


def test_f32_constant_rounding_matches_reference():
    """A double constant between two floats compares as its f32 rounding."""
    col = np.full((1, 256), np.float32(0.1), dtype=np.float32)
    bits = np.full((1, 8), 0xFFFFFFFF, dtype=np.uint32)
    for op in OPS:
        got = _u32(tops.predicate_blocks(_t(col), _t(bits), 0.1, op))
        want = np.asarray(kref.predicate_blocks_ref(
            jnp.asarray(col), jnp.asarray(bits), 0.1, op))
        np.testing.assert_array_equal(got, want)


# -- K2 bitmap_setop ----------------------------------------------------------

@pytest.mark.parametrize("n,w", [(1, 8), (5, 64), (3, 256)])
@pytest.mark.parametrize("opcode", [0, 1, 2])
def test_bitmap_setop_plain_matches_reference(n, w, opcode):
    rng = np.random.default_rng(opcode + n)
    a = _bits(rng, n, w)
    b = rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint32)
    out, pops = tops.bitmap_op(_t(a), _t(b), opcode)
    want, want_pops = kops.bitmap_op(jnp.asarray(a), jnp.asarray(b), opcode,
                                     interpret=True)
    np.testing.assert_array_equal(_u32(out), np.asarray(want))
    np.testing.assert_array_equal(pops.numpy(), np.asarray(want_pops))
    ref_fn = [kref.bitmap_and_ref, kref.bitmap_or_ref,
              kref.bitmap_andnot_ref][opcode]
    port_fn = [tref.bitmap_and_ref, tref.bitmap_or_ref,
               tref.bitmap_andnot_ref][opcode]
    want_words = np.asarray(ref_fn(a, b))
    np.testing.assert_array_equal(_u32(port_fn(_t(a), _t(b))), want_words)
    np.testing.assert_array_equal(_u32(out), want_words)


# -- K2 grouped: bitmap_setop_grouped -----------------------------------------

def _grouped_inputs(rng, n, w):
    """Shared input sets u32[N, W]: random rows with dead (all-zero) rows,
    an empty set and a full one."""
    sets = [_bits(rng, n, w, dead=j % n) for j in range(4)]
    if n > 2:
        sets[1][n - 1] = 0                       # a second dead row
    sets.append(np.zeros((n, w), dtype=np.uint32))
    sets.append(np.full((n, w), 0xFFFFFFFF, dtype=np.uint32))
    return sets


def _grouped_levels(rng, sets, g):
    """Two levels of ``g`` ops each over the shared inputs (mixed opcodes,
    ``a is b`` included); level 2 also reads level 1's outputs.  Returns
    (levels of SetOps, their (a, b, opcode) as indices into
    inputs + outputs, the outputs in op order)."""
    from repro_torch.kernels.bitmap_ops import SetOp
    tens = [_t(x) for x in sets]
    pops = [tref.popcount_ref(t) for t in tens]
    n, w = sets[0].shape
    levels, spec, outs = [], [], []
    for level in range(2):
        ops = []
        pool = len(tens)
        for j in range(g):
            ia = int(rng.integers(pool))
            ib = ia if j % 5 == 0 else int(rng.integers(pool))
            code = int(rng.integers(3))
            out = torch.empty((n, w), dtype=torch.int32)
            opop = torch.empty(n, dtype=torch.int32)
            ops.append(SetOp(tens[ia], pops[ia], tens[ib], pops[ib], out,
                             opop, code))
            spec.append((ia, ib, code))
            outs.append((out, opop))
        levels.append(ops)
        for op in ops:                          # level 2 reads these
            tens.append(op.out)
            pops.append(op.out_pops)
    return levels, spec, outs


@pytest.mark.parametrize("n,w", [(1, 8), (5, 64), (3, 256)])
@pytest.mark.parametrize("g", [1, 2, 9])
def test_bitmap_setop_grouped_plain_matches_reference(n, w, g):
    """Two dependent levels of set operations over shared inputs, dead
    rows, the empty and the full set: the grouped plain version equals the
    ops run one by one, and each equals the reference's bitmap_setop (the
    Pallas kernel in interpret mode, as its own tests run it)."""
    from repro_torch.kernels.bitmap_ops import (bitmap_setop_grouped,
                                                bitmap_setop_plain)
    rng = np.random.default_rng(100 * n + w + g)
    sets = _grouped_inputs(rng, n, w)
    levels, spec, outs = _grouped_levels(rng, sets, g)
    bitmap_setop_grouped(levels)
    one_by_one = [_t(x) for x in sets]
    ref_sets = [np.asarray(x) for x in sets]
    for (ia, ib, code), (out, pops) in zip(spec, outs):
        want, want_pops = bitmap_setop_plain(one_by_one[ia], one_by_one[ib],
                                             code)
        assert torch.equal(out, want) and torch.equal(pops, want_pops)
        one_by_one.append(want)
        r, r_pops = kops.bitmap_op(jnp.asarray(ref_sets[ia]),
                                   jnp.asarray(ref_sets[ib]), code,
                                   interpret=True)
        np.testing.assert_array_equal(_u32(out), np.asarray(r))
        np.testing.assert_array_equal(pops.numpy(),
                                      np.asarray(r_pops).reshape(-1))
        ref_sets.append(np.asarray(r))


def _by_dead_row_rules(a, b, code):
    """The grouped kernel's rules on host words: a row whose popcount is
    0 is not read; AND with either row dead and ANDNOT with ``a`` dead
    read neither row; the unread rows stand for zeros."""
    a_live = (a != 0).any(axis=1)
    b_live = (b != 0).any(axis=1)
    read_a = a_live & b_live if code == 0 else a_live
    read_b = b_live if code == 1 else a_live & b_live
    x = np.where(read_a[:, None], a, np.uint32(0))
    y = np.where(read_b[:, None], b, np.uint32(0))
    return (x & y, x | y, x & ~y)[code]


@pytest.mark.parametrize("opcode", [0, 1, 2])
def test_grouped_dead_row_rules_give_the_plain_words(opcode):
    """Every combination of live and dead rows in a and b: the rules by
    which the grouped kernel skips reads give the plain version's words
    and popcounts."""
    from repro_torch.kernels.bitmap_ops import bitmap_setop_plain
    rng = np.random.default_rng(40 + opcode)
    n, w = 8, 16
    a = rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint32)
    b = rng.integers(0, 2 ** 32, size=(n, w), dtype=np.uint32)
    a[[0, 1, 4]] = 0                          # dead in a
    b[[0, 2, 5]] = 0                          # dead in b
    got = _by_dead_row_rules(a, b, opcode)
    want, want_pops = bitmap_setop_plain(_t(a), _t(b), opcode)
    np.testing.assert_array_equal(got, _u32(want))
    np.testing.assert_array_equal(
        np.unpackbits(got.view(np.uint8), axis=1).sum(axis=1),
        want_pops.numpy())


# -- K3 fused_chain_scan ------------------------------------------------------

@pytest.mark.parametrize("n,b,k", [(2, 512, 2), (3, 1024, 3), (7, 2048, 3),
                                   (1, 256, 2)])
@pytest.mark.parametrize("conj", [True, False])
def test_fused_chain_plain_matches_reference(n, b, k, conj):
    rng = np.random.default_rng(n * 10 + k)
    cols = np.stack([_column(rng, n, b) for _ in range(k)])
    bits = _bits(rng, n, b // 32, dead=0)
    vals = rng.normal(size=(k,)).astype(np.float32)
    opcodes = tuple(int(rng.integers(0, 6)) for _ in range(k))
    got = _u32(tops.fused_chain_blocks(_t(cols), _t(bits), vals, opcodes,
                                       conj=conj))
    want = np.asarray(kref.fused_chain_ref(
        jnp.asarray(cols), jnp.asarray(bits), jnp.asarray(vals), opcodes,
        conj=conj))
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(kops.fused_chain_blocks(
        jnp.asarray(cols), jnp.asarray(bits), vals, opcodes, conj=conj,
        interpret=True))
    np.testing.assert_array_equal(got, pallas)


# -- K4 dict_lookup_scan ------------------------------------------------------

# (n, b, u, edges): ``edges`` puts the conversion's edge cases among the
# codes (:data:`EDGE_CODES`)
LOOKUP_CASES = [(1, 256, 1, False), (3, 1024, 2, False),
                (4, 2048, 64, False), (2, 8192, 2, False),
                (1, 256, 1, True), (3, 96, 33, True), (2, 1024, 2, True),
                (5, 288, 1, True)]
LOOKUP_IDS = [f"{n}-{b}-{u}" + ("-edges" if e else "")
              for n, b, u, e in LOOKUP_CASES]
# f32 codes at the ends of the f32 -> int32 conversion: NaN (code 0),
# saturating infinities and magnitudes, 2^31 (saturates to 2^31 - 1) and
# truncation toward zero
EDGE_CODES = [np.nan, np.inf, -np.inf, 1e10, -1e10, 2.0 ** 31, 31.9, -0.9]


def _put_edges(col, mask):
    """EDGE_CODES after the first 3 codes of block 0, and code 0 (what
    NaN and -0.9 become) in the mask."""
    col.reshape(-1)[3:3 + len(EDGE_CODES)] = EDGE_CODES
    mask[0] |= np.uint32(1)


@pytest.mark.parametrize("n,b,u,edges", LOOKUP_CASES, ids=LOOKUP_IDS)
def test_dict_lookup_plain_matches_reference(n, b, u, edges):
    """Masks of U words, with negative codes and codes >= 32*U (misses)."""
    rng = np.random.default_rng(n * 100 + u)
    col = rng.integers(-40, 32 * u + 40, size=(n, b)).astype(np.float32)
    col.reshape(-1)[:3] = [-0.5, 3.75, -1.0]      # truncation toward zero
    bits = _bits(rng, n, b // 32)
    mask = rng.integers(0, 2 ** 32, size=u, dtype=np.uint32)
    mask[0] |= np.uint32(1 << 31)
    if edges:
        _put_edges(col, mask)
        bits[0, 0] = np.uint32(0xFFFFFFFF)          # under the edge codes
    got = _u32(tops.dict_lookup_blocks(_t(col), _t(bits), _t(mask)))
    want = np.asarray(kref.dict_lookup_ref(
        jnp.asarray(col), jnp.asarray(bits), jnp.asarray(mask)))
    np.testing.assert_array_equal(got, want)
    pallas = np.asarray(kops.dict_lookup_blocks(
        jnp.asarray(col), jnp.asarray(bits), jnp.asarray(mask),
        interpret=True))
    np.testing.assert_array_equal(got, pallas)


def test_code_conversion_matches_reference_on_nan_and_overflow():
    """f32 -> int32 codes: NaN to 0, saturation out of range."""
    vals = np.array([np.nan, 1e10, -1e10, -0.5, 3.7, -3.7, 2.5e9],
                    dtype=np.float32)
    np.testing.assert_array_equal(
        tref.codes_of(torch.from_numpy(vals)).numpy(),
        np.asarray(jnp.asarray(vals).astype(jnp.int32)))


# -- K5 predicate_scan_multi, K6 dict_lookup_scan_multi -----------------------

def _stacked_bits(rng, q, n, w):
    """Q stacked bitmaps u32[Q*N, W] with a dead row, zero words, a block
    dead in every row and one live in the last row only, plus their
    popcounts with one live row masked to 0."""
    bits = rng.integers(0, 2 ** 32, size=(q, n, w), dtype=np.uint32)
    bits[:, :, 0] |= np.uint32(1 << 31)
    bits[:, :, 2::5] = 0                            # zero words
    bits[q - 1, 0] = 0                              # a dead row
    if n > 1:
        bits[:, 1] = 0                              # dead in every row
    if n > 2:
        bits[:q - 1, n - 1] = 0                     # live in one row
    bits = bits.reshape(q * n, w)
    pops = np.array(kref.popcount_ref(jnp.asarray(bits)), dtype=np.int32)
    pops[(q * n) // 2] = 0                          # masked, bits still set
    return bits, pops


@pytest.mark.parametrize("n,b", SHAPES)
@pytest.mark.parametrize("opcode", OPS)
def test_predicate_scan_multi_plain_matches_pallas_kernel(n, b, opcode):
    from repro.kernels.predicate_scan import predicate_scan_multi as ref_scan
    from repro_torch.kernels.predicate_scan import predicate_scan_multi
    rng = np.random.default_rng(opcode * 100 + n + 7)
    q, w = 3, b // 32
    col = _column(rng, n, b)
    bits, pops = _stacked_bits(rng, q, n, w)
    value = np.float32(rng.normal())
    out, out_pops = predicate_scan_multi(_t(col), _t(bits), _t(pops),
                                         value, opcode)
    col_bm = col.reshape(n, w, 32).transpose(0, 2, 1)
    want = np.asarray(ref_scan(
        jnp.asarray(col_bm), jnp.asarray(bits), jnp.asarray(pops),
        jnp.asarray([value]), opcode, interpret=True))
    np.testing.assert_array_equal(_u32(out), want)
    np.testing.assert_array_equal(
        out_pops.numpy(), np.asarray(kref.popcount_ref(jnp.asarray(want))))


@pytest.mark.parametrize("q", [1, 4])
@pytest.mark.parametrize("opcode", OPS)
def test_predicate_blocks_multi_matches_reference(q, opcode):
    """The record-major ops entry point and the plain oracle against the
    reference's (Pallas in interpret mode, and its jnp multi ref)."""
    rng = np.random.default_rng(q * 10 + opcode)
    n, b = 3, 1024
    col = _column(rng, n, b)
    bits = rng.integers(0, 2 ** 32, size=(q, n, b // 32), dtype=np.uint32)
    bits[0, 1] = 0
    value = float(rng.normal())
    got = _u32(tops.predicate_blocks_multi(_t(col), _t(bits), value,
                                           opcode))
    want = np.asarray(kref.predicate_blocks_multi_ref(
        jnp.asarray(col), jnp.asarray(bits), value, opcode))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        _u32(tref.predicate_blocks_multi_ref(_t(col), _t(bits), value,
                                             opcode)), want)
    pallas = np.asarray(kops.predicate_blocks_multi(
        jnp.asarray(col), jnp.asarray(bits), value, opcode, interpret=True))
    np.testing.assert_array_equal(got, pallas)


@pytest.mark.parametrize("n,b,u,edges", LOOKUP_CASES, ids=LOOKUP_IDS)
def test_dict_lookup_scan_multi_plain_matches_pallas_kernel(n, b, u, edges):
    from repro.kernels.dict_lookup import dict_lookup_scan_multi as ref_scan
    from repro_torch.kernels.dict_lookup import dict_lookup_scan_multi
    rng = np.random.default_rng(n * 100 + u + 3)
    q, w = 3, b // 32
    col = rng.integers(-40, 32 * u + 40, size=(n, b)).astype(np.float32)
    col.reshape(-1)[:3] = [-0.5, 3.75, -1.0]      # truncation toward zero
    bits, pops = _stacked_bits(rng, q, n, w)
    mask = rng.integers(0, 2 ** 32, size=u, dtype=np.uint32)
    mask[0] |= np.uint32(1 << 31)
    if edges:
        _put_edges(col, mask)
        bits[0, 0] = np.uint32(0xFFFFFFFF)          # set 0, block 0
        pops[0] = np.unpackbits(bits[0].view(np.uint8)).sum()
    out, out_pops = dict_lookup_scan_multi(_t(col), _t(bits), _t(pops),
                                           _t(mask))
    col_bm = col.reshape(n, w, 32).transpose(0, 2, 1)
    want = np.asarray(ref_scan(
        jnp.asarray(col_bm), jnp.asarray(bits), jnp.asarray(pops),
        jnp.asarray(mask), interpret=True))
    np.testing.assert_array_equal(_u32(out), want)
    np.testing.assert_array_equal(
        out_pops.numpy(), np.asarray(kref.popcount_ref(jnp.asarray(want))))
    hit = np.asarray(kref.dict_lookup_ref(
        jnp.asarray(col), jnp.asarray(bits.reshape(q, n, w)[0]),
        jnp.asarray(mask)))
    np.testing.assert_array_equal(
        _u32(tref.dict_lookup_multi_ref(_t(col), _t(bits.reshape(q, n, w)),
                                        _t(mask)))[0], hit)


# -- the lockstep executor's stacked set operations ---------------------------

@pytest.mark.parametrize("q,n,w,dead", [
    (2, 1, 8, False), (3, 4, 32, False), (9, 5, 256, False),
    (1, 3, 8, False), (1, 4, 3, True), (5, 3, 9, True), (8, 6, 256, True),
    (130, 2, 4, True)])
def test_stacked_set_ops_match_reference(q, n, w, dead):
    """bitmap_inter_multi and bitmap_union_reduce against the reference's
    jnp ``_inter_multi_impl`` / ``_union_impl`` (words and popcounts), on
    Q sets passed as (bits, exact popcounts) pairs; ``dead`` adds a dead
    set, a block dead in every set and dead blocks in a third of the sets
    (``a`` always has a dead block when N > 1).  The OR-reduce's stacked
    copy must equal its inputs, popcounts included."""
    from repro.columnar.device import _inter_multi_impl, _union_impl
    from repro_torch.kernels.bitmap_ops import (bitmap_inter_multi,
                                                bitmap_union_reduce)
    rng = np.random.default_rng(q * 10 + w + n)
    a = _bits(rng, n, w)
    bits = rng.integers(0, 2 ** 32, size=(q, n, w), dtype=np.uint32)
    bits[0, 0] = 0
    if dead:
        bits[q // 2] = 0                                 # a dead set
        bits[:, n - 1] = 0                               # dead in every set
        bits[1::3, 0] = 0
    pops = np.asarray(kref.popcount_ref(jnp.asarray(bits)))
    a_pops = np.asarray(kref.popcount_ref(jnp.asarray(a)))
    rows = [(_t(bits[j]), _t(pops[j])) for j in range(q)]
    out, out_pops = bitmap_inter_multi(_t(a), _t(a_pops), rows)
    want, want_pops = _inter_multi_impl(jnp.asarray(a), jnp.asarray(bits))
    np.testing.assert_array_equal(_u32(out), np.asarray(want))
    np.testing.assert_array_equal(out_pops.numpy(), np.asarray(want_pops))
    out, out_pops, stack, stack_pops = bitmap_union_reduce(rows)
    want, want_pops = _union_impl(jnp.asarray(bits), jnp.asarray(pops))
    np.testing.assert_array_equal(_u32(out), np.asarray(want))
    np.testing.assert_array_equal(out_pops.numpy(), np.asarray(want_pops))
    np.testing.assert_array_equal(_u32(stack), bits)
    np.testing.assert_array_equal(stack_pops.numpy(), pops)


# -- launch counters ----------------------------------------------------------

def test_stacked_launches_are_counted_by_q():
    """A stacked wrapper's launch counts once in LAUNCHES and once under
    its Q in LAUNCHES_BY_Q; reset_launches clears both (the CUDA wrappers
    call count_launch right after their launch)."""
    from repro_torch.kernels import LAUNCHES, LAUNCHES_BY_Q, _build
    saved = dict(LAUNCHES), {k: dict(v) for k, v in LAUNCHES_BY_Q.items()}
    try:
        _build.reset_launches()
        _build.count_launch("predicate_scan_multi", 9)
        _build.count_launch("predicate_scan_multi", 9)
        _build.count_launch("bitmap_union_reduce", 2)
        _build.count_launch("predicate_scan")
        assert LAUNCHES["predicate_scan_multi"] == 2
        assert LAUNCHES["predicate_scan"] == 1
        assert dict(LAUNCHES_BY_Q["predicate_scan_multi"]) == {9: 2}
        assert dict(LAUNCHES_BY_Q["bitmap_union_reduce"]) == {2: 1}
        assert "predicate_scan" not in LAUNCHES_BY_Q
        _build.reset_launches()
        assert not any(LAUNCHES.values())
        assert not any(LAUNCHES_BY_Q.values())
    finally:
        LAUNCHES.update(saved[0])
        for k, v in saved[1].items():
            LAUNCHES_BY_Q[k].update(v)
