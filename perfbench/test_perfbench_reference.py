"""The plain reference against small trees worked by hand."""
import numpy as np
import pytest
import torch

from perfbench.reference import Reference, compare_answer, pack_words


def ref(dtype=torch.float32):
    return Reference({"a": np.array([1, 2, 3, 4, 5, 6], dtype=np.float32),
                      "b": np.array([6, 5, 4, 3, 2, 1], dtype=np.float32),
                      "k": np.array([0, 1, 2, 0, 1, 2], dtype=np.int32)},
                     dtype=dtype)


def rows(tree, r=None):
    return [bool(x) for x in (r or ref()).evaluate(tree).tolist()]


def atom(c, op, v):
    return ("atom", c, op, v)


T, F = True, False


def test_numeric_atoms_and_trees():
    assert rows(atom("a", "lt", 3)) == [T, T, F, F, F, F]
    assert rows(atom("b", "ge", 4)) == [T, T, T, F, F, F]
    assert rows(atom("k", "eq", 2)) == [F, F, T, F, F, T]
    assert rows(("and", [atom("a", "gt", 1), atom("b", "le", 5)])) == \
        [F, T, T, T, T, T]
    tree = ("or", [atom("a", "lt", 2),
                   ("and", [atom("k", "eq", 1), atom("b", "lt", 3)])])
    assert rows(tree) == [T, F, F, F, T, F]


def test_categorical_atoms_in_a_tree():
    # an eq atom on a qualitative column, ORed and ANDed with ranges
    tree = ("and", [("or", [atom("k", "eq", 0), atom("a", "ge", 6)]),
                    atom("b", "gt", 1)])
    assert rows(tree) == [T, F, F, T, F, F]
    assert rows(("or", [atom("k", "eq", 5)])) == [F] * 6


def test_a_ragged_table_is_refused():
    with pytest.raises(ValueError):
        Reference({"a": np.zeros(3, np.float32), "b": np.zeros(4,
                                                                np.float32)})


def test_packing_is_lsb_first():
    mask = torch.zeros(40, dtype=torch.bool)
    mask[0] = mask[33] = mask[39] = True
    assert pack_words(mask).tolist() == [1, (1 << 1) | (1 << 7)]
    assert pack_words(torch.ones(32, dtype=torch.bool)).tolist() == \
        [0xFFFFFFFF]


def test_lower_precision_changes_answers():
    # bfloat16 keeps 8 bits: 2750 and 2751 are one value there
    r32 = Reference({"x": np.array([2750.0, 2751.0], np.float32)})
    r16 = Reference({"x": np.array([2750.0, 2751.0], np.float32)},
                    dtype=torch.bfloat16)
    tree = atom("x", "lt", 2751.0)
    assert rows(tree, r32) == [T, F]
    assert rows(tree, r16) == [F, F]


def test_answers_are_compared_record_for_record():
    full = torch.zeros(70, dtype=torch.bool)
    full[[3, 35, 39, 45, 69]] = True
    want = pack_words(full)
    assert compare_answer(want, want, 70) is None
    # a record flipped, two flipped, or a wrong length
    bad = want.copy()
    bad[1] |= np.uint32(1 << 9)
    assert compare_answer(bad, want, 70) == 1
    bad[0] ^= np.uint32(1 << 3)
    assert compare_answer(bad, want, 70) == 2
    assert compare_answer(want[:2], want, 70) == 70
    # the reference's bits past the last record are not compared
    padded = want.copy()
    padded[2] |= np.uint32(1 << 31)
    assert compare_answer(want, padded, 70) is None


@pytest.mark.parametrize("op", ["lt", "le", "gt", "ge", "eq", "ne"])
def test_every_numeric_op(op):
    import operator
    x = np.array([1, 2, 3], np.float32)
    r = Reference({"x": x})
    fn = {"lt": operator.lt, "le": operator.le, "gt": operator.gt,
          "ge": operator.ge, "eq": operator.eq, "ne": operator.ne}[op]
    assert rows(atom("x", op, 2), r) == [bool(fn(v, 2)) for v in x]
