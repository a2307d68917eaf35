"""The data and traffic generators repeat exactly from a seed, and make
what the configurations and mixes say."""
import numpy as np
import pytest

from perfbench.data import column_name, make_table_data
from perfbench.cell import HERE, load_json
from perfbench.queries import atoms_of, epochs, make_pool, tree_depth

SEED = 2**31 + 12345          # more than 32 signed bits hold
ROWS = 4096
CONFIGS = ["forest-x10"]
MIXES = ["adhoc"]


def config(name):
    return load_json(HERE / "configs" / f"{name}.json")


def mix(name):
    return load_json(HERE / "traffic" / f"{name}.json")


def data_of(name, seed=SEED):
    return make_table_data(config(name), seed, "cpu", records=ROWS)


@pytest.mark.parametrize("name", CONFIGS)
def test_table_repeats_from_its_seed(name):
    a, b, c = data_of(name), data_of(name), data_of(name, SEED + 1)
    assert list(a.columns) == list(b.columns)
    for k in a.columns:
        assert np.array_equal(a.columns[k], b.columns[k])
    assert any(not np.array_equal(a.columns[k], c.columns[k])
               for k in a.columns)


@pytest.mark.parametrize("name", CONFIGS)
def test_table_follows_the_configuration(name):
    cfg = config(name)
    d = data_of(name)
    assert len(d.columns) == cfg["attributes"]
    assert d.n_records == ROWS
    for a in d.attrs:
        base = d.columns[column_name(a.name, 0)]
        for dup in range(1, cfg["duplicates"]):
            col = d.columns[column_name(a.name, dup)]
            # every duplicate is a shuffle of its base attribute
            assert np.array_equal(np.sort(col), np.sort(base))
        if a.kind == "quant":
            assert base.dtype == np.float32
        else:
            assert base.dtype == np.int32
            assert base.min() >= 0 and base.max() < a.cardinality
    # row replication: the first duplicate repeats its base rows
    rep = cfg["row_replication"]
    first = d.columns[column_name(d.attrs[0].name, 0)]
    n_base = -(-ROWS // rep)
    assert np.array_equal(first[:n_base], first[n_base: 2 * n_base])


def test_constants_are_realized_quantiles():
    d = data_of("forest-x10")
    for a in d.attrs:
        if a.kind != "quant":
            continue
        col = d.columns[column_name(a.name, 3)]
        for g in (0.1, 0.5, 0.9):
            share = float((col < d.constant(a.name, g)).mean())
            assert abs(share - g) < 0.02, (a.name, g, share)


def test_categories_have_covertypes_cardinalities():
    # UCI Covertype: 4 wilderness areas and 40 soil types
    d = make_table_data(config("forest-x10"), SEED, "cpu", records=200_000)
    card = {a.name: a.cardinality for a in d.attrs if a.kind == "qual"}
    assert card == {"wilderness": 4, "soil": 40}
    for name, k in card.items():
        seen = np.unique(d.columns[column_name(name, 5)])
        assert seen.min() >= 0 and seen.max() < k and len(seen) > k // 2


def test_category_weights_are_the_deployments():
    # the skew comes from the configuration, not from the run's seed
    a, b = data_of("forest-x10"), data_of("forest-x10", 99)
    for x, y in zip(a.attrs, b.attrs):
        if x.weights is not None:
            assert np.array_equal(x.weights, y.weights)


@pytest.mark.parametrize("mix_name", MIXES)
def test_pool_repeats_and_has_the_papers_trees(mix_name):
    conf = "forest-x10"
    m = mix(mix_name)
    d = data_of(conf)
    p1 = make_pool(m, d.attrs, config(conf)["duplicates"], d.constant)
    p2 = make_pool(m, d.attrs, config(conf)["duplicates"], d.constant)
    assert p1.trees == p2.trees
    assert len(p1.trees) == m["templates"] * m["bindings"]
    for i, t in enumerate(p1.trees):
        atoms = atoms_of(t)
        assert len(atoms) == m["atoms"] and tree_depth(t) == m["depth"]
        assert len({a[1] for a in atoms}) == len(atoms)      # unique atoms
        for _, col, op, value in atoms:
            qual = col.startswith(("wilderness", "soil"))
            assert op == ("eq" if qual else "lt")
            assert isinstance(value, int) == qual
        # a template's bindings share its shape and columns
        first = p1.trees[p1.template_of(i) * m["bindings"]]
        assert [a[1:3] for a in atoms_of(first)] == [a[1:3] for a in atoms]


def test_the_program_sees_the_same_trees():
    from perfbench.drivers import adapt
    m = mix("adhoc")
    d = data_of("forest-x10")
    pool = make_pool(m, d.attrs, 12, d.constant)
    for t in pool.trees[:: m["bindings"]]:
        pt = adapt(t)
        assert pt.n == m["atoms"] and pt.depth == m["depth"]
        assert [(a.column, a.op, a.value) for a in pt.atoms] == \
            [tuple(a[1:]) for a in atoms_of(t)]


def test_schedules_repeat_and_cover_the_pool():
    a = [next(it) for it in [epochs(128, SEED)] for _ in range(384)]
    b = list(zip(range(384), epochs(128, SEED)))
    assert a == [x for _, x in b]
    for k in range(3):
        assert sorted(a[128 * k: 128 * (k + 1)]) == list(range(128))
    assert a != [x for _, x in zip(range(384), epochs(128, SEED + 1))]
