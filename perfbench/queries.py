"""The general traffic generator: query pools and their schedules.

A traffic mix (``traffic/<mix>.json``) is data only; this module turns it
into plain predicate trees and the order a run sends them in.

Trees follow the paper's generator (arXiv:2002.00540 sec. 7.1), as the
port's ``columnar/queries.py`` writes it: a fixed depth, a random AND/OR
root, 2-5 children per inner node, children that may end early as atoms,
and unique atoms.  A *template* fixes the tree's shape, the column of each
atom and the kind of each atom's comparison; a *binding* draws its
constants: ``lt`` at one of the paper's selectivities for a quantitative
column (the constant is the data's realized quantile), and ``eq`` to one
value of a qualitative column.

Templates and bindings come from the mix's own ``pool_seed``: they are the
deployment's queries.  ``--seed`` changes the data (so every constant) and
the order in which a run sends the pool, so every seed does the same
amount of work in another order.

Plain trees are tuples: ``("and", [children])``, ``("or", [children])``
and ``("atom", column, op, value)``.  Nothing here imports the program.
"""
from __future__ import annotations

from dataclasses import dataclass
from typing import Callable, Iterator, List, Sequence

import numpy as np

from .data import Attribute, column_name


# -- tree shapes (a frozen copy of the port's _partition / _build) -----------

def _partition(rng: np.random.Generator, quota: int, cap: int) -> List[int]:
    """Split quota into 2..5 parts, each 1..cap (cap = subtree capacity)."""
    kmin = max(2, -(-quota // cap))
    kmax = min(5, quota)
    k = int(rng.integers(kmin, kmax + 1)) if kmax > kmin else kmin
    parts = [1] * k
    rem = quota - k
    while rem > 0:
        j = int(rng.integers(k))
        if parts[j] < cap:
            parts[j] += 1
            rem -= 1
    return parts


def _shape(rng: np.random.Generator, quota: int, level: int, depth: int,
           kind: str):
    """A node with exactly ``quota`` atom slots (``"slot"`` leaves)."""
    if quota == 1:
        return "slot"
    if level == depth:
        return (kind, ["slot"] * quota)
    cap = 5 ** (depth - level)
    sub = "or" if kind == "and" else "and"
    return (kind, [_shape(rng, p, level + 1, depth, sub)
                   for p in _partition(rng, quota, cap)])


def tree_depth(node, level: int = 1) -> int:
    """The port's depth: the deepest atom's level less one (root = 1)."""
    if node == "slot" or node[0] == "atom":
        return level - 1
    return max(tree_depth(c, level + 1) for c in node[1])


def random_shape(rng: np.random.Generator, n_atoms: int, depth: int,
                 max_tries: int = 200):
    for _ in range(max_tries):
        kind = "and" if rng.random() < 0.5 else "or"
        shape = _shape(rng, n_atoms, 1, depth, kind)
        if tree_depth(shape) == depth:
            return shape
    raise RuntimeError(f"no depth-{depth} shape with {n_atoms} atoms")


def fill(shape, atoms: Sequence[tuple]):
    """The shape with its slots replaced by ``atoms`` in order."""
    it = iter(atoms)

    def walk(node):
        if node == "slot":
            return next(it)
        return (node[0], [walk(c) for c in node[1]])

    return walk(shape)


def atoms_of(tree) -> List[tuple]:
    if tree[0] == "atom":
        return [tree]
    return [a for c in tree[1] for a in atoms_of(c)]


# -- templates and bindings --------------------------------------------------

@dataclass
class Pool:
    """``trees[t * bindings + b]`` is template ``t`` under binding ``b``."""

    trees: List[tuple]
    templates: int
    bindings: int

    def template_of(self, index: int) -> int:
        return index // self.bindings


def make_pool(mix: dict, attrs: Sequence[Attribute], duplicates: int,
              constant: Callable[[str, float], float]) -> Pool:
    """The mix's query pool.  ``constant(attr, gamma)`` gives the data's
    realized quantile of a quantitative attribute."""
    rng = np.random.default_rng(mix["pool_seed"])
    by_col = {column_name(a.name, d): a for d in range(duplicates)
              for a in attrs}
    columns = list(by_col)
    n_atoms = mix["atoms"]
    trees = []
    for _ in range(mix["templates"]):
        shape = random_shape(rng, n_atoms, mix["depth"])
        cols = [columns[i] for i in rng.choice(len(columns), n_atoms,
                                               replace=False)]
        for _ in range(mix["bindings"]):
            atoms = []
            for c in cols:
                a = by_col[c]
                if a.kind == "quant":
                    g = float(rng.choice(mix["selectivities"]))
                    atoms.append(("atom", c, "lt", constant(a.name, g)))
                else:
                    atoms.append(("atom", c, "eq",
                                  int(rng.integers(a.cardinality))))
            trees.append(fill(shape, atoms))
    return Pool(trees=trees, templates=mix["templates"],
                bindings=mix["bindings"])


# -- schedules ----------------------------------------------------------------

def epochs(n: int, seed: int) -> Iterator[int]:
    """Pool indices without end: each pass a seeded permutation of all n."""
    rng = np.random.default_rng([int(seed) % (1 << 63), 1])
    while True:
        yield from (int(i) for i in rng.permutation(n))
