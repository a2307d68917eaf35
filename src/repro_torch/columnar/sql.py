"""Minimal SQL SELECT parser -> predicate tree (for the demo/driver).

Supports: SELECT col[, col...] FROM table WHERE <expr>
<expr>: comparisons (< <= > >= = != ), AND / OR / NOT, parentheses,
ILIKE 'pattern', IN (v, ...), numeric + single-quoted string literals.

A copy of the reference package's ``columnar/sql.py``: the parse tree is
made of the port's ``core.predicate`` nodes, and any engine runs it.
"""
from __future__ import annotations

import re
from typing import List, Optional, Tuple

from ..core.predicate import And, Atom, Node, Not, Or

_TOKEN = re.compile(r"""
    \s*(?:
      (?P<num>-?\d+(?:\.\d+)?)
    | (?P<str>'[^']*')
    | (?P<op><=|>=|!=|<>|=|<|>)
    | (?P<lp>\()
    | (?P<rp>\))
    | (?P<comma>,)
    | (?P<word>[A-Za-z_][A-Za-z_0-9]*)
    )""", re.VERBOSE)

_OPMAP = {"<": "lt", "<=": "le", ">": "gt", ">=": "ge", "=": "eq",
          "!=": "ne", "<>": "ne"}


def _tokenize(s: str) -> List[Tuple[str, str]]:
    out, i = [], 0
    while i < len(s):
        m = _TOKEN.match(s, i)
        if not m or m.end() == i:
            if s[i:].strip() == "":
                break
            raise ValueError(f"bad SQL near {s[i:i+20]!r}")
        i = m.end()
        for kind, val in m.groupdict().items():
            if val is not None:
                out.append((kind, val))
                break
    out.append(("eof", ""))
    return out


class _Parser:
    def __init__(self, tokens):
        self.toks = tokens
        self.i = 0

    def peek(self):
        return self.toks[self.i]

    def next(self):
        t = self.toks[self.i]
        self.i += 1
        return t

    def expect_word(self, word):
        k, v = self.next()
        if k != "word" or v.upper() != word:
            raise ValueError(f"expected {word}, got {v!r}")

    def parse_expr(self) -> Node:
        left = self.parse_term()
        while self.peek() == ("word", "OR") or \
                (self.peek()[0] == "word" and self.peek()[1].upper() == "OR"):
            self.next()
            left = Or([left, self.parse_term()])
        return left

    def parse_term(self) -> Node:
        left = self.parse_factor()
        while self.peek()[0] == "word" and self.peek()[1].upper() == "AND":
            self.next()
            left = And([left, self.parse_factor()])
        return left

    def parse_factor(self) -> Node:
        k, v = self.peek()
        if k == "word" and v.upper() == "NOT":
            self.next()
            return Not(self.parse_factor())
        if k == "lp":
            self.next()
            e = self.parse_expr()
            if self.next()[0] != "rp":
                raise ValueError("expected )")
            return e
        return self.parse_comparison()

    def parse_comparison(self) -> Atom:
        k, col = self.next()
        if k != "word":
            raise ValueError(f"expected column, got {col!r}")
        k2, op = self.next()
        if k2 == "word" and op.upper() == "ILIKE":
            _, lit = self.next()
            return Atom(col, "like", lit.strip("'"))
        if k2 == "word" and op.upper() == "IN":
            if self.next()[0] != "lp":
                raise ValueError("expected ( after IN")
            vals = []
            while True:
                kk, vv = self.next()
                if kk == "num":
                    vals.append(float(vv) if "." in vv else int(vv))
                elif kk == "str":
                    vals.append(vv.strip("'"))
                kk2, _ = self.peek()
                if kk2 == "comma":
                    self.next()
                    continue
                if self.next()[0] != "rp":
                    raise ValueError("expected ) in IN list")
                break
            return Atom(col, "in", tuple(vals))
        if k2 != "op":
            raise ValueError(f"expected comparison op, got {op!r}")
        k3, val = self.next()
        if k3 == "num":
            value = float(val) if "." in val else int(val)
        elif k3 == "str":
            value = val.strip("'")
        else:
            raise ValueError(f"expected literal, got {val!r}")
        return Atom(col, _OPMAP[op], value)


def parse_select(sql: str):
    """Returns (projected columns, table name, predicate Node)."""
    toks = _tokenize(sql)
    p = _Parser(toks)
    p.expect_word("SELECT")
    cols = []
    while True:
        k, v = p.next()
        if k != "word":
            raise ValueError("expected column in SELECT list")
        cols.append(v)
        if p.peek()[0] == "comma":
            p.next()
            continue
        break
    p.expect_word("FROM")
    _, table = p.next()
    k, v = p.peek()
    expr = None
    if k == "word" and v.upper() == "WHERE":
        p.next()
        expr = p.parse_expr()
    return cols, table, expr
