"""Seeded Forest-style table data, made on the device from ``--seed``.

The construction is the paper's (arXiv:2002.00540 sec. 7.1, UCI
Covertype): base attributes drawn from the configuration's marginals for
``base_records`` rows, replicated ``row_replication`` times row-wise, then
``duplicates`` copies of every base attribute, each copy but the first
row-shuffled.  Everything random is drawn from one ``torch.Generator`` on
the device in whole-column calls; the category weights come from the
configuration's own ``skew`` seed, so they are the deployment's and not
the run's.

This module imports neither the program nor JAX: the plain reference reads
the same arrays the program is handed.
"""
from __future__ import annotations

import math
from dataclasses import dataclass, field
from typing import Dict, List, Optional

import numpy as np
import torch


@dataclass
class Attribute:
    """One base attribute: ``kind`` is "quant" or "qual"."""

    name: str
    kind: str
    spec: dict
    weights: Optional[np.ndarray] = None      # qual: the values' weights

    @property
    def cardinality(self) -> int:
        return len(self.weights) if self.weights is not None else 0


def schema(cfg: dict) -> List[Attribute]:
    """The configuration's base attributes, with the deployment's fixed
    category weights (Dirichlet, from ``skew.seed``)."""
    rng = np.random.default_rng(cfg["skew"]["seed"])
    alpha = cfg["skew"]["dirichlet_alpha"]
    out = [Attribute(q["name"], "quant", q) for q in cfg["quantitative"]]
    for q in cfg["qualitative"]:
        out.append(Attribute(q["name"], "qual", q,
                             weights=rng.dirichlet(np.ones(q["k"]) * alpha)))
    return out


def column_name(attr: str, dup: int) -> str:
    return f"{attr}_{dup}"


def _gamma(n: int, shape: float, g: torch.Generator,
           device: torch.device) -> torch.Tensor:
    """Gamma(shape, 1) by Marsaglia and Tsang (shape >= 1), from ``g``."""
    if shape < 1:
        raise ValueError("gamma shape must be >= 1")
    d = shape - 1.0 / 3.0
    c = 1.0 / math.sqrt(9.0 * d)
    got, have = [], 0
    while have < n:
        m = int((n - have) * 1.1) + 1024
        x = torch.randn(m, generator=g, device=device, dtype=torch.float64)
        u = torch.rand(m, generator=g, device=device, dtype=torch.float64)
        v = (1.0 + c * x) ** 3
        ok = (v > 0) & (torch.log(u) < 0.5 * x * x + d - d * v
                        + d * torch.log(v.clamp_min(1e-300)))
        got.append((d * v)[ok])
        have += int(got[-1].numel())
    return torch.cat(got)[:n]


def _draw(attr: Attribute, n: int, g: torch.Generator,
          device: torch.device) -> torch.Tensor:
    """``n`` values of one base attribute (f32, or int32 codes)."""
    s = attr.spec
    if attr.kind != "quant":
        cdf = torch.as_tensor(np.cumsum(attr.weights), device=device,
                              dtype=torch.float64)
        u = torch.rand(n, generator=g, device=device, dtype=torch.float64)
        codes = torch.searchsorted(cdf, u * cdf[-1], right=True)
        return codes.clamp_max(attr.cardinality - 1).to(torch.int32)
    kind = s["dist"]
    if kind == "uniform":
        x = s["low"] + (s["high"] - s["low"]) * torch.rand(
            n, generator=g, device=device, dtype=torch.float64)
    elif kind == "gamma":
        x = s["scale"] * _gamma(n, s["shape"], g, device)
    else:
        x = s["mean"] + s["std"] * torch.randn(
            n, generator=g, device=device, dtype=torch.float64)
        if kind == "abs_normal":
            x = x.abs()
        elif kind == "clipped_normal":
            x = x.clamp(s["low"], s["high"])
        elif kind != "normal":
            raise ValueError(f"unknown distribution {kind!r}")
    return x.to(torch.float32)


@dataclass
class TableData:
    """The data of one run, made by the harness.

    ``columns`` is what the program is handed, and what the plain
    reference reads (f32 or int32); ``sorted_base`` holds
    each quantitative base attribute's sorted values, from which atom
    constants are taken at realized quantiles (a duplicate is a permutation
    of its base attribute, so one sort serves all of them)."""

    attrs: List[Attribute]
    duplicates: int
    n_records: int
    columns: Dict[str, np.ndarray]
    sorted_base: Dict[str, np.ndarray] = field(default_factory=dict)

    @property
    def names(self) -> List[str]:
        return list(self.columns)

    def constant(self, attr: str, gamma: float) -> float:
        """The realized ``gamma`` quantile of ``attr``: the value ``c`` such
        that ``col < c`` holds on the ``round(gamma * n)`` smallest
        records (exactly, where values do not tie at c)."""
        srt = self.sorted_base[attr]
        k = min(max(int(round(gamma * len(srt))), 0), len(srt) - 1)
        return float(srt[k])


def _generator(seed: int, device: torch.device) -> torch.Generator:
    g = torch.Generator(device=device)
    g.manual_seed(int(seed) % (1 << 63))
    return g


def make_table_data(cfg: dict, seed: int, device,
                    records: Optional[int] = None) -> TableData:
    """The table of configuration ``cfg`` for ``seed``.  ``records`` (the
    tests' small tables) replaces the configuration's row count; the base
    rows shrink with it by the replication factor."""
    device = torch.device(device)
    attrs = schema(cfg)
    rep = cfg["row_replication"]
    n = cfg["records"] if records is None else records
    n_base = -(-n // rep)
    g = _generator(seed, device)
    base = {a.name: _draw(a, n_base, g, device).repeat(rep)[:n]
            for a in attrs}
    out = TableData(attrs=attrs, duplicates=cfg["duplicates"], n_records=n,
                    columns={})
    for a in attrs:
        if a.kind == "quant":
            out.sorted_base[a.name] = torch.sort(base[a.name]).values.cpu() \
                .numpy()
    for d in range(cfg["duplicates"]):
        perm = None if d == 0 else torch.randperm(n, generator=g,
                                                  device=device)
        for a in attrs:
            col = base[a.name] if perm is None else base[a.name][perm]
            out.columns[column_name(a.name, d)] = col.cpu().numpy()
    return out

