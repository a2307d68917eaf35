"""Logical-axis sharding rules, as the reference names them.

Parameter schemas carry logical axis names (``"embed"``, ``"q_dim"``,
``"kv_seq"``, ...); one rules table maps each to mesh axes.  The port runs
each model on one device, so nothing here moves data: :func:`shard`
returns its input, and :func:`spec_for` only *computes* the partition the
reference would give an array on a mesh (its ``PartitionSpec`` entries as
a plain tuple), for checking, for the dry-run's per-device bytes
(:mod:`repro_torch.launch.dryrun`) and for the later multi-device slice.

A mesh here is any object with ``axis_names`` and a ``shape`` mapping of
axis name to size, as the reference's ``spec_for`` reads it.  Resolution is
divisibility-aware: a mesh axis is dropped from a dim whose size it does
not divide (the dim is then replicated).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

Axes = Union[None, str, Tuple[str, ...]]

# Logical axis -> mesh axis (or tuple). Missing key => replicated.
DEFAULT_RULES: Dict[str, Axes] = {
    "batch": ("pod", "data"),
    "vocab": "model",
    "heads": "model",
    "q_dim": "model",      # flattened n_heads*head_dim weight dim
    "kv_dim": "model",     # flattened kv weight dim (divisible even when
                           # kv_heads isn't)
    "ff": "model",
    "experts": "model",
    "embed": "data",       # FSDP dim of weight matrices
    "kv_seq": "model",     # decode-time KV cache length
    "act_seq": "model",    # sequence-parallel residual stream between blocks
    "layers": None,
    "seq": None,
    "blocks": "shards",    # columnar block axis on the 1-D table-shard mesh
}

_CTX = threading.local()


def _get():
    return getattr(_CTX, "mesh", None), getattr(_CTX, "rules", None)


@contextlib.contextmanager
def use_mesh(mesh, rules: Optional[Dict[str, Axes]] = None):
    """Install (mesh, rules) for this thread."""
    prev = _get()
    _CTX.mesh = mesh
    _CTX.rules = dict(DEFAULT_RULES, **(rules or {}))
    try:
        yield
    finally:
        _CTX.mesh, _CTX.rules = prev


def current_mesh():
    return _get()[0]


def _resolve_axis(rule: Axes, mesh, dim_size: int, used=frozenset()) -> Axes:
    """Keep the longest prefix of mesh axes whose product divides dim_size,
    skipping axes already used by earlier dims."""
    if rule is None:
        return None
    axes = (rule,) if isinstance(rule, str) else tuple(rule)
    axes = [a for a in axes if a in mesh.axis_names and a not in used]
    kept, prod = [], 1
    for a in axes:
        size = mesh.shape[a]
        if dim_size % (prod * size) == 0:
            kept.append(a)
            prod *= size
        else:
            break
    if not kept:
        return None
    return kept[0] if len(kept) == 1 else tuple(kept)


def spec_for(shape: Sequence[int], axes: Sequence[Optional[str]],
             mesh=None, rules: Optional[Dict[str, Axes]] = None) -> Tuple:
    """The reference's ``PartitionSpec`` entries for an array of ``shape``
    with logical ``axes``, as a tuple (trailing replicated dims dropped;
    ``()`` without a mesh).  A mesh axis may appear only once: later dims
    that resolve to an already-used mesh axis are replicated instead."""
    m, r = _get()
    mesh = mesh or m
    rules = rules or r or DEFAULT_RULES
    if mesh is None:
        return ()
    entries = []
    used = set()
    for size, name in zip(shape, axes):
        rule = rules.get(name) if name else None
        ent = _resolve_axis(rule, mesh, size, used)
        if ent is not None:
            used.update((ent,) if isinstance(ent, str) else ent)
        entries.append(ent)
    while entries and entries[-1] is None:
        entries.pop()
    return tuple(entries)


def shard(x, *axes):
    """The reference's sharding constraint by logical axis names: the port
    runs on one device, so ``x`` comes back unchanged."""
    return x


@dataclass(frozen=True)
class NamedSharding:
    """The reference's ``NamedSharding``: a mesh and the :func:`spec_for`
    tuple of an array on it.  Recorded, never applied: the port places
    nothing on a mesh."""
    mesh: Any
    spec: Tuple


def named_sharding(shape: Sequence[int], axes: Sequence[Optional[str]],
                   mesh=None, rules: Optional[Dict[str, Axes]] = None
                   ) -> NamedSharding:
    m, r = _get()
    mesh = mesh or m
    rules = rules or r or DEFAULT_RULES
    return NamedSharding(mesh, spec_for(shape, axes, mesh, rules))


def batch_axes(mesh=None) -> Tuple[str, ...]:
    """The mesh axes that carry data parallelism."""
    mesh = mesh or current_mesh()
    names = mesh.axis_names if mesh else ()
    return tuple(a for a in ("pod", "data") if a in names)
