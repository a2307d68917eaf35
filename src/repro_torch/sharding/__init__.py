"""Logical-axis sharding rules, as the reference names them, and their
placements on a device mesh.

Parameter schemas carry logical axis names (``"embed"``, ``"q_dim"``,
``"kv_seq"``, ...); one rules table maps each to mesh axes.
:func:`spec_for` computes the partition the reference gives an array on
a mesh (its ``PartitionSpec`` entries as a plain tuple) and
:func:`placements` turns it into DTensor placements: a mesh axis named in
dim *d*'s entry is ``Shard(d)`` on that mesh dim, every other mesh dim
``Replicate()``.

A mesh here is any object with ``axis_names`` and a ``shape`` mapping of
axis name to size, as the reference's ``spec_for`` reads it; one that
also carries a ``device_mesh`` (a ``torch.distributed`` ``DeviceMesh``
of an initialised process group, one process per device:
:func:`repro_torch.launch.mesh.make_device_mesh`) places data.  Under
such a mesh (:func:`use_mesh`) :func:`shard` redistributes a DTensor to
its partition, as the reference's ``with_sharding_constraint`` does, and
:func:`distribute` places a whole tensor, as ``device_put`` with a
``NamedSharding`` does.  Without one (no mesh, the ``meta`` production
mesh, a host mesh for checking) nothing moves: :func:`shard` returns its
input.

Resolution is divisibility-aware: a mesh axis is dropped from a dim whose
size it does not divide (the dim is then replicated).
"""
from __future__ import annotations

import contextlib
import threading
from dataclasses import dataclass
from typing import Any, Dict, Optional, Sequence, Tuple, Union

import torch

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


def current_rules():
    """The rules installed with :func:`current_mesh` (None without)."""
    return _get()[1]


def carried():
    """A function that runs ``fn(*args)`` under the (mesh, rules)
    installed on this thread now, on whichever thread calls it: autograd
    recomputes a checkpointed layer on its own device thread, where this
    thread's :func:`use_mesh` is not installed."""
    mesh, rules = _get()

    def call(fn, *args):
        if mesh is None:
            return fn(*args)
        with use_mesh(mesh, rules):
            return fn(*args)
    return call


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


def placed(x) -> bool:
    """Whether ``x`` is a DTensor (a tensor placed on a device mesh)."""
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def placements(spec: Tuple, mesh) -> Tuple:
    """The DTensor placements (one per mesh axis, in the mesh's order) of
    a :func:`spec_for` tuple: ``Shard(d)`` on a mesh axis that dim *d*'s
    entry names, ``Replicate()`` on every other and on an axis of size 1
    (one block is the whole)."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for name in mesh.axis_names:
        dim = next((d for d, ent in enumerate(spec) if ent == name or (
            isinstance(ent, tuple) and name in ent)), None)
        out.append(Replicate() if dim is None or mesh.shape[name] == 1
                   else Shard(dim))
    return tuple(out)


def _device_mesh():
    mesh, rules = _get()
    return getattr(mesh, "device_mesh", None), mesh, rules


def shard(x, *axes):
    """The reference's sharding constraint by logical axis names: a
    DTensor under a mesh with a ``device_mesh`` is redistributed to the
    partition ``spec_for`` gives it; anything else comes back unchanged.
    A mesh dim that moves its split from one dim to another (a sequence
    to heads, as XLA's all-to-all in the reference) moves it by
    :func:`all_to_all`."""
    dm, mesh, rules = _device_mesh()
    if dm is None or not placed(x):
        return x
    return redistribute(x, placements(spec_for(x.shape, axes, mesh, rules),
                                      mesh))


def redistribute(x, want):
    """A DTensor ``x`` redistributed to the placements ``want``: a mesh
    dim whose split moves from one dim of ``x`` to another by
    :func:`all_to_all` (where no other mesh dim splits either), the rest
    by DTensor."""
    want = tuple(want)
    for i, (have, to) in enumerate(zip(x.placements, want)):
        if have.is_shard() and to.is_shard() and have.dim != to.dim and \
                _only_split_by(x.placements, want, i, (have.dim, to.dim)) \
                and x.shape[to.dim] % x.device_mesh.size(i) == 0:
            x = all_to_all(x, i, to.dim)
    if tuple(x.placements) == want:
        return x
    return x.redistribute(x.device_mesh, want)


def _only_split_by(have, want, mesh_dim: int, dims) -> bool:
    """Whether no mesh dim but ``mesh_dim`` splits any of ``dims`` in
    either placement tuple."""
    return not any(p.is_shard() and p.dim in dims
                   for places in (have, want)
                   for i, p in enumerate(places) if i != mesh_dim)


def all_to_all(x, mesh_dim: int, dim: int):
    """A DTensor ``x`` split on mesh dim ``mesh_dim`` along one of its
    dims, split along ``dim`` instead: each rank cuts its block into that
    mesh dim's size parts along ``dim`` and sends part *j* to the *j*-th
    rank of the mesh dim, which joins what it receives along the old dim.
    One ``all_to_all_single`` over the mesh dim's group, forward and
    backward: NCCL's all-to-all, as DTensor's own ``shard_dim_alltoall``,
    which on a CPU group (gloo, or the dry-run's fake group) all-gathers
    and chunks instead; :class:`~repro_torch.launch.roofline.
    CollectiveCounter` counts it as one all-to-all."""
    from torch.distributed import _functional_collectives as funcol
    from torch.distributed.tensor import Shard
    dm = x.device_mesh
    src = x.placements[mesh_dim].dim
    places = tuple(Shard(dim) if i == mesh_dim else p
                   for i, p in enumerate(x.placements))
    parts = torch.stack(x.to_local(grad_placements=x.placements).chunk(
        dm.size(mesh_dim), dim))
    got = funcol.wait_tensor(funcol.all_to_all_single_autograd(
        parts.flatten(0, 1), None, None, (dm, mesh_dim))).reshape(parts.shape)
    return dtensor(torch.cat(got.unbind(0), dim=src), dm, places, x.shape)


def replicate_plain():
    """Under a mesh with a ``device_mesh``, a context in which a plain
    tensor meeting a DTensor in an op counts as replicated (DTensor's
    ``implicit_replication``); elsewhere a context that does nothing.

    The models make some tensors themselves (positions, RoPE angles, the
    vocab iota, the aux loss's zeros) as plain tensors, the same on every
    rank.  The context is entered around a loss and its gradient
    (``train.step``), not around the block body alone: the backward of
    those ops (the RoPE products, a masked ``where``) meets the same plain
    tensors, and the
    flag travels to autograd's device threads with the thread-local
    state ``autograd.grad`` captures."""
    if _device_mesh()[0] is None:
        return contextlib.nullcontext()
    from torch.distributed.tensor.experimental import implicit_replication
    return implicit_replication()


@dataclass(frozen=True)
class NamedSharding:
    """The reference's ``NamedSharding``: a mesh and the :func:`spec_for`
    tuple of an array on it; :func:`distribute` applies it."""
    mesh: Any
    spec: Tuple


def named_sharding(shape: Sequence[int], axes: Sequence[Optional[str]],
                   mesh=None, rules: Optional[Dict[str, Axes]] = None
                   ) -> NamedSharding:
    m, r = _get()
    mesh = mesh or m
    rules = rules or r or DEFAULT_RULES
    return NamedSharding(mesh, spec_for(shape, axes, mesh, rules))


def local_part(x, device_mesh, places):
    """This rank's block of a whole tensor ``x`` under ``places`` on
    ``device_mesh`` (a view): each ``Shard(d)`` takes the rank's equal
    share of dim ``d`` along that mesh dim, in mesh-dim order, as DTensor
    splits it."""
    coord = device_mesh.get_coordinate()
    for i, p in enumerate(places):
        if p.is_shard():
            n, size = device_mesh.size(i), x.shape[p.dim]
            if size % n:
                raise ValueError(f"dim {p.dim} of {tuple(x.shape)} does not "
                                 f"split into {n} equal parts")
            x = x.narrow(p.dim, coord[i] * (size // n), size // n)
    return x


def block(x, dim: int) -> Tuple[int, int]:
    """``(lo, n)``: the positions ``[lo, lo + n)`` of dim ``dim`` that this
    rank's block of ``x`` holds (the whole dim for a plain tensor or an
    unsharded dim), as :func:`local_part` splits it."""
    if not placed(x):
        return 0, x.shape[dim]
    return block_of(x.shape, dim, x.device_mesh, x.placements)


def block_of(shape, dim: int, device_mesh, places) -> Tuple[int, int]:
    """``(lo, n)`` of :func:`block` for a tensor of global ``shape`` placed
    by ``places`` on ``device_mesh``."""
    lo, n = 0, shape[dim]
    coord = device_mesh.get_coordinate()
    for i, p in enumerate(places):
        if p.is_shard(dim):
            n //= device_mesh.size(i)
            lo += coord[i] * n
    return lo, n


def seq_dims(x, dim: int) -> Tuple[int, ...]:
    """The mesh dims over which dim ``dim`` of ``x`` is sharded (none for
    a plain tensor)."""
    if not placed(x):
        return ()
    return tuple(i for i, p in enumerate(x.placements) if p.is_shard(dim))


def write_at(t, dim: int, pos: int, value) -> None:
    """``t[..., pos, ...] = value`` along dim ``dim``, in place.  ``value``
    has ``t``'s shape without that dim.  On a placed ``t`` only the rank
    whose block of dim ``dim`` holds ``pos`` writes, at ``pos - lo`` of its
    local block (``value`` brought to ``t``'s placement of the other dims
    first); every other rank writes nothing.  A plain ``t``, or an
    unsharded dim, takes the plain index assignment.  Writes into the
    local blocks directly, so it works under ``torch.inference_mode()``
    (a DTensor's own ``__setitem__`` on a sharded dim loses the write)."""
    idx = (slice(None),) * dim
    if not placed(t):
        t[idx + (pos,)] = value
        return
    from torch.distributed.tensor import Replicate, Shard
    dm = t.device_mesh
    want = tuple(Replicate() if p.is_shard(dim) else
                 Shard(p.dim - (p.dim > dim)) if p.is_shard() else p
                 for p in t.placements)
    if placed(value):
        v = value.redistribute(dm, want).to_local()
    else:
        v = local_part(value, dm, want)
    lo, n = block(t, dim)
    if lo <= pos < lo + n:
        t.to_local()[idx + (pos - lo,)] = v


def lookup(table, tokens):
    """``table[tokens]``, the rows of a placed (V, d) ``table``, without
    moving the table: each rank looks up every token (the tokens
    gathered: small) in its own block of rows and columns, a token whose
    row lies in another block giving zeros; the blocks are summed over the
    mesh dims that split the rows (exact: each row lies in one block) and
    the result placed by the tokens' batch placement, whole over every
    other mesh dim.  Outside autograd only: an index's backward has no
    DTensor rule."""
    import torch.nn.functional as F
    from torch.distributed.tensor import Partial, Replicate, Shard
    dm = table.device_mesh
    whole = (Replicate(),) * dm.ndim
    tok = tokens.redistribute(dm, whole).to_local() if placed(tokens) \
        else tokens
    lo, n = block(table, 0)
    ids = tok - lo
    local = table.to_local()
    x = F.embedding(ids.clamp(0, n - 1), local)
    x = torch.where(((ids >= 0) & (ids < n))[..., None], x,
                    torch.zeros((), dtype=x.dtype, device=x.device))
    places = tuple(Partial() if p.is_shard(0) else
                   Shard(tok.dim()) if p.is_shard(1) else Replicate()
                   for p in table.placements)
    y = dtensor(x, dm, places, tuple(tok.shape) + tuple(table.shape[1:]))
    return redistribute(y, rows_of(tokens) if placed(tokens) else whole)


def dtensor(local, device_mesh, places, shape):
    """A DTensor of global ``shape`` (contiguous strides) from this rank's
    block ``local``.  The strides are computed, not read off an empty
    tensor of the global shape: inside a traced step such a tensor would
    count as created storage (``launch.roofline``)."""
    from torch.distributed.tensor import DTensor
    stride, n = [], 1
    for size in reversed(tuple(shape)):
        stride.append(n)
        n *= max(size, 1)
    return DTensor.from_local(local, device_mesh, tuple(places),
                              run_check=False, shape=torch.Size(shape),
                              stride=tuple(reversed(stride)))


def rows_of(x) -> Tuple:
    """The placements of ``x``'s rows (its dim 0, the batch): ``x``'s own
    on the mesh dims that shard dim 0, ``Replicate()`` on every other."""
    from torch.distributed.tensor import Replicate
    return tuple(p if p.is_shard(0) else Replicate() for p in x.placements)


def local_rows(t, rows):
    """This rank's rows of a placed ``t`` (batch on dim 0), every other
    dim whole: the block plain code runs on.  The rank computes those rows
    alone, so their gradient has the same placement."""
    return t.redistribute(t.device_mesh, rows).to_local(grad_placements=rows)


def local_whole(w, rows):
    """A placed weight ``w`` whole on each rank, for plain code on the
    rows ``rows``: its gradient is partial over the mesh dims that split
    the rows and the same on every other."""
    from torch.distributed.tensor import Partial, Replicate
    return w.redistribute(w.device_mesh, (Replicate(),) * len(rows)) \
        .to_local(grad_placements=tuple(Partial() if r.is_shard() else
                                        Replicate() for r in rows))


def all_reduce(x, op: str, device_mesh, mesh_dims: Sequence[int]):
    """A plain (local) tensor reduced (``"sum"`` or ``"max"``) over the
    ranks of ``mesh_dims`` of ``device_mesh``, one functional collective
    per mesh dim (no host sync; :class:`~repro_torch.launch.roofline.
    CollectiveCounter` counts them)."""
    from torch.distributed import _functional_collectives as funcol
    for i in mesh_dims:
        x = funcol.all_reduce(x, op, (device_mesh, i))
    return funcol.wait_tensor(x) if mesh_dims else x


def distribute(x, sharding):
    """``x``, the same whole tensor on every rank, as a DTensor placed by
    ``sharding``: a :class:`NamedSharding` on a mesh with a
    ``device_mesh``, or a DTensor whose mesh and placements ``x`` takes.
    Each rank copies its own block to its device (a ``meta`` ``x`` gives a
    ``meta`` block: the dry-run's abstract arguments); nothing moves
    between ranks.  A :class:`NamedSharding` on a mesh without a
    ``device_mesh`` returns ``x`` as it is."""
    if isinstance(sharding, NamedSharding):
        dm = getattr(sharding.mesh, "device_mesh", None)
        if dm is None:
            return x
        places = placements(sharding.spec, sharding.mesh)
    else:
        dm, places = sharding.device_mesh, tuple(sharding.placements)
    part = local_part(x, dm, places)
    dev = (x.device if x.is_meta else
           torch.device("cuda", torch.cuda.current_device())
           if dm.device_type == "cuda" else torch.device(dm.device_type))
    local = torch.empty(part.shape, dtype=x.dtype, device=dev)
    local.copy_(part)
    return dtensor(local, dm, places, x.shape)


def batch_axes(mesh=None) -> Tuple[str, ...]:
    """The mesh axes that carry data parallelism."""
    mesh = mesh or current_mesh()
    names = mesh.axis_names if mesh else ()
    return tuple(a for a in ("pod", "data") if a in names)
