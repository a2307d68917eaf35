"""Shared model machinery: parameter schemas, norms, RoPE, blockwise attention.

Parameters are declared as a nested dict of :class:`ParamDef` (shape +
logical axes + init + dtype); from one schema we derive real
initialization, abstract (meta) tensors and each leaf's partition from
its axes (:func:`param_pspecs`).  Every function here is the
reference's ``models/common.py`` on torch tensors, one implementation for
both devices: each product the reference accumulates in f32
(``preferred_element_type=jnp.float32``) runs on inputs upcast to f32, so
a bf16 product never rounds its output.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Callable, Iterator, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from ..columnar.device import torch_device
from ..sharding import (carried, dtensor, local_part, placed, placements,
                        spec_for)


# ---------------------------------------------------------------------------
# Parameter schema
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class ParamDef:
    shape: Tuple[int, ...]
    axes: Tuple[Optional[str], ...]       # logical axis names (len == ndim)
    init: str = "normal"                  # normal | zeros | ones
    scale: float = 0.02
    dtype: Any = torch.bfloat16

    def __post_init__(self):
        if len(self.shape) != len(self.axes):
            raise ValueError(f"shape {self.shape} vs axes {self.axes}")


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def tree_items(tree, prefix: str = "") -> Iterator[Tuple[str, Any]]:
    """(dotted path, leaf) of a nested dict, keys in sorted order (the
    order ``jax.tree`` flattens a dict in)."""
    for k in sorted(tree):
        v = tree[k]
        path = f"{prefix}{k}"
        if isinstance(v, dict):
            yield from tree_items(v, path + ".")
        else:
            yield path, v


def tree_from_items(items):
    """The nested dicts whose :func:`tree_items` are ``items``."""
    out = {}
    for path, v in items:
        node = out
        *head, last = path.split(".")
        for k in head:
            node = node.setdefault(k, {})
        node[last] = v
    return out


def tree_map(fn: Callable, tree, *rest):
    """``fn`` over the leaves of nested dicts of one structure."""
    if isinstance(tree, dict):
        return {k: tree_map(fn, v, *(r[k] for r in rest))
                for k, v in tree.items()}
    return fn(tree, *rest)


def layer(tree, i):
    """Layer ``i`` of a tree of stacked ``(L, ...)`` leaves: views, so an
    in-place write reaches the stacked tensor."""
    return tree_map(lambda a: a[i], tree)


def layers(tree):
    """Every layer's tree of a tree of stacked ``(L, ...)`` leaves, for a
    pass over all of them.  The slices come from one ``unbind`` per leaf,
    whose backward is one ``stack``: under autograd a slice ``a[i]`` per
    layer would fill a zero gradient of the whole stacked leaf for every
    layer.  Views, as :func:`layer`'s are."""
    cols = tree_map(lambda a: a.unbind(0), tree)
    n = len(next(c for _, c in tree_items(cols)))
    return [tree_map(lambda c: c[i], cols) for i in range(n)]


def stack(trees):
    """The per-layer trees stacked on a new leading axis."""
    return tree_map(lambda *a: torch.stack(a), *trees)


def remat(cfg, fn):
    """``fn`` as the reference's ``_maybe_remat`` gives it: under
    ``cfg.remat`` and autograd its activations are not kept but recomputed
    in the backward pass (``torch.utils.checkpoint``, non-reentrant), so a
    layer holds only its inputs.  ``remat_policy="save_attn"`` recomputes
    everything too: the results are the same, only the recompute's cost
    differs.  Outside autograd ``fn`` runs as it is.  The recompute runs
    under the forward's mesh and rules (:func:`sharding.carried`), so its
    sharding constraints, and so its layouts, are the forward's."""
    if not cfg.remat:
        return fn

    def run(*args):
        if not torch.is_grad_enabled():
            return fn(*args)
        return checkpoint(carried(), fn, *args, use_reentrant=False)

    return run


def init_params(schema, seed: int = 0, device: str = "cuda", mesh=None):
    """Materialize a schema into real tensors on ``device``, drawn from one
    ``torch.Generator`` seeded with ``seed`` on that device.  A stacked
    leaf fills slice by slice along its leading axis, so no f32 copy of a
    whole leaf is ever held (granite-3-8b's ``blocks.mlp.w_in`` is 16.8 GB
    in f32).

    With a ``mesh`` that carries a ``device_mesh`` each leaf is a DTensor
    placed by its partition (:func:`param_pspecs`): every rank draws the
    same numbers in the same order as one device does and keeps only its
    own block of each slice, so the values are one device's and no rank
    ever holds a whole leaf."""
    dev = torch_device(device)
    gen = torch.Generator(device=dev)
    gen.manual_seed(seed)
    dm = getattr(mesh, "device_mesh", None)

    def make(d: ParamDef):
        if dm is None:
            return fill(d, lambda x: x, d.shape)
        places = placements(spec_for(d.shape, d.axes, mesh), mesh)
        # the leading (layer) axis is never sharded: a slice's placements
        # are the leaf's one dim down
        sub = places if len(d.shape) < 3 else tuple(
            type(p)(p.dim - 1) if p.is_shard() else p for p in places)
        local = local_part(torch.empty(d.shape, device="meta"), dm,
                           places).shape
        out = fill(d, lambda x: local_part(x, dm, sub), local)
        return dtensor(out, dm, places, d.shape)

    def fill(d: ParamDef, keep, shape):
        """A leaf of ``shape``: ``keep`` of each whole slice drawn."""
        if d.init == "zeros":
            return torch.zeros(shape, dtype=d.dtype, device=dev)
        if d.init == "ones":
            return torch.ones(shape, dtype=d.dtype, device=dev)
        out = torch.empty(shape, dtype=d.dtype, device=dev)
        parts = out if out.dim() >= 3 else [out]
        whole = d.shape[1:] if out.dim() >= 3 else d.shape
        for part in parts:
            # scaled in place: one f32 slice at a time (deepseek-v3's
            # expert slice is 28 GiB in f32)
            part.copy_(keep(torch.randn(whole, generator=gen, device=dev,
                                        dtype=torch.float32).mul_(d.scale)))
        return out

    return tree_map(make, schema)


def split_heads(t, n: int, hd: int):
    """(B, S, n * hd) -> (B, S, n, hd).  A placed ``t`` whose last dim is
    split into more blocks than there are heads, or into blocks that
    would cut a head, is gathered over the mesh dims that split it first
    (granite-3-8b's 8 kv heads on a "model" axis of 16): each rank then
    holds every head, and attention (``attention._attend``) takes those
    its query heads read.  A placed ``t`` splits on each rank's block, as
    :func:`merge_heads` merges (a block of whole heads, or a block of
    the sequence with every head: ``seq_parallel_proj``)."""
    if not placed(t):
        return t.reshape(t.shape[:-1] + (n, hd))
    last = t.dim() - 1
    dims = [i for i, p in enumerate(t.placements) if p.is_shard(last)]
    if n % math.prod(t.device_mesh.size(i) for i in dims):
        from torch.distributed.tensor import Replicate
        t = t.redistribute(t.device_mesh, tuple(
            Replicate() if i in dims else p
            for i, p in enumerate(t.placements)))
    local = t.to_local(grad_placements=t.placements)
    return dtensor(local.reshape(local.shape[:-1] + (-1, hd)), t.device_mesh,
                   t.placements, t.shape[:-1] + (n, hd))


def merge_heads(t):
    """(B, S, n, hd) -> (B, S, n * hd).  A placed ``t`` (its head dim
    sharded or whole, never its ``hd``) merges on each rank's block, so
    the gradient, in whatever placement it comes back, is brought to
    ``t``'s before it is split again: DTensor's own view would have to
    cut heads where the gradient's blocks of the merged dim are smaller
    than a head."""
    if not placed(t):
        return t.reshape(t.shape[:-2] + (-1,))
    local = t.to_local(grad_placements=t.placements)
    return dtensor(local.reshape(local.shape[:-2] + (-1,)), t.device_mesh,
                   t.placements, t.shape[:-2] + (t.shape[-2] * t.shape[-1],))


def abstract_params(schema):
    """Meta tensors of each leaf's shape and dtype: no allocation."""
    return tree_map(lambda d: torch.empty(d.shape, dtype=d.dtype,
                                          device="meta"), schema)


def param_pspecs(schema, mesh=None, rules=None):
    """The tree of ``spec_for`` tuples from the logical axes (the
    reference's ``PartitionSpec`` tree)."""
    return tree_map(lambda d: spec_for(d.shape, d.axes, mesh, rules), schema)


def count_params(schema) -> int:
    return int(sum(np.prod(d.shape) for _, d in tree_items(schema)))


def matmul(x, w, bias=None):
    """``x @ w + bias`` for a dense projection: x (..., K), w (K, N),
    bias (N,) or None; x and w of two dtypes multiply in the promoted one
    (an f32 stub input against bf16 weights, as JAX promotes them).

    Placed on a mesh, the layout is fixed here rather than left to
    DTensor's cost model (whose choice depends on the sizes and, at full
    width, can shard a product's rows over "model", which its view rules
    then refuse to fold back).  On each mesh dim, in the reference's
    GSPMD pattern: where x is sharded on a row dim (its batch, or a decode
    cache's positions), w is gathered over that dim (FSDP) and y keeps
    x's rows; else where w is sharded on its output dim, x is gathered and
    y sharded on its last dim (column-parallel); else where w is sharded
    on its input dim, x is sharded on its last dim and y is partial
    (row-parallel: its partial sums in the product's dtype; a bias is
    added after they are reduced); else all three are replicated.  Each
    rank then multiplies its local blocks."""
    if not placed(w):
        y = x @ w if x.dtype == w.dtype else promote_mm(x, w)
        return y if bias is None else y + bias
    from torch.distributed.tensor import DTensor, Partial, Replicate, Shard
    if not placed(x):                  # a plain input: the same on each rank
        x = DTensor.from_local(x, w.device_mesh,
                               (Replicate(),) * w.device_mesh.ndim,
                               run_check=False)
    dm, last = x.device_mesh, x.dim() - 1
    want_x, want_w, out, grad_x, grad_w = [], [], [], [], []
    for px, pw in zip(x.placements, w.placements):
        if px.is_shard() and px.dim < last:      # FSDP: rows stay put
            d = px.dim
            plan = (Shard(d), Replicate(), Shard(d), Shard(d), Partial())
        elif pw.is_shard(1):                     # column-parallel
            plan = (Replicate(), Shard(1), Shard(last), Partial(), Shard(1))
        elif pw.is_shard(0):                     # row-parallel
            plan = (Shard(last), Shard(0), Partial(), Shard(last), Shard(0))
        else:
            plan = (Replicate(),) * 5
        for acc, p in zip((want_x, want_w, out, grad_x, grad_w), plan):
            acc.append(p)
    xl = x.redistribute(dm, want_x).to_local(grad_placements=grad_x)
    wl = w.redistribute(dm, want_w).to_local(grad_placements=grad_w)
    shape = x.shape[:-1] + w.shape[-1:]
    y = dtensor(xl @ wl if xl.dtype == wl.dtype else promote_mm(xl, wl),
                dm, out, shape)
    if bias is None:
        return y
    out = [Replicate() if p.is_partial() else p for p in out]
    return y.redistribute(dm, out) + bias.redistribute(
        dm, [Shard(0) if p.is_shard(last) else Replicate() for p in out])


def promote_mm(a, b):
    """``a @ b`` with JAX's dtype promotion (f32 @ bf16 runs in f32)."""
    dt = torch.promote_types(a.dtype, b.dtype)
    return a.to(dt) @ b.to(dt)


# ---------------------------------------------------------------------------
# Numerics
# ---------------------------------------------------------------------------
def rms_norm(x, scale, eps: float = 1e-5):
    xf = x.float()
    var = (xf * xf).mean(-1, keepdim=True)
    out = xf * torch.rsqrt(var + eps)
    return (out * scale.float()).to(x.dtype)


def layer_norm(x, scale, bias, eps: float = 1e-5):
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = ((xf - mu) ** 2).mean(-1, keepdim=True)
    out = (xf - mu) * torch.rsqrt(var + eps)
    return (out * scale.float() + bias.float()).to(x.dtype)


def swiglu(gate, up):
    return F.silu(gate.float()).to(gate.dtype) * up


# ---------------------------------------------------------------------------
# RoPE
# ---------------------------------------------------------------------------
def rope_freqs(head_dim: int, theta: float, device=None):
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x, positions, theta: float = 1e4):
    """x: (..., S, H, D) or (..., S, D); positions: (..., S)."""
    d = x.shape[-1]
    freqs = rope_freqs(d, theta, x.device)                  # (D/2,)
    ang = positions[..., None].float() * freqs              # (..., S, D/2)
    if x.dim() == ang.dim() + 1:                            # head axis
        ang = ang[..., None, :]
    cos, sin = torch.cos(ang), torch.sin(ang)
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoid_positions(seq: int, d: int, device=None):
    pos = np.arange(seq)[:, None]
    i = np.arange(d // 2)[None, :]
    ang = pos / (10000 ** (2 * i / d))
    return torch.tensor(np.concatenate([np.sin(ang), np.cos(ang)], axis=-1),
                        dtype=torch.float32, device=device)


# ---------------------------------------------------------------------------
# Blockwise (flash-style) attention, O(block_q * block_kv) scores per head
# ---------------------------------------------------------------------------
def blockwise_attention(q, k, v, *, causal: bool, q_offset: int = 0,
                        block_q: int = 1024, block_kv: int = 1024,
                        kv_len_mask: Optional[int] = None,
                        window: int = 0):
    """Numerically-stable chunked attention.

    q: (B, Sq, Hq, D); k: (B, Sk, Hkv, D); v: (B, Sk, Hkv, Dv) with
    Hq % Hkv == 0 (GQA) and Dv free (MLA).  Causal masking treats query
    position i as absolute ``q_offset + i``; ``window > 0`` adds sliding-
    window masking.  The reference's ``lax.map`` over query blocks and
    ``lax.scan`` over key blocks are Python loops here, the same running
    max / sum / accumulator updates in f32.
    """
    b, sq, hq, d = q.shape
    _, sk, hkv, _ = k.shape
    dv = v.shape[-1]
    group = hq // hkv
    scalef = 1.0 / math.sqrt(d)
    dev = q.device

    bq = min(block_q, sq)
    bkv = min(block_kv, sk)
    pad_q = (-sq) % bq
    pad_kv = (-sk) % bkv
    if pad_q:
        q = F.pad(q, (0, 0, 0, 0, 0, pad_q))
    if pad_kv:
        k = F.pad(k, (0, 0, 0, 0, 0, pad_kv))
        v = F.pad(v, (0, 0, 0, 0, 0, pad_kv))
    nq, nkv = (sq + pad_q) // bq, (sk + pad_kv) // bkv

    qb = q.reshape(b, nq, bq, hkv, group, d).float()
    kb = k.reshape(b, nkv, bkv, hkv, d).float()
    vb = v.reshape(b, nkv, bkv, hkv, dv).float()

    q_pos = (q_offset + torch.arange(sq + pad_q, device=dev)).reshape(nq, bq)
    k_pos = torch.arange(sk + pad_kv, device=dev).reshape(nkv, bkv)
    k_valid = (torch.arange(sk + pad_kv, device=dev)
               < (sk if kv_len_mask is None else kv_len_mask)).reshape(nkv,
                                                                       bkv)
    outs = []
    for qi in range(nq):
        qc, qp = qb[:, qi], q_pos[qi]               # (B, bq, Hkv, G, D)
        acc = torch.zeros((b, hkv, group, bq, dv), dtype=torch.float32,
                          device=dev)
        m = torch.full((b, hkv, group, bq), -1e30, dtype=torch.float32,
                       device=dev)
        l = torch.zeros((b, hkv, group, bq), dtype=torch.float32, device=dev)
        for ki in range(nkv):
            kc, vc = kb[:, ki], vb[:, ki]           # (B, bkv, Hkv, D[v])
            s = torch.einsum("bqhgd,bkhd->bhgqk", qc, kc) * scalef
            mask = k_valid[ki][None, :]
            if causal:
                mask = mask & (qp[:, None] >= k_pos[ki][None, :])
            if window:
                mask = mask & (qp[:, None] - k_pos[ki][None, :] < window)
            s = torch.where(mask[None, None, None], s, -1e30)
            m_new = torch.maximum(m, s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            corr = torch.exp(m - m_new)
            l = l * corr + p.sum(-1)
            acc = acc * corr[..., None] + torch.einsum("bhgqk,bkhd->bhgqd",
                                                       p, vc)
            m = m_new
        outs.append(acc / torch.clamp(l[..., None], min=1e-30))
    out = torch.stack(outs, dim=3)                  # (B, Hkv, G, nq, bq, Dv)
    out = out.reshape(b, hkv, group, nq * bq, dv)[:, :, :, :sq]
    out = out.permute(0, 3, 1, 2, 4).reshape(b, sq, hq, dv)
    return out.to(q.dtype)


def decode_attention(q, k, v):
    """Single-position attention against a cache, softmax over all of it.

    q: (B, 1, Hq, D); k/v: (B, Sk, Hkv, D)."""
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float()) / math.sqrt(d)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", p, v.float())
    return o.reshape(b, 1, hq, d).to(q.dtype)


def cross_entropy(logits, labels, mask=None):
    """Mean token CE in f32. logits (B, S, V); labels (B, S) int.

    On one device the gold logit is gathered.  Placed on a mesh (a
    DTensor, vocab-sharded) it is the reference's iota-compare masked sum,
    so the reduction stays vocab-sharded and the (B, S, V) f32 logits are
    never gathered.  Padded vocab columns come in at -1e30 and add nothing
    to the log-sum-exp."""
    logits = logits.float()
    logz = torch.logsumexp(logits, dim=-1)
    if placed(logits):
        vidx = torch.arange(logits.shape[-1], device=logits.device)
        gold = torch.where(vidx == labels.long()[..., None], logits,
                           0.0).sum(-1)
    else:
        gold = torch.gather(logits, -1, labels.long()[..., None])[..., 0]
    nll = logz - gold
    if mask is None:
        return nll.mean()
    mask = mask.float()
    return (nll * mask).sum() / torch.clamp(mask.sum(), min=1.0)
