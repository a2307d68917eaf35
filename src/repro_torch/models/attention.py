"""Attention variants: GQA (llama-family), MLA (DeepSeek/MiniCPM3), cross.

Each variant exposes ``*_schema(cfg)`` (ParamDefs), ``*_train`` (full-seq
causal), and ``*_decode`` (one token against a cache).  Caches are plain
dicts of tensors sized by the caller.  A decode step writes its new
position into the cache tensors it is given, in place (the reference's
``dynamic_update_slice`` without the copy of the whole buffer), and
returns them.
"""
from __future__ import annotations

import functools
import math
from typing import Dict, Optional

import torch

from ..sharding import (all_reduce, block, dtensor, placed, rows_of,
                        seq_dims, shard, write_at)
from .common import (ParamDef, apply_rope, blockwise_attention,
                     decode_attention, matmul, rms_norm, split_heads)
from .config import LMConfig


def _lead(L):
    return ((L,), ("layers",)) if L else ((), ())


# ---------------------------------------------------------------------------
# GQA
# ---------------------------------------------------------------------------
def gqa_schema(cfg: LMConfig, layers: Optional[int] = None) -> Dict:
    """Stacked (layers, ...) GQA projection weights."""
    L = cfg.n_layers if layers is None else layers
    d, h, kv, hd = cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    lead, lax = _lead(L)
    p = {
        "wq": ParamDef(lead + (d, h * hd), lax + ("embed", "q_dim")),
        "wk": ParamDef(lead + (d, kv * hd), lax + ("embed", "kv_dim")),
        "wv": ParamDef(lead + (d, kv * hd), lax + ("embed", "kv_dim")),
        "wo": ParamDef(lead + (h * hd, d), lax + ("q_dim", "embed")),
    }
    if cfg.qk_norm:
        p["q_norm"] = ParamDef(lead + (hd,), lax + (None,), init="ones")
        p["k_norm"] = ParamDef(lead + (hd,), lax + (None,), init="ones")
    return p


def _qkv(cfg: LMConfig, p, x, positions):
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q2, k2, v2 = (matmul(x, p["wq"]), matmul(x, p["wk"]),
                  matmul(x, p["wv"]))
    if cfg.seq_parallel_proj:
        # projections kept sequence-parallel: the (small) weights are
        # gathered over "model", not the activations
        q2 = shard(q2, "batch", "act_seq", None)
        k2 = shard(k2, "batch", "act_seq", None)
        v2 = shard(v2, "batch", "act_seq", None)
    q, k, v = (split_heads(t, n, hd) for t, n in ((q2, h), (k2, kv),
                                                   (v2, kv)))
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _positions(x, s):
    return torch.arange(s, device=x.device)[None, :]


def _attend(q, k, v, fn=blockwise_attention, **kw):
    """``fn`` (:func:`blockwise_attention`, or :func:`decode_attention`)
    of q (B, Sq, Hq, D) over k, v (B, Sk, Hkv, D).  Placed on a mesh (q
    sharded over batch and heads, as the reference's sites put it), each
    rank attends its own batch rows and heads on its local blocks: k and
    v placed as q is (each rank's own heads, when there are as many kv
    heads as query heads), or else taking q's batch placement and, of
    their heads, those that q's local heads read: a block of whole GQA
    groups, or the one group a block lies in (a group straddling two
    blocks raises).  Gradients of whole k and v come back ``Partial``
    over each mesh dim that shards q's heads: a kv head that the query
    heads of several ranks read has its gradient split among them.  The
    attention itself moves no data."""
    if not placed(q):
        return fn(q, k, v, **kw)
    from torch.distributed.tensor import Partial, Replicate
    dm, qp = q.device_mesh, tuple(q.placements)
    hq, hkv = q.shape[2], k.shape[2]
    ql = q.to_local()
    hl = ql.shape[2]
    if hkv == hq and tuple(k.placements) == qp == tuple(v.placements):
        kl = k.to_local(grad_placements=qp)
        vl = v.to_local(grad_placements=qp)
    else:
        kvp = tuple(p if p.is_shard(0) else Replicate() for p in qp)
        grad = tuple(Partial() if a.is_shard(2) else p
                     for a, p in zip(qp, kvp))
        kl = k.redistribute(dm, kvp).to_local(grad_placements=grad)
        vl = v.redistribute(dm, kvp).to_local(grad_placements=grad)
        if hl != hq:                          # heads sharded: their kv heads
            first = block(q, 2)[0]
            group = hq // hkv
            if hl % group and group % hl:
                raise NotImplementedError(
                    f"{hl} query heads per block with GQA groups of {group}:"
                    " a group straddles two head blocks")
            lo, n = first // group, max(1, hl // group)
            kl, vl = kl.narrow(2, lo, n), vl.narrow(2, lo, n)
    o = fn(ql, kl, vl, **kw).contiguous()
    return dtensor(o, dm, qp, q.shape[:3] + v.shape[3:])


def gqa_train(cfg: LMConfig, p, x, *, window: int = 0):
    """Causal self-attention over the full sequence. x: (B, S, d)."""
    b, s, _ = x.shape
    q, k, v = _qkv(cfg, p, x, _positions(x, s))
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", None, None)
    v = shard(v, "batch", "seq", None, None)
    o = _attend(q, k, v, causal=True, window=window,
                block_q=cfg.attn_block_q, block_kv=cfg.attn_block_kv)
    o = shard(o, "batch", "seq", "heads", None)
    return matmul(o.reshape(b, s, cfg.n_heads * cfg.head_dim), p["wo"])


def gqa_cache_schema(cfg: LMConfig, batch: int, max_seq: int,
                     layers: Optional[int] = None) -> Dict:
    L = cfg.n_layers if layers is None else layers
    kv, hd = cfg.n_kv_heads, cfg.head_dim
    lead, lax = _lead(L)
    return {
        "k": ParamDef(lead + (batch, max_seq, kv, hd),
                      lax + ("batch", "kv_seq", None, None), init="zeros"),
        "v": ParamDef(lead + (batch, max_seq, kv, hd),
                      lax + ("batch", "kv_seq", None, None), init="zeros"),
    }


def gqa_decode(cfg: LMConfig, p, x, cache, index: int, *, window: int = 0):
    """One-step decode. x: (B, 1, d); cache: {"k","v"} (B, S, kv, hd);
    index: the current position (a host int). Writes the new K/V into
    ``cache`` at its slot and returns (out, cache)."""
    b = x.shape[0]
    positions = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
    q, k, v = _qkv(cfg, p, x, positions)
    slot = index % window if window else index
    ck, cv = cache["k"], cache["v"]
    write_at(ck, 1, slot, k[:, 0].to(ck.dtype))
    write_at(cv, 1, slot, v[:, 0].to(cv.dtype))
    ck = shard(ck, "batch", "kv_seq", None, None)
    cv = shard(cv, "batch", "kv_seq", None, None)
    s_max = ck.shape[1]
    valid = torch.arange(s_max, device=x.device) <= (
        min(index, s_max - 1) if window else index)
    o = _masked_decode_attn(q, ck, cv, valid)
    out = matmul(o.reshape(b, 1, cfg.n_heads * cfg.head_dim), p["wo"])
    return out, {"k": ck, "v": cv}


def _masked_decode_attn(q, k, v, valid, seq_group=None):
    """q (B, 1, Hq, D) against a cache k, v (B, S, Hkv, D), the positions
    ``valid`` (S,) masked in.  On a cache whose positions are sharded
    (``kv_seq``), see :func:`_on_seq_blocks` (which passes
    ``seq_group``)."""
    if seq_dims(k, 1):
        return _on_seq_blocks(_masked_decode_attn, q, (k, v), valid)
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    dv = v.shape[-1]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float()) / math.sqrt(d)
    s = torch.where(valid[None, None, None, :], s, -1e30)
    o = _softmax_weighted(s, v.float(), "bhgk,bkhd->bhgd", seq_group)
    return o.reshape(b, 1, hq, dv).to(q.dtype)


def _softmax_weighted(s, v, eq, seq_group=None):
    """``einsum(eq, softmax(s, -1), v)``, the softmax over the last dim of
    the scores ``s``.  With ``seq_group`` (a device mesh and the mesh dims
    that split the positions, from :func:`_on_seq_blocks`) ``s`` and ``v``
    hold this rank's positions only: the maxima, the sums of exponentials
    and the weighted values are combined over those ranks (one all-reduce
    of the maxima, one of the rescaled sums and values)."""
    if seq_group is None:
        return torch.einsum(eq, torch.softmax(s, dim=-1), v)
    dm, dims = seq_group
    m = all_reduce(s.amax(-1, keepdim=True), "max", dm, dims)
    pr = torch.exp(s - m)
    o = torch.einsum(eq, pr, v)
    lsum = pr.sum(-1)
    # one all-reduce for both: the sums ride as o's last column
    both = all_reduce(torch.cat([o, lsum.reshape(o.shape[:-1] + (1,))],
                                dim=-1), "sum", dm, dims)
    return both[..., :-1] / both[..., -1:]


def _on_seq_blocks(fn, q, cache, valid, *weights):
    """``fn(q, *cache, valid, *weights, seq_group=...)`` on a cache whose
    position dim (dim 1 of every leaf of ``cache``) is sharded over
    "model", the counterpart of what GSPMD makes of the reference's
    ``kv_seq``-sharded cache: the cache never moves.  Each rank runs
    ``fn`` on plain tensors: its own block of the cache and of ``valid``,
    its batch rows of the query with every head (one token: small), the
    ``weights`` whole, and :func:`_softmax_weighted` combines the ranks'
    partial softmaxes over ``seq_group``.  The result is placed by the cache's
    batch placement, whole over the mesh dims that split the positions."""
    from torch.distributed.tensor import Replicate
    k = cache[0]
    dm, dims = k.device_mesh, seq_dims(k, 1)
    rows = rows_of(k)
    lo, n = block(k, 1)
    whole = (Replicate(),) * dm.ndim
    o = fn(q.redistribute(dm, rows).to_local(),
           *(c.to_local() for c in cache), valid[lo:lo + n],
           *(w.redistribute(dm, whole).to_local() for w in weights),
           seq_group=(dm, dims)).contiguous()
    return dtensor(o, dm, rows, q.shape[:2] + o.shape[2:])


# ---------------------------------------------------------------------------
# MLA (multi-head latent attention)
# ---------------------------------------------------------------------------
def mla_schema(cfg: LMConfig, layers: Optional[int] = None) -> Dict:
    L = cfg.n_layers if layers is None else layers
    d, h = cfg.d_model, cfg.n_heads
    qk = cfg.qk_nope + cfg.qk_rope
    lead, lax = _lead(L)
    return {
        "wdq": ParamDef(lead + (d, cfg.q_lora), lax + ("embed", None)),
        "q_norm": ParamDef(lead + (cfg.q_lora,), lax + (None,), init="ones"),
        "wuq": ParamDef(lead + (cfg.q_lora, h * qk), lax + ("embed", "q_dim")),
        "wdkv": ParamDef(lead + (d, cfg.kv_lora + cfg.qk_rope),
                         lax + ("embed", None)),
        "kv_norm": ParamDef(lead + (cfg.kv_lora,), lax + (None,), init="ones"),
        "wuk": ParamDef(lead + (cfg.kv_lora, h * cfg.qk_nope),
                        lax + ("embed", "q_dim")),
        "wuv": ParamDef(lead + (cfg.kv_lora, h * cfg.v_head),
                        lax + ("embed", "q_dim")),
        "wo": ParamDef(lead + (h * cfg.v_head, d), lax + ("q_dim", "embed")),
    }


def _mla_q(cfg, p, x, positions):
    h, qk = cfg.n_heads, cfg.qk_nope + cfg.qk_rope
    cq = rms_norm(matmul(x, p["wdq"]), p["q_norm"], cfg.norm_eps)
    q = split_heads(matmul(cq, p["wuq"]), h, qk)
    q_nope, q_rope = q.split([cfg.qk_nope, cfg.qk_rope], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return torch.cat([q_nope, q_rope], dim=-1)


def _mla_latent(cfg, p, x, positions):
    c, k_rope = matmul(x, p["wdkv"]).split([cfg.kv_lora, cfg.qk_rope],
                                           dim=-1)
    c = rms_norm(c, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)   # (B, S, rope)
    return c, k_rope


def _mla_expand_kv(cfg, p, c):
    h = cfg.n_heads
    k_nope = split_heads(matmul(c, p["wuk"]), h, cfg.qk_nope)
    v = split_heads(matmul(c, p["wuv"]), h, cfg.v_head)
    return k_nope, v


def mla_train(cfg: LMConfig, p, x):
    b, s, _ = x.shape
    positions = _positions(x, s)
    q = _mla_q(cfg, p, x, positions)
    c, k_rope = _mla_latent(cfg, p, x, positions)
    k_nope, v = _mla_expand_kv(cfg, p, c)
    k = torch.cat([k_nope, k_rope[:, :, None, :].expand(
        b, s, cfg.n_heads, cfg.qk_rope)], dim=-1)
    q = shard(q, "batch", "seq", "heads", None)
    k = shard(k, "batch", "seq", "heads", None)
    v = shard(v, "batch", "seq", "heads", None)
    o = _attend(q, k, v, causal=True, block_q=cfg.attn_block_q,
                block_kv=cfg.attn_block_kv)
    return matmul(o.reshape(b, s, cfg.n_heads * cfg.v_head), p["wo"])


def mla_cache_schema(cfg: LMConfig, batch: int, max_seq: int,
                     layers: Optional[int] = None) -> Dict:
    L = cfg.n_layers if layers is None else layers
    lead, lax = _lead(L)
    return {
        "c": ParamDef(lead + (batch, max_seq, cfg.kv_lora),
                      lax + ("batch", "kv_seq", None), init="zeros"),
        "k_rope": ParamDef(lead + (batch, max_seq, cfg.qk_rope),
                           lax + ("batch", "kv_seq", None), init="zeros"),
    }


def mla_decode(cfg: LMConfig, p, x, cache, index: int):
    """One-step MLA decode against the compressed-latent cache (written in
    place at ``index``).

    Baseline: "naive" expansion (k_nope/v recomputed from the cached
    latent).  ``cfg.mla_absorb`` switches to the absorbed form: W_uk folds
    into the query and W_uv into the output projection, so attention runs
    directly in the latent space (same math).
    """
    b = x.shape[0]
    h = cfg.n_heads
    positions = torch.full((b, 1), index, dtype=torch.int32, device=x.device)
    q = _mla_q(cfg, p, x, positions)                        # (B,1,H,qk)
    c_new, kr_new = _mla_latent(cfg, p, x, positions)
    cc, ckr = cache["c"], cache["k_rope"]
    write_at(cc, 1, index, c_new[:, 0].to(cc.dtype))
    write_at(ckr, 1, index, kr_new[:, 0].to(ckr.dtype))
    cc = shard(cc, "batch", "kv_seq", None)
    ckr = shard(ckr, "batch", "kv_seq", None)
    s_max = cc.shape[1]
    valid = torch.arange(s_max, device=x.device) <= index

    if cfg.mla_absorb:
        absorbed = functools.partial(_mla_absorbed_attn, cfg, x.dtype)
        if seq_dims(cc, 1):
            o = _on_seq_blocks(absorbed, q, (cc, ckr), valid, p["wuk"],
                               p["wuv"])
        else:
            o = absorbed(q, cc, ckr, valid, p["wuk"], p["wuv"])
    else:
        k_nope, v = _mla_expand_kv(cfg, p, cc)               # (B,S,H,·)
        k = torch.cat([k_nope, ckr[:, :, None, :].expand(
            b, s_max, h, cfg.qk_rope)], dim=-1)
        o = _masked_decode_attn(q, k, v, valid)
    out = matmul(o.reshape(b, 1, h * cfg.v_head), p["wo"])
    return out, {"c": cc, "k_rope": ckr}


def _mla_absorbed_attn(cfg, dtype, q, cc, ckr, valid, wuk, wuv,
                       seq_group=None):
    """The absorbed form of MLA decode: W_uk folds into the query (q_lat
    (B, 1, H, kv_lora)), scores against the latent, W_uv into the
    output."""
    h = cfg.n_heads
    q_nope, q_rope = q.split([cfg.qk_nope, cfg.qk_rope], dim=-1)
    q_lat = torch.einsum("bqhd,chd->bqhc", q_nope,
                         wuk.reshape(cfg.kv_lora, h, cfg.qk_nope))
    s_nope = torch.einsum("bqhc,bkc->bhqk", q_lat.float(), cc.float())
    s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope.float(), ckr.float())
    s = (s_nope + s_rope) * (1.0 / math.sqrt(cfg.qk_nope + cfg.qk_rope))
    s = torch.where(valid[None, None, None, :], s, -1e30)
    o_lat = _softmax_weighted(s, cc.float(), "bhqk,bkc->bqhc", seq_group)
    return torch.einsum("bqhc,chd->bqhd", o_lat.to(dtype),
                        wuv.reshape(cfg.kv_lora, h, cfg.v_head))


# ---------------------------------------------------------------------------
# Cross-attention (whisper decoder / VLM gated cross layers)
# ---------------------------------------------------------------------------
def cross_schema(cfg: LMConfig, layers: Optional[int] = None,
                 kv_dim: Optional[int] = None) -> Dict:
    L = 0 if layers is None else layers
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    kvd = kv_dim or d
    lead, lax = _lead(L)
    return {
        "wq": ParamDef(lead + (d, h * hd), lax + ("embed", "q_dim")),
        "wk": ParamDef(lead + (kvd, h * hd), lax + ("embed", "q_dim")),
        "wv": ParamDef(lead + (kvd, h * hd), lax + ("embed", "q_dim")),
        "wo": ParamDef(lead + (h * hd, d), lax + ("q_dim", "embed")),
    }


def cross_attn(cfg: LMConfig, p, x, memory):
    """x: (B, Sq, d) queries; memory: (B, Sk, kv_dim). Non-causal.  An f32
    memory (the vision stub) runs its projections in f32, as JAX promotes
    them."""
    b, sq, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    q = split_heads(matmul(x, p["wq"]), h, hd)
    k = split_heads(matmul(memory, p["wk"]), h, hd)
    v = split_heads(matmul(memory, p["wv"]), h, hd)
    o = _attend(q, k, v, causal=False, block_q=cfg.attn_block_q,
                block_kv=cfg.attn_block_kv)
    return matmul(o.reshape(b, sq, h * hd), p["wo"])


def cross_decode(cfg: LMConfig, p, x, k, v):
    """One token's cross-attention against precomputed K/V (B, Sk, H,
    hd): every position attended, no cache write."""
    b = x.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    q = split_heads(matmul(x, p["wq"]), h, hd)
    o = _attend(q, k, v, fn=decode_attention)
    return matmul(o.reshape(b, 1, h * hd), p["wo"])
