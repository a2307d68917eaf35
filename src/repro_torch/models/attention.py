"""Attention variants: GQA (llama-family), MLA (DeepSeek/MiniCPM3), cross.

Each variant exposes ``*_schema(cfg)`` (ParamDefs), ``*_train`` (full-seq
causal), and ``*_decode`` (one token against a cache).  Caches are plain
dicts of tensors sized by the caller.  A decode step writes its new
position into the cache tensors it is given, in place (the reference's
``dynamic_update_slice`` without the copy of the whole buffer), and
returns them.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..sharding import placed, shard
from .common import (ParamDef, apply_rope, blockwise_attention, matmul,
                     promote_mm, rms_norm)
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
    b, s, _ = x.shape
    h, kv, hd = cfg.n_heads, cfg.n_kv_heads, cfg.head_dim
    q2, k2, v2 = (matmul(x, p["wq"]), matmul(x, p["wk"]),
                  matmul(x, p["wv"]))
    if cfg.seq_parallel_proj:
        # projections kept sequence-parallel: the (small) weights are
        # gathered over "model", not the activations
        q2 = shard(q2, "batch", "act_seq", None)
        k2 = shard(k2, "batch", "act_seq", None)
        v2 = shard(v2, "batch", "act_seq", None)
    q = q2.reshape(b, s, h, hd)
    k = k2.reshape(b, s, kv, hd)
    v = v2.reshape(b, s, kv, hd)
    if cfg.qk_norm:
        q = rms_norm(q, p["q_norm"], cfg.norm_eps)
        k = rms_norm(k, p["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _positions(x, s):
    return torch.arange(s, device=x.device)[None, :]


def _attend(q, k, v, **kw):
    """:func:`blockwise_attention` of q (B, S, Hq, D) over k, v (B, S,
    Hkv, D).  Placed on a mesh (q sharded over batch and heads, as the
    reference's sites put it), each rank attends its own batch rows and
    heads on its local blocks: k and v take q's batch placement, and of
    their heads only those that q's local heads read (a GQA group never
    straddles two blocks when the head counts are powers of two).  Their
    gradients come back ``Partial`` over the head-sharded mesh dim, where
    every rank read the same k and v.  The attention itself moves no
    data."""
    if not placed(q):
        return blockwise_attention(q, k, v, **kw)
    from torch.distributed.tensor import DTensor, Partial, Replicate
    dm, qp = q.device_mesh, tuple(q.placements)
    kvp = tuple(p if p.is_shard(0) else Replicate() for p in qp)
    grad = tuple(Partial() if p.is_shard(2) else p for p in kvp)
    kl = k.redistribute(dm, kvp).to_local(grad_placements=grad)
    vl = v.redistribute(dm, kvp).to_local(grad_placements=grad)
    ql = q.to_local()
    hq, hkv, hl = q.shape[2], k.shape[2], ql.shape[2]
    if hl != hq:                              # heads sharded: their kv heads
        j = next(dm.get_local_rank(i) for i, p in enumerate(qp)
                 if p.is_shard(2))
        group = hq // hkv
        lo, n = j * hl // group, max(1, hl // group)
        kl, vl = kl.narrow(2, lo, n), vl.narrow(2, lo, n)
    o = blockwise_attention(ql, kl, vl, **kw).contiguous()
    return DTensor.from_local(o, dm, qp, run_check=False,
                              shape=q.shape[:3] + v.shape[3:],
                              stride=torch.empty(q.shape[:3] + v.shape[3:],
                                                 device="meta").stride())


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
    ck[:, slot] = k[:, 0].to(ck.dtype)
    cv[:, slot] = v[:, 0].to(cv.dtype)
    ck = shard(ck, "batch", "kv_seq", None, None)
    cv = shard(cv, "batch", "kv_seq", None, None)
    s_max = ck.shape[1]
    valid = torch.arange(s_max, device=x.device) <= (
        min(index, s_max - 1) if window else index)
    o = _masked_decode_attn(q, ck, cv, valid)
    out = o.reshape(b, 1, cfg.n_heads * cfg.head_dim) @ p["wo"]
    return out, {"k": ck, "v": cv}


def _masked_decode_attn(q, k, v, valid):
    b, _, hq, d = q.shape
    hkv = k.shape[2]
    dv = v.shape[-1]
    group = hq // hkv
    qg = q.reshape(b, hkv, group, d)
    s = torch.einsum("bhgd,bkhd->bhgk", qg.float(), k.float()) / math.sqrt(d)
    s = torch.where(valid[None, None, None, :], s, -1e30)
    pr = torch.softmax(s, dim=-1)
    o = torch.einsum("bhgk,bkhd->bhgd", pr, v.float())
    return o.reshape(b, 1, hq, dv).to(q.dtype)


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
    b, s, _ = x.shape
    h, qk = cfg.n_heads, cfg.qk_nope + cfg.qk_rope
    cq = rms_norm(x @ p["wdq"], p["q_norm"], cfg.norm_eps)
    q = (cq @ p["wuq"]).reshape(b, s, h, qk)
    q_nope, q_rope = q.split([cfg.qk_nope, cfg.qk_rope], dim=-1)
    q_rope = apply_rope(q_rope, positions, cfg.rope_theta)
    return torch.cat([q_nope, q_rope], dim=-1)


def _mla_latent(cfg, p, x, positions):
    c, k_rope = (x @ p["wdkv"]).split([cfg.kv_lora, cfg.qk_rope], dim=-1)
    c = rms_norm(c, p["kv_norm"], cfg.norm_eps)
    k_rope = apply_rope(k_rope, positions, cfg.rope_theta)   # (B, S, rope)
    return c, k_rope


def _mla_expand_kv(cfg, p, c):
    b, s, _ = c.shape
    h = cfg.n_heads
    k_nope = (c @ p["wuk"]).reshape(b, s, h, cfg.qk_nope)
    v = (c @ p["wuv"]).reshape(b, s, h, cfg.v_head)
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
    o = blockwise_attention(q, k, v, causal=True,
                            block_q=cfg.attn_block_q,
                            block_kv=cfg.attn_block_kv)
    return o.reshape(b, s, cfg.n_heads * cfg.v_head) @ p["wo"]


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
    cc[:, index] = c_new[:, 0].to(cc.dtype)
    ckr[:, index] = kr_new[:, 0].to(ckr.dtype)
    cc = shard(cc, "batch", "kv_seq", None)
    ckr = shard(ckr, "batch", "kv_seq", None)
    s_max = cc.shape[1]
    valid = torch.arange(s_max, device=x.device) <= index

    q_nope, q_rope = q.split([cfg.qk_nope, cfg.qk_rope], dim=-1)
    if cfg.mla_absorb:
        # fold W_uk into q: q_lat (B,1,H,kv_lora); score against the latent
        wuk = p["wuk"].reshape(cfg.kv_lora, h, cfg.qk_nope)
        q_lat = torch.einsum("bqhd,chd->bqhc", q_nope, wuk)
        s_nope = torch.einsum("bqhc,bkc->bhqk", q_lat.float(), cc.float())
        s_rope = torch.einsum("bqhd,bkd->bhqk", q_rope.float(), ckr.float())
        s = (s_nope + s_rope) * (1.0 / math.sqrt(cfg.qk_nope + cfg.qk_rope))
        s = torch.where(valid[None, None, None, :], s, -1e30)
        pr = torch.softmax(s, dim=-1)
        o_lat = torch.einsum("bhqk,bkc->bqhc", pr, cc.float())
        wuv = p["wuv"].reshape(cfg.kv_lora, h, cfg.v_head)
        o = torch.einsum("bqhc,chd->bqhd", o_lat.to(x.dtype), wuv)
    else:
        k_nope, v = _mla_expand_kv(cfg, p, cc)               # (B,S,H,·)
        k = torch.cat([k_nope, ckr[:, :, None, :].expand(
            b, s_max, h, cfg.qk_rope)], dim=-1)
        o = _masked_decode_attn(q, k, v, valid)
    out = o.reshape(b, 1, h * cfg.v_head) @ p["wo"]
    return out, {"c": cc, "k_rope": ckr}


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
    sk = memory.shape[1]
    h, hd = cfg.n_heads, cfg.head_dim
    q = (x @ p["wq"]).reshape(b, sq, h, hd)
    k = promote_mm(memory, p["wk"]).reshape(b, sk, h, hd)
    v = promote_mm(memory, p["wv"]).reshape(b, sk, h, hd)
    o = blockwise_attention(q, k, v, causal=False,
                            block_q=cfg.attn_block_q,
                            block_kv=cfg.attn_block_kv)
    return o.reshape(b, sq, h * hd) @ p["wo"]
