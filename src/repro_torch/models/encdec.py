"""Whisper-style encoder-decoder backbone (audio frontend stubbed).

``frames`` are precomputed frame embeddings (B, enc_seq, d); the
conv1d/mel frontend is out of scope, as in the reference.  The decoder's
position table is sized from ``cfg.max_seq``.  Self-attention K/V caches
are written in place by :func:`decode_step`.
"""
from __future__ import annotations

from typing import Dict

import torch
import torch.nn.functional as F

from ..sharding import lookup, placed, shard, write_at
from . import attention as att
from .common import (ParamDef, layer, layer_norm, layers, matmul, remat,
                     sinusoid_positions, split_heads, stack)
from .config import LMConfig


def _ln(cfg, L):
    lead = (L,) if L else ()
    lax_ = ("layers",) if L else ()
    return {
        "s": ParamDef(lead + (cfg.d_model,), lax_ + (None,), init="ones"),
        "b": ParamDef(lead + (cfg.d_model,), lax_ + (None,), init="zeros"),
    }


def _gelu_mlp_schema(cfg, L):
    lead = (L,) if L else ()
    lax_ = ("layers",) if L else ()
    return {
        "w1": ParamDef(lead + (cfg.d_model, cfg.d_ff), lax_ + ("embed", "ff")),
        "b1": ParamDef(lead + (cfg.d_ff,), lax_ + ("ff",), init="zeros"),
        "w2": ParamDef(lead + (cfg.d_ff, cfg.d_model), lax_ + ("ff", "embed")),
        "b2": ParamDef(lead + (cfg.d_model,), lax_ + (None,), init="zeros"),
    }


def _gelu_mlp(p, x):
    # jax.nn.gelu's default is the tanh approximation
    h = F.gelu(matmul(x, p["w1"], p["b1"]).float(),
               approximate="tanh").to(x.dtype)
    h = shard(h, "batch", "seq", "ff")
    return matmul(h, p["w2"], p["b2"])


def _mha_schema(cfg, L):
    d, h, hd = cfg.d_model, cfg.n_heads, cfg.head_dim
    lead = (L,) if L else ()
    lax_ = ("layers",) if L else ()
    return {
        "wq": ParamDef(lead + (d, h * hd), lax_ + ("embed", "q_dim")),
        "wk": ParamDef(lead + (d, h * hd), lax_ + ("embed", "q_dim")),
        "wv": ParamDef(lead + (d, h * hd), lax_ + ("embed", "q_dim")),
        "wo": ParamDef(lead + (h * hd, d), lax_ + ("q_dim", "embed")),
    }


def _mha(cfg, p, x, memory=None, causal=False):
    """Attention of x (B, S, d) over ``memory`` (itself by default).  On a
    mesh its input and output hold their sequence whole, as the
    projections read and write it (``lm._whole_seq``)."""
    x = _whole(x)
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    mem = x if memory is None else _whole(memory)
    q = split_heads(matmul(x, p["wq"]), h, hd)
    k = split_heads(matmul(mem, p["wk"]), h, hd)
    v = split_heads(matmul(mem, p["wv"]), h, hd)
    o = att._attend(q, k, v, causal=causal, block_q=cfg.attn_block_q,
                    block_kv=cfg.attn_block_kv)
    return _whole(matmul(o.reshape(b, s, h * hd), p["wo"]))


def _whole(x):
    """``x`` (B, S, d) with its sequence whole, on a mesh."""
    return shard(x, "batch", "seq", None)


def _embed(params, tokens):
    """The decoder's token embeddings.  On a mesh of more than one device
    the table is taken whole on each rank for training, and looked up
    where it lies for serving, as ``lm._embed`` does."""
    table = params["embed"]
    if placed(table) and table.device_mesh.size() > 1:
        if not (torch.is_grad_enabled() and table.requires_grad):
            return lookup(table, tokens).to(torch.bfloat16)
        from torch.distributed.tensor import Replicate
        dm = table.device_mesh
        return F.embedding(tokens, table.redistribute(
            dm, (Replicate(),) * dm.ndim)).to(torch.bfloat16)
    return table[tokens].to(torch.bfloat16)


def _unembed(cfg, params, x):
    """The tied unembedding ``x @ embed.T``, vocab padding masked."""
    return _mask_pad(cfg, matmul(x, params["embed"].T))


def encdec_schema(cfg: LMConfig) -> Dict:
    from .lm import vocab_padded
    d = cfg.d_model
    return {
        "embed": ParamDef((vocab_padded(cfg), d), ("vocab", "embed"),
                          scale=0.01),
        "pos_dec": ParamDef((cfg.max_seq, d), (None, None), scale=0.01),
        "enc_blocks": {
            "ln1": _ln(cfg, cfg.enc_layers), "ln2": _ln(cfg, cfg.enc_layers),
            "attn": _mha_schema(cfg, cfg.enc_layers),
            "mlp": _gelu_mlp_schema(cfg, cfg.enc_layers)},
        "enc_ln": _ln(cfg, 0),
        "dec_blocks": {
            "ln1": _ln(cfg, cfg.n_layers), "ln2": _ln(cfg, cfg.n_layers),
            "ln3": _ln(cfg, cfg.n_layers),
            "self_attn": _mha_schema(cfg, cfg.n_layers),
            "cross_attn": _mha_schema(cfg, cfg.n_layers),
            "mlp": _gelu_mlp_schema(cfg, cfg.n_layers)},
        "dec_ln": _ln(cfg, 0),
    }


def _mask_pad(cfg, logits):
    if logits.shape[-1] != cfg.vocab:
        if placed(logits):
            # vocab-sharded: the iota compare (an in-place write to a
            # sharded dim would be lost)
            vidx = torch.arange(logits.shape[-1], device=logits.device)
            return torch.where(vidx < cfg.vocab, logits, -1e30)
        logits[..., cfg.vocab:] = -1e30
    return logits


def _ln_apply(p, x, eps):
    return layer_norm(x, p["s"], p["b"], eps)


def encode(cfg: LMConfig, params, frames):
    """frames: (B, enc_seq, d) precomputed embeddings (frontend stub)."""
    x = frames.to(torch.bfloat16) + sinusoid_positions(
        frames.shape[1], cfg.d_model, frames.device).to(torch.bfloat16)[None]
    x = shard(x, "batch", "act_seq", None)

    def body(lp, h):
        h = h + _mha(cfg, lp["attn"], _ln_apply(lp["ln1"], h, cfg.norm_eps))
        return h + _whole(_gelu_mlp(lp["mlp"], _whole(_ln_apply(
            lp["ln2"], h, cfg.norm_eps))))

    body = remat(cfg, body)
    for lp in layers(params["enc_blocks"]):
        x = body(lp, x)
    return _ln_apply(params["enc_ln"], x, cfg.norm_eps)


def decode_train(cfg: LMConfig, params, tokens, memory, mode="train"):
    """tokens: (B, S); memory: (B, enc_seq, d). Returns (logits, caches)."""
    s = tokens.shape[1]
    x = _embed(params, tokens)
    x = x + params["pos_dec"][:s][None]
    x = shard(x, "batch", "act_seq", None)

    def body(lp, h):
        hn = _ln_apply(lp["ln1"], h, cfg.norm_eps)
        h = h + _mha(cfg, lp["self_attn"], hn, causal=True)
        hc = _ln_apply(lp["ln2"], h, cfg.norm_eps)
        h = h + _mha(cfg, lp["cross_attn"], hc, memory=memory)
        hm = _whole(_ln_apply(lp["ln3"], h, cfg.norm_eps))
        h = h + _whole(_gelu_mlp(lp["mlp"], hm))
        if mode != "prefill":
            return h, None
        hd, hh = cfg.head_dim, cfg.n_heads
        hn = _whole(hn)
        return h, {"k": split_heads(matmul(hn, lp["self_attn"]["wk"]),
                                    hh, hd),
                   "v": split_heads(matmul(hn, lp["self_attn"]["wv"]),
                                    hh, hd)}

    if mode == "train":
        body = remat(cfg, body)
    caches = []
    for lp in layers(params["dec_blocks"]):
        x, kv = body(lp, x)
        if kv is not None:
            caches.append(kv)
    x = _whole(_ln_apply(params["dec_ln"], x, cfg.norm_eps))
    logits = _unembed(cfg, params, x)
    return (shard(logits, "batch", "seq", "vocab"),
            stack(caches) if caches else None)


def encdec_cache_schema(cfg: LMConfig, batch: int, max_seq: int) -> Dict:
    L = cfg.n_layers
    h, hd = cfg.n_heads, cfg.head_dim
    return {
        "k": ParamDef((L, batch, max_seq, h, hd),
                      ("layers", "batch", "kv_seq", None, None), init="zeros"),
        "v": ParamDef((L, batch, max_seq, h, hd),
                      ("layers", "batch", "kv_seq", None, None), init="zeros"),
        "cross_k": ParamDef((L, batch, cfg.enc_seq, h, hd),
                            ("layers", "batch", None, None, None),
                            init="zeros"),
        "cross_v": ParamDef((L, batch, cfg.enc_seq, h, hd),
                            ("layers", "batch", None, None, None),
                            init="zeros"),
    }


def cross_kv(cfg: LMConfig, params, memory):
    """Precompute per-layer cross K/V from encoder memory."""
    b, sm, _ = memory.shape
    h, hd = cfg.n_heads, cfg.head_dim
    ks, vs = [], []
    for i in range(cfg.n_layers):
        lp = layer(params["dec_blocks"]["cross_attn"], i)
        ks.append(split_heads(matmul(memory, lp["wk"]), h, hd))
        vs.append(split_heads(matmul(memory, lp["wv"]), h, hd))
    return torch.stack(ks), torch.stack(vs)


def decode_step(cfg: LMConfig, params, token, cache, index: int):
    """token: (B, 1); cache: encdec_cache_schema dict (stacked L leading),
    its self-attention K/V written in place at ``index``."""
    b = token.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    x = _embed(params, token)
    x = x + params["pos_dec"][index:index + 1][None]
    for i in range(cfg.n_layers):
        lp = layer(params["dec_blocks"], i)
        ck, cv = cache["k"][i], cache["v"][i]
        hn = _ln_apply(lp["ln1"], x, cfg.norm_eps)
        q = split_heads(matmul(hn, lp["self_attn"]["wq"]), h, hd)
        write_at(ck, 1, index, split_heads(matmul(
            hn, lp["self_attn"]["wk"]), h, hd).reshape(b, h, hd)
            .to(ck.dtype))
        write_at(cv, 1, index, split_heads(matmul(
            hn, lp["self_attn"]["wv"]), h, hd).reshape(b, h, hd)
            .to(cv.dtype))
        ck = shard(ck, "batch", "kv_seq", None, None)
        cv = shard(cv, "batch", "kv_seq", None, None)
        valid = torch.arange(ck.shape[1], device=x.device) <= index
        o = att._masked_decode_attn(q, ck, cv, valid)
        x = x + matmul(o.reshape(b, 1, h * hd), lp["self_attn"]["wo"])
        hc = _ln_apply(lp["ln2"], x, cfg.norm_eps)
        x = x + att.cross_decode(cfg, lp["cross_attn"], hc,
                                 cache["cross_k"][i], cache["cross_v"][i])
        hm = _ln_apply(lp["ln3"], x, cfg.norm_eps)
        x = x + _gelu_mlp(lp["mlp"], hm)
    x = _ln_apply(params["dec_ln"], x, cfg.norm_eps)
    return _unembed(cfg, params, x), cache
