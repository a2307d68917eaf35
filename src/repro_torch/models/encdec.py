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

from ..sharding import shard
from . import attention as att
from .common import (ParamDef, blockwise_attention, decode_attention, layer,
                     layer_norm, layers, remat, sinusoid_positions, stack)
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
    h = F.gelu((x @ p["w1"] + p["b1"]).float(),
               approximate="tanh").to(x.dtype)
    h = shard(h, "batch", "seq", "ff")
    return h @ p["w2"] + p["b2"]


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
    b, s, _ = x.shape
    h, hd = cfg.n_heads, cfg.head_dim
    mem = x if memory is None else memory
    sm = mem.shape[1]
    q = (x @ p["wq"]).reshape(b, s, h, hd)
    k = (mem @ p["wk"]).reshape(b, sm, h, hd)
    v = (mem @ p["wv"]).reshape(b, sm, h, hd)
    o = blockwise_attention(q, k, v, causal=causal,
                            block_q=cfg.attn_block_q,
                            block_kv=cfg.attn_block_kv)
    return o.reshape(b, s, h * hd) @ p["wo"]


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
        return h + _gelu_mlp(lp["mlp"], _ln_apply(lp["ln2"], h,
                                                    cfg.norm_eps))

    body = remat(cfg, body)
    for lp in layers(params["enc_blocks"]):
        x = body(lp, x)
    return _ln_apply(params["enc_ln"], x, cfg.norm_eps)


def decode_train(cfg: LMConfig, params, tokens, memory, mode="train"):
    """tokens: (B, S); memory: (B, enc_seq, d). Returns (logits, caches)."""
    b, s = tokens.shape
    x = params["embed"][tokens].to(torch.bfloat16)
    x = x + params["pos_dec"][:s][None]
    x = shard(x, "batch", "act_seq", None)

    def body(lp, h):
        hn = _ln_apply(lp["ln1"], h, cfg.norm_eps)
        h = h + _mha(cfg, lp["self_attn"], hn, causal=True)
        hc = _ln_apply(lp["ln2"], h, cfg.norm_eps)
        h = h + _mha(cfg, lp["cross_attn"], hc, memory=memory)
        hm = _ln_apply(lp["ln3"], h, cfg.norm_eps)
        h = h + _gelu_mlp(lp["mlp"], hm)
        if mode != "prefill":
            return h, None
        hd, hh = cfg.head_dim, cfg.n_heads
        return h, {"k": (hn @ lp["self_attn"]["wk"]).reshape(b, s, hh, hd),
                   "v": (hn @ lp["self_attn"]["wv"]).reshape(b, s, hh, hd)}

    if mode == "train":
        body = remat(cfg, body)
    caches = []
    for lp in layers(params["dec_blocks"]):
        x, kv = body(lp, x)
        if kv is not None:
            caches.append(kv)
    x = _ln_apply(params["dec_ln"], x, cfg.norm_eps)
    logits = _mask_pad(cfg, x @ params["embed"].T)   # tied unembedding
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
        ks.append((memory @ lp["wk"]).reshape(b, sm, h, hd))
        vs.append((memory @ lp["wv"]).reshape(b, sm, h, hd))
    return torch.stack(ks), torch.stack(vs)


def decode_step(cfg: LMConfig, params, token, cache, index: int):
    """token: (B, 1); cache: encdec_cache_schema dict (stacked L leading),
    its self-attention K/V written in place at ``index``."""
    b = token.shape[0]
    h, hd = cfg.n_heads, cfg.head_dim
    x = params["embed"][token].to(torch.bfloat16)
    x = x + params["pos_dec"][index:index + 1][None]
    for i in range(cfg.n_layers):
        lp = layer(params["dec_blocks"], i)
        ck, cv = cache["k"][i], cache["v"][i]
        hn = _ln_apply(lp["ln1"], x, cfg.norm_eps)
        q = (hn @ lp["self_attn"]["wq"]).reshape(b, 1, h, hd)
        ck[:, index] = (hn @ lp["self_attn"]["wk"]).reshape(b, h, hd) \
            .to(ck.dtype)
        cv[:, index] = (hn @ lp["self_attn"]["wv"]).reshape(b, h, hd) \
            .to(cv.dtype)
        ck = shard(ck, "batch", "kv_seq", None, None)
        cv = shard(cv, "batch", "kv_seq", None, None)
        valid = torch.arange(ck.shape[1], device=x.device) <= index
        o = att._masked_decode_attn(q, ck, cv, valid)
        x = x + o.reshape(b, 1, h * hd) @ lp["self_attn"]["wo"]
        hc = _ln_apply(lp["ln2"], x, cfg.norm_eps)
        qc = (hc @ lp["cross_attn"]["wq"]).reshape(b, 1, h, hd)
        oc = decode_attention(qc, cache["cross_k"][i], cache["cross_v"][i])
        x = x + oc.reshape(b, 1, h * hd) @ lp["cross_attn"]["wo"]
        hm = _ln_apply(lp["ln3"], x, cfg.norm_eps)
        x = x + _gelu_mlp(lp["mlp"], hm)
    x = _ln_apply(params["dec_ln"], x, cfg.norm_eps)
    return _mask_pad(cfg, x @ params["embed"].T), cache
