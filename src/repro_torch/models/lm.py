"""Decoder-only LM assembly for all non-enc-dec families.

Families: dense (llama/granite/yi), moe (qwen3), mla (minicpm3),
mla_moe (deepseek-v3 + MTP), vlm (llama-3.2-vision gated cross-attn),
zamba (mamba2 + shared attn block), rwkv (rwkv6).

Layers are stacked on a leading axis, as in the reference; its
``lax.scan`` over them is a Python loop here over the stacked ``(L, ...)``
parameters' slices (``common.layers``: one ``unbind`` per leaf) and, in
decode, the caches' (``common.layer``: views written in place).  Two
entry points per family: ``forward`` (modes ``train`` and ``prefill``;
prefill also returns the per-layer caches, stacked; under autograd each
layer is rematerialized, ``common.remat``) and ``decode`` (one token; it
updates the cache tensors it is given in place and returns them).
``mtp_logits`` is DeepSeek-V3's multi-token-prediction head.
"""
from __future__ import annotations

from typing import Any, Dict, Optional

import torch
import torch.nn.functional as F

from ..sharding import local_part, lookup, placed, shard
from . import attention as att
from . import mamba2, moe, rwkv6
from .common import (ParamDef, layer, layer_norm, layers, matmul, remat,
                     rms_norm, split_heads, stack, swiglu, tree_map)
from .config import LMConfig


# ---------------------------------------------------------------------------
# MLP
# ---------------------------------------------------------------------------
def mlp_schema(cfg: LMConfig, d_ff: int, layers: Optional[int] = None) -> Dict:
    L = cfg.n_layers if layers is None else layers
    d = cfg.d_model
    lead = (L,) if L else ()
    lax_ = ("layers",) if L else ()
    return {
        "w_in": ParamDef(lead + (d, 2 * d_ff), lax_ + ("embed", "ff")),
        "w_out": ParamDef(lead + (d_ff, d), lax_ + ("ff", "embed")),
    }


def mlp_apply(p, x, seq_par: bool = False):
    hidden = matmul(x, p["w_in"])
    if seq_par:
        hidden = shard(hidden, "batch", "act_seq", None)
    gate, up = hidden.chunk(2, dim=-1)
    h = shard(swiglu(gate, up), "batch", "act_seq" if seq_par else "seq",
              None if seq_par else "ff")
    return matmul(h, p["w_out"])


def norm_def(cfg: LMConfig, layers: Optional[int] = None) -> ParamDef:
    L = cfg.n_layers if layers is None else layers
    lead = (L,) if L else ()
    lax_ = ("layers",) if L else ()
    return ParamDef(lead + (cfg.d_model,), lax_ + (None,), init="ones")


# ---------------------------------------------------------------------------
# Blocks
# ---------------------------------------------------------------------------
def attn_ff_block(cfg: LMConfig, p, x, *, kind: str, mode: str,
                  cache=None, index=None, window: int = 0):
    """One transformer block; kind in {dense, moe, mla_dense, mla_moe}.
    Returns (x, aux, new_cache).

    Under a mesh the residual stream ``x`` is sequence-sharded between
    blocks (``act_seq``, the reference's sites).  DTensor does not fold a
    sharded sequence into a product's rows, forward or backward, so the
    norms' outputs going into the projections and the sublayers' outputs
    coming out of them hold the whole sequence (``_whole_seq``), as GSPMD
    gathers them for the reference.  With ``cfg.seq_parallel_proj`` the
    reference's sites keep the sequence split instead (``_seq_par``):
    GQA's q/k/v projections and the dense MLP take ``act_seq`` rows
    (their weights gathered over "model"), and their outputs go straight
    back to ``act_seq``; MLA and MoE are fed as without it."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    gqa = not kind.startswith("mla")
    h = rms_norm(x, p["attn_norm"], cfg.norm_eps)
    h = _seq_par(cfg, h) if gqa else _whole_seq(h)
    new_cache = None
    if not gqa:
        if mode == "decode":
            a, new_cache = att.mla_decode(cfg, p["attn"], h, cache, index)
        else:
            a = att.mla_train(cfg, p["attn"], h)
            if mode == "prefill":
                positions = torch.arange(h.shape[1], device=h.device)[None]
                c, k_rope = att._mla_latent(cfg, p["attn"], h, positions)
                new_cache = {"c": c, "k_rope": k_rope}
    else:
        if mode == "decode":
            a, new_cache = att.gqa_decode(cfg, p["attn"], h, cache, index,
                                          window=window)
        else:
            a = att.gqa_train(cfg, p["attn"], h, window=window)
            if mode == "prefill":
                positions = torch.arange(h.shape[1], device=h.device)[None]
                _, k, v = att._qkv(cfg, p["attn"], h, positions)
                new_cache = {"k": k, "v": v}
    a = _seq_par(cfg, a) if gqa else _whole_seq(a)
    x = shard(x + a, "batch", "act_seq", None)
    h2 = rms_norm(x, p["mlp_norm"], cfg.norm_eps)
    if kind.endswith("moe"):
        m, aux = moe.moe_apply(cfg, p["moe"], _whole_seq(h2))
        m = _whole_seq(m)
    else:
        m = _seq_par(cfg, mlp_apply(p["mlp"], _seq_par(cfg, h2),
                                    seq_par=cfg.seq_parallel_proj))
    return shard(x + m, "batch", "act_seq", None), aux, new_cache


def _whole_seq(h):
    """``h`` with its sequence whole (a product reads or writes it as
    rows)."""
    return shard(h, "batch", "seq", None)


def _seq_par(cfg, h):
    """``h`` at one of the reference's sequence-parallel projection sites
    (GQA's q/k/v, the MLP, mamba's in-projection): on ``act_seq`` with
    ``cfg.seq_parallel_proj`` (a product then keeps its rows and gathers
    its weight: ``common.matmul``), else whole (:func:`_whole_seq`)."""
    if cfg.seq_parallel_proj:
        return shard(h, "batch", "act_seq", None)
    return _whole_seq(h)


# ---------------------------------------------------------------------------
# Schemas per family
# ---------------------------------------------------------------------------
def vocab_padded(cfg: LMConfig) -> int:
    """Vocab rounded up to a 128 multiple (the reference pads it so the
    vocab dim divides its model axis).  Pad columns are masked to -1e30 in
    _logits."""
    return -(-cfg.vocab // 128) * 128


def lm_schema(cfg: LMConfig) -> Dict:
    d, v = cfg.d_model, vocab_padded(cfg)
    emb_d_axis = "embed" if cfg.embed_fsdp else None
    s: Dict[str, Any] = {
        "embed": ParamDef((v, d), ("vocab", emb_d_axis), scale=0.01),
        "final_norm": norm_def(cfg, 0),
        "unembed": ParamDef((d, v), ("embed", "vocab")),
    }
    f = cfg.family
    if f in ("dense", "moe", "mla"):
        blk = {"attn_norm": norm_def(cfg), "mlp_norm": norm_def(cfg)}
        blk["attn"] = (att.mla_schema(cfg) if f == "mla"
                       else att.gqa_schema(cfg))
        if f == "moe":
            blk["moe"] = moe.moe_schema(cfg)
        else:
            blk["mlp"] = mlp_schema(cfg, cfg.d_ff)
        s["blocks"] = blk
    elif f == "mla_moe":
        nd, nm = cfg.first_dense_layers, cfg.n_layers - cfg.first_dense_layers
        s["dense_blocks"] = {
            "attn_norm": norm_def(cfg, nd), "mlp_norm": norm_def(cfg, nd),
            "attn": att.mla_schema(cfg, nd), "mlp": mlp_schema(cfg, cfg.d_ff, nd)}
        s["moe_blocks"] = {
            "attn_norm": norm_def(cfg, nm), "mlp_norm": norm_def(cfg, nm),
            "attn": att.mla_schema(cfg, nm), "moe": moe.moe_schema(cfg, nm)}
        if cfg.mtp:
            s["mtp"] = {
                "proj": ParamDef((2 * d, d), (None, "embed")),
                "norm_h": norm_def(cfg, 0), "norm_e": norm_def(cfg, 0),
                "attn_norm": norm_def(cfg, 0), "mlp_norm": norm_def(cfg, 0),
                "attn": att.mla_schema(cfg, 0),
                "mlp": mlp_schema(cfg, cfg.d_ff, 0)}
    elif f == "vlm":
        ncross = cfg.n_layers // cfg.cross_every
        nself = ncross * (cfg.cross_every - 1)
        s["self_blocks"] = {
            "attn_norm": norm_def(cfg, nself), "mlp_norm": norm_def(cfg, nself),
            "attn": att.gqa_schema(cfg, nself),
            "mlp": mlp_schema(cfg, cfg.d_ff, nself)}
        s["cross_blocks"] = {
            "attn_norm": norm_def(cfg, ncross), "mlp_norm": norm_def(cfg, ncross),
            "attn": att.cross_schema(cfg, ncross),
            "mlp": mlp_schema(cfg, cfg.d_ff, ncross),
            "gate_attn": ParamDef((ncross, 1), ("layers", None), init="zeros",
                                  dtype=torch.float32),
            "gate_mlp": ParamDef((ncross, 1), ("layers", None), init="zeros",
                                 dtype=torch.float32)}
    elif f == "zamba":
        g = cfg.n_layers // cfg.attn_every
        tail = cfg.n_layers % cfg.attn_every
        s["mamba_groups"] = {
            "norm": _stack_norm(cfg, (g, cfg.attn_every)),
            "mamba": _stack2(mamba2.mamba_schema(cfg, cfg.attn_every), g)}
        if tail:
            s["mamba_tail"] = {"norm": norm_def(cfg, tail),
                               "mamba": mamba2.mamba_schema(cfg, tail)}
        s["shared"] = {
            "proj": ParamDef((2 * d, d), (None, "embed")),
            "attn_norm": norm_def(cfg, 0), "mlp_norm": norm_def(cfg, 0),
            "attn": att.gqa_schema(cfg, 0),
            "mlp": mlp_schema(cfg, cfg.d_ff, 0)}
    elif f == "rwkv":
        s["blocks"] = rwkv6.rwkv_schema(cfg)
        s["ln0_s"] = ParamDef((d,), (None,), init="ones")
        s["ln0_b"] = ParamDef((d,), (None,), init="zeros")
    else:
        raise ValueError(f"unknown family {f}")
    return s


def _stack_norm(cfg, lead):
    return ParamDef(tuple(lead) + (cfg.d_model,),
                    ("layers",) * len(lead) + (None,), init="ones")


def _stack2(schema, g):
    """Add an extra leading group axis to every ParamDef in schema."""
    return tree_map(lambda d: ParamDef((g,) + d.shape, ("layers",) + d.axes,
                                       d.init, d.scale, d.dtype), schema)


# ---------------------------------------------------------------------------
# Cache schemas
# ---------------------------------------------------------------------------
def cache_schema(cfg: LMConfig, batch: int, max_seq: int) -> Dict:
    f = cfg.family
    if f in ("dense", "moe"):
        return {"kv": att.gqa_cache_schema(cfg, batch, max_seq)}
    if f == "mla":
        return {"kv": att.mla_cache_schema(cfg, batch, max_seq)}
    if f == "mla_moe":
        return {"kv_dense": att.mla_cache_schema(cfg, batch, max_seq,
                                                 cfg.first_dense_layers),
                "kv_moe": att.mla_cache_schema(
                    cfg, batch, max_seq,
                    cfg.n_layers - cfg.first_dense_layers)}
    if f == "vlm":
        ncross = cfg.n_layers // cfg.cross_every
        nself = ncross * (cfg.cross_every - 1)
        cross = ParamDef((ncross, batch, cfg.img_seq, cfg.n_heads,
                          cfg.head_dim),
                         ("layers", "batch", None, "heads", None),
                         init="zeros")
        return {"kv": att.gqa_cache_schema(cfg, batch, max_seq, nself),
                "cross_k": cross, "cross_v": cross}
    if f == "zamba":
        g = cfg.n_layers // cfg.attn_every
        tail = cfg.n_layers % cfg.attn_every
        win = min(cfg.window or max_seq, max_seq)
        out = {"mamba": _stack2(mamba2.mamba_state_schema(cfg, batch,
                                                          cfg.attn_every), g),
               "attn": att.gqa_cache_schema(cfg, batch, win, g)}
        if tail:
            out["mamba_tail"] = mamba2.mamba_state_schema(cfg, batch, tail)
        return out
    if f == "rwkv":
        return {"blocks": rwkv6.rwkv_state_schema(cfg, batch)}
    raise ValueError(f)


# ---------------------------------------------------------------------------
# Forward passes
# ---------------------------------------------------------------------------
def n_layers_of(tree) -> int:
    """The leading (layer) size of a tree of stacked leaves."""
    while isinstance(tree, dict):
        tree = next(iter(tree.values()))
    return tree.shape[0]


def _embed(cfg, params, tokens):
    table = params["embed"]
    if placed(table) and table.device_mesh.size() > 1:
        if torch.is_grad_enabled() and table.requires_grad:
            # the table whole on each rank (its gradient comes back
            # partial): DTensor's vocab-parallel lookup does not survive
            # the act_seq redistribution, and an index's backward has no
            # DTensor rule
            from torch.distributed.tensor import Replicate
            dm = table.device_mesh
            x = F.embedding(tokens, table.redistribute(
                dm, (Replicate(),) * dm.ndim))
        else:                      # serving: the table stays where it is
            x = lookup(table, tokens)
    else:                          # a one-device mesh keeps the index
        x = table[tokens]
    return shard(x.to(torch.bfloat16), "batch", "act_seq", None)


def _logits(cfg, params, x):
    x = _whole_seq(rms_norm(x, params["final_norm"], cfg.norm_eps))
    logits = shard(matmul(x, params["unembed"]), "batch", "seq", "vocab")
    if logits.shape[-1] != cfg.vocab:     # mask vocab padding
        if placed(logits):
            # vocab-sharded: the reference's iota compare, no slice of
            # the sharded dim
            vidx = torch.arange(logits.shape[-1], device=logits.device)
            return torch.where(vidx < cfg.vocab, logits, -1e30)
        logits[..., cfg.vocab:] = -1e30
    return logits


def _blocks(cfg, params, x, kind, mode):
    """The stacked blocks ``params`` in order, each under :func:`remat`;
    returns (x, aux, the prefill caches stacked or None)."""
    aux = torch.zeros((), dtype=torch.float32, device=x.device)
    body = remat(cfg, lambda lp, h: attn_ff_block(cfg, lp, h, kind=kind,
                                                  mode=mode))
    kvs = []
    for lp in layers(params):
        x, a, kv = body(lp, x)
        aux = aux + a
        kvs.append(kv)
    return x, aux, (stack(kvs) if mode == "prefill" else None)


def _mamba_layer(cfg, lp, h):
    out, (cs, ss) = mamba2.mamba_train(cfg, lp["mamba"],
                                       rms_norm(h, lp["norm"], cfg.norm_eps))
    return h + _whole_seq(out), {"conv": cs, "ssm": ss}


def _mamba_layers(cfg, params, h, body=None):
    """Mamba layers over a full sequence, each through ``body`` (default
    :func:`_mamba_layer`); returns (h, states stacked)."""
    body = body or (lambda lp, x: _mamba_layer(cfg, lp, x))
    states = []
    for lp in layers(params):
        h, st = body(lp, h)
        states.append(st)
    return h, stack(states)


def forward(cfg: LMConfig, params, tokens, vision=None, frames=None,
            mode: str = "train"):
    """tokens: (B, S) int -> (logits, aux, caches-or-None, hidden).

    ``vision``: (B, img_seq, d) stub embeddings for the vlm family.
    ``mode``: train | prefill (prefill also returns per-layer caches).
    Each layer (a vlm or zamba group, as in the reference) runs under
    :func:`remat`.
    """
    f = cfg.family
    x = _embed(cfg, params, tokens)
    aux_total = torch.zeros((), dtype=torch.float32, device=x.device)
    caches = None
    emb0 = x

    if f in ("dense", "moe", "mla"):
        kind = {"dense": "dense", "moe": "moe", "mla": "mla_dense"}[f]
        x, aux_total, kv = _blocks(cfg, params["blocks"], x, kind, mode)
        caches = {"kv": kv} if mode == "prefill" else None

    elif f == "mla_moe":
        x, a_d, kvd = _blocks(cfg, params["dense_blocks"], x, "mla_dense",
                              mode)
        x, a_m, kvm = _blocks(cfg, params["moe_blocks"], x, "mla_moe", mode)
        aux_total = a_d + a_m
        caches = ({"kv_dense": kvd, "kv_moe": kvm}
                  if mode == "prefill" else None)

    elif f == "vlm":
        ncross = cfg.n_layers // cfg.cross_every
        nself_per = cfg.cross_every - 1
        selfs = layers(params["self_blocks"])

        def group(sps, cp, h):
            aux, kvs = torch.zeros((), dtype=torch.float32,
                                   device=h.device), []
            for lp in sps:
                h, a, kv = attn_ff_block(cfg, lp, h, kind="dense", mode=mode)
                aux = aux + a
                kvs.append(kv)
            # gated cross-attn layer
            hn = _whole_seq(rms_norm(h, cp["attn_norm"], cfg.norm_eps))
            ca = _whole_seq(att.cross_attn(cfg, cp["attn"], hn, vision))
            h = h + torch.tanh(cp["gate_attn"]).to(h.dtype) * ca
            hm = _whole_seq(rms_norm(h, cp["mlp_norm"], cfg.norm_eps))
            h = h + torch.tanh(cp["gate_mlp"]).to(h.dtype) \
                * _whole_seq(mlp_apply(cp["mlp"], hm))
            return h, aux, kvs

        body = remat(cfg, group)
        kvs = []
        for g, cp in enumerate(layers(params["cross_blocks"])):
            x, a, kv = body(selfs[g * nself_per:(g + 1) * nself_per], cp, x)
            aux_total = aux_total + a
            kvs.extend(kv)
        if mode == "prefill":
            caches = {"kv": stack(kvs), "vision": vision}

    elif f == "zamba":
        shared = params["shared"]

        def group(lps, h):
            # shared attention block (concat with the original embedding)
            hin = matmul(_whole_seq(torch.cat([h, emb0], dim=-1)),
                         shared["proj"])
            hb, a, kv = attn_ff_block(cfg, shared, hin, kind="dense",
                                      mode=mode, window=cfg.window)
            h, st = _mamba_layers(cfg, lps, h + hb)
            return h, a, kv, st

        body = remat(cfg, group)
        kvs, mstates = [], []
        for lps in layers(params["mamba_groups"]):
            x, a, kv, st = body(lps, x)
            aux_total = aux_total + a
            kvs.append(kv)
            mstates.append(st)
        tail_states = None
        if "mamba_tail" in params:
            x, tail_states = _mamba_layers(
                cfg, params["mamba_tail"], x,
                remat(cfg, lambda lp, h: _mamba_layer(cfg, lp, h)))
        if mode == "prefill":
            caches = {"mamba": stack(mstates), "attn": stack(kvs)}
            if tail_states is not None:
                caches["mamba_tail"] = tail_states

    elif f == "rwkv":
        x = layer_norm(x, params["ln0_s"], params["ln0_b"], cfg.norm_eps)
        b = tokens.shape[0]
        state0 = tree_map(
            lambda d: torch.zeros(d.shape[1:], dtype=d.dtype,
                                  device=x.device),
            rwkv6.rwkv_state_schema(cfg, b))
        body = remat(cfg, lambda lp, h: rwkv6.rwkv_block(cfg, lp, h, state0))
        states = []
        for lp in layers(params["blocks"]):
            x, st = body(lp, x)
            states.append(st)
        caches = {"blocks": stack(states)} if mode == "prefill" else None

    else:
        raise ValueError(f)

    logits = _logits(cfg, params, x)
    return logits, aux_total, caches, x


# ---------------------------------------------------------------------------
# Decode
# ---------------------------------------------------------------------------
def _put(dst, src):
    """Write a layer's new recurrent state into its cache views.  A
    placed view takes the new state in its own placement, written into
    its local block (the stacked cache's storage) on every rank."""
    def put(d, s):
        if not placed(d):
            d.copy_(s)
            return
        dm, want = d.device_mesh, tuple(d.placements)
        d.to_local().copy_(s.redistribute(dm, want).to_local() if placed(s)
                           else local_part(s, dm, want))
    tree_map(put, dst, src)


def _decode_blocks(cfg, params, kv, x, kind, index):
    for i in range(n_layers_of(params)):
        x, _, _ = attn_ff_block(cfg, layer(params, i), x, kind=kind,
                                mode="decode", cache=layer(kv, i),
                                index=index)
    return x


def _mamba_decode_layers(cfg, params, states, h):
    for i in range(n_layers_of(params)):
        lp, st = layer(params, i), layer(states, i)
        out, ns = mamba2.mamba_decode(
            cfg, lp["mamba"], rms_norm(h, lp["norm"], cfg.norm_eps), st)
        _put(st, ns)
        h = h + _whole_seq(out)
    return h


def decode(cfg: LMConfig, params, token, cache, index: int):
    """token: (B, 1) int; cache: family cache tree; index: the position (a
    host int).  Updates ``cache`` in place; returns (logits (B, 1, V),
    cache)."""
    f = cfg.family
    x = _embed(cfg, params, token)
    emb0 = x

    if f in ("dense", "moe", "mla"):
        kind = {"dense": "dense", "moe": "moe", "mla": "mla_dense"}[f]
        x = _decode_blocks(cfg, params["blocks"], cache["kv"], x, kind, index)

    elif f == "mla_moe":
        x = _decode_blocks(cfg, params["dense_blocks"], cache["kv_dense"], x,
                           "mla_dense", index)
        x = _decode_blocks(cfg, params["moe_blocks"], cache["kv_moe"], x,
                           "mla_moe", index)

    elif f == "vlm":
        ncross = cfg.n_layers // cfg.cross_every
        nself_per = cfg.cross_every - 1
        for g in range(ncross):
            for j in range(nself_per):
                i = g * nself_per + j
                x, _, _ = attn_ff_block(
                    cfg, layer(params["self_blocks"], i), x, kind="dense",
                    mode="decode", cache=layer(cache["kv"], i), index=index)
            cp = layer(params["cross_blocks"], g)
            hn = _whole_seq(rms_norm(x, cp["attn_norm"], cfg.norm_eps))
            ca = _whole_seq(att.cross_decode(
                cfg, cp["attn"], hn, cache["cross_k"][g],
                cache["cross_v"][g]))
            x = x + torch.tanh(cp["gate_attn"]).to(x.dtype) * ca
            hm = _whole_seq(rms_norm(x, cp["mlp_norm"], cfg.norm_eps))
            x = x + torch.tanh(cp["gate_mlp"]).to(x.dtype) \
                * _whole_seq(mlp_apply(cp["mlp"], hm))

    elif f == "zamba":
        shared = params["shared"]
        for g in range(n_layers_of(params["mamba_groups"])):
            hin = matmul(_whole_seq(torch.cat([x, emb0], dim=-1)),
                         shared["proj"])
            hb, _, _ = attn_ff_block(cfg, shared, hin, kind="dense",
                                     mode="decode",
                                     cache=layer(cache["attn"], g),
                                     index=index, window=cfg.window)
            x = _mamba_decode_layers(cfg, layer(params["mamba_groups"], g),
                                     layer(cache["mamba"], g), x + hb)
        if "mamba_tail" in params:
            x = _mamba_decode_layers(cfg, params["mamba_tail"],
                                     cache["mamba_tail"], x)

    elif f == "rwkv":
        x = layer_norm(x, params["ln0_s"], params["ln0_b"], cfg.norm_eps)
        for i in range(n_layers_of(params["blocks"])):
            st = layer(cache["blocks"], i)
            x, ns = rwkv6.rwkv_block(cfg, layer(params["blocks"], i), x, st)
            _put(st, ns)

    else:
        raise ValueError(f)

    return _logits(cfg, params, x), cache


def vlm_cross_cache(cfg: LMConfig, params, vision):
    """Precompute cross-attn K/V from vision states (prefill side); an f32
    vision stub gives f32 K/V, as in the reference."""
    h, hd = cfg.n_heads, cfg.head_dim
    cross = params["cross_blocks"]["attn"]
    ks, vs = [], []
    for g in range(n_layers_of(cross)):
        cp = layer(cross, g)
        ks.append(split_heads(matmul(vision, cp["wk"]), h, hd))
        vs.append(split_heads(matmul(vision, cp["wv"]), h, hd))
    return torch.stack(ks), torch.stack(vs)


# ---------------------------------------------------------------------------
# MTP head (DeepSeek-V3)
# ---------------------------------------------------------------------------
def mtp_logits(cfg: LMConfig, params, hidden, tokens_next):
    """hidden: (B, S, d) final hidden; tokens_next: (B, S) = token t+1.
    Returns logits for predicting t+2 (one extra MLA block).  On a mesh
    the two normed inputs hold the whole sequence before they are joined
    and projected (``_whole_seq``)."""
    mp = params["mtp"]
    e = _embed(cfg, params, tokens_next)
    h = torch.cat([_whole_seq(rms_norm(hidden, mp["norm_h"],
                                            cfg.norm_eps)),
                   _whole_seq(rms_norm(e, mp["norm_e"], cfg.norm_eps))],
                  dim=-1)
    h = matmul(h, mp["proj"])
    h, _, _ = attn_ff_block(cfg, mp, h, kind="mla_dense", mode="train")
    return _logits(cfg, params, h)
