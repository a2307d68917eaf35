"""Unified model API: schema / init / loss / prefill / decode per config.

``batch`` layout, as in the reference:
    tokens: (B, S) int              LM families ((B, S+1) for ``loss_fn``:
                                    inputs and targets by shift)
    frames: (B, enc_seq, d) f32     encdec stub frontend
    vision: (B, img_seq, d) f32     vlm stub frontend

Parameters are a nested dict of tensors in the reference's tree layout
(stacked ``(L, ...)`` leaves), so the reference's parameters convert leaf
by leaf (:func:`repro_torch.convert.lm_params_from_arrays`).  :class:`LM`
holds such a tree as an ``nn.Module`` whose ``state_dict()`` keys are the
schema paths joined with ``"."`` (``blocks.attn.wq``).  Every function
runs on the device its tensors are on; ``init`` and ``init_cache`` default
to the card and raise without one.
"""
from __future__ import annotations

from typing import Dict, Tuple

import torch
from torch import nn

from ..sharding import replicate_plain, shard
from . import encdec, lm
from .common import (abstract_params, count_params, cross_entropy,
                     init_params, param_pspecs, tree_from_items, tree_items)
from .config import LMConfig


def schema(cfg: LMConfig):
    if cfg.family == "encdec":
        return encdec.encdec_schema(cfg)
    return lm.lm_schema(cfg)


def init(cfg: LMConfig, seed: int = 0, device: str = "cuda", mesh=None):
    """Seeded parameters on ``device``; with a ``mesh`` that carries a
    ``device_mesh``, DTensors placed by :func:`pspecs` (the same values,
    each rank holding its blocks: ``common.init_params``)."""
    return init_params(schema(cfg), seed, device, mesh)


#: the families that train, prefill and decode on a mesh of more than one
#: device: all eight (the MoE families through the expert-parallel path,
#: ROADMAP B2.11, done)
MESH_FAMILIES = ("dense", "moe", "mla", "mla_moe", "zamba", "rwkv", "vlm",
                 "encdec")


def abstract(cfg: LMConfig):
    return abstract_params(schema(cfg))


def pspecs(cfg: LMConfig, mesh=None, rules=None):
    return param_pspecs(schema(cfg), mesh, rules)


def n_params(cfg: LMConfig) -> int:
    return count_params(schema(cfg))


def cache_schema(cfg: LMConfig, batch: int, max_seq: int):
    if cfg.family == "encdec":
        return encdec.encdec_cache_schema(cfg, batch, max_seq)
    return lm.cache_schema(cfg, batch, max_seq)


def abstract_cache(cfg: LMConfig, batch: int, max_seq: int):
    return abstract_params(cache_schema(cfg, batch, max_seq))


def init_cache(cfg: LMConfig, batch: int, max_seq: int,
               device: str = "cuda", mesh=None):
    """Zero decode buffers on ``device``; with a ``mesh`` that carries a
    ``device_mesh``, DTensors placed by :func:`cache_pspecs`."""
    return init_params(cache_schema(cfg, batch, max_seq), 0, device, mesh)


def cache_pspecs(cfg: LMConfig, batch: int, max_seq: int, mesh=None,
                 rules=None):
    return param_pspecs(cache_schema(cfg, batch, max_seq), mesh, rules)


# ---------------------------------------------------------------------------
# Loss (train)
# ---------------------------------------------------------------------------
def loss_fn(cfg: LMConfig, params, batch) -> Tuple[torch.Tensor, Dict]:
    """(loss, metrics) of a batch: mean next-token CE plus the MoE aux
    loss and, with ``cfg.mtp``, the weighted t+2 CE.  Metrics are 0-dim
    f32 tensors: ``ce``, ``aux`` (not for encdec) and ``mtp_ce``."""
    tokens = batch["tokens"].long()
    inputs, targets = tokens[:, :-1], tokens[:, 1:]
    if cfg.family == "encdec":
        memory = encdec.encode(cfg, params, batch["frames"])
        logits, _ = encdec.decode_train(cfg, params, inputs, memory)
        loss = cross_entropy(logits, targets)
        return loss, {"ce": loss}
    logits, aux, _, hidden = lm.forward(cfg, params, inputs,
                                        vision=batch.get("vision"))
    ce = cross_entropy(logits, targets)
    loss = ce + aux
    metrics = {"ce": ce, "aux": aux}
    if cfg.mtp:
        # predict t+2 from (hidden_t, emb(token_{t+1})); on a mesh the
        # hidden's sequence is made whole before it is cut
        mtp_lg = lm.mtp_logits(cfg, params,
                               shard(hidden, "batch", "seq", None)[:, :-1],
                               targets[:, :-1])
        mtp_ce = cross_entropy(mtp_lg, targets[:, 1:])
        loss = loss + cfg.mtp_loss_coef * mtp_ce
        metrics["mtp_ce"] = mtp_ce
    return loss, metrics


# ---------------------------------------------------------------------------
# Serving
# ---------------------------------------------------------------------------
def prefill(cfg: LMConfig, params, batch):
    """Returns (last-position logits (B, V), caches).  On a mesh the
    caches come out in the reference's cache partition (``cache_pspecs``
    at their own lengths: the K/V positions on ``kv_seq``), as decode
    takes them."""
    tokens = batch["tokens"]
    with replicate_plain():
        if cfg.family == "encdec":
            memory = encdec.encode(cfg, params, batch["frames"])
            logits, caches = encdec.decode_train(cfg, params, tokens,
                                                 memory, mode="prefill")
            ck, cv = encdec.cross_kv(cfg, params, memory)
            caches = {"k": caches["k"], "v": caches["v"],
                      "cross_k": ck, "cross_v": cv}
        else:
            logits, _, caches, _ = lm.forward(cfg, params, tokens,
                                              vision=batch.get("vision"),
                                              mode="prefill")
            if cfg.family == "vlm" and caches is not None:
                ck, cv = lm.vlm_cross_cache(cfg, params, batch["vision"])
                caches = {"kv": caches["kv"], "cross_k": ck, "cross_v": cv}
        return logits[:, -1], _cache_partition(cfg, caches, tokens.shape)


def _cache_partition(cfg: LMConfig, cache, tokens_shape):
    """Each leaf of a prefill cache moved to the partition the cache
    schema's logical axes give it at its own shape (nothing moves without
    a mesh)."""
    axes = {p: d.axes for p, d in
            tree_items(cache_schema(cfg, *tokens_shape))}
    return tree_from_items((p, shard(t, *axes[p]))
                           for p, t in tree_items(cache))


def decode(cfg: LMConfig, params, token, cache, index: int):
    """token: (B, 1) int; index: the position (a host int).  Updates
    ``cache`` in place; returns (logits (B, 1, V), cache)."""
    with replicate_plain():
        if cfg.family == "encdec":
            return encdec.decode_step(cfg, params, token, cache, index)
        return lm.decode(cfg, params, token, cache, index)


# ---------------------------------------------------------------------------
# The module
# ---------------------------------------------------------------------------
def _register(module: nn.Module, tree: Dict) -> None:
    for key, val in tree.items():
        if isinstance(val, dict):
            sub = nn.Module()
            _register(sub, val)
            module.add_module(key, sub)
        else:
            module.register_parameter(
                key, nn.Parameter(val, requires_grad=False))


def _tree(module: nn.Module) -> Dict:
    out = dict(module._parameters)
    out.update({k: _tree(m) for k, m in module._modules.items()})
    return out


class LM(nn.Module):
    """An architecture's parameters as a module (the tensors are shared,
    not copied), with the serving entry points as methods."""

    def __init__(self, cfg: LMConfig, params: Dict):
        super().__init__()
        self.cfg = cfg
        _register(self, params)

    @classmethod
    def init(cls, cfg: LMConfig, seed: int = 0, device: str = "cuda"):
        return cls(cfg, init(cfg, seed, device))

    @property
    def params(self) -> Dict:
        """The parameter tree, in the reference's layout."""
        return _tree(self)

    def prefill(self, batch):
        return prefill(self.cfg, self.params, batch)

    def decode(self, token, cache, index: int):
        return decode(self.cfg, self.params, token, cache, index)
