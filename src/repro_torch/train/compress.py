"""Int8 gradient compression with error feedback, the reference's
``train/compress.py`` on torch tensors.

Per-tensor symmetric int8 quantization with an f32 scale, and error
feedback: ``compress_tree_with_feedback`` keeps each leaf's quantization
residual, so the compression is unbiased over time (EF-SGD).
``compressed_allreduce_mean`` is the wire primitive in the port's
single-controller form (as ``ShardMesh`` drives its shards from one
process): it takes one tensor per replica, gathers their int8 payloads
and scales onto the first replica's device, and averages them there.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..models.common import tree_map


def quantize_int8(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale f32 0-dim); rounds half to even, as ``jnp.round``."""
    xf = x.float()
    scale = torch.clamp(torch.max(torch.abs(xf)), min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    return q.float() * scale


def quantization_error(x, q, scale):
    return x.float() - dequantize_int8(q, scale)


def compressed_allreduce_mean(xs: Sequence[torch.Tensor]):
    """The mean of ``xs`` (one tensor per replica) with int8 payloads."""
    dev = xs[0].device
    pairs = [quantize_int8(x) for x in xs]
    qs = torch.stack([q.to(dev) for q, _ in pairs])      # int8 "on the wire"
    ss = torch.stack([s.to(dev) for _, s in pairs])
    deq = qs.float() * ss.reshape((-1,) + (1,) * xs[0].dim())
    return deq.mean(dim=0)


def compress_tree_with_feedback(grads, residuals):
    """Quantize every leaf, fold in carried residuals (error feedback).

    Returns (dequantized grads, new residuals): the values the optimizer
    sees are what a compressed transfer would deliver, and the residual
    carries the quantization error forward."""
    def one(g, r):
        gf = g.float() + r
        q, scale = quantize_int8(gf)
        deq = dequantize_int8(q, scale)
        return deq.to(g.dtype), gf - deq

    out = tree_map(one, grads, residuals)
    return (tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out))


def init_residuals(params):
    return tree_map(lambda p: torch.zeros(p.shape, dtype=torch.float32,
                                          device=p.device), params)
