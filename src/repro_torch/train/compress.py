"""Int8 gradient compression with error feedback, the reference's
``train/compress.py`` on torch tensors.

Per-tensor symmetric int8 quantization with an f32 scale, and error
feedback: ``compress_tree_with_feedback`` keeps each leaf's quantization
residual, so the compression is unbiased over time (EF-SGD).  A placed
leaf (a DTensor) is quantized with one scale from its global max (each
rank's local max reduced over the mesh dims that shard it), on each
rank's own block, and its residual keeps the leaf's placements, as the
reference's step quantizes its sharded gradients and places
``ef_residual`` like the parameters.

``compressed_allreduce_mean(x, axis_name)`` is the wire primitive: on
each rank of the active mesh (``sharding.use_mesh``) it all-gathers the
int8 payloads and f32 scales of ``x`` over the mesh dim ``axis_name``
and averages them locally, as the reference does under ``shard_map``.
Given a sequence of tensors instead, it is the single-controller form (as
``ShardMesh`` drives its shards from one process): one tensor per
replica, their payloads gathered onto the first replica's device.
"""
from __future__ import annotations

from typing import Sequence, Tuple

import torch

from ..models.common import tree_map
from ..sharding import all_reduce, current_mesh, dtensor, placed


def quantize_int8(x) -> Tuple[torch.Tensor, torch.Tensor]:
    """(q int8, scale f32 0-dim); rounds half to even, as ``jnp.round``.
    A placed ``x`` gives a placed ``q`` and a plain scale, the same on
    every rank."""
    if placed(x):
        local, scale = _quantize(x.to_local(), x.device_mesh, [
            i for i, p in enumerate(x.placements) if p.is_shard()])
        return dtensor(local, x.device_mesh, x.placements, x.shape), scale
    return _quantize(x, None, ())


def _quantize(x, device_mesh, mesh_dims):
    xf = x.float()
    amax = torch.max(torch.abs(xf))
    if mesh_dims:
        amax = all_reduce(amax, "max", device_mesh, mesh_dims)
    scale = torch.clamp(amax, min=1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q, scale):
    if placed(q):
        return dtensor(q.to_local().float() * scale, q.device_mesh,
                       q.placements, q.shape)
    return q.float() * scale


def quantization_error(x, q, scale):
    return x.float() - dequantize_int8(q, scale)


def compressed_allreduce_mean(x, axis_name: str = None):
    """The mean over the mesh dim ``axis_name`` of this rank's ``x`` with
    int8 payloads: ``x`` quantized, its payload and scale all-gathered
    over that dim's group (int8 on the wire), dequantized and averaged.
    ``x`` is a plain tensor, this rank's block, as under the reference's
    ``shard_map``.  A sequence ``x`` (one tensor per replica) is the
    single-controller form and takes no ``axis_name``."""
    if isinstance(x, (list, tuple)):
        return _replicas_mean(x)
    from torch.distributed import _functional_collectives as funcol
    dm = getattr(current_mesh(), "device_mesh", None)
    if dm is None or axis_name not in (dm.mesh_dim_names or ()):
        raise ValueError(f"compressed_allreduce_mean over {axis_name!r} "
                         "needs a mesh with that axis installed "
                         "(sharding.use_mesh on a device mesh)")
    group = (dm, dm.mesh_dim_names.index(axis_name))
    # all_gather_single is the newer name of all_gather_tensor
    gather = getattr(funcol, "all_gather_single", funcol.all_gather_tensor)
    q, scale = quantize_int8(x)
    qs = funcol.wait_tensor(gather(q[None], 0, group))
    ss = funcol.wait_tensor(gather(scale.reshape(1), 0, group))
    deq = qs.float() * ss.reshape((-1,) + (1,) * x.dim())
    return deq.mean(dim=0)


def _replicas_mean(xs: Sequence[torch.Tensor]):
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
    carries the quantization error forward.  Placed leaves stay placed
    (the residual as its gradient, which the step pins to its parameter's
    placements)."""
    def one(g, r):
        gf = g.float() + r
        q, scale = quantize_int8(gf)
        deq = dequantize_int8(q, scale)
        return deq.to(g.dtype), gf - deq

    out = tree_map(one, grads, residuals)
    return (tree_map(lambda o: o[0], out), tree_map(lambda o: o[1], out))


def init_residuals(params):
    """f32 zeros in each parameter's shape and placements."""
    return tree_map(lambda p: torch.zeros_like(p, dtype=torch.float32),
                    params)
