"""Train-step factory: grad accumulation, clipping, optimizer, metrics.

``make_train_step(cfg)`` returns ``step(params, opt_state, batch) ->
(params, opt_state, metrics)``.  Microbatch accumulation is a loop over
``cfg.microbatch`` leading batch splits with a ``cfg.grad_accum_dtype``
accumulator (activation memory divides by the split).  The gradients come
from ``torch.autograd.grad`` over detached, differentiable aliases of the
parameter leaves, so the parameters themselves (an ``LM``'s are registered
without gradients) stay as they are until the optimizer writes them.  The
step takes ``params`` and ``opt_state`` over and updates them in place, as
the reference's launcher jits it with ``donate_argnums=(0, 1)`` (see
``optimizer``).

Under a mesh that carries a ``device_mesh`` (``sharding.use_mesh``; the
parameters and optimizer state DTensors placed by their partitions) the
step takes the same global batch on every rank: each microbatch is cut
from it as on one device and placed ``Shard(0)`` over the batch axes, the
loss and its gradient run with the models' own plain tensors counted as
replicated (``sharding.replicate_plain``), each gradient is redistributed
to its parameter's placements before it is accumulated, as the
reference's ``_pin`` constrains its f32 accumulator, and the loss and
metrics come back whole (replicated, plain tensors).  A batch given
placed is redistributed to that partition as it is (one microbatch) or
taken whole first (each microbatch a slice of it).  With
``grad_compression="int8"`` the placed gradients are quantized with error
feedback as on one device (``compress``: one scale per leaf from its
global max), the residuals placed as the parameters; their reduction over
"pod" and "data" stays the one DTensor issues, as XLA issues it in the
reference's step.
"""
from __future__ import annotations

from typing import Callable, Optional

import torch

from ..models import api
from ..models.common import tree_from_items, tree_items, tree_map
from ..models.config import LMConfig
from ..sharding import (current_mesh, distribute, named_sharding, placed,
                        placements, replicate_plain, shard, spec_for)
from . import compress
from .optimizer import make_optimizer


def make_train_step(cfg: LMConfig, lr: float = 3e-4,
                    grad_compression: Optional[str] = None,
                    params_pspecs=None) -> Callable:
    """``params_pspecs``: the parameters' partition tree (``api.pspecs``):
    under a mesh each gradient is redistributed to these partitions before
    it is accumulated (to the parameter's own placements without it), as
    the reference pins its f32 accumulator; without a mesh nothing
    moves."""
    opt_init, opt_update = make_optimizer(cfg.optimizer)
    acc_dtype = torch.bfloat16 if cfg.grad_accum_dtype == "bf16" \
        else torch.float32
    pspecs = None if params_pspecs is None else dict(
        tree_items(params_pspecs))

    def pin(path, g, p):
        if not placed(g):
            return g
        want = (p.placements if pspecs is None
                else placements(pspecs[path], current_mesh()))
        return g.redistribute(p.device_mesh, want)

    def whole(t):
        return t.full_tensor() if placed(t) else t

    def grads_of(params, batch):
        """(loss, metrics, grads) of one (micro)batch; a leaf the loss
        does not reach gets a zero gradient, as ``jax.grad`` gives."""
        paths, leaves = zip(*[(p, t.detach().requires_grad_())
                              for p, t in tree_items(params)])
        if current_mesh() is not None:
            rows = lambda x: ("batch",) + (None,) * (x.dim() - 1)
            batch = {n: shard(x, *rows(x)) if placed(x) else distribute(
                x, named_sharding(x.shape, rows(x)))
                for n, x in batch.items()}
        with torch.enable_grad(), replicate_plain():
            loss, metrics = api.loss_fn(
                cfg, tree_from_items(zip(paths, leaves)), batch)
            grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                        materialize_grads=True)
        metrics = {k: whole(v.detach()) for k, v in metrics.items()}
        grads = [pin(path, g, p) for path, g, p in zip(paths, grads, leaves)]
        return whole(loss.detach()), metrics, tree_from_items(
            zip(paths, grads))

    def compute_grads(params, batch):
        k = cfg.microbatch
        if k <= 1:
            return grads_of(params, batch)
        # a batch given placed (launch.dryrun.build_step places it as the
        # reference's in_shardings do) is taken whole: each microbatch is
        # a slice of the global batch, placed by grads_of
        batch = {n: whole(x) for n, x in batch.items()}
        for i in range(k):
            mb = {n: x.reshape((k, x.shape[0] // k) + x.shape[1:])[i]
                  for n, x in batch.items()}
            loss, metrics, grads = grads_of(params, mb)
            # the reference adds to zeros: the first term as it is
            if i == 0:
                loss_sum = loss
                acc = tree_map(lambda g: g.to(acc_dtype), grads)
            else:
                loss_sum = loss_sum + loss
                tree_map(lambda a, g: a.add_(g.to(acc_dtype)), acc, grads)
            del grads
        # leaf by leaf, each accumulator dropped once cast
        acc = dict(tree_items(acc))
        grads = tree_from_items((path, (acc.pop(path) / k).to(p.dtype))
                                for path, p in tree_items(params))
        return loss_sum / k, metrics, grads

    def step(params, opt_state, batch):
        loss, metrics, grads = compute_grads(params, batch)
        if grad_compression == "int8":
            grads, new_resid = compress.compress_tree_with_feedback(
                grads, opt_state["ef_residual"])
        new_params, new_opt, gnorm = opt_update(
            grads, opt_state["opt"], params, lr)
        out_state = {"opt": new_opt}
        if grad_compression == "int8":
            out_state["ef_residual"] = new_resid
        m = dict(metrics)
        m["loss"] = loss
        m["grad_norm"] = gnorm
        return new_params, out_state, m

    def init_state(params):
        st = {"opt": opt_init(params)}
        if grad_compression == "int8":
            st["ef_residual"] = compress.init_residuals(params)
        return st

    step.init_state = init_state
    return step


def opt_state_pspecs(cfg: LMConfig, params_pspecs,
                     grad_compression: Optional[str] = None,
                     mesh=None, rules=None):
    """The partitions of the optimizer state (mirroring the params'), as
    ``spec_for`` tuples (``()`` is the reference's ``P()``).

    Adafactor's factored leaves are derived from the parameter SCHEMA
    (shape/axes), not from the params' specs: specs trim trailing Nones,
    so their length says nothing about the parameter's rank."""
    if cfg.optimizer == "adamw":
        st = {"opt": {"m": params_pspecs, "v": params_pspecs, "step": ()}}
    else:
        def fac(d):
            if len(d.shape) >= 2:
                return {"vr": spec_for(d.shape[:-1], d.axes[:-1], mesh, rules),
                        "vc": spec_for(d.shape[:-2] + d.shape[-1:],
                                       d.axes[:-2] + d.axes[-1:], mesh,
                                       rules)}
            return {"v": spec_for(d.shape, d.axes, mesh, rules)}
        st = {"opt": {"f": tree_map(fac, api.schema(cfg)), "step": ()}}
    if grad_compression == "int8":
        st["ef_residual"] = params_pspecs
    return st
