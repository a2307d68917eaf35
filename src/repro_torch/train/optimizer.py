"""Optimizers: AdamW (f32 moments) and Adafactor (factored second moment,
bf16 state), the reference's ``train/optimizer.py`` on torch tensors.

``init(params) -> state``; ``update(grads, state, params, lr) -> (params,
state, grad_norm)``.  The state trees are the reference's:
``{"m", "v", "step"}`` and ``{"f": {... {"vr", "vc"} or {"v"}}, "step"}``,
``step`` a 0-dim int32 tensor.

An update takes ``params`` and ``state`` over, as the reference's launcher
jits its step with ``donate_argnums=(0, 1)``: it writes the new values
into their tensors in place and returns them (``step`` is a new tensor); a
caller that needs the old values keeps a copy.  AdamW updates a stacked
leaf (``ndim >= 3``, one slice per layer) slice by slice, so its f32
temporaries are one layer's (at granite-3-8b's width one f32 copy of the
stacked ``mlp.w_in`` is 6.7 GB at 16 layers); its math is elementwise once
the global norm is taken, so the result does not change.  Adafactor's RMS
clip is per slice when it slices, so it slices only where the reference
does: leaves of ``ndim >= 3`` above ``_CHUNK_THRESHOLD`` elements (the
reference's ``lax.map``).

Placed on a mesh (DTensor leaves, each gradient, moment and parameter of
one placement), the global norm sums each leaf's squares on its blocks
and takes the leaf's sum whole (one all-reduce per leaf) before adding
it in, and AdamW then updates every rank's blocks where they lie (its
math is elementwise).  Adafactor updates every rank's blocks too: a
leaf's row factor ``vr`` is placed as the leaf without its last dim, its
column factor ``vc`` as the leaf without its second-to-last (the
placements ``train.step.opt_state_pspecs`` gives them), and each mean
over a sharded dim (``vr``'s, ``vc``'s, the row factor's own mean, the
update's RMS) is a sum over the rank's block added over the mesh dims
that shard it, then divided by the whole dim's size.  Unsharded, the
means are the one-device code's, so a 1x1 mesh is bit for bit one device.
"""
from __future__ import annotations

import math
from dataclasses import dataclass

import torch

from ..models.common import tree_items, tree_map
from ..sharding import dtensor, local_part, placed


@dataclass(frozen=True)
class AdamWConfig:
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    grad_clip: float = 1.0


def _slices(t):
    """A stacked leaf's layer slices (views), or the leaf alone."""
    return [t[i] for i in range(t.shape[0])] if t.dim() >= 3 else [t]


def _leaves(tree):
    return [t for _, t in tree_items(tree)]


def _local(t):
    """A DTensor's block on this rank (its storage), or ``t``."""
    return t.to_local() if placed(t) else t


def _global_norm(tree):
    """sqrt of the sum of squares of every leaf in f32, leaves in the
    reference's order, a stacked leaf summed slice by slice (a placed
    leaf's sum taken whole before it is added)."""
    total = 0.0
    for g in _leaves(tree):
        part = sum(torch.sum(torch.square(s.float())) for s in _slices(g))
        total = total + (part.full_tensor() if placed(part) else part)
    return torch.sqrt(total)


def _clip_scale(norm, max_norm: float):
    return torch.clamp(max_norm / torch.clamp(norm, min=1e-9), max=1.0)


def clip_by_global_norm(grads, max_norm: float):
    """(grads scaled to a global norm of at most ``max_norm``, new
    tensors; the norm before)."""
    norm = _global_norm(grads)
    scale = _clip_scale(norm, max_norm)
    return tree_map(lambda g: (g.float() * scale).to(g.dtype), grads), norm


def adamw_init(params):
    zeros = lambda p: torch.zeros_like(p, dtype=torch.float32)
    dev = _leaves(params)[0].device
    return {"m": tree_map(zeros, params), "v": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


@torch.no_grad()
def adamw_update(grads, state, params, lr, cfg: AdamWConfig = AdamWConfig()):
    gnorm = _global_norm(grads)
    scale = _clip_scale(gnorm, cfg.grad_clip)
    step = _local(state["step"]) + 1
    t = step.float()
    bc1 = 1.0 - cfg.b1 ** t
    bc2 = 1.0 - cfg.b2 ** t

    def upd(p, g, m, v, decay):
        # the clipped gradient as clip_by_global_norm rounds it
        gf = (g.float() * scale).to(g.dtype).float()
        m_new = cfg.b1 * m + (1 - cfg.b1) * gf
        v_new = cfg.b2 * v + (1 - cfg.b2) * gf * gf
        mh = m_new / bc1
        vh = v_new / bc2
        delta = mh / (torch.sqrt(vh) + cfg.eps)
        if decay:                            # decoupled wd on matrices only
            delta = delta + cfg.weight_decay * p.float()
        p.copy_((p.float() - lr * delta).to(p.dtype))
        m.copy_(m_new)
        v.copy_(v_new)

    for p, g, m, v in zip(_leaves(params), _leaves(grads),
                          _leaves(state["m"]), _leaves(state["v"])):
        for args in zip(*map(_slices, map(_local, (p, g, m, v)))):
            upd(*args, decay=p.dim() >= 2)
    return params, {"m": state["m"], "v": state["v"], "step": step}, gnorm


# ---------------------------------------------------------------------------
# Adafactor (no momentum, factored v, bf16 state)
# ---------------------------------------------------------------------------
@dataclass(frozen=True)
class AdafactorConfig:
    eps: float = 1e-30
    clip_threshold: float = 1.0
    decay: float = 0.8          # beta2 = 1 - t^-decay


def _factored(p):
    return p.dim() >= 2


def _factor_placements(p):
    """(``vr``'s, ``vc``'s) placements for a placed factored leaf ``p``:
    its own without its last dim, and without its second-to-last."""
    from torch.distributed.tensor import Replicate, Shard
    last = p.dim() - 1
    vr = tuple(Shard(q.dim) if q.is_shard() and q.dim < last else Replicate()
               for q in p.placements)
    vc = tuple(Shard(q.dim) if q.is_shard() and q.dim < last - 1 else
               Shard(last - 1) if q.is_shard(last) else Replicate()
               for q in p.placements)
    return vr, vc


def adafactor_init(params):
    def zeros(shape, dtype, p, places=None):
        if not placed(p):
            return torch.zeros(shape, dtype=dtype, device=p.device)
        # the block on the parameter's own device (a meta parameter of
        # the dry-run gives a meta block)
        places = places or p.placements
        block = local_part(torch.empty(shape, device="meta"),
                           p.device_mesh, places).shape
        return dtensor(torch.zeros(block, dtype=dtype,
                                   device=p.to_local().device),
                       p.device_mesh, places, shape)

    def one(p):
        if _factored(p):
            vr, vc = _factor_placements(p) if placed(p) else (None, None)
            return {"vr": zeros(p.shape[:-1], torch.bfloat16, p, vr),
                    "vc": zeros(p.shape[:-2] + p.shape[-1:], torch.bfloat16,
                                p, vc)}
        return {"v": zeros(p.shape, torch.float32, p)}
    dev = _local(_leaves(params)[0]).device
    return {"f": tree_map(one, params),
            "step": torch.zeros((), dtype=torch.int32, device=dev)}


_CHUNK_THRESHOLD = 1 << 27      # leaves above ~134M elements update chunked


class _Means:
    """Means over whole dims of a leaf's local block: the block's sum
    added over the mesh dims that shard the dim, over the dim's size (the
    plain ``mean`` where nothing shards it)."""

    def __init__(self, p, g, s):
        if not placed(p):
            self.dm, self.dims = None, {}
            return
        if tuple(g.placements) != tuple(p.placements):
            raise ValueError("a gradient placed otherwise than its "
                             "parameter")
        want = dict(zip(("vr", "vc"), _factor_placements(p))) \
            if _factored(p) else {"v": tuple(p.placements)}
        for k, t in s.items():
            if tuple(t.placements) != want[k]:
                raise ValueError(
                    f"Adafactor state {k} placed {t.placements}, not as "
                    f"train.step.opt_state_pspecs places it ({want[k]})")
        self.dm = p.device_mesh
        self.dims = {d: [i for i, q in enumerate(p.placements)
                         if q.is_shard(d)] for d in range(p.dim())}

    def __call__(self, t, dim, of: int, keepdim=False):
        """``t.mean(dim)``, ``t``'s dim ``dim`` being the leaf's dim
        ``of`` (``None``: every dim, ``t.mean()`` of the whole leaf)."""
        from ..sharding import all_reduce
        dims = sorted({i for d in (self.dims if of is None else [of])
                       for i in self.dims.get(d, [])})
        if not dims:
            return t.mean() if dim is None else t.mean(dim, keepdim=keepdim)
        size = math.prod(self.dm.size(i) for i in dims)
        if dim is None:
            return all_reduce(t.sum(), "sum", self.dm, dims) \
                / (t.numel() * size)
        return all_reduce(t.sum(dim, keepdim=keepdim), "sum", self.dm,
                          dims) / (t.shape[dim] * size)


@torch.no_grad()
def adafactor_update(grads, state, params, lr,
                     cfg: AdafactorConfig = AdafactorConfig()):
    step = _local(state["step"]) + 1
    t = step.float()
    beta2 = 1.0 - t ** (-cfg.decay)

    def upd_core(p, g, s, mean, lead):
        """One leaf (or one slice of it: ``lead`` leading dims cut) on
        local blocks."""
        last = p.dim() - 1 + lead
        gf = g.float()
        g2 = gf * gf + cfg.eps
        if _factored(p):
            vr = beta2 * s["vr"].float() + (1 - beta2) * mean(g2, -1, last)
            vc = beta2 * s["vc"].float() + (1 - beta2) * mean(g2, -2,
                                                               last - 1)
            denom = torch.clamp(mean(vr, -1, last - 1, keepdim=True),
                                min=cfg.eps)
            v_hat = (vr[..., None] / denom[..., None]) * vc[..., None, :]
            u = gf / torch.sqrt(v_hat + cfg.eps)
            s["vr"].copy_(vr.to(torch.bfloat16))
            s["vc"].copy_(vc.to(torch.bfloat16))
        else:
            v = beta2 * s["v"] + (1 - beta2) * g2
            u = gf / torch.sqrt(v + cfg.eps)
            s["v"].copy_(v)
        rms_u = torch.sqrt(mean(u * u, None, None) + 1e-12)
        u = u / torch.clamp(rms_u / cfg.clip_threshold, min=1.0)
        p.copy_((p.float() - lr * u).to(p.dtype))

    for (path, p), g in zip(tree_items(params), _leaves(grads)):
        s = state["f"]
        for k in path.split("."):
            s = s[k]
        mean = _Means(p, g, s)
        pl, gl = _local(p), _local(g)
        sl = {k: _local(x) for k, x in s.items()}
        if p.dim() >= 3 and p.numel() > _CHUNK_THRESHOLD:
            # one layer slice at a time (the reference's lax.map); each
            # slice's RMS is its own, so dim 0 is whole on every rank
            if mean.dims.get(0):
                raise ValueError(f"{path}: a chunked leaf sharded on its "
                                 "leading dim")
            mean.dims.pop(0, None)
            for i in range(p.shape[0]):
                upd_core(pl[i], gl[i], {k: x[i] for k, x in sl.items()},
                         mean, 1)
        else:
            upd_core(pl, gl, sl, mean, 0)
    return params, {"f": state["f"], "step": step}, _global_norm(grads)


def make_optimizer(name: str):
    if name == "adamw":
        return adamw_init, adamw_update
    if name == "adafactor":
        return adafactor_init, adafactor_update
    raise ValueError(name)
