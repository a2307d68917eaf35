"""Mixture-of-Experts layer: top-k routing + grouped expert products.

On one device, the reference's local path: tokens sort by expert (a stable
sort, as ``jnp.argsort``), and each expert's rows run through its two
matrices.  ``jax.lax.ragged_dot`` becomes one ``torch.matmul`` per expert
over its slice of the sorted rows, plain products, so the expert group
sizes are read on the host: one host sync per MoE layer on each rank (none
under ``cfg.moe_dense_analysis``, the same-work dense surrogate; ROADMAP
B2.10).

On a (data x model) device mesh (the input a DTensor), the reference's
expert-parallel ``shard_map`` (B2.11): each rank runs plain code on its
local blocks, as ``attention._attend`` does.  The router is taken whole
and routes the rank's own token rows (split over the batch axes, as the
reference's ``tok_spec``; replicated with ``cfg.ep_over_data`` or when
they do not split evenly); the aux loss's expert counts and mean
probabilities are summed over the ranks that split the rows, so it is the
global one.  The experts are placed ``Shard(0)`` over the EP mesh dims
("model", or "model" and "data" with ``ep_over_data``) and whole over the
rest (the reference's ``in_specs``: the FSDP "embed" dim is gathered over
"data"); each rank computes its own experts' rows under the per-shard
capacity ``capacity_factor * expected``, and the partial sums are added
over the EP dims (the ``psum``).  Where the experts do not split over the
EP ranks, or "model" has one device, the local path runs on each rank's
rows with the weights whole, as the reference's does outside
``shard_map``.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..sharding import block_of, current_mesh, dtensor, placed
from .common import ParamDef, matmul, swiglu
from .config import LMConfig


def moe_schema(cfg: LMConfig, layers: Optional[int] = None) -> Dict:
    L = cfg.n_layers if layers is None else layers
    d, e, h = cfg.d_model, cfg.n_experts, cfg.moe_d_ff
    lead = (L,) if L else ()
    lax = ("layers",) if L else ()
    p = {
        "router": ParamDef(lead + (d, e), lax + (None, None),
                           dtype=torch.float32),
        "w_in": ParamDef(lead + (e, d, 2 * h),
                         lax + ("experts", "embed", None)),
        "w_out": ParamDef(lead + (e, h, d),
                          lax + ("experts", None, "embed")),
    }
    if cfg.n_shared_experts:
        sh = cfg.moe_d_ff * cfg.n_shared_experts
        p["shared_in"] = ParamDef(lead + (d, 2 * sh), lax + ("embed", "ff"))
        p["shared_out"] = ParamDef(lead + (sh, d), lax + ("ff", "embed"))
    return p


def _grouped_mm(rows, w, sizes):
    """The reference's ``ragged_dot``: rows ``[o_e, o_e + sizes[e])`` times
    ``w[e]``; rows past the last group give zeros."""
    out = rows.new_zeros((rows.shape[0], w.shape[-1]))
    start = 0
    for e, n in enumerate(sizes):
        if n:
            out[start:start + n] = rows[start:start + n] @ w[e]
            start += n
    return out


def _expert_rows(xf, top_i, top_p, w_in, w_out, *, n_local: int,
                 first_expert: int, cap: int, k: int,
                 dense_surrogate: bool = False):
    """Grouped products over one shard's experts.

    xf: (N, d) tokens; top_i/top_p: (N, K); w_in: (El, d, 2h); w_out: (El, h, d).
    Returns (N, d) contribution of local experts.  ``dense_surrogate``
    (``cfg.moe_dense_analysis``, the roofline's analysis variants and the
    dry-run's trace on ``meta``): every selected row through expert 0's
    matrices, one dense product each, with the grouped products' rows x d x
    h work and no host read of the group sizes (not the model's output).

    Each selected row is one (token, slot) pair, a distinct index of the
    N*K pairs, so the rows are read from, and their results written back
    to, an (N*K, d) array of pairs, and each token's K slots then summed:
    the reference's scatter-add to the tokens (and a gather's backward)
    would add into one token from several rows at once, which on the card
    (atomic adds) gives other bits from run to run.
    """
    n, d = xf.shape
    flat_i = top_i.reshape(-1)                     # (N*K,)
    flat_p = top_p.reshape(-1)
    local = (flat_i >= first_expert) & (flat_i < first_expert + n_local)
    local_eid = torch.where(local, flat_i - first_expert, n_local)
    order = torch.sort(local_eid, stable=True).indices  # non-local rows last
    sel = order[:cap]                              # (cap,)
    sel_eid = local_eid[sel]
    sel_valid = sel_eid < n_local
    pairs = xf[:, None].expand(n, k, d).reshape(n * k, d)
    rows = torch.where(sel_valid[:, None], pairs[sel], 0)
    if dense_surrogate:
        hidden = rows @ w_in[0]
        gate, up = hidden.chunk(2, dim=-1)
        out_rows = swiglu(gate, up) @ w_out[0]
    else:
        # the group sizes by a scatter-add (bincount would sync for its size)
        eids = torch.where(sel_valid, sel_eid, n_local)
        group_sizes = torch.zeros(n_local + 1, dtype=eids.dtype,
                                  device=eids.device).index_add_(
            0, eids, torch.ones_like(eids))[:n_local]
        sizes = group_sizes.tolist()               # the host sync
        hidden = _grouped_mm(rows, w_in, sizes)
        gate, up = hidden.chunk(2, dim=-1)
        act = swiglu(gate, up)
        out_rows = _grouped_mm(act, w_out, sizes)
    w = torch.where(sel_valid, flat_p[sel], 0.0).to(out_rows.dtype)
    y = out_rows.new_zeros((n * k, d))
    y[sel] = out_rows * w[:, None]
    return y.view(n, k, d).sum(1)


def _route(cfg: LMConfig, xf, router):
    """(probs (N, E) f32, top_p (N, K), top_i (N, K)) of tokens ``xf``."""
    probs = torch.softmax(xf.float() @ router, dim=-1)
    top_p, top_i = torch.topk(probs, cfg.top_k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)
    return probs, top_p, top_i


def _counts(top_i, e: int):
    """How many of the rows' K choices went to each of ``e`` experts (f32),
    by a scatter-add."""
    return torch.zeros(e, dtype=torch.float32, device=top_i.device) \
        .index_add_(0, top_i.reshape(-1),
                    torch.ones(top_i.numel(), device=top_i.device))


def _aux(cfg: LMConfig, density, mean_prob):
    """The Switch-style load-balancing loss."""
    return cfg.aux_loss_coef * cfg.n_experts * torch.sum(density * mean_prob)


def _ep_axes(cfg: LMConfig, names, size):
    """(the EP mesh axes, whether the EP path runs) on a mesh of axes
    ``names`` whose sizes ``size(name)`` gives, as the reference decides."""
    axes = ("model", "data") if cfg.ep_over_data and "data" in names \
        else ("model",)
    n_ep = math.prod(size(a) for a in axes)
    return axes, ("model" in names and size("model") > 1
                  and cfg.n_experts % n_ep == 0)


def moe_apply(cfg: LMConfig, p, x):
    """x: (B, S, d) -> (out, aux_loss).  A DTensor ``x`` (parameters
    placed on the same device mesh) takes the mesh path; a plain one the
    local path, unless a mesh is installed whose "model" axis the
    reference would run expert-parallel over (that needs placed tensors,
    and raises)."""
    if placed(x):
        y, aux = _on_mesh(cfg, p, x)
    else:
        mesh = current_mesh()
        if mesh is not None and _ep_axes(cfg, mesh.axis_names,
                                         mesh.shape.__getitem__)[1]:
            raise NotImplementedError(
                "the expert-parallel MoE path runs on tensors placed on a "
                "device mesh (api.init(cfg, mesh=...)); this input is a "
                "plain tensor under a mesh with a 'model' axis")
        y, aux = _local(cfg, p, x)
    if cfg.n_shared_experts:
        gate, up = matmul(x, p["shared_in"]).chunk(2, dim=-1)
        y = y + matmul(swiglu(gate, up), p["shared_out"])
    return y, aux


def _local(cfg: LMConfig, p, x):
    """The reference's local path on one device: (routed output, aux)."""
    b, s, d = x.shape
    n, e, k = b * s, cfg.n_experts, cfg.top_k
    xf = x.reshape(n, d)
    probs, top_p, top_i = _route(cfg, xf, p["router"])
    aux = _aux(cfg, _counts(top_i, e) / (n * k), probs.mean(0))
    y = _expert_rows(xf, top_i, top_p.to(xf.dtype), p["w_in"], p["w_out"],
                     n_local=e, first_expert=0, cap=n * k, k=k,
                     dense_surrogate=cfg.moe_dense_analysis)
    return y.reshape(b, s, d).to(x.dtype), aux


def _on_mesh(cfg: LMConfig, p, x):
    """The mesh path (see the module docstring): (routed output placed as
    the tokens' rows, aux a replicated DTensor).

    Gradients: the tokens, the router and the routing weights reach the
    experts through a boundary whose gradient is summed over the EP mesh
    dims (each EP rank saw only its own experts' rows: the transpose of
    the reference's unmapped ``shard_map`` inputs); the router's and the
    experts' gradients are partial over the mesh dims that split the
    rows."""
    from torch.distributed.tensor import Partial, Replicate, Shard
    dm = x.device_mesh
    names, nd = dm.mesh_dim_names, dm.ndim
    b, s, d = x.shape
    n, e, k = b * s, cfg.n_experts, cfg.top_k
    ep_axes, ep = _ep_axes(cfg, names, lambda a: dm.size(names.index(a)))
    ep_dims = {names.index(a) for a in ep_axes} if ep else set()
    n_ep = math.prod(dm.size(i) for i in ep_dims)
    batch = [i for i, a in enumerate(names)
             if a in ("pod", "data") and dm.size(i) > 1]
    n_shard = math.prod(dm.size(i) for i in batch)
    # the token rows: split over the batch dims as the reference's
    # tok_spec, as x's own batch rows where they split evenly, else each
    # rank's block of the flattened rows; replicated with ep_over_data or
    # where the rows do not split (the local path needs no split)
    split = batch and not (ep and cfg.ep_over_data) and n % n_shard == 0 \
        and (ep or b % n_shard == 0)
    tok = set(batch) if split else set()
    by_batch = split and b % n_shard == 0
    n_per = n // n_shard if split else n

    def places(on_tok, on_ep, other=Replicate()):
        return tuple(on_tok if i in tok else on_ep if i in ep_dims
                     else other for i in range(nd))

    row = places(Shard(0), Replicate())          # the (N, .) token arrays
    x_rows = places(Shard(0) if by_batch else Replicate(), Replicate())
    xl = x.redistribute(dm, x_rows).to_local(grad_placements=places(
        Shard(0) if by_batch else Partial(), Replicate()))
    xf = xl.reshape(-1, d)
    if split and not by_batch:
        coord, r = dm.get_coordinate(), 0
        for i in sorted(tok):
            r = r * dm.size(i) + coord[i]
        xf = xf.narrow(0, r * n_per, n_per)

    router = p["router"].redistribute(dm, (Replicate(),) * nd).to_local(
        grad_placements=places(Partial(), Replicate()))
    probs, top_p, top_i = _route(cfg, xf, router)
    if tok:
        # the global counts and mean: the rows' sums added over the ranks
        # that split them (one all-reduce; differentiable in probs)
        both = dtensor(torch.cat([_counts(top_i, e), probs.sum(0)]), dm,
                       places(Partial(), Replicate()), (2 * e,)) \
            .redistribute(dm, (Replicate(),) * nd).to_local()
        aux = _aux(cfg, both[:e] / (n * k), both[e:] / n)
    else:
        aux = _aux(cfg, _counts(top_i, e) / (n * k), probs.mean(0))

    ep_w = places(Replicate(), Shard(0))
    ep_grad = places(Partial(), Shard(0))

    def experts(w):
        return w.redistribute(dm, ep_w).to_local(grad_placements=ep_grad)

    first, n_local = block_of(p["w_in"].shape, 0, dm, ep_w)
    xe, tp = xf, top_p.to(xf.dtype)
    if ep_dims:
        into = places(Shard(0), Partial())

        def cross(t):
            return dtensor(t, dm, row, (n,) + tuple(t.shape[1:])) \
                .to_local(grad_placements=into)
        xe, tp = cross(xe), cross(tp)
        cap = int(min(n_per * k, max(k, cfg.capacity_factor * n_per * k
                                     / n_ep)))
    else:
        cap = n_per * k
    y = _expert_rows(xe, top_i, tp, experts(p["w_in"]),
                     experts(p["w_out"]), n_local=n_local,
                     first_expert=first, cap=cap, k=k,
                     dense_surrogate=cfg.moe_dense_analysis)
    # the psum over the EP dims, into the tokens' rows
    y = dtensor(y, dm, places(Shard(0), Partial()), (n, d)).redistribute(
        dm, places(Shard(0) if by_batch else Replicate(), Replicate())) \
        .to_local()
    # aux as a DTensor, the same on every rank: a plain tensor added to a
    # DTensor would take its gradient back as a DTensor
    return (dtensor(y.reshape(-1, s, d).to(x.dtype), dm, x_rows, (b, s, d)),
            dtensor(aux, dm, (Replicate(),) * nd, ()))
