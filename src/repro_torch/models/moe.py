"""Mixture-of-Experts layer: top-k routing + grouped expert products.

The reference's local path, on one device: tokens sort by expert (a stable
sort, as ``jnp.argsort``), and each expert's rows run through its two
matrices.  ``jax.lax.ragged_dot`` becomes one ``torch.matmul`` per expert
over its slice of the sorted rows, plain products, so the expert group
sizes are read on the host: one host sync per MoE layer (none under
``cfg.moe_dense_analysis``, the same-work dense surrogate).  The
reference's expert-parallel ``shard_map`` path over a "model" mesh axis is
not ported: under a mesh with a "model" axis wider than 1,
:func:`moe_apply` raises.
"""
from __future__ import annotations

import math
from typing import Dict, Optional

import torch

from ..sharding import current_mesh
from .common import ParamDef, swiglu
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
    token_idx = torch.div(sel, k, rounding_mode="floor")
    rows = torch.where(sel_valid[:, None], xf[token_idx], 0)
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
    y = out_rows.new_zeros((n, d))
    y.index_add_(0, token_idx, out_rows * w[:, None])
    return y


def moe_apply(cfg: LMConfig, p, x):
    """x: (B, S, d) -> (out, aux_loss)."""
    b, s, d = x.shape
    n = b * s
    xf = x.reshape(n, d)
    e, k = cfg.n_experts, cfg.top_k
    logits = xf.float() @ p["router"]                        # (N, E)
    probs = torch.softmax(logits, dim=-1)
    top_p, top_i = torch.topk(probs, k, dim=-1)
    top_p = top_p / torch.clamp(top_p.sum(-1, keepdim=True), min=1e-9)

    # Switch-style load-balancing aux loss
    density = torch.zeros(e, dtype=torch.float32, device=x.device).index_add_(
        0, top_i.reshape(-1), torch.ones(n * k, device=x.device)) / (n * k)
    aux = cfg.aux_loss_coef * e * torch.sum(density * probs.mean(0))

    mesh = current_mesh()
    ep_axes = ("model", "data") if (cfg.ep_over_data and mesh is not None
                                    and "data" in mesh.axis_names) \
        else ("model",)
    if mesh is not None and "model" in mesh.axis_names \
            and mesh.shape["model"] > 1 \
            and e % math.prod(mesh.shape[a] for a in ep_axes) == 0:
        raise NotImplementedError(
            "the expert-parallel MoE path (experts sharded over a 'model' "
            "mesh axis) is not ported; run without a mesh")
    y = _expert_rows(xf, top_i, top_p.to(xf.dtype), p["w_in"], p["w_out"],
                     n_local=e, first_expert=0, cap=n * k, k=k,
                     dense_surrogate=cfg.moe_dense_analysis)

    out = y.reshape(b, s, d).to(x.dtype)
    if cfg.n_shared_experts:
        gate, up = (x @ p["shared_in"]).chunk(2, dim=-1)
        out = out + swiglu(gate, up) @ p["shared_out"]
    return out, aux
