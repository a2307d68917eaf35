"""RWKV6 "Finch" block — attention-free time-mix with data-dependent decay.

Time-mix recurrence per head (state S: (P, P)):
    S_t = diag(w_t) S_{t-1} + k_t ⊗ v_t
    y_t = r_t · (S_{t-1} + diag(u) k_t ⊗ v_t)
with per-channel decay w_t = exp(-exp(w0 + lora(x̄_t))) (data-dependent, the
Finch contribution).  Token-shift interpolation is static-μ, as in the
reference.  The reference scans chunks of ``rwkv_chunk`` steps (its
padding steps, w = 1 and k = v = 0, leave the state as it is) to bound
training memory; the same recurrence here is one loop over time.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..sharding import dtensor, local_part, placed, shard
from .common import ParamDef, layer_norm, matmul, merge_heads, split_heads
from .config import LMConfig


def rwkv_schema(cfg: LMConfig, layers: Optional[int] = None) -> Dict:
    L = cfg.n_layers if layers is None else layers
    d, ff, r = cfg.d_model, cfg.d_ff, cfg.rwkv_lora
    lead = (L,) if L else ()
    lax = ("layers",) if L else ()
    return {
        "ln1_s": ParamDef(lead + (d,), lax + (None,), init="ones"),
        "ln1_b": ParamDef(lead + (d,), lax + (None,), init="zeros"),
        "ln2_s": ParamDef(lead + (d,), lax + (None,), init="ones"),
        "ln2_b": ParamDef(lead + (d,), lax + (None,), init="zeros"),
        # token-shift lerp coefficients for r,k,v,g,w
        "mu": ParamDef(lead + (5, d), lax + (None, None)),
        "wr": ParamDef(lead + (d, d), lax + ("embed", "q_dim")),
        "wk": ParamDef(lead + (d, d), lax + ("embed", "q_dim")),
        "wv": ParamDef(lead + (d, d), lax + ("embed", "q_dim")),
        "wg": ParamDef(lead + (d, d), lax + ("embed", "q_dim")),
        "wo": ParamDef(lead + (d, d), lax + ("q_dim", "embed")),
        "decay_w0": ParamDef(lead + (d,), lax + (None,), init="zeros",
                             dtype=torch.float32),
        "decay_w1": ParamDef(lead + (d, r), lax + ("embed", None)),
        "decay_w2": ParamDef(lead + (r, d), lax + (None, "q_dim")),
        "bonus_u": ParamDef(lead + (d,), lax + (None,), init="zeros",
                            dtype=torch.float32),
        "lnx_s": ParamDef(lead + (d,), lax + (None,), init="ones"),
        "lnx_b": ParamDef(lead + (d,), lax + (None,), init="zeros"),
        # channel mix
        "cmix_mu": ParamDef(lead + (2, d), lax + (None, None)),
        "ck": ParamDef(lead + (d, ff), lax + ("embed", "ff")),
        "cv": ParamDef(lead + (ff, d), lax + ("ff", "embed")),
        "cr": ParamDef(lead + (d, d), lax + ("embed", "q_dim")),
    }


def _streams(cfg, p, x, x_prev):
    """Token-shifted lerp streams. x: (B,S,d); x_prev: (B,1,d) carry."""
    xx = torch.cat([x_prev, x[:, :-1]], dim=1)
    z = x[:, :, None, :] + p["mu"][None, None] * (xx - x)[:, :, None, :]
    zr, zk, zv, zg, zw = z.unbind(2)
    r = matmul(zr, p["wr"])
    k = matmul(zk, p["wk"])
    v = matmul(zv, p["wv"])
    g = matmul(zg, p["wg"])
    w = torch.exp(-torch.exp(
        p["decay_w0"]
        + matmul(torch.tanh(matmul(zw, p["decay_w1"])),
                 p["decay_w2"]).float()))
    return r, k, v, g, w


def _wkv_scan(r, k, v, w, u, s0):
    """r,k,v: (B,S,H,P) f32; w: (B,S,H,P) decay; u: (H,P); s0: (B,H,P,P).
    Returns y (B,S,H,P), s_final."""
    s, ys = s0, []
    for t in range(r.shape[1]):
        rt, kt, vt, wt = r[:, t], k[:, t], v[:, t], w[:, t]     # (B,H,P)
        kv = kt[..., :, None] * vt[..., None, :]                # (B,H,P,P)
        ys.append(torch.einsum("bhi,bhij->bhj", rt,
                               s + u[None, :, :, None] * kv))
        s = wt[..., :, None] * s + kv
    return torch.stack(ys, dim=1), s


def _wkv_on_heads(r, k, v, w, u, s0):
    """:func:`_wkv_scan` of (B, S, H, P) streams.  Placed on a mesh (the
    streams sharded over batch and heads, as the projections leave them),
    each rank scans its own rows and heads: the state ``s0`` (B, H, P, P)
    and the bonus ``u`` (H, P) are brought to the same blocks, and the
    results are placed by them."""
    if not placed(r):
        return _wkv_scan(r, k, v, w, u, s0)
    from torch.distributed.tensor import Partial, Replicate, Shard
    # partial sums (a row-parallel projection's, where the rows do not
    # split over a dim) are reduced first: the scan is not linear
    r, k, v, w = (t.redistribute(t.device_mesh, tuple(
        Replicate() if p.is_partial() else p for p in t.placements))
        for t in (r, k, v, w))
    dm, rp = r.device_mesh, tuple(r.placements)
    # the state's and the bonus's blocks: rows and heads as the streams'
    sp = tuple(Shard(1) if p.is_shard(2) else p for p in rp)
    up = tuple(Shard(0) if p.is_shard(2) else Replicate() for p in rp)
    ug = tuple(Shard(0) if p.is_shard(2) else Partial() if p.is_shard()
               else Replicate() for p in rp)
    s0l = (s0.redistribute(dm, sp).to_local(grad_placements=sp)
           if placed(s0) else local_part(s0, dm, sp))
    y, s_fin = _wkv_scan(*(t.to_local(grad_placements=rp)
                           for t in (r, k, v, w)),
                         u.redistribute(dm, up).to_local(
                             grad_placements=ug), s0l)
    b, _, h, pd = r.shape
    return dtensor(y, dm, rp, r.shape), dtensor(s_fin, dm, sp,
                                                (b, h, pd, pd))


def rwkv_time_mix(cfg: LMConfig, p, x, state_s, x_prev):
    """x: (B,S,d). Returns (out, new_state_s, new_x_prev)."""
    d = x.shape[-1]
    h = cfg.n_heads
    pd = d // h
    r, k, v, g, w = _streams(cfg, p, x, x_prev)
    rh, kh, vh = (split_heads(t, h, pd).float() for t in (r, k, v))
    wh = split_heads(w, h, pd)
    u = p["bonus_u"].reshape(h, pd)
    y, s_fin = _wkv_on_heads(rh, kh, vh, wh, u, state_s)
    y = shard(merge_heads(y), "batch", "seq", None)
    y = layer_norm(y, p["lnx_s"], p["lnx_b"], cfg.norm_eps).to(x.dtype)
    y = y * F.silu(g.float()).to(x.dtype)
    return shard(matmul(y, p["wo"]), "batch", "seq", None), s_fin, \
        x[:, -1:, :]


def rwkv_channel_mix(cfg: LMConfig, p, x, x_prev):
    xx = torch.cat([x_prev, x[:, :-1]], dim=1)
    mu = p["cmix_mu"]
    zk = x + mu[None, None, 0] * (xx - x)
    zr = x + mu[None, None, 1] * (xx - x)
    kk = torch.square(F.relu(matmul(zk, p["ck"]).float())).to(x.dtype)
    rr = torch.sigmoid(matmul(zr, p["cr"]).float()).to(x.dtype)
    kv = shard(matmul(kk, p["cv"]), "batch", "seq", None)
    return shard(rr * kv, "batch", "seq", None), x[:, -1:, :]


def rwkv_state_schema(cfg: LMConfig, batch: int,
                      layers: Optional[int] = None) -> Dict:
    L = cfg.n_layers if layers is None else layers
    d, h = cfg.d_model, cfg.n_heads
    pd = d // h
    lead = (L,) if L else ()
    lax = ("layers",) if L else ()
    return {
        "s": ParamDef(lead + (batch, h, pd, pd),
                      lax + ("batch", "heads", None, None), init="zeros",
                      dtype=torch.float32),
        "tm_prev": ParamDef(lead + (batch, 1, d), lax + ("batch", None, None),
                            init="zeros"),
        "cm_prev": ParamDef(lead + (batch, 1, d), lax + ("batch", None, None),
                            init="zeros"),
    }


def rwkv_block(cfg: LMConfig, p, x, state):
    """Full block (time-mix + channel-mix). Works for S>=1; state threads
    the recurrence across calls.  On a mesh ``x`` is taken with its
    sequence whole (the token shift reads the previous position)."""
    x = shard(x, "batch", "seq", None)
    h1 = layer_norm(x, p["ln1_s"], p["ln1_b"], cfg.norm_eps)
    att, s_new, tm_prev = rwkv_time_mix(cfg, p, h1, state["s"],
                                        state["tm_prev"])
    x = x + att
    h2 = layer_norm(x, p["ln2_s"], p["ln2_b"], cfg.norm_eps)
    ffn, cm_prev = rwkv_channel_mix(cfg, p, h2, state["cm_prev"])
    x = x + ffn
    return x, {"s": s_new, "tm_prev": tm_prev, "cm_prev": cm_prev}
