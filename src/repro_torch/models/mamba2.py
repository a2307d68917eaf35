"""Mamba2 (SSD) block — chunked parallel scan for train/prefill, O(1)-state
recurrence for decode.

State-space recurrence per head (scalar A, shared B/C, ngroups=1):
    h_t = exp(dt_t * A) h_{t-1} + dt_t * B_t ⊗ x_t        (h: (P, N))
    y_t = C_t · h_t + D * x_t
Prefill uses the chunk decomposition (intra-chunk quadratic with decay
mask + inter-chunk state scan; the reference's ``lax.scan`` over chunks is
a Python loop here), every product in f32.
"""
from __future__ import annotations

from typing import Dict, Optional

import torch
import torch.nn.functional as F

from ..sharding import (dtensor, local_rows, local_whole, placed, rows_of,
                        shard)
from .common import ParamDef, matmul, rms_norm
from .config import LMConfig


def mamba_schema(cfg: LMConfig, layers: Optional[int] = None) -> Dict:
    L = cfg.n_layers if layers is None else layers
    d, di, n, hh = cfg.d_model, cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    conv_dim = di + 2 * n
    lead = (L,) if L else ()
    lax = ("layers",) if L else ()
    return {
        # order: [z (di) | x (di) | B (n) | C (n) | dt (H)]
        "in_proj": ParamDef(lead + (d, 2 * di + 2 * n + hh),
                            lax + ("embed", "ff")),
        "conv_w": ParamDef(lead + (cfg.ssm_conv, conv_dim),
                           lax + (None, "ff")),
        "conv_b": ParamDef(lead + (conv_dim,), lax + ("ff",), init="zeros"),
        "A_log": ParamDef(lead + (hh,), lax + (None,), init="zeros",
                          dtype=torch.float32),
        "D": ParamDef(lead + (hh,), lax + (None,), init="ones",
                      dtype=torch.float32),
        "dt_bias": ParamDef(lead + (hh,), lax + (None,), init="zeros",
                            dtype=torch.float32),
        "norm": ParamDef(lead + (di,), lax + ("ff",), init="ones"),
        "out_proj": ParamDef(lead + (di, d), lax + ("ff", "embed")),
    }


def _split_proj(cfg: LMConfig, zxbcdt):
    di, n, hh = cfg.d_inner, cfg.ssm_state, cfg.ssm_heads
    return zxbcdt.split([di, di, n, n, hh], dim=-1)


def _causal_conv(x, w, b, state=None):
    """Depthwise causal conv. x: (B, S, C); w: (K, C); returns (y, new_state)
    where state is the last K-1 inputs."""
    k = w.shape[0]
    if state is None:
        state = x.new_zeros((x.shape[0], k - 1, x.shape[2]))
    xx = torch.cat([state, x], dim=1)
    y = sum(xx[:, i:i + x.shape[1]] * w[i] for i in range(k))
    new_state = xx[:, -(k - 1):] if k > 1 else state
    return F.silu((y + b).float()).to(x.dtype), new_state


def _softplus(x):
    """``jax.nn.softplus``: log(1 + e^x) = logaddexp(x, 0), no threshold."""
    return torch.logaddexp(x, torch.zeros_like(x))


def ssd_chunked(x, dt, A, B, C, chunk: int):
    """x: (b,s,h,p); dt: (b,s,h) >=0; A: (h,) <0; B,C: (b,s,n).
    Returns y: (b,s,h,p), final state (b,h,n,p)."""
    b, s, h, p = x.shape
    n = B.shape[-1]
    q = min(chunk, s)
    pad = (-s) % q
    if pad:
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        B = F.pad(B, (0, 0, 0, pad))
        C = F.pad(C, (0, 0, 0, pad))
    nc = (s + pad) // q
    xq = x.reshape(b, nc, q, h, p).float()
    dtq = dt.reshape(b, nc, q, h)
    Bq = B.reshape(b, nc, q, n).float()
    Cq = C.reshape(b, nc, q, n).float()

    a = dtq * A                                   # (b,nc,q,h) log-decay <=0
    acum = torch.cumsum(a, dim=2)                 # within-chunk cumulative
    a_tot = acum[:, :, -1]                        # (b,nc,h)

    # intra-chunk: y[i] += sum_{j<=i} C_i·B_j exp(acum_i - acum_j) dt_j x_j
    scores = torch.einsum("bcqn,bckn->bcqk", Cq, Bq)
    decay = torch.exp(acum[:, :, :, None, :] - acum[:, :, None, :, :])
    tri = torch.tril(torch.ones((q, q), dtype=torch.bool, device=x.device))
    decay = torch.where(tri[None, None, :, :, None], decay, 0.0)
    w_intra = scores[..., None] * decay * dtq[:, :, None, :, :]  # (b,c,q,k,h)
    y_intra = torch.einsum("bcqkh,bckhp->bcqhp", w_intra, xq)

    # chunk summaries: S_c = sum_j exp(a_tot - acum_j) dt_j B_j ⊗ x_j
    w_state = torch.exp(a_tot[:, :, None, :] - acum) * dtq         # (b,c,q,h)
    S = torch.einsum("bcqh,bcqn,bcqhp->bchnp", w_state, Bq, xq)    # (b,c,h,n,p)

    # inter-chunk scan: H_c = exp(a_tot_c) H_{c-1} + S_c
    hstate = torch.zeros((b, h, n, p), dtype=torch.float32, device=x.device)
    hprevs = []
    for c in range(nc):
        hprevs.append(hstate)                     # state BEFORE chunk c
        hstate = torch.exp(a_tot[:, c])[:, :, None, None] * hstate + S[:, c]
    hprevs = torch.stack(hprevs, dim=1)           # (b,c,h,n,p)

    y_inter = torch.einsum("bcqn,bcqh,bchnp->bcqhp", Cq, torch.exp(acum),
                           hprevs)
    y = (y_intra + y_inter).reshape(b, nc * q, h, p)[:, :s]
    return y.to(x.dtype), hstate


#: the mixer's small weights (the projections are products)
_MIXER = ("conv_w", "conv_b", "A_log", "D", "dt_bias", "norm")


def _on_rows(fn, zxbcdt, p, *states):
    """``fn(zxbcdt, weights, *states)`` -> (y, *new states), on plain
    tensors.  Placed on a mesh, each rank runs it on its own batch rows,
    the projected streams and the mixer's weights whole (the in-projection
    splits its columns into z | x | B | C | dt, which no even block of
    them follows), and its results are placed by those rows; the states
    move to their schema's placement where they are stored."""
    weights = {k: p[k] for k in _MIXER}
    if not placed(zxbcdt):
        return fn(zxbcdt, weights, *states)
    rows = rows_of(zxbcdt)
    dm = zxbcdt.device_mesh
    out = fn(local_rows(zxbcdt, rows),
             {k: local_whole(w, rows) for k, w in weights.items()},
             *(local_rows(t, rows) if placed(t) else t for t in states))
    return tuple(dtensor(t, dm, rows, (zxbcdt.shape[0],) + t.shape[1:])
                 for t in out)


def mamba_train(cfg: LMConfig, p, u, conv_state=None, ssm_state=None):
    """u: (B, S, d) -> (out (B, S, d), (conv_state, ssm_state)).

    On a mesh the in-projection reads the whole sequence (``u`` gathered
    over "model", the weight's columns split), or with
    ``cfg.seq_parallel_proj`` each rank's sequence block (the weight
    gathered, as the reference keeps it sequence-parallel).  Either way
    the recurrence then takes one reshard of the projected streams to
    each rank's rows with the whole sequence and every channel
    (``_on_rows``)."""
    if cfg.seq_parallel_proj:
        # the in-projection kept sequence-parallel (weights gathered, not
        # activations)
        u = shard(u, "batch", "act_seq", None)
    else:
        u = shard(u, "batch", "seq", None)    # the recurrence's whole sequence
    zxbcdt = matmul(u, p["in_proj"])
    if cfg.seq_parallel_proj:
        zxbcdt = shard(zxbcdt, "batch", "act_seq", None)
    y, conv_new, ssm_new = _on_rows(
        lambda zx, w, cs, ss: _mix_train(cfg, zx, w, cs, ss), zxbcdt, p,
        conv_state, ssm_state)
    return matmul(y, p["out_proj"]), (conv_new, ssm_new)


def _mix_train(cfg: LMConfig, zxbcdt, p, conv_state, ssm_state):
    b, s, _ = zxbcdt.shape
    hh, pdim, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    z, x, Bm, Cm, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([x, Bm, Cm], dim=-1)
    xbc, conv_new = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    x, Bm, Cm = xbc.split([cfg.d_inner, n, n], dim=-1)
    x = shard(x, "batch", "seq", "ff")
    dt = _softplus(dt.float() + p["dt_bias"])
    A = -torch.exp(p["A_log"])
    xh = x.reshape(b, s, hh, pdim)
    y, ssm_new = ssd_chunked(xh, dt, A, Bm.float(), Cm.float(),
                             cfg.ssm_chunk)
    y = y + xh * p["D"][None, None, :, None].to(y.dtype)
    y = y.reshape(b, s, cfg.d_inner)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg.norm_eps)
    return y, conv_new, ssm_new


def mamba_state_schema(cfg: LMConfig, batch: int,
                       layers: Optional[int] = None) -> Dict:
    L = cfg.n_layers if layers is None else layers
    hh, pdim, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    conv_dim = cfg.d_inner + 2 * n
    lead = (L,) if L else ()
    lax = ("layers",) if L else ()
    return {
        "conv": ParamDef(lead + (batch, cfg.ssm_conv - 1, conv_dim),
                         lax + ("batch", None, "ff"), init="zeros"),
        "ssm": ParamDef(lead + (batch, hh, n, pdim),
                        lax + ("batch", None, None, None), init="zeros",
                        dtype=torch.float32),
    }


def mamba_decode(cfg: LMConfig, p, u, state):
    """One-token recurrent step. u: (B, 1, d); state: {"conv","ssm"}.
    Returns (out, new state)."""
    y, conv_new, h = _on_rows(
        lambda zx, w, cs, ss: _mix_decode(cfg, zx, w, cs, ss),
        matmul(u, p["in_proj"]), p, state["conv"], state["ssm"])
    return matmul(y, p["out_proj"]), {"conv": conv_new, "ssm": h}


def _mix_decode(cfg: LMConfig, zxbcdt, p, conv_state, ssm_state):
    b = zxbcdt.shape[0]
    hh, pdim, n = cfg.ssm_heads, cfg.ssm_headdim, cfg.ssm_state
    z, x, Bm, Cm, dt = _split_proj(cfg, zxbcdt)
    xbc = torch.cat([x, Bm, Cm], dim=-1)
    xbc, conv_new = _causal_conv(xbc, p["conv_w"], p["conv_b"], conv_state)
    x, Bm, Cm = xbc.split([cfg.d_inner, n, n], dim=-1)
    dt = _softplus(dt.float() + p["dt_bias"])[:, 0]                   # (B,H)
    A = -torch.exp(p["A_log"])
    xh = x.reshape(b, hh, pdim).float()
    decay = torch.exp(dt * A)                                         # (B,H)
    h = ssm_state * decay[:, :, None, None] + torch.einsum(
        "bh,bn,bhp->bhnp", dt, Bm[:, 0].float(), xh)
    y = torch.einsum("bn,bhnp->bhp", Cm[:, 0].float(), h)
    y = y + xh * p["D"][None, :, None]
    y = y.reshape(b, 1, cfg.d_inner).to(zxbcdt.dtype)
    y = rms_norm(y * F.silu(z.float()).to(y.dtype), p["norm"], cfg.norm_eps)
    return y, conv_new, h
