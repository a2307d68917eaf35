"""The port's LM layer functions against the reference's, on the CPU.

The same f32 inputs, made from a numpy seed, go through each JAX function
(``repro.models``) and its torch counterpart (``repro_torch.models``):
``rms_norm``, ``layer_norm``, ``apply_rope``, ``blockwise_attention``
(causal, sliding window, GQA, ``kv_len_mask``, Dv != D, padded blocks),
``decode_attention``, the SSD chunked scan, the RWKV6 WKV scan and the MoE
expert rows.  Tolerance: the largest absolute difference is at most 1e-5
of the reference output's largest magnitude (at least 1): f32 throughout,
only the order of summation differs.
"""
import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp
import numpy as np

from repro.models import common as RC
from repro.models import mamba2 as RM
from repro.models import moe as RMoE
from repro.models import rwkv6 as RW
from repro_torch.models import common as TC
from repro_torch.models import mamba2 as TM
from repro_torch.models import moe as TMoE
from repro_torch.models import rwkv6 as TW

RTOL = 1e-5


def _close(got, want):
    got = got.detach().float().numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    err = float(np.abs(got - want).max())
    assert err <= RTOL * scale, f"max abs diff {err} (scale {scale})"


def _randn(rng, *shape):
    return rng.standard_normal(shape).astype(np.float32)


def _both(a):
    return jnp.asarray(a), torch.from_numpy(np.array(a))


def test_norms_and_swiglu():
    rng = np.random.default_rng(0)
    x, s, b = _randn(rng, 3, 5, 48), _randn(rng, 48), _randn(rng, 48)
    (jx, tx), (js, ts), (jb, tb) = _both(x), _both(s), _both(b)
    _close(TC.rms_norm(tx, ts, 1e-5), RC.rms_norm(jx, js, 1e-5))
    _close(TC.layer_norm(tx, ts, tb, 1e-6), RC.layer_norm(jx, js, jb, 1e-6))
    _close(TC.swiglu(tx, tx * 0.5), RC.swiglu(jx, jx * 0.5))


@pytest.mark.parametrize("shape,pos_shape", [((2, 7, 3, 16), (2, 7)),
                                             ((2, 7, 8), (1, 7))])
def test_apply_rope(shape, pos_shape):
    rng = np.random.default_rng(1)
    x = _randn(rng, *shape)
    pos = rng.integers(0, 4000, pos_shape).astype(np.int32)
    (jx, tx), (jp, tp) = _both(x), _both(pos)
    for theta in (1e4, 5e5):
        _close(TC.apply_rope(tx, tp, theta), RC.apply_rope(jx, jp, theta))


ATTN_CASES = {
    # name: (B, Sq, Sk, Hq, Hkv, D, Dv, kwargs)
    "causal": (2, 20, 20, 4, 4, 16, 16, dict(causal=True)),
    "gqa_blocks": (2, 20, 20, 8, 2, 16, 16,
                   dict(causal=True, block_q=8, block_kv=8)),
    "window": (1, 24, 24, 4, 2, 8, 8,
               dict(causal=True, window=5, block_q=8, block_kv=8)),
    "kv_len_mask": (2, 6, 18, 4, 1, 16, 16,
                    dict(causal=False, kv_len_mask=11, block_kv=8)),
    "dv": (2, 12, 12, 4, 4, 24, 16, dict(causal=True, block_q=8)),
    "offset": (1, 5, 17, 4, 2, 16, 16,
               dict(causal=True, q_offset=12, block_kv=4)),
}


@pytest.mark.parametrize("case", sorted(ATTN_CASES))
def test_blockwise_attention(case):
    b, sq, sk, hq, hkv, d, dv, kw = ATTN_CASES[case]
    rng = np.random.default_rng(2)
    q, k, v = (_randn(rng, b, sq, hq, d), _randn(rng, b, sk, hkv, d),
               _randn(rng, b, sk, hkv, dv))
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    _close(TC.blockwise_attention(tq, tk, tv, **kw),
           RC.blockwise_attention(jq, jk, jv, **kw))


def test_decode_attention():
    rng = np.random.default_rng(3)
    q, k, v = (_randn(rng, 2, 1, 8, 16), _randn(rng, 2, 19, 2, 16),
               _randn(rng, 2, 19, 2, 16))
    (jq, tq), (jk, tk), (jv, tv) = _both(q), _both(k), _both(v)
    _close(TC.decode_attention(tq, tk, tv), RC.decode_attention(jq, jk, jv))


@pytest.mark.parametrize("s,chunk", [(20, 8), (16, 16), (5, 32)])
def test_ssd_chunked(s, chunk):
    rng = np.random.default_rng(4)
    b, h, p, n = 2, 3, 4, 5
    x = _randn(rng, b, s, h, p)
    dt = np.abs(_randn(rng, b, s, h)) * 0.5
    A = -np.abs(_randn(rng, h)) - 0.1
    B, C = _randn(rng, b, s, n), _randn(rng, b, s, n)
    args = [_both(a) for a in (x, dt, A, B, C)]
    jy, jh = RM.ssd_chunked(*(a for a, _ in args), chunk)
    ty, th = TM.ssd_chunked(*(t for _, t in args), chunk)
    _close(ty, jy)
    _close(th, jh)


def test_wkv_scan():
    rng = np.random.default_rng(5)
    b, s, h, p = 2, 9, 3, 4
    r, k, v = (_randn(rng, b, s, h, p) for _ in range(3))
    w = np.exp(-np.exp(_randn(rng, b, s, h, p))).astype(np.float32)
    u, s0 = _randn(rng, h, p), _randn(rng, b, h, p, p)
    args = [_both(a) for a in (r, k, v, w, u, s0)]
    jy, js = RW._wkv_scan(*(a for a, _ in args))
    ty, ts = TW._wkv_scan(*(t for _, t in args))
    _close(ty, jy)
    _close(ts, js)


@pytest.mark.parametrize("n_local,first,cap", [(6, 0, 40), (3, 2, 9)])
def test_expert_rows(n_local, first, cap):
    """The stable sort by expert, the capacity cut, the grouped products
    (``ragged_dot`` against one product per expert) and the weighted
    scatter-add back to the tokens; experts past the shard give nothing."""
    rng = np.random.default_rng(6)
    n, d, hdim, k, e = 20, 8, 6, 2, 6
    xf = _randn(rng, n, d)
    top_i = np.stack([rng.choice(e, k, replace=False) for _ in range(n)]) \
        .astype(np.int32)
    top_p = np.abs(_randn(rng, n, k))
    w_in = _randn(rng, n_local, d, 2 * hdim)
    w_out = _randn(rng, n_local, hdim, d)
    ja, ta = zip(*(_both(a) for a in (xf, top_i, top_p, w_in, w_out)))
    ta = list(ta)
    ta[1] = ta[1].long()                 # torch.topk's index dtype
    kw = dict(n_local=n_local, first_expert=first, cap=cap, k=k)
    _close(TMoE._expert_rows(*ta, **kw), RMoE._expert_rows(*ja, **kw))
