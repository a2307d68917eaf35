"""The port's optimizers, clipping and int8 gradient compression against
the reference's, on the CPU.

The same parameters (the reference's SMOKE granite-3-8b init, bf16), the
same gradients (numpy-seeded, bf16) and the same optimizer state go
through both packages' update: the f32 state must agree within STATE_RTOL
of each leaf's largest magnitude, the bf16 parameters within one bf16 ulp
of the larger of each value and the parameter before the updates (an
update that nearly cancels a parameter leaves a value whose own ulp is
below the f32 rounding of ``p - lr * u``: seen once in 16 K values, at
1.45e-7), and ``grad_norm`` within NORM_RTOL.  The port updates in
place, so it is handed copies.  ``quantize_int8`` must give exactly the
reference's ``q`` and ``scale``.

The global norm is an f32 sum over 300 K squares whose order differs
between the packages (the reference's is 1.4e-6 off the float64 value,
the port's 4.5e-8), so ``grad_norm`` is held to NORM_RTOL, and AdamW's
state, where the norm clips the gradients (scaled by 0.05), to
CLIPPED_RTOL; gradients scaled by 0.002 stay under the clip (scale
exactly 1) and the state is held to STATE_RTOL.
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

import repro.train.optimizer as RO
import repro_torch.train.optimizer as TO
from repro.configs import get_smoke
from repro.models import api as R
from repro.train import compress as RC
from repro_torch import configs as TCFG
from repro_torch.convert import (lm_params_from_arrays, opt_state_from_arrays,
                                 tensor_from_array)
from repro_torch.models.common import tree_items, tree_map
from repro_torch.train import compress as TC

STATE_RTOL = 1e-6
NORM_RTOL = 1e-5
CLIPPED_RTOL = 1e-5


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ulp_bf16(x):
    """One bf16 ulp at each value of ``x`` (f32 array)."""
    e = np.floor(np.log2(np.maximum(np.abs(x), 2.0 ** -126)))
    return 2.0 ** (e - 7)


def _assert_close(path, got, want, rtol=STATE_RTOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, path
    scale = max(float(np.abs(want).max()), 1e-30)
    assert float(np.abs(got - want).max()) <= rtol * scale, path


def _assert_params(tp, rp, before):
    for path, t in tree_items(tp):
        want = np.asarray(rp[path], np.float32)
        got = t.float().numpy()
        if t.dtype == torch.bfloat16:
            mag = np.maximum(np.abs(want),
                             np.abs(np.asarray(before[path], np.float32)))
            assert (np.abs(got - want) <= _ulp_bf16(mag)).all(), path
        else:
            _assert_close(path, got, want)


def _setup(opt, seed=0, gscale=0.002):
    cfg = get_smoke("granite-3-8b").replace(optimizer=opt)
    tcfg = TCFG.get_smoke("granite-3-8b").replace(optimizer=opt)
    params = R.init(cfg, jax.random.PRNGKey(0))
    rng = np.random.default_rng(seed)
    grads = jax.tree.map(
        lambda p: jnp.asarray(rng.standard_normal(p.shape).astype(np.float32)
                              * gscale, p.dtype), params)
    return cfg, tcfg, params, grads


def _run_both(opt, steps=2, gscale=0.002):
    cfg, tcfg, params, grads = _setup(opt, gscale=gscale)
    r_init, r_upd = RO.make_optimizer(opt)
    t_init, t_upd = TO.make_optimizer(opt)
    rstate = r_init(params)
    tp = lm_params_from_arrays(tcfg, _np(params), "cpu")
    tg = lm_params_from_arrays(tcfg, _np(grads), "cpu")
    tstate = t_init(tp)
    before = dict(tree_items(_np(params)))
    norms = []
    for i in range(steps):
        params, rstate, rn = r_upd(grads, rstate, params, 1e-2)
        tp, tstate, tn = t_upd(tg, tstate, tp, 1e-2)
        norms.append((float(rn), float(tn)))
    return (dict(tree_items(_np(params))), _np(rstate), tp, tstate, norms,
            before)


@pytest.mark.parametrize("opt,gscale,rtol", [
    ("adamw", 0.002, STATE_RTOL), ("adamw", 0.05, CLIPPED_RTOL),
    ("adafactor", 0.002, STATE_RTOL), ("adafactor", 0.05, STATE_RTOL)])
def test_update_matches_the_reference(opt, gscale, rtol):
    rp, rstate, tp, tstate, norms, before = _run_both(opt, gscale=gscale)
    _assert_params(tp, rp, before)
    want = dict(tree_items(rstate))
    got = dict(tree_items(tstate))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        if path == "step":
            assert g.dtype == torch.int32 and g.dim() == 0 and int(g) == 2
            continue
        assert g.dtype == {"float32": torch.float32,
                           "bfloat16": torch.bfloat16}[w.dtype.name], path
        if g.dtype == torch.bfloat16:
            wf = np.asarray(w, np.float32)
            assert (np.abs(g.float().numpy() - wf) <= _ulp_bf16(wf)).all()
        else:
            _assert_close(path, g.numpy(), w, rtol)
    clipped = gscale == 0.05
    assert (norms[0][0] > 1.0) == clipped
    for rn, tn in norms:
        assert abs(rn - tn) <= NORM_RTOL * rn, norms


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_chunked_update_matches_the_reference(opt, monkeypatch):
    """Every stacked leaf forced over the chunking threshold (Adafactor's
    per-slice RMS clip then applies in both packages; AdamW always
    updates slice by slice)."""
    monkeypatch.setattr(RO, "_CHUNK_THRESHOLD", 16)
    monkeypatch.setattr(TO, "_CHUNK_THRESHOLD", 16)
    rp, rstate, tp, tstate, norms, before = _run_both(opt, steps=1)
    _assert_params(tp, rp, before)
    for path, w in tree_items(rstate):
        g = dict(tree_items(tstate))[path]
        if w.dtype.name == "float32":
            _assert_close(path, g.numpy(), w)


def test_state_converts_from_the_reference_and_continues():
    """``opt_state_from_arrays`` carries the reference's AdamW state (with
    the int8 residuals) into the port; one more update on each side
    agrees."""
    cfg, tcfg, params, grads = _setup("adamw")
    state = RO.adamw_init(params)
    params, state, _ = RO.adamw_update(grads, state, params, 1e-2)
    full = {"opt": state, "ef_residual": RC.init_residuals(params)}
    tstate = opt_state_from_arrays(tcfg, _np(full), "cpu")
    assert int(tstate["opt"]["step"]) == 1
    tp = lm_params_from_arrays(tcfg, _np(params), "cpu")
    tg = lm_params_from_arrays(tcfg, _np(grads), "cpu")
    before = dict(tree_items(_np(params)))
    params, state, _ = RO.adamw_update(grads, state, params, 1e-2)
    tp, ts, _ = TO.adamw_update(tg, tstate["opt"], tp, 1e-2)
    _assert_params(tp, dict(tree_items(_np(params))), before)
    bad = dict(_np(full))
    bad["opt"] = dict(bad["opt"], m={})
    with pytest.raises(ValueError, match="missing leaves"):
        opt_state_from_arrays(tcfg, bad, "cpu")
    fcfg = tcfg.replace(optimizer="adafactor")
    fstate = RO.adafactor_init(params)
    got = opt_state_from_arrays(fcfg, _np({"opt": fstate}), "cpu")
    assert got["opt"]["f"]["blocks"]["mlp"]["w_in"]["vr"].dtype \
        == torch.bfloat16
    with pytest.raises(ValueError):
        opt_state_from_arrays(tcfg, _np({"opt": fstate}), "cpu")


def test_clip_by_global_norm_matches_the_reference():
    rng = np.random.default_rng(1)
    tree = {"a": rng.standard_normal((4, 3, 5)).astype(np.float32) * 30,
            "b": {"c": rng.standard_normal((7,)).astype(np.float32) * 50}}
    rc, rn = RO.clip_by_global_norm(jax.tree.map(jnp.asarray, tree), 1.0)
    tc, tn = TO.clip_by_global_norm(tree_map(torch.from_numpy, tree), 1.0)
    assert abs(float(rn) - float(tn)) <= NORM_RTOL * float(rn)
    assert float(rn) > 1.0
    for path, w in tree_items(_np(rc)):
        _assert_close(path, dict(tree_items(tc))[path].numpy(), w)
    norm = float(torch.sqrt(sum(torch.sum(x ** 2) for _, x in
                                tree_items(tc))))
    assert abs(norm - 1.0) < 1e-5
    # under the bound nothing changes
    small = tree_map(lambda x: torch.from_numpy(x) * 1e-4, tree)
    same, _ = TO.clip_by_global_norm(small, 1.0)
    for (_, a), (_, b) in zip(tree_items(same), tree_items(small)):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quantize_int8_is_the_references_exactly(dtype):
    rng = np.random.default_rng(2)
    x = rng.standard_normal((64, 33)).astype(np.float32)
    x[0, :4] = [0.5, -0.5, 1.5, 2.5]          # halves round to even
    jx = jnp.asarray(x, getattr(jnp, dtype))
    rq, rs = RC.quantize_int8(jx)
    tq, ts = TC.quantize_int8(tensor_from_array(np.asarray(jx)))
    assert tq.dtype == torch.int8
    np.testing.assert_array_equal(tq.numpy(), np.asarray(rq))
    assert float(ts) == float(rs)
    np.testing.assert_array_equal(
        TC.dequantize_int8(tq, ts).numpy(),
        np.asarray(RC.dequantize_int8(rq, rs)))
    np.testing.assert_array_equal(
        TC.quantization_error(tensor_from_array(np.asarray(jx)), tq,
                              ts).numpy(),
        np.asarray(RC.quantization_error(jx, rq, rs)))
    zq, zs = TC.quantize_int8(torch.zeros(5))
    assert float(zs) == np.float32(1e-12) / np.float32(127.0)
    assert not zq.any()


def test_error_feedback_matches_the_reference():
    rng = np.random.default_rng(3)
    g = {"w": rng.standard_normal((128,)).astype(np.float32) * 1e-3,
         "m": {"x": rng.standard_normal((6, 9)).astype(np.float32)}}
    rr = RC.init_residuals(jax.tree.map(jnp.asarray, g))
    tr = TC.init_residuals(tree_map(torch.from_numpy, g))
    for _ in range(5):
        rd, rr = RC.compress_tree_with_feedback(
            jax.tree.map(jnp.asarray, g), rr)
        td, tr = TC.compress_tree_with_feedback(
            tree_map(torch.from_numpy, g), tr)
        for (path, w), (_, t) in zip(tree_items(_np(rd)), tree_items(td)):
            np.testing.assert_array_equal(t.numpy(), w, err_msg=path)
        for (path, w), (_, t) in zip(tree_items(_np(rr)), tree_items(tr)):
            np.testing.assert_array_equal(t.numpy(), w, err_msg=path)


@pytest.mark.parametrize("n", [2, 4])
def test_compressed_allreduce_mean(n):
    """The single-controller all-reduce against the reference's formula in
    numpy (the int8 payloads times their scales, averaged), and within
    half a quantization step of each replica's scale of the true mean."""
    rng = np.random.default_rng(n)
    xs = [rng.standard_normal((17, 8)).astype(np.float32) * (i + 1)
          for i in range(n)]
    got = TC.compressed_allreduce_mean([torch.from_numpy(x) for x in xs])
    qs, ss = [], []
    for x in xs:
        scale = np.float32(max(np.abs(x).max(), 1e-12)) / np.float32(127.0)
        qs.append(np.clip(np.round(x / scale), -127, 127).astype(np.int8))
        ss.append(scale)
    want = (np.stack(qs).astype(np.float32)
            * np.asarray(ss, np.float32).reshape(-1, 1, 1)).mean(axis=0)
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=1e-6)
    bound = sum(s / 2 for s in ss) / n + 1e-6
    assert np.abs(got.numpy() - np.mean(xs, axis=0)).max() <= bound
