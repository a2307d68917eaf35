"""The port's training loss and its gradients against the reference's, on
the CPU.

For every ``ARCHS`` entry at its SMOKE config, the reference's parameters
(``api.init(cfg, jax.random.PRNGKey(0))``) are copied into the port with
``lm_params_from_arrays`` and one numpy-seeded batch (tokens of length
S+1, and the stub ``frames`` / ``vision``) goes through both packages'
``loss_fn``, the reference's under ``jax.value_and_grad``, the port's
under ``torch.autograd.grad`` (each layer rematerialized, as in the
reference).  Parameters and activations are bf16, so the loss and its
metrics agree to LOSS_TOL (largest difference seen: 4.4e-4, deepseek's
``ce``), and each parameter's gradient to GRAD_TOL of that leaf's largest
|g| (largest seen: 0.028, llama-3.2-vision's cross-attention gate).
"""
import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import ARCHS, get_smoke
from repro.models import api as R
from repro_torch import configs as TCFG
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import api as T
from repro_torch.models import lm as TL
from repro_torch.models.common import cross_entropy, tree_from_items, tree_items

LOSS_TOL = 1e-3
GRAD_TOL = 0.05
B, S = 2, 8


def _batch(cfg, seed=0):
    rng = np.random.default_rng(seed)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision"] = rng.standard_normal(
            (B, cfg.img_seq, cfg.d_model)).astype(np.float32)
    return batch


def _ref_value_and_grad(cfg, params, batch):
    jb = {k: jnp.asarray(v) for k, v in batch.items()}
    (loss, metrics), grads = jax.value_and_grad(
        lambda p: R.loss_fn(cfg, p, jb), has_aux=True)(params)
    return (float(loss), {k: float(v) for k, v in metrics.items()},
            dict(tree_items(jax.tree.map(lambda g: np.asarray(g, np.float32),
                                         grads))))


def _port_value_and_grad(cfg, params, batch):
    paths, leaves = zip(*[(p, t.detach().requires_grad_())
                          for p, t in tree_items(params)])
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    loss, metrics = T.loss_fn(cfg, tree_from_items(zip(paths, leaves)), tb)
    grads = torch.autograd.grad(loss, leaves, allow_unused=True,
                                materialize_grads=True)
    return (float(loss.detach()),
            {k: float(v.detach()) for k, v in metrics.items()},
            {p: g.float().numpy() for p, g in zip(paths, grads)})


@pytest.fixture(scope="module", params=ARCHS)
def both(request):
    arch = request.param
    cfg = get_smoke(arch)
    params = R.init(cfg, jax.random.PRNGKey(0))
    batch = _batch(cfg)
    ref = _ref_value_and_grad(cfg, params, batch)
    tcfg = TCFG.get_smoke(arch)
    tp = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, params), "cpu")
    port = _port_value_and_grad(tcfg, tp, batch)
    return arch, ref, port


def test_loss_and_metrics_match_the_reference(both):
    arch, (rl, rm, _), (tl, tm, _) = both
    assert set(tm) == set(rm), (arch, tm, rm)
    assert abs(rl - tl) < LOSS_TOL, (arch, rl, tl)
    for k in rm:
        assert abs(rm[k] - tm[k]) < LOSS_TOL, (arch, k, rm[k], tm[k])
    if get_smoke(arch).mtp:
        assert "mtp_ce" in tm


def test_gradients_match_the_reference_per_leaf(both):
    arch, (_, _, rg), (_, _, tg) = both
    assert set(rg) == set(tg)
    for path, r in rg.items():
        g = tg[path]
        assert g.shape == r.shape, (arch, path)
        assert np.isfinite(g).all(), (arch, path)
        scale = max(float(np.abs(r).max()), 1e-30)
        err = float(np.abs(g - r).max()) / scale
        assert err < GRAD_TOL, (arch, path, err)


def test_padded_vocab_columns_take_no_gradient():
    """A vocab that is not a multiple of 128: the padding columns enter the
    loss at -1e30, so the unembedding's (and embedding's) gradient there
    is zero, and its other columns match the reference's."""
    cfg = get_smoke("granite-3-8b").replace(vocab=250)
    tcfg = TCFG.get_smoke("granite-3-8b").replace(vocab=250)
    assert TL.vocab_padded(tcfg) == 256
    params = R.init(cfg, jax.random.PRNGKey(0))
    batch = _batch(cfg, seed=3)
    _, _, rg = _ref_value_and_grad(cfg, params, batch)
    tp = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, params), "cpu")
    _, _, tg = _port_value_and_grad(tcfg, tp, batch)
    assert np.all(tg["unembed"][:, 250:] == 0)
    assert np.all(tg["embed"][250:] == 0)
    assert np.abs(tg["unembed"]).max() > 0
    err = np.abs(tg["unembed"] - rg["unembed"]).max() \
        / np.abs(rg["unembed"]).max()
    assert err < GRAD_TOL, err


def test_cross_entropy_matches_the_reference_with_and_without_mask():
    from repro.models.common import cross_entropy as ref_ce
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 7, 40)).astype(np.float32) * 4
    logits[..., 37:] = -1e30
    labels = rng.integers(0, 37, (3, 7)).astype(np.int32)
    mask = rng.random((3, 7)) < 0.6
    for m in (None, mask, np.zeros_like(mask)):
        want = float(ref_ce(jnp.asarray(logits), jnp.asarray(labels),
                            None if m is None else jnp.asarray(m)))
        got = float(cross_entropy(torch.from_numpy(logits),
                                  torch.from_numpy(labels),
                                  None if m is None else torch.from_numpy(m)))
        assert abs(got - want) <= 1e-6 * max(1.0, abs(want)), (got, want)


def test_remat_changes_no_value_or_gradient():
    """Rematerialized layers (the configs' default) give the same loss and
    the same gradients, bit for bit, as keeping every activation."""
    out = []
    for remat in (True, False):
        cfg = TCFG.get_smoke("granite-3-8b").replace(remat=remat)
        params = T.init(cfg, 0, "cpu")
        out.append(_port_value_and_grad(cfg, params, _batch(cfg)))
    (l1, m1, g1), (l2, m2, g2) = out
    assert l1 == l2 and m1 == m2
    for p in g1:
        np.testing.assert_array_equal(g1[p], g2[p])
