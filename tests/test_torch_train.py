"""The port's training substrate on the CPU: the mirror of the reference's
``tests/test_train.py`` (optimizers converge, microbatch equivalence,
clipping, the factored state, int8 compression, checkpoints), and three
``make_train_step`` steps against the reference's on the same parameters
and batches.

The port's step updates its parameters and optimizer state in place (the
reference's launcher donates them), so a test that starts two runs from
one tree hands each a copy.  Against the reference, with bf16 parameters,
the losses and metrics agree to LOSS_TOL, ``grad_norm`` to NORM_TOL of
its size (largest seen 2.3e-3, qwen3-moe's third step, the trajectories
a few bf16 roundings apart by then), and every parameter to PARAM_TOL
after three steps at lr 1e-3: an Adam step moves a parameter by about lr
whatever the gradient's size, so a gradient entry near zero whose sign
differs between the packages moves it 2 lr the other way (largest seen
4.4e-3, granite-3-8b and qwen3-moe at microbatch 1 and 2).
"""
import os

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import get_smoke as ref_smoke
from repro.models import api as R
from repro.train import make_train_step as ref_make_train_step
from repro_torch.configs import get_smoke
from repro_torch.convert import lm_params_from_arrays
from repro_torch.models import api
from repro_torch.models.common import tree_from_items, tree_items, tree_map
from repro_torch.train import (adafactor_init, clip_by_global_norm, compress,
                               make_train_step)

LOSS_TOL = 2e-3
NORM_TOL = 1e-2
PARAM_TOL = 1e-2


def tiny_cfg(**kw):
    return get_smoke("granite-3-8b").replace(**kw)


def make_batch(cfg, b=4, s=32, seed=0):
    g = torch.Generator().manual_seed(seed)
    return {"tokens": torch.randint(0, cfg.vocab, (b, s + 1), generator=g)}


def copy(tree):
    return tree_map(lambda t: t.clone(), tree)


def test_adamw_reduces_loss():
    cfg = tiny_cfg(microbatch=1)
    params = api.init(cfg, 0, "cpu")
    step = make_train_step(cfg, lr=5e-3)
    state = step.init_state(params)
    batch = make_batch(cfg)
    losses = []
    for _ in range(8):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses


def test_adafactor_reduces_loss():
    cfg = tiny_cfg(microbatch=1, optimizer="adafactor")
    params = api.init(cfg, 0, "cpu")
    step = make_train_step(cfg, lr=1e-2)
    state = step.init_state(params)
    batch = make_batch(cfg)
    losses = []
    for _ in range(8):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0] - 0.3, losses


def test_microbatch_equivalent_to_full_batch():
    cfg1 = tiny_cfg(microbatch=1)
    cfg2 = tiny_cfg(microbatch=2)
    params = api.init(cfg1, 0, "cpu")
    batch = make_batch(cfg1, b=4)
    s1 = make_train_step(cfg1, lr=1e-3)
    s2 = make_train_step(cfg2, lr=1e-3)
    p1, _, m1 = s1(copy(params), s1.init_state(params), batch)
    p2, _, m2 = s2(copy(params), s2.init_state(params), batch)
    assert abs(float(m1["loss"]) - float(m2["loss"])) < 5e-3
    d = max(float((a.float() - b.float()).abs().max())
            for (_, a), (_, b) in zip(tree_items(p1), tree_items(p2)))
    assert d < 5e-2, d      # same update up to bf16 accumulation noise


def test_grad_clip():
    tree = {"a": torch.ones(4) * 100.0, "b": torch.ones(2) * 50.0}
    clipped, norm = clip_by_global_norm(tree, 1.0)
    cn = float(torch.sqrt(sum(torch.sum(x ** 2)
                              for _, x in tree_items(clipped))))
    assert abs(cn - 1.0) < 1e-5
    assert float(norm) > 100


def test_adafactor_memory_is_factored():
    cfg = tiny_cfg(optimizer="adafactor")
    params = api.init(cfg, 0, "cpu")
    st = adafactor_init(params)
    n_params = sum(x.numel() for _, x in tree_items(params))
    n_state = sum(x.numel() for _, x in tree_items(st["f"]))
    assert n_state < 0.25 * n_params   # factored second moment is tiny


# --- gradient compression ---------------------------------------------------
def test_quantize_roundtrip_error_bound():
    rng = np.random.default_rng(0)
    x = torch.from_numpy(rng.normal(size=(256,)).astype(np.float32))
    q, scale = compress.quantize_int8(x)
    err = float((compress.dequantize_int8(q, scale) - x).abs().max())
    assert err <= float(scale) / 2 + 1e-7


def test_error_feedback_is_unbiased_over_time():
    """With error feedback the accumulated compressed sum converges to the
    true sum (EF-SGD property)."""
    rng = np.random.default_rng(1)
    g = torch.from_numpy(rng.normal(size=(128,)).astype(np.float32)) * 1e-3
    grads = {"w": g}
    resid = compress.init_residuals(grads)
    total = torch.zeros(128)
    for _ in range(50):
        deq, resid = compress.compress_tree_with_feedback(grads, resid)
        total += deq["w"].float()
    true = g * 50
    rel = float((total - true).abs().max() / (true.abs().max() + 1e-12))
    assert rel < 0.05, rel


def test_train_step_with_compression_runs():
    cfg = tiny_cfg(microbatch=1)
    params = api.init(cfg, 0, "cpu")
    step = make_train_step(cfg, lr=1e-3, grad_compression="int8")
    state = step.init_state(params)
    assert "ef_residual" in state
    batch = make_batch(cfg)
    losses = []
    for _ in range(6):
        params, state, m = step(params, state, batch)
        losses.append(float(m["loss"]))
    assert losses[-1] < losses[0]


# --- checkpointing ----------------------------------------------------------
def test_checkpoint_roundtrip_bit_exact(tmp_path):
    from repro_torch.ckpt import load_pytree, save_pytree
    cfg = tiny_cfg()
    params = api.init(cfg, 0, "cpu")
    save_pytree({"params": params, "x": torch.arange(7)}, str(tmp_path), 3)
    tree, manifest = load_pytree(str(tmp_path))
    assert manifest["step"] == 3
    for (_, a), (_, b) in zip(tree_items(params),
                              tree_items(tree["params"])):
        assert a.dtype == b.dtype and torch.equal(a, b)
    assert torch.equal(tree["x"], torch.arange(7))


def test_checkpoint_atomic_and_gc(tmp_path):
    from repro_torch.ckpt import CheckpointManager, latest_step
    mgr = CheckpointManager(str(tmp_path), keep=2, use_async=False)
    for s in (1, 2, 3, 4):
        mgr.save({"v": torch.full((3,), s)}, s)
    assert latest_step(str(tmp_path)) == 4
    steps = sorted(int(d.split("_")[1]) for d in os.listdir(tmp_path)
                   if d.startswith("step_"))
    assert steps == [3, 4]               # keep=2 gc'd older
    tree, _ = mgr.restore()
    assert float(tree["v"][0]) == 4


def test_async_checkpointer(tmp_path):
    """The writer copies the tree when ``save`` is called: an in-place
    update after it (the train step's) does not reach the file."""
    from repro_torch.ckpt import AsyncCheckpointer, load_pytree
    ck = AsyncCheckpointer()
    a = torch.ones(5)
    ck.save({"a": a}, str(tmp_path), 10)
    a.add_(1.0)
    ck.wait()
    tree, manifest = load_pytree(str(tmp_path), 10)
    assert torch.equal(tree["a"], torch.ones(5))
    ck.close()


# --- against the reference -----------------------------------------------
@pytest.mark.parametrize("arch,microbatch,compression,optimizer", [
    ("granite-3-8b", 1, None, "adamw"),
    ("granite-3-8b", 2, None, "adamw"),
    ("granite-3-8b", 1, "int8", "adamw"),
    ("granite-3-8b", 2, "int8", "adafactor"),
    ("qwen3-moe-30b-a3b", 2, None, "adamw"),
])
def test_three_steps_match_the_reference(arch, microbatch, compression,
                                         optimizer):
    kw = dict(microbatch=microbatch, optimizer=optimizer)
    cfg, tcfg = ref_smoke(arch).replace(**kw), get_smoke(arch).replace(**kw)
    params = R.init(cfg, jax.random.PRNGKey(0))
    tp = lm_params_from_arrays(tcfg, jax.tree.map(np.asarray, params), "cpu")
    rs = jax.jit(ref_make_train_step(cfg, lr=1e-3,
                                     grad_compression=compression))
    ts = make_train_step(tcfg, lr=1e-3, grad_compression=compression)
    rstate = ref_make_train_step(cfg, grad_compression=compression) \
        .init_state(params)
    tstate = ts.init_state(tp)
    rng = np.random.default_rng(0)
    for _ in range(3):
        toks = rng.integers(0, cfg.vocab, (4, 17)).astype(np.int32)
        params, rstate, rm = rs(params, rstate, {"tokens": jnp.asarray(toks)})
        tp, tstate, tm = ts(tp, tstate, {"tokens": torch.from_numpy(toks)})
        assert set(tm) == set(rm)
        for k in rm:
            tol = NORM_TOL * float(rm[k]) if k == "grad_norm" else LOSS_TOL
            assert abs(float(rm[k]) - float(tm[k])) < tol, \
                (k, float(rm[k]), float(tm[k]))
    assert int(tstate["opt"]["step"]) == 3
    if compression:
        assert set(tstate) == {"opt", "ef_residual"}
    rp = dict(tree_items(jax.tree.map(np.asarray, params)))
    for path, t in tree_items(tp):
        d = float(np.abs(np.asarray(rp[path], np.float32)
                         - t.float().numpy()).max())
        assert d < PARAM_TOL, (path, d)


class DuckMesh:
    """What ``spec_for`` reads of a mesh: its axis names and sizes."""
    axis_names = ("data", "model")
    shape = {"data": 4, "model": 16}


@pytest.mark.parametrize("arch,optimizer,compression", [
    ("granite-3-8b", "adafactor", None), ("deepseek-v3-671b", "adafactor",
                                          "int8"),
    ("qwen3-moe-30b-a3b", "adamw", "int8")])
def test_opt_state_pspecs_match_the_reference(arch, optimizer, compression):
    """The optimizer state's partitions on a (data 4, model 16) mesh: the
    reference's ``PartitionSpec`` entries, as the port's tuples."""
    from repro.models.common import ParamDef as RefParamDef
    from repro.sharding import spec_for as ref_spec_for
    from repro.train import opt_state_pspecs as ref_pspecs
    from repro_torch.sharding import spec_for
    from repro_torch.train import opt_state_pspecs
    cfg = get_smoke(arch).replace(optimizer=optimizer)
    rcfg = ref_smoke(arch).replace(optimizer=optimizer)
    mesh = DuckMesh()
    tparams = tree_from_items((p, spec_for(d.shape, d.axes, mesh))
                              for p, d in tree_items(api.schema(cfg)))
    rparams = jax.tree.map(lambda d: ref_spec_for(d.shape, d.axes, mesh),
                           R.schema(rcfg),
                           is_leaf=lambda x: isinstance(x, RefParamDef))
    got = dict(tree_items(opt_state_pspecs(cfg, tparams, compression,
                                           mesh)))
    want = dict(tree_items(jax.tree.map(
        tuple, ref_pspecs(rcfg, rparams, compression, mesh),
        is_leaf=lambda x: isinstance(x, jax.sharding.PartitionSpec))))
    assert got == want
