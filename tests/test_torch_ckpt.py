"""Checkpoints across the two packages, on the CPU: a directory written
by the reference's ``save_pytree`` loads in the port's ``load_pytree``
and the other way round, bit for bit (bf16 parameters, AdamW's f32
moments, Adafactor's bf16 factored moments, the int32 step, int8
residual-free trees and integer leaves), and the two manifests name the
same keys, shapes and dtypes."""
import json
import os

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.ckpt import CheckpointManager as RefManager
from repro.ckpt import load_pytree as ref_load
from repro.ckpt import save_pytree as ref_save
from repro.configs import get_smoke
from repro.models import api as R
from repro.train import make_train_step as ref_make_train_step
from repro_torch.ckpt import CheckpointManager, load_pytree, save_pytree
from repro_torch.models.common import tree_items
from repro_torch.train.step import make_train_step
from repro_torch import configs as TCFG
from repro_torch.convert import (lm_params_from_arrays, opt_state_from_arrays,
                                 tensor_from_array)

STEP = 7


def _ref_state(opt):
    """The reference's train state after one step: {"params", "opt"} as
    its TrainLoop saves it, plus an integer leaf."""
    cfg = get_smoke("granite-3-8b").replace(optimizer=opt)
    params = R.init(cfg, jax.random.PRNGKey(0))
    step = ref_make_train_step(cfg, lr=1e-3)
    state = step.init_state(params)
    toks = jax.random.randint(jax.random.PRNGKey(1), (2, 9), 0, cfg.vocab)
    params, state, _ = jax.jit(step)(params, state, {"tokens": toks})
    return {"params": params, "opt": state, "x": jnp.arange(7)}


def _bits(a):
    """A numpy view of an array or tensor's bytes, for bit equality."""
    if isinstance(a, torch.Tensor):
        if a.dtype == torch.bfloat16:
            return a.view(torch.int16).numpy().view(np.uint16), "bfloat16"
        return a.numpy(), a.numpy().dtype.name
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        return a.view(np.uint16), "bfloat16"
    return a, a.dtype.name


def _assert_bit_equal(port_tree, ref_tree):
    got = dict(tree_items(port_tree))
    want = {k.replace("/", "."): v for k, v in _ref_flat(ref_tree).items()}
    assert set(got) == set(want)
    for path, w in want.items():
        (gb, gn), (wb, wn) = _bits(got[path]), _bits(w)
        assert gn == wn, (path, gn, wn)
        assert gb.shape == wb.shape, path
        np.testing.assert_array_equal(gb, wb, err_msg=path)


def _ref_flat(tree):
    from repro.ckpt.manager import _flatten
    return _flatten(tree)


def _manifest(directory, step):
    with open(os.path.join(directory, f"step_{step:08d}",
                           "manifest.json")) as f:
        return json.load(f)


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_reference_checkpoint_loads_in_the_port(tmp_path, opt):
    tree = _ref_state(opt)
    ref_save(tree, str(tmp_path), STEP, extra={"step": STEP})
    got, manifest = load_pytree(str(tmp_path))
    assert manifest["step"] == STEP and manifest["extra"] == {"step": STEP}
    assert got["params"]["blocks"]["mlp"]["w_in"].dtype == torch.bfloat16
    assert got["opt"]["opt"]["step"].dtype == torch.int32
    _assert_bit_equal(got, tree)
    # and it carries on as the port's train state
    tcfg = TCFG.get_smoke("granite-3-8b").replace(optimizer=opt)
    arrays = jax.tree.map(np.asarray, tree)
    st = opt_state_from_arrays(tcfg, arrays["opt"], "cpu")
    assert int(st["opt"]["step"]) == 1


@pytest.mark.parametrize("opt", ["adamw", "adafactor"])
def test_port_checkpoint_loads_in_the_reference(tmp_path, opt):
    ref = _ref_state(opt)
    arrays = jax.tree.map(np.asarray, ref)
    tcfg = TCFG.get_smoke("granite-3-8b").replace(optimizer=opt)
    port = {"params": lm_params_from_arrays(tcfg, arrays["params"], "cpu"),
            "opt": opt_state_from_arrays(tcfg, arrays["opt"], "cpu"),
            "x": tensor_from_array(arrays["x"])}
    save_pytree(port, str(tmp_path / "port"), STEP, extra={"step": STEP})
    got, manifest = ref_load(str(tmp_path / "port"))
    assert manifest["step"] == STEP
    assert got["params"]["embed"].dtype == jnp.bfloat16
    _assert_bit_equal(port, got)
    # the manifests name the same keys, shapes and dtypes
    ref_save(ref, str(tmp_path / "ref"), STEP, extra={"step": STEP})
    assert _manifest(str(tmp_path / "port"), STEP)["keys"] \
        == _manifest(str(tmp_path / "ref"), STEP)["keys"]


def test_port_train_state_round_trips_with_the_reference(tmp_path):
    """The port's own train state (AdamW, int8 residuals) after a step:
    written by the port's manager (async), read by the reference's
    manager, written again by the reference, read by the port: the same
    bits throughout."""
    cfg = TCFG.get_smoke("granite-3-8b")
    from repro_torch.models import api
    params = api.init(cfg, 0, "cpu")
    step = make_train_step(cfg, lr=1e-3, grad_compression="int8")
    state = step.init_state(params)
    toks = torch.randint(0, cfg.vocab, (2, 9),
                         generator=torch.Generator().manual_seed(0))
    params, state, _ = step(params, state, {"tokens": toks})
    tree = {"params": params, "opt": state}
    mgr = CheckpointManager(str(tmp_path / "a"), keep=2)
    mgr.save(tree, 1, extra={"step": 1})
    mgr.wait()
    ref_tree, _ = RefManager(str(tmp_path / "a"), use_async=False).restore()
    _assert_bit_equal(tree, ref_tree)
    assert set(ref_tree["opt"]) == {"opt", "ef_residual"}
    ref_save(ref_tree, str(tmp_path / "b"), 1)
    back, _ = load_pytree(str(tmp_path / "b"))
    _assert_bit_equal(back, ref_tree)
    mgr.async_ckpt.close()


def test_load_onto_a_device_and_restore_by_step(tmp_path):
    save_pytree({"a": torch.arange(4, dtype=torch.int32)}, str(tmp_path), 1)
    save_pytree({"a": torch.ones(2, dtype=torch.bfloat16)}, str(tmp_path), 2)
    t, m = load_pytree(str(tmp_path), step=1, device="cpu")
    assert m["step"] == 1 and t["a"].dtype == torch.int32
    t, m = load_pytree(str(tmp_path))
    assert m["step"] == 2 and t["a"].dtype == torch.bfloat16
    with pytest.raises(FileNotFoundError):
        load_pytree(str(tmp_path / "empty"))
