"""The port's ten architectures against the reference's, on the CPU.

For every ``ARCHS`` entry at its SMOKE config, the reference's parameters
(``api.init(cfg, jax.random.PRNGKey(0))``) are copied into the port with
``lm_params_from_arrays``, and the same numpy-seeded batch runs through
both packages: the prefill logits and caches, then 8 decode steps from a
fresh cache (the stub ``frames`` / ``vision`` inputs and the cross caches
made as the reference's smoke tests make them).  Parameters are bf16, so
the logits must agree to a largest absolute difference below 0.15 on the
first ``vocab`` columns (the reference's own decode-vs-forward tolerance),
and the caches to 0.05 of their largest magnitude (at least 1).  The
schemas (``n_params`` for FULL and SMOKE, every leaf's shape, axes, init
and dtype) and the partition ``spec_for`` gives each FULL parameter on a
(data 4, model 16) mesh must be the reference's exactly.
"""
import dataclasses
import functools

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np

from repro.configs import ARCHS, get_config, get_smoke
from repro.models import api as R
from repro.models import common as RC
from repro.models import encdec as RE
from repro.models import lm as RL
from repro.sharding import spec_for as ref_spec_for
from repro_torch import configs as TCFG
from repro_torch.convert import lm_params_from_arrays, tensor_from_array
from repro_torch.models import api as T
from repro_torch.models import encdec as TE
from repro_torch.models import lm as TL
from repro_torch.models.common import tree_items
from repro_torch.sharding import spec_for

LOGIT_TOL = 0.15
CACHE_TOL = 0.05
B, S, STEPS = 2, 8, 8


class DuckMesh:
    """What ``spec_for`` reads of a mesh: its axis names and sizes."""
    axis_names = ("data", "model")
    shape = {"data": 4, "model": 16}


def _batch(cfg):
    rng = np.random.default_rng(0)
    batch = {"tokens": rng.integers(0, cfg.vocab, (B, S)).astype(np.int32)}
    if cfg.family == "encdec":
        batch["frames"] = rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)
    if cfg.family == "vlm":
        batch["vision"] = rng.standard_normal(
            (B, cfg.img_seq, cfg.d_model)).astype(np.float32)
    return batch


def _np(tree):
    return jax.tree.map(np.asarray, tree)


def _ref_decode_cache(cfg, params, batch):
    cache = R.init_cache(cfg, B, cfg.max_seq)
    if cfg.family == "encdec":
        mem = RE.encode(cfg, params, jnp.asarray(batch["frames"]))
        ck, cv = RE.cross_kv(cfg, params, mem)
        cache = dict(cache, cross_k=ck, cross_v=cv)
    if cfg.family == "vlm":
        ck, cv = RL.vlm_cross_cache(cfg, params, jnp.asarray(batch["vision"]))
        cache = dict(cache, cross_k=ck, cross_v=cv)
    return cache


def _port_decode_cache(cfg, params, batch):
    cache = T.init_cache(cfg, B, cfg.max_seq, "cpu")
    if cfg.family == "encdec":
        mem = TE.encode(cfg, params, torch.from_numpy(batch["frames"]))
        cache["cross_k"], cache["cross_v"] = TE.cross_kv(cfg, params, mem)
    if cfg.family == "vlm":
        cache["cross_k"], cache["cross_v"] = TL.vlm_cross_cache(
            cfg, params, torch.from_numpy(batch["vision"]))
    return cache


@pytest.fixture(scope="module", params=ARCHS)
def ref_run(request):
    """The reference's prefill and 8 decode steps for one architecture,
    computed once for the module."""
    arch = request.param
    cfg = get_smoke(arch)
    params = R.init(cfg, jax.random.PRNGKey(0))
    batch = _batch(cfg)
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    last, caches = jax.jit(functools.partial(R.prefill, cfg))(params, jbatch)
    step = jax.jit(functools.partial(R.decode, cfg))
    cache = _ref_decode_cache(cfg, params, batch)
    logits = []
    for i in range(STEPS):
        lg, cache = step(params, jbatch["tokens"][:, i:i + 1], cache,
                         jnp.int32(i))
        logits.append(np.asarray(lg[:, 0], np.float32))
    return dict(arch=arch, params=_np(params), batch=batch,
                last=np.asarray(last, np.float32), caches=_np(caches),
                steps=np.stack(logits, axis=1))


@pytest.fixture(scope="module")
def port_run(ref_run):
    cfg = TCFG.get_smoke(ref_run["arch"])
    params = lm_params_from_arrays(cfg, ref_run["params"], device="cpu")
    batch = {k: torch.from_numpy(v) for k, v in ref_run["batch"].items()}
    batch["tokens"] = batch["tokens"].long()
    with torch.inference_mode():
        last, caches = T.prefill(cfg, params, batch)
        cache = _port_decode_cache(cfg, params, ref_run["batch"])
        logits = []
        for i in range(STEPS):
            lg, cache = T.decode(cfg, params, batch["tokens"][:, i:i + 1],
                                 cache, i)
            logits.append(lg[:, 0].float().numpy())
    return dict(cfg=cfg, params=params, last=last.float().numpy(),
                caches=caches, steps=np.stack(logits, axis=1))


def _logit_diff(got, want, vocab):
    return float(np.abs(got[..., :vocab] - want[..., :vocab]).max())


def test_prefill_logits_and_caches(ref_run, port_run):
    cfg = port_run["cfg"]
    d = _logit_diff(port_run["last"], ref_run["last"], cfg.vocab)
    assert d < LOGIT_TOL, f"{cfg.name}: prefill logits differ by {d}"
    if cfg.vocab % 128:
        assert (port_run["last"][..., cfg.vocab:] < -1e29).all()
    want = dict(tree_items(ref_run["caches"]))
    got = dict(tree_items(port_run["caches"]))
    assert set(got) == set(want)
    for path, w in want.items():
        g = got[path]
        assert tuple(g.shape) == w.shape, path
        w = w.astype(np.float32)
        err = float(np.abs(g.float().numpy() - w).max())
        scale = max(1.0, float(np.abs(w).max()))
        assert err <= CACHE_TOL * scale, f"{cfg.name} cache {path}: {err}"


def test_decode_steps_match_reference(ref_run, port_run):
    cfg = port_run["cfg"]
    d = _logit_diff(port_run["steps"], ref_run["steps"], cfg.vocab)
    assert d < LOGIT_TOL, f"{cfg.name}: decode logits differ by {d}"
    assert np.isfinite(port_run["steps"][..., :cfg.vocab]).all()


def test_module_holds_the_reference_tree(ref_run, port_run):
    """``LM``'s state_dict keys are the schema paths, its tensors the
    converted leaves; its prefill is the functional one."""
    cfg, params = port_run["cfg"], port_run["params"]
    model = T.LM(cfg, params)
    sd = model.state_dict()
    assert sorted(sd) == sorted(p for p, _ in tree_items(ref_run["params"]))
    for path, arr in tree_items(ref_run["params"]):
        assert torch.equal(sd[path], tensor_from_array(arr))
    batch = {k: torch.from_numpy(v) for k, v in ref_run["batch"].items()}
    batch["tokens"] = batch["tokens"].long()
    with torch.inference_mode():
        last, _ = model.prefill(batch)
    np.testing.assert_array_equal(last.float().numpy(), port_run["last"])


@pytest.mark.parametrize("arch", ARCHS)
def test_schema_and_n_params_match_reference(arch):
    for ref_cfg, cfg in ((get_config(arch), TCFG.get_config(arch)),
                         (get_smoke(arch), TCFG.get_smoke(arch))):
        assert dataclasses.asdict(cfg) == dataclasses.asdict(ref_cfg)
        assert T.n_params(cfg) == R.n_params(ref_cfg)
        want = dict(jax.tree_util.tree_flatten_with_path(
            R.schema(ref_cfg), is_leaf=RC.is_def)[0])
        want = {".".join(k.key for k in path): d for path, d in want.items()}
        got = dict(tree_items(T.schema(cfg)))
        assert sorted(got) == sorted(want)
        for path, d in got.items():
            w = want[path]
            assert (d.shape, d.axes, d.init, d.scale) == \
                (w.shape, w.axes, w.init, w.scale), path
            assert str(d.dtype).split(".")[-1] == np.dtype(w.dtype).name, path


@pytest.mark.parametrize("arch", ARCHS)
def test_spec_for_matches_reference_on_full_schemas(arch):
    mesh = DuckMesh()
    cfg = TCFG.get_config(arch)
    for path, d in tree_items(T.schema(cfg)):
        want = tuple(ref_spec_for(d.shape, d.axes, mesh))
        assert spec_for(d.shape, d.axes, mesh) == want, path
    # the cache schemas at the decode shape too
    for path, d in tree_items(T.cache_schema(cfg, 128, cfg.max_seq)):
        want = tuple(ref_spec_for(d.shape, d.axes, mesh))
        assert spec_for(d.shape, d.axes, mesh) == want, path


def test_conversion_rejects_a_mismatch(ref_run):
    cfg = TCFG.get_smoke(ref_run["arch"])
    params = dict(ref_run["params"])
    params.pop("embed")
    with pytest.raises(ValueError, match="missing"):
        lm_params_from_arrays(cfg, params, device="cpu")
    params["embed"] = np.zeros((3, 3), np.float32)
    with pytest.raises(ValueError, match="embed"):
        lm_params_from_arrays(cfg, params, device="cpu")
