"""The port's launch layer on the CPU: meshes, input specs, partitions,
the ``meta``-device dry-run and the H100 roofline.

- The mirror of the reference's ``tests/test_launch.py`` against the
  port's functions (spec shapes and dtypes, the HLO parse, the unit
  solver, model FLOPs, the 32 supported cells), and the input specs of
  every (arch x shape) cell equal to the reference's.
- Partitions: every FULL config's parameter, decode-cache, optimizer-state
  and input partitions on the two production meshes equal the
  reference's ``PartitionSpec`` entries, computed on
  ``jax.sharding.AbstractMesh`` (exact).
- The dry-run on a one-device mesh: arguments, outputs and aliases held
  to the reference's ``compiled.memory_analysis()`` on ``jax.make_mesh((1,
  1), ...)``.  Arguments and aliases are exact; XLA's output size adds 8
  bytes per result leaf (the tuple's index table), which the test names.
- The step counter on ``meta`` equals the same counter on real CPU
  tensors (exact); the unit solve over the analysis variants equals a
  full-depth trace (1e-9 relative); rwkv's length extrapolation (the
  quadratic through three traced lengths) equals a direct trace at a
  fourth (1e-9 relative).
- The MoE dense surrogate against the reference's (f32, 1e-5 of the
  output's scale, at least 1); ``make_train_step(params_pspecs=...)``
  the same step as without (exact).

SMOKE widths or abstract shapes only: a FULL config is never traced here.
"""
import json
import os
import re
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import AbstractMesh, NamedSharding, PartitionSpec

from repro.configs import ARCHS as REF_ARCHS
from repro.configs import get_config as ref_config
from repro.configs import get_smoke as ref_smoke
from repro.launch import specs as RS
from repro.models import api as RA
from repro.models import moe as RMoE
from repro.train import opt_state_pspecs as ref_opt_pspecs
from repro_torch.configs import ARCHS, get_config, get_smoke
from repro_torch.launch import dryrun, make_host_mesh, make_production_mesh
from repro_torch.launch import roofline as RL
from repro_torch.launch.roofline import (Measurement, collective_bytes,
                                         measure_step, model_flops,
                                         model_params_active, solve_units)
from repro_torch.launch.specs import input_shardings, input_specs
from repro_torch.models import SHAPES, api, supports_shape
from repro_torch.models import moe as TMoE
from repro_torch.models.common import is_def, param_pspecs, tree_items
from repro_torch.models.config import ShapeCell
from repro_torch.sharding import NamedSharding as TNamedSharding
from repro_torch.sharding import named_sharding
from repro_torch.train import make_train_step, opt_state_pspecs

ROOT = Path(__file__).resolve().parents[1]
#: the relative tolerance of a solve or an extrapolation (float64 sums)
REL = 1e-9
#: XLA's output size counts a pointer per result leaf (the tuple's table)
XLA_TUPLE_BYTES = 8


# ---------------------------------------------------------------------------
# The mirror of tests/test_launch.py
# ---------------------------------------------------------------------------
def test_input_specs_shapes_train():
    cfg = get_config("granite-3-8b")
    spec = input_specs(cfg, SHAPES["train_4k"])["batch"]
    assert spec["tokens"].shape == (256, 4097)
    assert spec["tokens"].dtype == torch.int32
    assert spec["tokens"].device.type == "meta"


def test_input_specs_decode_cache():
    cfg = get_config("yi-9b")
    spec = input_specs(cfg, SHAPES["decode_32k"])
    assert spec["token"].shape == (128, 1)
    kv = spec["cache"]["kv"]
    assert kv["k"].shape == (48, 128, 32768, 4, 128)


def test_input_specs_stub_frontends():
    w = get_config("whisper-base")
    spec = input_specs(w, SHAPES["train_4k"])["batch"]
    assert spec["frames"].shape == (256, 1500, 512)
    v = get_config("llama-3.2-vision-11b")
    spec = input_specs(v, SHAPES["prefill_32k"])["batch"]
    assert spec["vision"].shape == (32, 1601, 4096)


def test_collective_parse():
    hlo = """
  %all-reduce.1 = f32[16,128]{1,0} all-reduce(%x), replica_groups={}
  %ag = bf16[4,256]{1,0} all-gather(%y), dimensions={0}
  %cp = f32[8]{0} collective-permute(%z), source_target_pairs={{0,1}}
  %notacoll = f32[99]{0} add(%a, %b)
"""
    out = collective_bytes(hlo)
    assert out["all-reduce"] == 16 * 128 * 4 * 2       # ring x2
    assert out["all-gather"] == 4 * 256 * 2
    assert out["collective-permute"] == 8 * 4
    assert out["total"] == sum(v for k, v in out.items() if k != "total")


def test_unit_solver_exact():
    # base=5, unitA=3, unitB=7 reconstructed from 3 variants
    variants = [
        ({"a": 1, "b": 1}, Measurement(5 + 3 + 7, 0, {})),
        ({"a": 2, "b": 1}, Measurement(5 + 6 + 7, 0, {})),
        ({"a": 1, "b": 2}, Measurement(5 + 3 + 14, 0, {})),
    ]
    m = solve_units(variants, {"a": 10, "b": 4})
    assert abs(m.flops - (5 + 30 + 28)) < 1e-6


def test_model_flops_sanity():
    cfg = get_config("granite-3-8b")
    n, n_active = model_params_active(cfg)
    assert n == n_active                      # dense
    assert 7.5e9 < n < 9e9
    f = model_flops(cfg, SHAPES["train_4k"])
    assert abs(f - 6 * n * 256 * 4096) / f < 1e-6
    ds = get_config("deepseek-v3-671b")
    nt, na = model_params_active(ds)
    assert nt > 6e11 and na < 0.1 * nt        # sparse activation


def test_supports_matrix_counts():
    runnable = sum(supports_shape(get_config(a), s)
                   for a in ARCHS for s in SHAPES)
    assert runnable == 32                     # 40 cells - 8 long_500k skips


# ---------------------------------------------------------------------------
# Input specs, meshes, partitions against the reference
# ---------------------------------------------------------------------------
def _dtype_name(t):
    return str(t.dtype).replace("torch.", "")


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_the_reference(arch):
    """Every cell's abstract inputs: the reference's shapes and dtypes."""
    assert ARCHS == REF_ARCHS
    cfg, rcfg = get_config(arch), ref_config(arch)
    for shape, cell in SHAPES.items():
        got = dict(tree_items(input_specs(cfg, cell)))
        want = jax.tree_util.tree_flatten_with_path(
            RS.input_specs(rcfg, cell))[0]
        want = {".".join(str(k.key) for k in path): leaf
                for path, leaf in want}
        assert sorted(got) == sorted(want), shape
        for k, t in got.items():
            assert t.device.type == "meta"
            assert tuple(t.shape) == tuple(want[k].shape), (shape, k)
            assert _dtype_name(t) == str(want[k].dtype), (shape, k)


def test_meshes():
    one = make_production_mesh()
    two = make_production_mesh(multi_pod=True)
    assert one.axis_names == ("data", "model")
    assert dict(one.shape) == {"data": 16, "model": 16}
    assert one.devices.shape == (16, 16) and one.devices.size == 256
    assert two.axis_names == ("pod", "data", "model")
    assert two.devices.size == 512
    assert {d.type for d in two.devices.flat} == {"meta"}
    host = make_host_mesh(data=2, model=4)
    assert host.devices.shape == (2, 4)
    assert {d.type for d in host.devices.flat} == {"cpu"}
    assert make_host_mesh(pod=2).axis_names == ("pod", "data", "model")
    assert make_host_mesh().devices.size == 1


def test_named_sharding_and_param_pspecs():
    mesh = make_production_mesh()
    ns = named_sharding((256, 4097), ("batch", "seq"), mesh)
    assert isinstance(ns, TNamedSharding)
    assert ns.mesh is mesh and ns.spec == ("data",)
    assert named_sharding((3,), ("batch",), mesh).spec == ()
    schema = api.schema(get_smoke("granite-3-8b"))
    specs = param_pspecs(schema, mesh)
    assert all(is_def(d) for _, d in tree_items(schema))
    assert not is_def(specs["embed"])
    assert sorted(dict(tree_items(schema))) == \
        sorted(dict(tree_items(specs)))


def _ref_tuples(tree):
    """A reference tree of PartitionSpecs / NamedShardings -> {path: tuple}."""
    leaves = jax.tree_util.tree_flatten_with_path(
        tree, is_leaf=lambda x: isinstance(x, (PartitionSpec,
                                                NamedSharding)))[0]
    return {".".join(str(k.key) for k in path):
            tuple(leaf.spec if isinstance(leaf, NamedSharding) else leaf)
            for path, leaf in leaves}


def _port_tuples(tree):
    return {p: (v.spec if isinstance(v, TNamedSharding) else v)
            for p, v in tree_items(tree)}


@pytest.mark.parametrize("multi_pod", [False, True],
                         ids=["16x16", "2x16x16"])
@pytest.mark.parametrize("arch", ARCHS)
def test_partitions_match_the_reference(arch, multi_pod):
    """``api.pspecs``, ``api.cache_pspecs`` at decode_32k,
    ``opt_state_pspecs`` and every cell's ``input_shardings`` on the
    production mesh: the reference's entries on the AbstractMesh."""
    shape, names = ((2, 16, 16), ("pod", "data", "model")) if multi_pod \
        else ((16, 16), ("data", "model"))
    rmesh = AbstractMesh(shape, names)
    mesh = make_production_mesh(multi_pod=multi_pod)
    cfg, rcfg = get_config(arch), ref_config(arch)
    pspec, rpspec = api.pspecs(cfg, mesh), RA.pspecs(rcfg, rmesh)
    assert _port_tuples(pspec) == _ref_tuples(rpspec)
    b, s = SHAPES["decode_32k"].global_batch, SHAPES["decode_32k"].seq_len
    assert _port_tuples(api.cache_pspecs(cfg, b, s, mesh)) == \
        _ref_tuples(RA.cache_pspecs(rcfg, b, s, rmesh))
    assert _port_tuples(opt_state_pspecs(cfg, pspec, mesh=mesh)) == \
        _ref_tuples(ref_opt_pspecs(rcfg, rpspec, mesh=rmesh))
    for cell in SHAPES.values():
        assert _port_tuples(input_shardings(cfg, cell, mesh)) == \
            _ref_tuples(RS.input_shardings(rcfg, cell, rmesh)), cell.name


# ---------------------------------------------------------------------------
# The dry-run on a one-device mesh against the reference's compile
# ---------------------------------------------------------------------------
def _ref_build_step():
    """The reference's ``build_step``.  Its module sets ``XLA_FLAGS`` (512
    host devices) when imported: the backend starts first, so this process
    keeps its one device, and the variable is restored, so no later
    subprocess inherits it."""
    jax.devices()
    prev = os.environ.get("XLA_FLAGS")
    try:
        from repro.launch.dryrun import build_step
    finally:
        if prev is None:
            os.environ.pop("XLA_FLAGS", None)
        else:
            os.environ["XLA_FLAGS"] = prev
    return build_step


def _ref_memory(arch, cell):
    fn, args = _ref_build_step()(ref_smoke(arch), cell,
                                 jax.make_mesh((1, 1), ("data", "model")))
    ma = fn.lower(*args).compile().memory_analysis()
    n_out = len(jax.tree.leaves(jax.eval_shape(fn, *args)))
    return ma, n_out


@pytest.mark.parametrize("kind", ["train", "decode"])
@pytest.mark.parametrize("arch", ["granite-3-8b", "qwen3-moe-30b-a3b"])
def test_dryrun_memory_matches_the_reference(arch, kind):
    cell = ShapeCell("t", 64, 8, kind)
    rec = dryrun.run_cell(arch, cell, False, False,
                          cfg_override=get_smoke(arch),
                          mesh=make_host_mesh())
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "1x1" and rec["coll"]["total"] == 0
    assert (rec.get("moe") == "dense surrogate") == (arch != "granite-3-8b")
    flags = os.environ.get("XLA_FLAGS")
    ma, n_out = _ref_memory(arch, cell)
    assert jax.device_count() == 1 and os.environ.get("XLA_FLAGS") == flags
    mem = rec["memory"]
    assert mem["argument_bytes"] == ma.argument_size_in_bytes
    assert mem["alias_bytes"] == ma.alias_size_in_bytes
    assert mem["output_bytes"] + XLA_TUPLE_BYTES * n_out == \
        ma.output_size_in_bytes
    assert mem["total_bytes"] == (mem["argument_bytes"] + mem["output_bytes"]
                                  + mem["temp_bytes"] - mem["alias_bytes"])
    assert mem["temp_bytes"] > 0


def test_dryrun_memory_known_values():
    """The reference's numbers for granite-3-8b SMOKE train at 8 x 64."""
    rec = dryrun.run_cell("granite-3-8b", ShapeCell("t", 64, 8, "train"),
                          False, False,
                          cfg_override=get_smoke("granite-3-8b"),
                          mesh=make_host_mesh())
    assert rec["memory"]["argument_bytes"] == 1_070_244
    assert rec["memory"]["output_bytes"] + 38 * XLA_TUPLE_BYTES == 1_068_484


def test_dryrun_per_device_bytes_on_the_production_mesh():
    """Arguments per device: each sharded dim divided by its mesh axes;
    the traced rank's collectives give the roofline a collective term."""
    cfg = get_smoke("granite-3-8b")
    cell = ShapeCell("d", 64, 32, "decode")
    mesh = make_production_mesh()
    rec = dryrun.run_cell("granite-3-8b", cell, False, True,
                          cfg_override=cfg, mesh=mesh)
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "16x16"
    with_mesh = rec["memory"]
    one = dryrun.run_cell("granite-3-8b", cell, False, False,
                          cfg_override=cfg, mesh=make_host_mesh())["memory"]
    fn, args = dryrun.build_step(cfg, cell, mesh)
    want = 0
    for tree, specs in zip(args, fn.in_specs):
        if isinstance(tree, int):
            want += dryrun.INDEX_BYTES
            continue
        sp = dict(tree_items(specs)) if isinstance(specs, dict) else None
        for p, t in (tree_items(tree) if isinstance(tree, dict)
                     else [("", tree)]):
            spec = sp[p] if sp is not None else specs
            n = t.element_size() * t.numel()
            for e in spec:
                for a in (() if e is None else (e,) if isinstance(e, str)
                          else e):
                    n //= mesh.shape[a]
            want += n
    assert with_mesh["argument_bytes"] == want
    assert with_mesh["argument_bytes"] < one["argument_bytes"]
    assert rec["cost_analysis"]["flops"] * 256 == pytest.approx(
        dryrun.measure_cell(cfg, cell, make_host_mesh())[3].flops, rel=REL)
    rl = rec["roofline"]
    assert rl["collective_s"] > 0
    assert rl["collective_s"] == rl["coll_bytes_per_dev"] / RL.LINK_BW
    assert rl["bottleneck"] in ("compute", "memory")


def test_dryrun_skips_what_the_reference_skips():
    rec = dryrun.run_cell("granite-3-8b", "long_500k", False, False)
    assert rec["status"] == "skipped" and "reason" in rec
    assert rec["mesh"] == "16x16"


def test_dryrun_records_an_error():
    bad = get_smoke("granite-3-8b").replace(n_heads=3)
    rec = dryrun.run_cell("granite-3-8b", ShapeCell("t", 8, 2, "train"),
                          False, False, cfg_override=bad,
                          mesh=make_host_mesh())
    assert rec["status"] == "error"
    assert rec["error"].startswith("RuntimeError: ")
    assert "dryrun.py" in rec["traceback"]


def test_dryrun_main_writes_records(tmp_path, monkeypatch):
    """The CLI on a SMOKE config (``get_config`` replaced): the
    reference's flags, one JSON line per cell."""
    monkeypatch.setattr(dryrun, "get_config", get_smoke)
    out = tmp_path / "d" / "dry.jsonl"
    recs = dryrun.main(["--arch", "granite-3-8b", "--shape", "decode_32k",
                        "--roofline", "--out", str(out), "--tag", "x",
                        "--set", "attn_block_kv=512", "--set", "remat=True"])
    assert [r["status"] for r in recs] == ["ok"]
    lines = [json.loads(x) for x in out.read_text().splitlines()]
    assert lines == recs
    assert lines[0]["tag"] == "x" and "roofline" in lines[0]
    assert lines[0]["memory"]["alias_bytes"] > 0


# ---------------------------------------------------------------------------
# The step counter
# ---------------------------------------------------------------------------
@pytest.mark.parametrize("kind", ["train", "prefill", "decode"])
@pytest.mark.parametrize("arch", ["granite-3-8b", "deepseek-v3-671b",
                                  "zamba2-1.2b"])
def test_measure_step_meta_equals_cpu(arch, kind):
    """The same counter on ``meta`` and on real CPU tensors: flops, bytes
    and the peak of live storage, exact."""
    cfg = get_smoke(arch).replace(moe_dense_analysis=True)
    cell = ShapeCell("c", 32, 4, kind)
    got = {}
    for dev in ("meta", "cpu"):
        fn, args = dryrun.build_step(cfg, cell, make_host_mesh(), device=dev)
        got[dev] = measure_step(fn, *args)
    assert got["meta"] == got["cpu"]
    assert got["meta"].flops > 0 and got["meta"].peak_bytes > 0
    assert got["meta"].coll == {"total": 0.0}


def test_measure_step_counts():
    """One matmul: 2mnk FLOPs, its inputs read and output written; a view
    moves nothing; a storage counts once across its views."""
    a = torch.empty(64, 32, device="meta")
    b = torch.empty(32, 16, device="meta")
    m = measure_step(lambda x, y: x @ y, a, b)
    assert m.flops == 2 * 64 * 32 * 16
    assert m.bytes_accessed == (64 * 32 + 32 * 16 + 64 * 16) * 4
    assert m.peak_bytes == 64 * 16 * 4
    m = measure_step(lambda x: x.t().reshape(-1)[:10], b)
    assert m.flops == 0 and m.peak_bytes == 32 * 16 * 4

    def two(x):
        y = x * 2
        z = y.view(-1)
        del y
        return z * 3

    m = measure_step(two, a)
    assert m.peak_bytes == 2 * 64 * 32 * 4
    assert m.bytes_accessed == 4 * 64 * 32 * 4


FAMILY_CONFIGS = {
    # family: (arch, overrides deeper than the variants)
    "dense": ("granite-3-8b", dict(n_layers=4)),
    "moe": ("qwen3-moe-30b-a3b", dict(n_layers=3)),
    "mla": ("minicpm3-4b", dict(n_layers=3)),
    "mla_moe": ("deepseek-v3-671b", dict(n_layers=5, first_dense_layers=2)),
    "vlm": ("llama-3.2-vision-11b", dict(n_layers=6, cross_every=3)),
    "zamba": ("zamba2-1.2b", dict(n_layers=4, attn_every=2)),
    "rwkv": ("rwkv6-1.6b", dict(n_layers=3)),
    "encdec": ("whisper-base", dict(n_layers=3, enc_layers=3)),
}


@pytest.mark.parametrize("family", sorted(FAMILY_CONFIGS))
def test_unit_solve_equals_the_full_depth_trace(family):
    """The reference's analysis variants, traced and solved, extrapolate
    to a trace of the whole depth with the variants' settings."""
    arch, kw = FAMILY_CONFIGS[family]
    cfg = get_smoke(arch).replace(**kw)
    assert cfg.family == family
    cell = ShapeCell("t", 16, 2, "train")
    mesh = make_host_mesh()
    variants, full_counts = RL.analysis_variants(cfg, cell)
    measured = [(c, dryrun.measure_cell(v, cell, mesh)[3])
                for v, c in variants]
    solved = solve_units(measured, full_counts)
    base = variants[0][0]
    full = cfg.replace(**{k: getattr(base, k) for k in (
        "scan_layers", "microbatch", "moe_dense_analysis", "attn_block_q",
        "attn_block_kv", "ssm_chunk")})
    direct = dryrun.measure_cell(full, cell, mesh)[3]
    assert solved.flops == pytest.approx(direct.flops, rel=REL)
    assert solved.bytes_accessed == pytest.approx(direct.bytes_accessed,
                                                  rel=REL)


def test_rwkv_length_extrapolation_equals_a_direct_trace():
    cfg = get_smoke("rwkv6-1.6b").replace(n_layers=1)
    mesh = make_host_mesh()
    n = dryrun.RWKV_LENGTHS[-1] + 32
    for kind in ("train", "prefill"):
        cell = ShapeCell("r", n, 2, kind)
        fn, args, out, m, lengths = dryrun.measure_cell(cfg, cell, mesh)
        assert lengths == list(dryrun.RWKV_LENGTHS)
        assert args[-1]["tokens"].shape[1] == n + (kind == "train")
        direct = dryrun._traced(cfg, cell, mesh)[3]
        for f in ("flops", "bytes_accessed", "peak_bytes"):
            assert getattr(m, f) == pytest.approx(getattr(direct, f),
                                                  rel=REL), (kind, f)


def test_roofline_has_the_h100_figures_only():
    assert (RL.PEAK_FLOPS, RL.HBM_BW, RL.LINK_BW) == (989e12, 3.35e12,
                                                       450e9)
    src = (ROOT / "src/repro_torch/launch/roofline.py").read_text()
    for tpu in (r"\b197e12", r"\b819e9", r"\b50e9", "v5e", "TPU"):
        assert not re.search(tpu, src), tpu
    for path in ("launch/dryrun.py", "launch/roofline.py", "launch/specs.py",
                 "launch/mesh.py"):
        text = (ROOT / "src/repro_torch" / path).read_text()
        assert not re.search(r"XLA_FLAGS|os\.environ\[", text), path


def test_roofline_terms_add_no_rwkv_correction():
    cfg = get_config("rwkv6-1.6b")
    cell = SHAPES["train_4k"]
    assert RL.rwkv_scan_correction(cfg, cell, 1) > 0
    m = Measurement(1e15, 2e12, {"total": 0.0})
    rl = RL.roofline_terms(m, cfg, cell, 4)
    assert rl.flops_per_dev == 1e15 and rl.hlo_total_flops == 4e15
    assert rl.compute_s == 1e15 / 989e12 and rl.memory_s == 2e12 / 3.35e12
    assert rl.bottleneck == "compute" and rl.collective_s == 0.0


# ---------------------------------------------------------------------------
# The MoE dense surrogate and make_train_step(params_pspecs=...)
# ---------------------------------------------------------------------------
def _close(got, want, rtol=1e-5):
    got = got.detach().float().numpy()
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape
    scale = max(1.0, float(np.abs(want).max()))
    assert float(np.abs(got - want).max()) <= rtol * scale


@pytest.mark.parametrize("n_local,first,cap", [(6, 0, 40), (3, 2, 9)])
def test_dense_surrogate_rows_match_the_reference(n_local, first, cap):
    rng = np.random.default_rng(6)
    n, d, hdim, k, e = 20, 8, 6, 2, 6
    arrays = [rng.standard_normal((n, d)),
              np.stack([rng.choice(e, k, replace=False) for _ in range(n)]),
              np.abs(rng.standard_normal((n, k))),
              rng.standard_normal((n_local, d, 2 * hdim)),
              rng.standard_normal((n_local, hdim, d))]
    arrays = [a.astype(np.int32 if i == 1 else np.float32)
              for i, a in enumerate(arrays)]
    kw = dict(n_local=n_local, first_expert=first, cap=cap, k=k,
              dense_surrogate=True)
    ta = [torch.from_numpy(a) for a in arrays]
    ta[1] = ta[1].long()
    _close(TMoE._expert_rows(*ta, **kw),
           RMoE._expert_rows(*map(jnp.asarray, arrays), **kw))


def test_dense_surrogate_moe_apply_matches_the_reference():
    """qwen3-moe SMOKE's MoE layer with ``moe_dense_analysis=True`` in
    f32 on both sides; the default path differs from it."""
    cfg = get_smoke("qwen3-moe-30b-a3b").replace(moe_dense_analysis=True)
    rcfg = ref_smoke("qwen3-moe-30b-a3b").replace(moe_dense_analysis=True)
    rng = np.random.default_rng(3)
    schema = TMoE.moe_schema(cfg, 0)
    arrays = {p: (rng.standard_normal(d.shape) * 0.2).astype(np.float32)
              for p, d in tree_items(schema)}
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    tp = {p: torch.from_numpy(a) for p, a in arrays.items()}
    got, aux = TMoE.moe_apply(cfg, tp, torch.from_numpy(x))
    want, raux = RMoE.moe_apply(rcfg, {p: jnp.asarray(a)
                                       for p, a in arrays.items()},
                                jnp.asarray(x))
    _close(got, want)
    assert float(aux) == pytest.approx(float(raux), rel=1e-5)
    dflt, _ = TMoE.moe_apply(cfg.replace(moe_dense_analysis=False), tp,
                             torch.from_numpy(x))
    assert not torch.equal(dflt, got)


def test_train_step_params_pspecs_changes_nothing():
    cfg = get_smoke("granite-3-8b").replace(microbatch=2)
    mesh = make_production_mesh()
    params = api.init(cfg, 0, "cpu")
    g = torch.Generator().manual_seed(0)
    batch = {"tokens": torch.randint(0, cfg.vocab, (4, 17), generator=g)}
    runs = []
    for pspecs in (None, api.pspecs(cfg, mesh)):
        p = {k: v for k, v in tree_items(params)}
        from repro_torch.models.common import tree_from_items
        p = tree_from_items((k, v.clone()) for k, v in p.items())
        step = make_train_step(cfg, lr=1e-3, params_pspecs=pspecs)
        st = step.init_state(p)
        for _ in range(2):
            p, st, m = step(p, st, batch)
        runs.append((p, m))
    (p0, m0), (p1, m1) = runs
    assert all(torch.equal(a, b) for (_, a), (_, b) in
               zip(tree_items(p0), tree_items(p1)))
    assert all(torch.equal(m0[k], m1[k]) for k in m0)
