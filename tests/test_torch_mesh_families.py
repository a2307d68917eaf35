"""Every family without experts on a (data x model) mesh on the port
(DTensor over gloo ranks, one process per rank): training, and prefill
and decode on placed parameters and a placed cache, held to the
reference's sharded steps and to one device, on the CPU.

One module fixture starts everything at once and the tests read what it
wrote under ``tmp_path``:

- the port's ranks, each ``python tests/test_torch_mesh_families.py port
  SHAPE RANK DIR`` (gloo, a ``file://`` rendezvous under ``tmp_path``), on
  2x2 and 1x1 meshes; each loops over the six families' SMOKE configs.
  The 1x1 process also runs each family on one device, without a mesh;
- two ranks of a 1x2 mesh for the cache write (``... write RANK DIR``);
- the reference's sharded side, ``... ref DIR``, with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and a 2x2 mesh of
  ``AxisType.Auto`` axes: each family's loss and gradients, and its
  ``launch.dryrun.build_step`` prefill and decode steps (the arguments
  placed by their ``in_shardings``), and the same on one device.

Every side starts from the reference's seed-0 parameters (its checkpoint,
placed by each rank with ``load_pytree(shardings=...)``); the vlm's two
``gate_attn`` gates are set to 0.5 in both packages, so its
cross-attention path reaches the logits (at their zero init it does
not).  The serving cell: batch B, a P-token prompt, a MAX_SEQ cache (its
positions split over "model": the new positions P .. P + STEPS - 1
straddle the two blocks), STEPS decode steps fed fixed tokens.

Tolerances (bf16 parameters; the ranks and XLA reduce in other orders):
the loss to LOSS_TOL and each gradient to GRAD_TOL of its leaf's largest
entry (``test_torch_mesh_train.py``'s) or, where it is larger, to
SPREAD_FACTOR times the gap between the reference's own one-device and
sharded gradients of that leaf (the vlm's ``gate_mlp``: one bf16 product
summed over the whole batch, its two entries a few 1e-4 after
cancellation, where the reference's two steps differ by about 16 %;
zamba's ``dt_bias``, whose gradient is under 1e-7); prefill and decode logits to
LOGIT_TOL on the first ``vocab`` columns (``test_torch_lm_models.py``'s);
a cache position to CACHE_TOL of the leaf's largest magnitude (at least
1), and nonzero where one device's is: the test that shows a lost write,
which LOGIT_TOL can hide for a step or two.  ServeEngine's greedy tokens
on the mesh may part from one device's after a flipped bf16 argmax (at
random weights the top two logits can lie within a bf16 step), so each
is held to one device fed the same tokens: its logit there within
2 x LOGIT_TOL of one device's largest (what logits within LOGIT_TOL
allow).  The 1x1 mesh and the positions past the last index are exact.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
FAMILIES = {"dense": "granite-3-8b", "mla": "minicpm3-4b",
            "mla_absorb": "minicpm3-4b", "zamba": "zamba2-1.2b",
            "rwkv": "rwkv6-1.6b", "vlm": "llama-3.2-vision-11b",
            "encdec": "whisper-base"}
#: config fields set on a family's SMOKE config in both packages:
#: "mla_absorb" serves minicpm3-4b through MLA's absorbed decode
OVERRIDES = {"mla_absorb": {"mla_absorb": True}}
#: the families whose training this file holds (dense training on a mesh
#: is test_torch_mesh_train.py's)
TRAINED = ("mla", "zamba", "rwkv", "vlm", "encdec")
LOSS_TOL = 1e-3
GRAD_TOL = 0.05
SPREAD_FACTOR = 2.0
LOGIT_TOL = 0.15
CACHE_TOL = 0.05
VLM_GATE = 0.5
B, P, STEPS, SEQ = 4, 8, 4, 16
#: the decode buffers' length: its two blocks over "model" are [0, 10)
#: and [10, 20), and no SMOKE width is 20, so an all-gathered cache leaf
#: would show as a collective result with a dim of this size
MAX_SEQ = 20
#: every process must be done within this
DEADLINE_S = 600
MESHES = {"2x2": (2, 2), "1x1": (1, 1)}
#: the SMOKE config build_step's cells run on
STEP_ARCH = "granite-3-8b"
STEP_CELLS = {"train": (SEQ, "train"), "prefill": (P, "prefill"),
              "decode": (MAX_SEQ, "decode")}


def port_cfg(fam):
    from repro_torch.configs import get_smoke
    return get_smoke(FAMILIES[fam]).replace(**OVERRIDES.get(fam, {}))


def ref_cfg(fam):
    from repro.configs import get_smoke
    return get_smoke(FAMILIES[fam]).replace(**OVERRIDES.get(fam, {}))


def train_batch(cfg):
    rng = np.random.default_rng(100)
    out = {"tokens": rng.integers(0, cfg.vocab, (B, SEQ + 1))
           .astype(np.int32)}
    out.update(extras(cfg))
    return out


def extras(cfg):
    """The stub frontend inputs, as the reference's smoke tests make
    them."""
    rng = np.random.default_rng(1)
    if cfg.family == "encdec":
        return {"frames": rng.standard_normal(
            (B, cfg.enc_seq, cfg.d_model)).astype(np.float32)}
    if cfg.family == "vlm":
        return {"vision": rng.standard_normal(
            (B, cfg.img_seq, cfg.d_model)).astype(np.float32)}
    return {}


def prompts(cfg):
    return np.random.default_rng(0).integers(
        0, cfg.vocab, (B, P)).astype(np.int32)


def forced(cfg):
    """The tokens fed to the decode steps (the same on every side)."""
    return np.random.default_rng(2).integers(
        0, cfg.vocab, (B, STEPS)).astype(np.int32)


def _save_np(path, arrays):
    np.savez(path, **{k.replace(".", "|"): v for k, v in arrays.items()})


def _load_np(path):
    with np.load(path) as f:
        return {k.replace("|", "."): f[k] for k in f.files}


# ---------------------------------------------------------------------------
# The port's ranks (no JAX here)
# ---------------------------------------------------------------------------
def _whole(t):
    from repro_torch.sharding import placed
    return (t.full_tensor() if placed(t) else t).float().numpy()


def _placed_batch(arrays, mesh):
    """numpy arrays as tensors placed by their batch partition (plain
    without a mesh)."""
    from repro_torch.sharding import distribute, named_sharding
    out = {}
    for k, v in arrays.items():
        t = torch.from_numpy(v)
        if t.dtype == torch.int32:
            t = t.long()
        out[k] = t if mesh is None else distribute(t, named_sharding(
            t.shape, ("batch",) + (None,) * (t.dim() - 1), mesh))
    return out


def shape_log(mesh):
    """A ``CollectiveCounter`` that also keeps the result shapes of every
    collective run under it (``shapes``)."""
    from repro_torch.launch.roofline import CollectiveCounter, _tensors

    class ShapeLog(CollectiveCounter):
        def _count(self, func, args, out):
            super()._count(func, args, out)
            if func.namespace == "_c10d_functional" and \
                    "wait" not in func._schema.name:
                self.shapes.append([func._schema.name.split("::")[-1]]
                                   + [list(t.shape) for t in _tensors(out)])

    log = ShapeLog(mesh)
    log.shapes = []
    return log


def port_train(cfg, params, mesh):
    """Loss and gradients of ``train_batch`` (whole numpy arrays)."""
    from repro_torch.models import api
    from repro_torch.models.common import tree_from_items, tree_items
    from repro_torch.sharding import replicate_plain
    paths, leaves = zip(*[(p, t.detach().requires_grad_())
                          for p, t in tree_items(params)])
    with torch.enable_grad(), replicate_plain():
        loss, _ = api.loss_fn(cfg, tree_from_items(zip(paths, leaves)),
                              _placed_batch(train_batch(cfg), mesh))
        grads = torch.autograd.grad(loss, leaves)
    return float(_whole(loss.detach())), {p: _whole(g) for p, g in
                                          zip(paths, grads)}


def port_serve(cfg, params, mesh, counted=False):
    """ServeEngine's greedy tokens, then the manual loop: the prefill's
    last logits, the cache grown by ``ServeEngine._grow_cache`` and STEPS
    decode steps fed ``forced``; (tokens, logits, cache, shapes of the
    collectives of the last decode step or None)."""
    from repro_torch.models import api
    from repro_torch.serve import ServeEngine
    eng = ServeEngine(cfg, params, B, MAX_SEQ, device="cpu")
    gen = eng.generate(prompts(cfg), STEPS + 1,
                       batch_extras=extras(cfg) or None)
    feed = forced(cfg)
    shapes = None
    with torch.no_grad():
        logits, cache = api.prefill(cfg, params, _placed_batch(
            dict(tokens=prompts(cfg), **extras(cfg)), mesh))
        out = [_whole(logits)]
        cache = eng._grow_cache(cache, P)
        for i in range(STEPS):
            tok = _placed_batch({"t": feed[:, i:i + 1]}, mesh)["t"]
            if counted and i == STEPS - 1:
                log = shape_log(mesh)
                with log:
                    logits, cache = api.decode(cfg, params, tok, cache,
                                               P + i)
                shapes = {"calls": log.calls, "by_dim": log.by_dim,
                          "shapes": log.shapes}
            else:
                logits, cache = api.decode(cfg, params, tok, cache, P + i)
            out.append(_whole(logits[:, -1]))
    return gen, out, cache, shapes


def engine_margins(cfg, params, gen):
    """One device fed ServeEngine's tokens ``gen``: per step, the largest
    (over the batch) gap between one device's largest logit and its logit
    of the engine's token."""
    from repro_torch.models import api
    out = []
    with torch.no_grad():
        logits, cache = api.prefill(cfg, params, _placed_batch(
            dict(tokens=prompts(cfg), **extras(cfg)), None))
        cache = _grow(cfg, params, cache)
        for i in range(gen.shape[1]):
            lg = logits.float()[:, :cfg.vocab]
            pick = lg.gather(1, torch.as_tensor(gen[:, i:i + 1]).long())
            out.append(float((lg.max(1, keepdim=True).values - pick).max()))
            if i + 1 < gen.shape[1]:
                logits, cache = api.decode(
                    cfg, params, torch.as_tensor(gen[:, i:i + 1]).long(),
                    cache, P + i)
                logits = logits[:, -1]
    return out


def _grow(cfg, params, cache):
    from repro_torch.serve import ServeEngine
    return ServeEngine(cfg, params, B, MAX_SEQ, device="cpu")._grow_cache(
        cache, P)


def _blocks(cache):
    """{path: this rank's block} and {path: its offset in each dim}."""
    from repro_torch.models.common import tree_items
    from repro_torch.sharding import block, placed
    blocks, offsets = {}, {}
    for p, t in tree_items(cache):
        blocks[p] = (t.to_local() if placed(t) else t).float().numpy()
        offsets[p] = [block(t, d)[0] for d in range(t.dim())]
    return blocks, offsets


def port_rank(shape, rank, out):
    """One rank of the port on ``shape``; every rank writes its cache
    blocks, rank 0 the rest under ``OUT/<shape>/``."""
    d, m = MESHES[shape]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(d * m),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.ckpt import load_pytree
    from repro_torch.launch.mesh import init_distributed, make_device_mesh
    from repro_torch.models import api
    from repro_torch.models.common import tree_items
    from repro_torch.sharding import use_mesh

    here = out / shape
    here.mkdir(parents=True, exist_ok=True)
    init_distributed("cpu", "file://" + str(out / f"rendezvous-{shape}"))
    mesh = make_device_mesh(d, m, device="cpu")
    rank0 = rank == 0
    res = {"families": sorted(FAMILIES)}
    for fam in FAMILIES:
        cfg = port_cfg(fam)
        src = str(out / "params" / fam)
        r = res[fam] = {}
        if shape == "1x1":
            # one device, no mesh: what every mesh run is held to
            plain = load_pytree(src)[0]["params"]
            one = {}
            if fam in TRAINED:
                one["loss"], grads = port_train(cfg, plain, None)
                _save_np(here / f"one_grads_{fam}.npz", grads)
            one["gen"], logits, cache, _ = port_serve(cfg, plain, None)
            one["gen"] = one["gen"].tolist()
            _save_np(here / f"one_logits_{fam}.npz",
                     {str(i): x for i, x in enumerate(logits)})
            _save_np(here / f"one_cache_{fam}.npz",
                     {p: t.float().numpy() for p, t in tree_items(cache)})
            r["one"] = one
        with use_mesh(mesh):
            params = load_pytree(src, shardings={"params": _named(
                api.pspecs(cfg, mesh), mesh)})[0]["params"]
            if fam in TRAINED:
                r["loss"], grads = port_train(cfg, params, mesh)
                if rank0:
                    _save_np(here / f"grads_{fam}.npz", grads)
            gen, logits, cache, coll = port_serve(cfg, params, mesh,
                                                  counted=True)
        r["gen"], r["collectives"] = gen.tolist(), coll
        if rank0:
            r["margins"] = engine_margins(
                cfg, load_pytree(src)[0]["params"], gen)
        blocks, offsets = _blocks(cache)
        _save_np(here / f"cache_{fam}_r{rank}.npz", blocks)
        r[f"offsets_r{rank}"] = offsets
        if rank0:
            _save_np(here / f"logits_{fam}.npz",
                     {str(i): x for i, x in enumerate(logits)})
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, offsets)
        r["offsets"] = got
    if shape == "2x2":
        res["build_step"] = build_step_cases(mesh)
        res["remat_off_thread"] = remat_off_thread(mesh, out)
        res["lookup"] = serving_lookup(mesh, out)
    if rank0:
        (here / "result.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def build_step_cases(mesh):
    """``launch.dryrun.build_step`` on the device mesh with real
    arguments: each argument leaf's local shape, and whether the step ran
    to finite results."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.dryrun import build_step
    from repro_torch.models.common import tree_items
    from repro_torch.models.config import ShapeCell
    from repro_torch.sharding import placed, use_mesh
    cfg = get_smoke(STEP_ARCH)
    out = {}
    for kind, (seq, k) in STEP_CELLS.items():
        with use_mesh(mesh):
            fn, args = build_step(cfg, ShapeCell(kind, seq, B, k), mesh,
                                  device="cpu")
        local = {}
        for i, a in enumerate(args):
            if isinstance(a, int):
                continue
            tree = a if isinstance(a, dict) else {"x": a}
            local.update({f"{i}.{p}": [list((t.to_local() if placed(t)
                                             else t).shape), placed(t)]
                          for p, t in tree_items(tree)})
        with torch.no_grad() if kind != "train" else \
                torch.enable_grad():
            res = fn(*args)
        leaves = [t for r in (res if isinstance(res, tuple) else (res,))
                  for t in (r.values() if isinstance(r, dict) else [r])
                  if isinstance(t, torch.Tensor)]
        finite = all(bool(torch.isfinite(_as_whole(t)).all())
                     for t in leaves if t.is_floating_point())
        out[kind] = {"local": local, "finite": finite}
    return out


def remat_off_thread(mesh, out):
    """dense SMOKE's gradients with the backward (each remat layer's
    recompute) run on a thread of its own, as autograd runs it on a device
    thread on the card, where this thread's ``use_mesh`` is not installed:
    whether they equal the same thread's bit for bit."""
    import threading

    from torch.distributed.tensor.experimental import implicit_replication

    from repro_torch.ckpt import load_pytree
    from repro_torch.models import api
    from repro_torch.models.common import tree_from_items, tree_items
    from repro_torch.sharding import replicate_plain, use_mesh
    cfg = port_cfg("dense")
    with use_mesh(mesh):
        params = load_pytree(str(out / "params" / "dense"), shardings={
            "params": _named(api.pspecs(cfg, mesh), mesh)})[0]["params"]
        paths, leaves = zip(*[(p, t.detach().requires_grad_())
                              for p, t in tree_items(params)])
        got = {}
        for where in ("same", "other"):
            with torch.enable_grad(), replicate_plain():
                loss, _ = api.loss_fn(cfg, tree_from_items(zip(
                    paths, leaves)), _placed_batch(train_batch(cfg), mesh))

            def backward():
                with implicit_replication():
                    got[where] = torch.autograd.grad(loss, leaves)
            if where == "same":
                with replicate_plain():
                    backward()
            else:
                worker = threading.Thread(target=backward)
                worker.start()
                worker.join(timeout=DEADLINE_S)
    return "other" in got and all(
        torch.equal(_as_whole(a), _as_whole(b))
        for a, b in zip(got["same"], got["other"]))


def serving_lookup(mesh, out):
    """The decoder embeddings of one decode step's tokens outside
    autograd, as serving takes them (``lm._embed`` for dense, and
    ``encdec._embed``), on placed parameters: whether they equal the
    plain table's rows, and the bytes the step's collectives moved beside
    the table's."""
    from repro_torch.ckpt import load_pytree
    from repro_torch.launch.roofline import CollectiveCounter
    from repro_torch.models import api, encdec, lm
    from repro_torch.sharding import use_mesh
    got = {}
    for fam in ("dense", "encdec"):
        cfg = port_cfg(fam)
        src = str(out / "params" / fam)
        plain = load_pytree(src)[0]["params"]["embed"]
        tok = forced(cfg)[:, :1]
        with use_mesh(mesh):
            params = load_pytree(src, shardings={"params": _named(
                api.pspecs(cfg, mesh), mesh)})[0]["params"]
            counter = CollectiveCounter(mesh)
            with torch.no_grad(), counter:
                placed_tok = _placed_batch({"t": tok}, mesh)["t"]
                x = (encdec._embed(params, placed_tok) if fam == "encdec"
                     else lm._embed(cfg, params, placed_tok))
        want = plain[torch.as_tensor(tok).long()].to(torch.bfloat16)
        got[fam] = {"equal": bool(np.array_equal(_whole(x),
                                                 want.float().numpy())),
                    "moved": sum(counter.coll_bytes.values()),
                    "table": plain.numel() * plain.element_size()}
    return got


def _as_whole(t):
    from repro_torch.sharding import placed
    return t.full_tensor() if placed(t) else t


def _named(specs, mesh):
    from repro_torch.models.common import tree_map
    from repro_torch.sharding import NamedSharding
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def write_rank(rank, out):
    """One of two ranks of a 1x2 mesh: ``sharding.write_at`` into a
    DTensor of zeros whose dim 1 is split over "model", at a position in
    each rank's block, with and without ``inference_mode``."""
    os.environ.update(RANK=str(rank), WORLD_SIZE="2", LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist
    from torch.distributed.tensor import Replicate, Shard, distribute_tensor

    from repro_torch.launch.mesh import init_distributed, make_device_mesh
    from repro_torch.sharding import write_at
    init_distributed("cpu", "file://" + str(out / "rendezvous-write"))
    dm = make_device_mesh(1, 2, device="cpu").device_mesh
    res = {}
    for mode in ("plain", "inference_mode"):
        ctx = torch.inference_mode() if mode == "inference_mode" else \
            torch.no_grad()
        with ctx:
            t = distribute_tensor(torch.zeros(2, 8, 3), dm,
                                  [Replicate(), Shard(1)])
            for pos, val in ((1, 1.0), (6, 2.0)):
                v = distribute_tensor(torch.full((2, 3), val), dm,
                                      [Replicate(), Shard(1)])
                write_at(t, 1, pos, v)
        res[mode] = t.to_local().tolist()
    (out / f"write_r{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The reference's sharded side (its own process: 4 host devices)
# ---------------------------------------------------------------------------
def ref_side(out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding

    from repro.ckpt import load_pytree as ref_load
    from repro.launch.dryrun import build_step as ref_build_step
    from repro.models import api as R
    from repro.models.config import ShapeCell
    from repro.serve.engine import ServeEngine as RServe
    from repro.sharding import use_mesh

    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    put = lambda tree, specs: jax.tree.map(
        lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)), tree,
        specs)
    res = {}
    for fam in FAMILIES:
        cfg = ref_cfg(fam)
        params0 = jax.tree.map(jnp.asarray, ref_load(
            str(out / "params" / fam))[0]["params"])
        r = res[fam] = {}
        tb = {k: jnp.asarray(v) for k, v in train_batch(cfg).items()}
        for where in ("one", "sharded"):
            tag = "" if where == "sharded" else "one_"
            try:
                with use_mesh(mesh) if where == "sharded" else \
                        _nullcontext():
                    params = (put(params0, R.pspecs(cfg, mesh))
                              if where == "sharded" else params0)
                    if fam in TRAINED:
                        (loss, _), grads = jax.jit(jax.value_and_grad(
                            lambda p, b: R.loss_fn(cfg, p, b),
                            has_aux=True))(params, tb)
                        r[tag + "loss"] = float(loss)
                        _save_np(out / f"ref_{tag}grads_{fam}.npz",
                                 _jflat(grads))
                    logits = _ref_serve(cfg, params, mesh if where ==
                                        "sharded" else None, ref_build_step,
                                        ShapeCell, RServe, put, R)
                    _save_np(out / f"ref_{tag}logits_{fam}.npz",
                             {str(i): x for i, x in enumerate(logits)})
            except Exception as e:   # recorded: the test says what it holds
                r[tag + "error"] = f"{type(e).__name__}: {e}"[:500]
    (out / "ref.json").write_text(json.dumps(res))


def _nullcontext():
    import contextlib
    return contextlib.nullcontext()


def _ref_serve(cfg, params, mesh, build_step, ShapeCell, RServe, put, R):
    """The reference's prefill and STEPS decode steps: on a mesh its
    ``build_step`` steps (arguments placed by their ``in_shardings``),
    else the same functions jitted on one device."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec
    batch = {k: jnp.asarray(v) for k, v in
             dict(tokens=prompts(cfg), **extras(cfg)).items()}
    if mesh is None:
        prefill = jax.jit(lambda p, b: R.prefill(cfg, p, b))
        decode = jax.jit(lambda p, t, c, i: R.decode(cfg, p, t, c, i))
    else:
        prefill, _ = build_step(cfg, ShapeCell("p", P, B, "prefill"), mesh)
        decode, _ = build_step(cfg, ShapeCell("d", MAX_SEQ, B, "decode"),
                               mesh)
        shard = lambda x, *axes: jax.device_put(x, NamedSharding(
            mesh, PartitionSpec(*axes)))
        batch = {k: shard(v, "data") for k, v in batch.items()}
    logits, cache = prefill(params, batch)
    out = [np.asarray(logits, np.float32)]
    cache = RServe(cfg, params, B, MAX_SEQ)._grow_cache(cache, P)
    feed = forced(cfg)
    for i in range(STEPS):
        tok = jnp.asarray(feed[:, i:i + 1])
        if mesh is not None:
            # each step's arguments as the step's in_shardings place them
            tok = shard(tok, "data")
            cache = put(cache, R.cache_pspecs(cfg, B, MAX_SEQ, mesh))
        logits, cache = decode(params, tok, cache, jnp.int32(P + i))
        out.append(np.asarray(logits[:, -1], np.float32))
    return out


def _jflat(tree):
    import jax
    return {".".join(str(getattr(k, "key", k)) for k in path):
            np.asarray(v, np.float32) for path, v in
            jax.tree_util.tree_flatten_with_path(tree)[0]}


# ---------------------------------------------------------------------------
# The tests: one fixture runs every side at once
# ---------------------------------------------------------------------------
def _start(argv, log, **env):
    with open(log, "w") as f:
        return subprocess.Popen(argv, cwd=ROOT, stdout=f, stderr=f,
                                env=dict(os.environ, PYTHONPATH=str(
                                    ROOT / "src"), OMP_NUM_THREADS="1",
                                         **env))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax
    import jax.numpy as jnp

    from repro.ckpt import save_pytree as ref_save
    from repro.models import api as R

    out = tmp_path_factory.mktemp("families")
    for fam in FAMILIES:
        rparams = R.init(ref_cfg(fam), jax.random.PRNGKey(0))
        if fam == "vlm":
            cross = dict(rparams["cross_blocks"])
            cross["gate_attn"] = jnp.full_like(cross["gate_attn"], VLM_GATE)
            rparams = dict(rparams, cross_blocks=cross)
        ref_save({"params": rparams}, str(out / "params" / fam), 0)
    me = str(Path(__file__).resolve())
    procs = {"ref": _start([sys.executable, me, "ref", str(out)],
                           out / "ref.log", JAX_PLATFORMS="cpu",
                           XLA_FLAGS="--xla_force_host_platform_device_"
                                     "count=4")}
    for shape, (d, m) in MESHES.items():
        for r in range(d * m):
            procs[f"{shape}/{r}"] = _start(
                [sys.executable, me, "port", shape, str(r), str(out)],
                out / f"port-{shape}-{r}.log")
    for r in range(2):
        procs[f"write/{r}"] = _start(
            [sys.executable, me, "write", str(r), str(out)],
            out / f"write-{r}.log")
    end = time.monotonic() + DEADLINE_S
    for p in procs.values():
        try:
            p.wait(timeout=max(1.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    logs = {k: (out / ("ref.log" if k == "ref" else
                       "%s-%s.log" % tuple(k.split("/")) if
                       k.startswith("write") else
                       "port-%s-%s.log" % tuple(k.split("/"))))
            .read_text()[-4000:] for k in procs}

    def result(name):
        for k, p in procs.items():
            if k.startswith(name + "/") or k == name:
                assert p.returncode == 0, (k, logs[k])
        if name == "ref":
            return json.loads((out / "ref.json").read_text())
        if name == "write":
            return [json.loads((out / f"write_r{r}.json").read_text())
                    for r in range(2)]
        return json.loads((out / name / "result.json").read_text())

    return {"out": out, "result": result}


def _logits(path):
    got = _load_np(path)
    return [got[str(i)] for i in range(len(got))]


def _max_diff(got, want, vocab):
    return max(float(np.abs(g[..., :vocab] - w[..., :vocab]).max())
               for g, w in zip(got, want))


def _ref_names(runs, fam, what):
    """The reference's sharded result file for ``what`` (grads or
    logits), or its one-device file where its sharded side raised for
    this family on this JAX (the error is kept in ref.json)."""
    ref = runs["result"]("ref")[fam]
    out = runs["out"]
    if "error" in ref:
        return out / f"ref_one_{what}_{fam}.npz", ref.get("one_loss")
    return out / f"ref_{what}_{fam}.npz", ref.get("loss")


@pytest.mark.parametrize("against", ["ref_sharded", "port_one"])
@pytest.mark.parametrize("fam", TRAINED)
def test_loss_and_grads_on_2x2_match(runs, fam, against):
    res = runs["result"]("2x2")[fam]
    grads = _load_np(runs["out"] / "2x2" / f"grads_{fam}.npz")
    if against == "ref_sharded":
        path, want_loss = _ref_names(runs, fam, "grads")
        want = _load_np(path)
    else:
        want_loss = runs["result"]("1x1")[fam]["one"]["loss"]
        want = _load_np(runs["out"] / "1x1" / f"one_grads_{fam}.npz")
    assert abs(res["loss"] - want_loss) < LOSS_TOL, (res["loss"], want_loss)
    assert set(grads) == set(want)
    spread = _ref_spread(runs, fam)
    for k, w in want.items():
        err = _rel(grads[k], w)
        assert err < max(GRAD_TOL, SPREAD_FACTOR * spread.get(k, 0.0)), \
            (k, err, spread.get(k))


def _rel(got, want):
    return float(np.abs(got - want).max()) / max(float(np.abs(want).max()),
                                                  1e-12)


def _ref_spread(runs, fam):
    """{leaf: the reference's sharded gradient's gap to its one-device
    one, as ``_rel`` measures it} (empty where its sharded side raised)."""
    out = runs["out"]
    if "error" in runs["result"]("ref")[fam]:
        return {}
    one = _load_np(out / f"ref_one_grads_{fam}.npz")
    return {k: _rel(g, one[k]) for k, g in
            _load_np(out / f"ref_grads_{fam}.npz").items()}


@pytest.mark.parametrize("against", ["ref_sharded", "port_one"])
@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_prefill_and_decode_on_2x2_match(runs, fam, against):
    vocab = port_cfg(fam).vocab
    runs["result"]("2x2")
    got = _logits(runs["out"] / "2x2" / f"logits_{fam}.npz")
    if against == "ref_sharded":
        want = _logits(_ref_names(runs, fam, "logits")[0])
    else:
        runs["result"]("1x1")
        want = _logits(runs["out"] / "1x1" / f"one_logits_{fam}.npz")
    assert len(got) == len(want) == STEPS + 1
    assert all(np.isfinite(g[..., :vocab]).all() for g in got)
    d = _max_diff(got, want, vocab)
    assert d < LOGIT_TOL, f"{fam}: logits differ by {d}"


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_serve_engine_on_2x2_agrees_with_one_device(runs, fam):
    res = runs["result"]("2x2")[fam]
    got = np.asarray(res["gen"])
    assert got.shape == (B, STEPS + 1)
    assert len(res["margins"]) == STEPS + 1
    assert max(res["margins"]) < 2 * LOGIT_TOL, res["margins"]


def _ref_cache_local_shapes(fam):
    """Each cache leaf's block shape under the reference's partition on a
    2x2 mesh."""
    import jax
    from jax.sharding import AbstractMesh, PartitionSpec

    from repro.models import api as R
    cfg = ref_cfg(fam)
    amesh = AbstractMesh((2, 2), ("data", "model"))
    specs = _flat(R.cache_pspecs(cfg, B, MAX_SEQ, amesh), PartitionSpec)
    shapes = {k: list(v.shape) for k, v in
              _flat(R.abstract_cache(cfg, B, MAX_SEQ)).items()}
    return {k: _local_shape(shapes[k], tuple(specs[k])) for k in shapes}


def _flat(tree, leaf_type=None):
    import jax
    return {".".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=(lambda x: isinstance(x, leaf_type))
                if leaf_type else None)[0]}


def _local_shape(shape, spec, sizes=(("data", 2), ("model", 2))):
    sizes = dict(sizes)
    out = list(shape)
    for d, ent in enumerate(spec):
        for a in ((ent,) if isinstance(ent, str) else ent or ()):
            out[d] //= sizes[a]
    return out


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_the_cache_after_four_steps(runs, fam):
    """Each new position is written on the rank whose block holds it and
    equals one device's; every position past the last index is exactly
    zero; each block has the reference's local shape."""
    from repro_torch.models import api
    from repro_torch.models.common import tree_items
    res = runs["result"]("2x2")[fam]
    runs["result"]("1x1")
    one = _load_np(runs["out"] / "1x1" / f"one_cache_{fam}.npz")
    want_shapes = _ref_cache_local_shapes(fam)
    axes = {p: d.axes for p, d in tree_items(api.cache_schema(
        port_cfg(fam), B, MAX_SEQ))}
    seen = {}
    for rank, offsets in enumerate(res["offsets"]):
        blocks = _load_np(runs["out"] / "2x2" / f"cache_{fam}_r{rank}.npz")
        assert set(blocks) == set(one) == set(want_shapes)
        for path, blk in blocks.items():
            assert list(blk.shape) == want_shapes[path], (path, rank)
            lo = offsets[path]
            want = one[path][tuple(slice(o, o + n)
                                   for o, n in zip(lo, blk.shape))]
            tol = CACHE_TOL * max(1.0, float(np.abs(one[path]).max()))
            if "kv_seq" not in axes[path]:
                assert float(np.abs(blk - want).max()) < tol, (path, rank)
                continue
            ax = axes[path].index("kv_seq")
            for j in range(blk.shape[ax]):
                pos = lo[ax] + j
                g, w = np.take(blk, j, ax), np.take(want, j, ax)
                if pos >= P + STEPS:
                    assert not g.any(), (path, rank, pos, "not zero")
                    continue
                assert float(np.abs(g - w).max()) < tol, (path, rank, pos)
                if pos >= P:
                    assert g.any() == w.any(), (path, rank, pos, "lost")
                    seen.setdefault(path, set()).add((pos, rank))
    # the new positions straddle the two blocks of "model": each written
    # on the ranks that hold it (one per "data" row block)
    for path, got in seen.items():
        owners = {pos: {r for p, r in got if p == pos} for pos, _ in got}
        assert sorted(owners) == list(range(P, P + STEPS)), path
        assert len({frozenset(v) for v in owners.values()}) == 2, path


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_a_decode_step_gathers_no_cache_leaf(runs, fam):
    coll = runs["result"]("2x2")[fam]["collectives"]
    assert coll["calls"], "a decode step on 2x2 ran no collective"
    gathers = [s for s in coll["shapes"] if s[0].startswith("all_gather")]
    assert not any(MAX_SEQ in shape for s in gathers for shape in s[1:]), \
        gathers


@pytest.mark.parametrize("fam", ("dense", "encdec"))
def test_serving_looks_up_the_embedding_where_it_lies(runs, fam):
    """Outside autograd each rank looks the tokens up in its own block of
    the table (``sharding.lookup``): the rows are the plain table's, bit
    for bit, and the collectives move a small part of one block (taking
    the table whole moves three blocks to each rank)."""
    got = runs["result"]("2x2")["lookup"][fam]
    assert got["equal"]
    assert got["moved"] < got["table"] / 16, got


@pytest.mark.parametrize("fam", sorted(FAMILIES))
def test_one_by_one_mesh_is_one_device_bit_for_bit(runs, fam):
    res = runs["result"]("1x1")[fam]
    here = runs["out"] / "1x1"
    if fam in TRAINED:
        assert res["loss"] == res["one"]["loss"]
        got = _load_np(here / f"grads_{fam}.npz")
        want = _load_np(here / f"one_grads_{fam}.npz")
        assert set(got) == set(want)
        for k, w in want.items():
            np.testing.assert_array_equal(got[k], w, err_msg=k)
    for g, w in zip(_logits(here / f"logits_{fam}.npz"),
                    _logits(here / f"one_logits_{fam}.npz")):
        np.testing.assert_array_equal(g, w)
    assert res["gen"] == res["one"]["gen"]
    blocks = _load_np(here / f"cache_{fam}_r0.npz")
    one = _load_np(here / f"one_cache_{fam}.npz")
    assert set(blocks) == set(one)
    for k, w in one.items():
        np.testing.assert_array_equal(blocks[k], w, err_msg=k)


@pytest.mark.parametrize("mode", ["plain", "inference_mode"])
def test_a_write_reaches_the_owner_block(runs, mode):
    got = [np.asarray(r[mode]) for r in runs["result"]("write")]
    want = np.zeros((2, 8, 3))
    want[:, 1], want[:, 6] = 1.0, 2.0
    np.testing.assert_array_equal(got[0], want[:, :4])
    np.testing.assert_array_equal(got[1], want[:, 4:])


def _ref_step_local_shapes(kind):
    """The reference's local shape of every argument leaf of its
    ``build_step`` cell on a 2x2 mesh, keyed as ``build_step_cases``
    keys them."""
    import jax
    from jax.sharding import AbstractMesh, PartitionSpec

    from repro.configs import get_smoke as ref_smoke
    from repro.launch.specs import input_shardings, input_specs
    from repro.models import api as R
    from repro.models.config import ShapeCell
    from repro.train import make_train_step, opt_state_pspecs
    cfg = ref_smoke(STEP_ARCH)
    amesh = AbstractMesh((2, 2), ("data", "model"))
    seq, k = STEP_CELLS[kind]
    cell = ShapeCell(kind, seq, B, k)
    pspec = R.pspecs(cfg, amesh)
    shapes = {"0." + p: (list(v.shape), tuple(_flat(pspec, PartitionSpec)
                                             [p]))
              for p, v in _flat(R.abstract(cfg)).items()}
    specs = input_specs(cfg, cell)
    shard = input_shardings(cfg, cell, amesh)
    if k in ("train", "prefill"):
        at = 2 if k == "train" else 1
        for name, v in specs["batch"].items():
            shapes[f"{at}.{name}"] = (list(v.shape),
                                      tuple(shard["batch"][name].spec))
    if k == "train":
        step = make_train_step(cfg, params_pspecs=pspec)
        state = jax.eval_shape(step.init_state, R.abstract(cfg))
        ospec = _flat(opt_state_pspecs(cfg, pspec), PartitionSpec)
        for p, v in _flat(state).items():
            shapes["1." + p] = (list(v.shape), tuple(ospec.get(p, ())))
    if k == "decode":
        shapes["1.x"] = (list(specs["token"].shape),
                         tuple(shard["token"].spec))
        cspec = _flat(shard["cache"], PartitionSpec)
        for p, v in _flat(specs["cache"]).items():
            shapes["2." + p] = (list(v.shape), tuple(cspec[p]))
    return {p: _local_shape(s, sp) for p, (s, sp) in shapes.items()}


@pytest.mark.parametrize("kind", list(STEP_CELLS))
def test_build_step_places_and_runs_on_2x2(runs, kind):
    got = runs["result"]("2x2")["build_step"][kind]
    want = _ref_step_local_shapes(kind)
    local = {p: s for p, (s, _) in got["local"].items()}
    assert local == want
    # every leaf with a dim is placed (the optimizer's step count, a
    # 0-dim tensor, stays plain, the same on every rank)
    assert all(is_placed for shape, is_placed in got["local"].values()
               if shape)
    assert got["finite"]


@pytest.mark.parametrize("where", ["one_device", "2x2"])
def test_the_vlm_cross_path_reaches_the_outputs(runs, where):
    """llama-3.2-vision with its gates at 0.5 against the reference: the
    prefill logits, STEPS decode steps and the loss, on one device and on
    the 2x2 mesh (the gated cross layers enter only through tanh(gate),
    zero at init)."""
    vocab = port_cfg("vlm").vocab
    out = runs["out"]
    ref = runs["result"]("ref")["vlm"]
    if where == "one_device":
        res = runs["result"]("1x1")["vlm"]["one"]
        got = _logits(out / "1x1" / "one_logits_vlm.npz")
        loss = res["loss"]
        want, want_loss = _logits(out / "ref_one_logits_vlm.npz"), \
            ref["one_loss"]
    else:
        loss = runs["result"]("2x2")["vlm"]["loss"]
        got = _logits(out / "2x2" / "logits_vlm.npz")
        path, want_loss = _ref_names(runs, "vlm", "logits")
        want = _logits(path)
    assert abs(loss - want_loss) < LOSS_TOL, (loss, want_loss)
    assert _max_diff(got, want, vocab) < LOGIT_TOL


def test_remat_recomputes_under_the_forward_mesh(runs):
    """A remat layer recomputed on another thread (autograd's device
    thread on the card) gives the same gradients, bit for bit."""
    assert runs["result"]("2x2")["remat_off_thread"] is True


def test_the_mesh_families():
    """All eight families run on a mesh: the six here and the two MoE
    families (``test_torch_mesh_moe.py``); nothing is left to do."""
    from repro_torch.models import api
    assert set(api.MESH_FAMILIES) == {port_cfg(f).family for f in FAMILIES
                                      } | {"moe", "mla_moe"}
    assert len(api.MESH_FAMILIES) == 8
    assert not hasattr(api, "_MESH_TODO")


if __name__ == "__main__":
    if sys.argv[1] == "port":
        port_rank(sys.argv[2], int(sys.argv[3]), Path(sys.argv[4]))
    elif sys.argv[1] == "write":
        write_rank(int(sys.argv[2]), Path(sys.argv[3]))
    else:
        ref_side(Path(sys.argv[2]))
    sys.exit(0)
