"""The two MoE families (qwen3-moe, deepseek-v3) on a (data x model) mesh
on the port: the expert-parallel ``moe_apply``, training, prefill and
decode on placed experts and a placed cache, and Adafactor on placed
leaves, held to the reference's sharded steps and to one device, on the
CPU.

The harness is ``test_torch_mesh_families.py``'s (its helpers are
imported from it): one module fixture starts everything at once and the
tests read what it wrote under ``tmp_path``:

- the port's ranks, each ``python tests/test_torch_mesh_moe.py port SHAPE
  RANK DIR`` (gloo, a ``file://`` rendezvous under ``tmp_path``), on 2x2
  and 1x1 meshes; the 1x1 process also runs every case on one device,
  without a mesh;
- the reference's side, ``... ref DIR``, with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and a 2x2 mesh of
  ``AxisType.Auto`` axes: its ``shard_map`` EP ``moe_apply`` and its local
  oracle (no mesh), each family's loss and gradients, and its
  ``launch.dryrun.build_step`` prefill and decode steps, sharded and on
  one device (the port's 2x2 ranks also run their own ``build_step``
  cells);
- the launcher, ``python -m repro_torch.launch.train --mesh 2x2`` on
  qwen3-moe SMOKE.

Every side starts from the reference's seed-0 parameters (its checkpoint;
for the layer cases its ``moe_schema`` init, saved as arrays).

The layer cases (``MOE_CASES``) run qwen3-moe SMOKE's MoE layer on tokens
of shape ``(batch, LAYER_SEQ, d)``; each gives the output, the aux loss
and the gradients of ``sum(out * R) + aux`` (R a fixed f32 array) in the
parameters and the tokens.  Tolerances: bf16 outputs within MOE_BF16_TOL
(the reference's own EP-vs-oracle bound, ``tests/test_dryrun_small.py``),
the aux loss within AUX_TOL (the same test's), f32 outputs within
MOE_F32_TOL and f32 gradients within MOE_GRAD_F32_TOL of each leaf's
largest entry (f32 sums in another order).  Where capacity drops rows
(``capacity_factor`` 0.5) the port is held to the reference's EP path
alone, which parts from the oracle there.

The families' loss, gradients, logits, cache and ServeEngine tokens are
held with ``test_torch_mesh_families.py``'s tolerances (LOSS_TOL,
GRAD_TOL, SPREAD_FACTOR, LOGIT_TOL, CACHE_TOL); a bf16 gradient's spread
is the larger of the reference's own sharded-to-one-device gap and the
two packages' one-device gap (routing is discontinuous: ``_spread``), and
the same step with f32 parameters, where no rounding reorders the
routing, holds every gradient to F32_GRAD_TOL.  Adafactor's three steps
on 2x2 are held to one device's: losses within STEP_TOL, the gradient
norm within NORM_TOL of its size, every parameter within PARAM_TOL (an
Adafactor step moves one by about lr, as an Adam step does:
``test_torch_mesh_train.py``'s).  One ``adafactor_update`` of seeded f32
gradients and state, distributed on 2x2 from the same arrays as one
device's, is held to one device's at f32 rounding (UPDATE_TOL,
FACTOR_ULP): a mean or RMS taken over one rank's block alone fails it.
The 1x1 mesh is exact.
"""
import contextlib
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import test_torch_mesh_families as fam  # noqa: E402  (the shared harness)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = {"moe": "qwen3-moe-30b-a3b", "mla_moe": "deepseek-v3-671b"}
B, P, STEPS, SEQ, MAX_SEQ = fam.B, fam.P, fam.STEPS, fam.SEQ, fam.MAX_SEQ
LOSS_TOL, GRAD_TOL, SPREAD_FACTOR = fam.LOSS_TOL, fam.GRAD_TOL, \
    fam.SPREAD_FACTOR
LOGIT_TOL, CACHE_TOL = fam.LOGIT_TOL, fam.CACHE_TOL
MOE_BF16_TOL = 0.15
AUX_TOL = 1e-5
MOE_F32_TOL = 1e-5
MOE_GRAD_F32_TOL = 1e-4
F32_LOSS_TOL = 1e-4
F32_GRAD_TOL = 1e-2
STEP_TOL = 2e-3
NORM_TOL = 1e-2
PARAM_TOL = 1e-2
LR = 1e-3
OPT_STEPS = 3
#: one ``adafactor_update`` of seeded f32 gradients (N(0, UPDATE_GRAD^2))
#: and a seeded state (uniform in UPDATE_STATE, under the gradients'
#: squares, so every leaf's update is clipped to RMS 1 and the update's
#: RMS is reduced over the mesh), the step counter at UPDATE_STEP (so
#: beta2 mixes that state in).  Held to one device's at f32 rounding:
#: each parameter's update within UPDATE_TOL of the leaf's largest (a
#: mean or RMS taken over one rank's block alone moves it by 10 % or
#: more), each factor (stored in bf16) within FACTOR_ULP of its size (one
#: bf16 rounding step), the gradient norm within NORM_F32_TOL
UPDATE_GRAD, UPDATE_STATE = 1e-2, (1e-6, 1e-5)
UPDATE_STEP, UPDATE_LR = 9, 0.1
UPDATE_TOL = 1e-5
FACTOR_ULP = 2.0 ** -7
NORM_F32_TOL = 1e-6
#: a threshold under which most of deepseek SMOKE's stacked leaves update
#: slice by slice (the default, 2**27 elements, chunks only FULL leaves)
SMALL_CHUNK = 1 << 12
LAYER_SEQ = 16
#: the MoE layer cases: qwen3-moe SMOKE's config fields and the token
#: batch.  "c_rows" splits the flattened rows of one sequence over "data"
#: (its batch of 1 does not split)
MOE_CASES = {
    "a": ({"capacity_factor": 2.0}, B),
    "b": ({"capacity_factor": 2.0, "ep_over_data": True}, B),
    "c": ({"capacity_factor": 0.5}, B),
    "c_ep_over_data": ({"capacity_factor": 0.5, "ep_over_data": True}, B),
    "c_rows": ({"capacity_factor": 0.5}, 1),
    "d": ({"ep_over_data": True, "n_experts": 6}, B),
}
#: the cases where capacity drops rows (held to the reference's EP path)
DROPS = ("c", "c_ep_over_data", "c_rows")
DTYPES = ("bf16", "f32")
DEADLINE_S = 600
MESHES = {"2x2": (2, 2), "1x1": (1, 1)}
LAYER_LEAVES = ("x", "router", "w_in", "w_out")


def port_cfg(arch):
    from repro_torch.configs import get_smoke
    return get_smoke(ARCHS[arch])


def ref_cfg(arch):
    from repro.configs import get_smoke
    return get_smoke(ARCHS[arch])


def layer_cfg(case, get_smoke):
    return get_smoke(ARCHS["moe"]).replace(**MOE_CASES[case][0])


def layer_inputs(out, case, dtype):
    """{"x", "r", "router", "w_in", "w_out"} as numpy f32 arrays (bf16
    values unless ``dtype`` is f32): the reference's seed-0 layer
    parameters (saved by the fixture) and seeded tokens."""
    e = MOE_CASES[case][0].get("n_experts", 8)
    arrays = fam._load_np(out / f"layer_params_e{e}.npz")
    rng = np.random.default_rng(3)
    b = MOE_CASES[case][1]
    d = arrays["w_in"].shape[1]
    arrays["x"] = rng.standard_normal((b, LAYER_SEQ, d)).astype(np.float32)
    arrays["r"] = rng.standard_normal((b, LAYER_SEQ, d)).astype(np.float32)
    if dtype == "bf16":
        for k in ("x", "w_in", "w_out"):
            arrays[k] = _bf16_round(arrays[k])
    return arrays


def _bf16_round(a):
    return torch.from_numpy(a).to(torch.bfloat16).float().numpy()


# ---------------------------------------------------------------------------
# The port's ranks (no JAX here)
# ---------------------------------------------------------------------------
def port_layer(case, dtype, arrays, mesh):
    """The port's ``moe_apply`` on ``arrays``: (out, aux, {leaf: grad}),
    whole, as float32 numpy."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import moe
    from repro_torch.models.common import param_pspecs
    from repro_torch.sharding import (NamedSharding, distribute,
                                      named_sharding, replicate_plain,
                                      use_mesh)
    cfg = layer_cfg(case, get_smoke)
    dt = torch.bfloat16 if dtype == "bf16" else torch.float32
    specs = param_pspecs(moe.moe_schema(cfg, 0), mesh)
    leaves = {}
    for k in LAYER_LEAVES:
        t = torch.from_numpy(arrays[k]).to(torch.float32 if k == "router"
                                           else dt)
        if mesh is not None:
            t = distribute(t, NamedSharding(mesh, specs[k]) if k in specs
                           else named_sharding(t.shape, ("batch", "seq",
                                                         None), mesh))
        leaves[k] = t.detach().requires_grad_()
    r = torch.from_numpy(arrays["r"])
    if mesh is not None:
        r = distribute(r, named_sharding(r.shape, ("batch", "seq", None),
                                         mesh))
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext(), \
            torch.enable_grad(), replicate_plain():
        y, aux = moe.moe_apply(cfg, {k: leaves[k] for k in LAYER_LEAVES[1:]},
                               leaves["x"])
        loss = (y.float() * r).sum() + aux
        grads = torch.autograd.grad(loss, [leaves[k] for k in LAYER_LEAVES])
    return (fam._whole(y.detach()), float(fam._whole(aux.detach())),
            {k: fam._whole(g) for k, g in zip(LAYER_LEAVES, grads)})


def layer_cases(out, mesh, here, rank0, one_device):
    """Every layer case on ``mesh`` (rank 0 writes them), and on one
    device where ``one_device``."""
    res = {}
    for case in MOE_CASES:
        for dtype in DTYPES:
            arrays = layer_inputs(out, case, dtype)
            tag = f"{case}_{dtype}"
            wheres = (("one", None),) if one_device else ()
            for where, on in wheres + (("mesh", mesh),):
                y, aux, grads = port_layer(case, dtype, arrays, on)
                if rank0:
                    fam._save_np(here / f"layer_{where}_{tag}.npz",
                                 dict(grads, out=y))
                res[f"{where}_{tag}"] = aux
    return res


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
    one = shape == "1x1"
    res = {"layer": layer_cases(out, mesh, here, rank0, one)}
    for arch in ARCHS:
        cfg = port_cfg(arch)
        src = str(out / "params" / arch)
        r = res[arch] = {}
        if one:
            # one device, no mesh: what every mesh run is held to
            plain = load_pytree(src)[0]["params"]
            o = {}
            o["loss"], grads = fam.port_train(cfg, plain, None)
            fam._save_np(here / f"one_grads_{arch}.npz", grads)
            o["f32_loss"], grads = fam.port_train(cfg, _f32(plain), None)
            fam._save_np(here / f"one_f32_grads_{arch}.npz", grads)
            o["gen"], logits, cache, _ = fam.port_serve(cfg, plain, None)
            o["gen"] = o["gen"].tolist()
            fam._save_np(here / f"one_logits_{arch}.npz",
                         {str(i): x for i, x in enumerate(logits)})
            fam._save_np(here / f"one_cache_{arch}.npz",
                         {p: t.float().numpy() for p, t in tree_items(cache)})
            r["one"] = o
        with use_mesh(mesh):
            params = load_pytree(src, shardings={"params": fam._named(
                api.pspecs(cfg, mesh), mesh)})[0]["params"]
            r["loss"], grads = fam.port_train(cfg, params, mesh)
            if rank0:
                fam._save_np(here / f"grads_{arch}.npz", grads)
            r["f32_loss"], grads = fam.port_train(cfg, _f32(params), mesh)
            if rank0:
                fam._save_np(here / f"f32_grads_{arch}.npz", grads)
            gen, logits, cache, coll = fam.port_serve(cfg, params, mesh,
                                                      counted=True)
        r["gen"], r["collectives"] = gen.tolist(), coll
        if rank0:
            r["margins"] = fam.engine_margins(
                cfg, load_pytree(src)[0]["params"], gen)
        blocks, offsets = fam._blocks(cache)
        fam._save_np(here / f"cache_{arch}_r{rank}.npz", blocks)
        got = [None] * dist.get_world_size()
        dist.all_gather_object(got, offsets)
        r["offsets"] = got
        if rank0:
            fam._save_np(here / f"logits_{arch}.npz",
                         {str(i): x for i, x in enumerate(logits)})
    res["adafactor"] = adafactor_cases(out, mesh, here, rank0, one)
    update_cases(out, mesh, here, rank0, one)
    if shape == "2x2":
        res["build_step"] = build_step_cases(mesh)
    if rank0:
        (here / "result.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def _f32(params):
    """Every parameter leaf in f32 (placed as it was)."""
    from repro_torch.models.common import tree_map
    return tree_map(lambda t: t.float(), params)


def build_step_cases(mesh):
    """``launch.dryrun.build_step`` on the device mesh with real arguments
    for both families (deepseek-v3 with Adafactor): whether every
    argument leaf with a dim is placed, and whether the step ran to
    finite results."""
    from repro_torch.launch.dryrun import build_step
    from repro_torch.models.common import tree_items
    from repro_torch.models.config import ShapeCell
    from repro_torch.sharding import placed, use_mesh
    out = {}
    for arch in ARCHS:
        cfg = port_cfg(arch)
        if arch == "mla_moe":
            cfg = cfg.replace(optimizer="adafactor")
        for kind, (seq, k) in fam.STEP_CELLS.items():
            with use_mesh(mesh):
                fn, args = build_step(cfg, ShapeCell(kind, seq, B, k), mesh,
                                      device="cpu")
            leaves = [t for a in args if not isinstance(a, int)
                      for _, t in tree_items(a if isinstance(a, dict)
                                             else {"x": a})]
            with torch.no_grad() if kind != "train" else \
                    torch.enable_grad():
                res = fn(*args)
            got = [t for r in (res if isinstance(res, tuple) else (res,))
                   for t in (r.values() if isinstance(r, dict) else [r])
                   if isinstance(t, torch.Tensor)]
            out[f"{arch}/{kind}"] = {
                "placed": all(placed(t) for t in leaves if t.dim()),
                "finite": all(bool(torch.isfinite(fam._as_whole(t)).all())
                              for t in got if t.is_floating_point())}
    return out


def opt_tokens(cfg, i):
    """Adafactor step ``i``'s global batch (every side builds the same)."""
    rng = np.random.default_rng(200 + i)
    return rng.integers(0, cfg.vocab, (B, SEQ + 1)).astype(np.int32)


def adafactor_run(cfg, src, mesh):
    """OPT_STEPS Adafactor steps from the checkpoint ``src``: (metrics
    per step, the parameters whole, the state's placements as
    ``opt_state_pspecs`` gives them or not)."""
    from repro_torch.ckpt import load_pytree
    from repro_torch.models import api
    from repro_torch.models.common import tree_items
    from repro_torch.sharding import placed, placements, use_mesh
    from repro_torch.train import make_train_step, opt_state_pspecs
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        pspecs = None if mesh is None else api.pspecs(cfg, mesh)
        params = load_pytree(src, shardings=None if mesh is None else {
            "params": fam._named(pspecs, mesh)})[0]["params"]
        step = make_train_step(cfg, lr=LR, params_pspecs=pspecs)
        state = step.init_state(params)
        as_specs = True
        if mesh is not None:
            want = dict(tree_items(opt_state_pspecs(cfg, pspecs, mesh=mesh)))
            as_specs = all(
                tuple(t.placements) == placements(want[p], mesh)
                for p, t in tree_items(state) if placed(t))
            as_specs &= all(placed(t) for p, t in tree_items(state)
                            if t.dim())
        hist = []
        for i in range(OPT_STEPS):
            batch = {"tokens": torch.from_numpy(opt_tokens(cfg, i)).long()}
            params, state, m = step(params, state, batch)
            hist.append({k: float(v) for k, v in m.items()})
        whole = {p: fam._whole(t) for p, t in tree_items(params)}
    return hist, whole, as_specs


def adafactor_cases(out, mesh, here, rank0, one_device):
    """deepseek-v3 SMOKE with Adafactor: OPT_STEPS steps on ``mesh`` (and
    on one device where ``one_device``), at the default chunk threshold
    and at SMALL_CHUNK (most stacked leaves then update slice by
    slice)."""
    from repro_torch.train import optimizer
    cfg = port_cfg("mla_moe").replace(optimizer="adafactor")
    src = str(out / "params" / "mla_moe")
    res, default = {}, optimizer._CHUNK_THRESHOLD
    for chunk in ("default", "small"):
        optimizer._CHUNK_THRESHOLD = default if chunk == "default" \
            else SMALL_CHUNK
        try:
            wheres = (("one", None),) if one_device else ()
            for where, on in wheres + (("mesh", mesh),):
                hist, whole, as_specs = adafactor_run(cfg, src, on)
                if rank0:
                    fam._save_np(here / f"adafactor_{where}_{chunk}.npz",
                                 whole)
                res[f"{where}_{chunk}"] = {"history": hist,
                                           "as_specs": as_specs}
        finally:
            optimizer._CHUNK_THRESHOLD = default
    return res


def update_inputs(params):
    """Seeded f32 gradients ({path: array}) for the leaves of ``params``
    (whole shapes), and a seeded Adafactor state for them ({state path:
    array}): the same on every side."""
    from repro_torch.models.common import tree_items
    from repro_torch.train import optimizer
    rng = np.random.default_rng(11)
    grads, state = {}, {}
    for p, t in tree_items(params):
        grads[p] = (UPDATE_GRAD * rng.standard_normal(tuple(t.shape))) \
            .astype(np.float32)
        shapes = {"vr": t.shape[:-1], "vc": t.shape[:-2] + t.shape[-1:]} \
            if optimizer._factored(t) else {"v": t.shape}
        for k, shape in shapes.items():
            state[f"{p}.{k}"] = rng.uniform(*UPDATE_STATE, tuple(shape)) \
                .astype(np.float32)
    return grads, state


def update_run(src, mesh, cfg):
    """One ``adafactor_update`` of the f32 checkpoint ``src`` (placed by
    ``api.pspecs`` on ``mesh``) with :func:`update_inputs`' gradients and
    state, the step counter at UPDATE_STEP: the parameters before and
    after, the state after and the gradient norm, whole."""
    from torch.distributed.tensor import distribute_tensor

    from repro_torch.ckpt import load_pytree
    from repro_torch.models import api
    from repro_torch.models.common import tree_from_items, tree_items
    from repro_torch.sharding import NamedSharding, distribute, placed, \
        use_mesh
    from repro_torch.train import optimizer
    with use_mesh(mesh) if mesh is not None else contextlib.nullcontext():
        pspecs = None if mesh is None else api.pspecs(cfg, mesh)
        params = _f32(load_pytree(src, shardings=None if mesh is None else {
            "params": fam._named(pspecs, mesh)})[0]["params"])
        g_np, s_np = update_inputs(params)
        specs = dict(tree_items(pspecs)) if mesh is not None else {}
        grads = tree_from_items(
            (p, torch.from_numpy(g) if mesh is None else distribute(
                torch.from_numpy(g), NamedSharding(mesh, specs[p])))
            for p, g in g_np.items())
        state = optimizer.adafactor_init(params)
        seeded = []
        for p, t in tree_items(state["f"]):
            a = torch.from_numpy(s_np[p]).to(t.dtype)
            seeded.append((p, distribute_tensor(a, t.device_mesh,
                                                t.placements)
                           if placed(t) else a))
        state["f"] = tree_from_items(seeded)
        state["step"].fill_(UPDATE_STEP)
        before = {f"before.{p}": fam._whole(t).copy()   # updated in place
                  for p, t in tree_items(params)}
        params, state, norm = optimizer.adafactor_update(
            grads, state, params, UPDATE_LR)
        out = dict(before, **{f"param.{p}": fam._whole(t)
                              for p, t in tree_items(params)},
                   **{f"state.{p}": fam._whole(t)
                      for p, t in tree_items(state["f"])})
        out["norm"] = np.asarray(float(fam._as_whole(norm)))
    return out


def update_cases(out, mesh, here, rank0, one_device):
    """:func:`update_run` of deepseek-v3 SMOKE on ``mesh`` (and on one
    device where ``one_device``) at the default chunk threshold and at
    SMALL_CHUNK; rank 0 writes them."""
    from repro_torch.train import optimizer
    cfg = port_cfg("mla_moe").replace(optimizer="adafactor")
    src = str(out / "params" / "mla_moe")
    default = optimizer._CHUNK_THRESHOLD
    for chunk in ("default", "small"):
        optimizer._CHUNK_THRESHOLD = default if chunk == "default" \
            else SMALL_CHUNK
        try:
            wheres = (("one", None),) if one_device else ()
            for where, on in wheres + (("mesh", mesh),):
                got = update_run(src, on, cfg)
                if rank0:
                    fam._save_np(here / f"update_{where}_{chunk}.npz", got)
        finally:
            optimizer._CHUNK_THRESHOLD = default


# ---------------------------------------------------------------------------
# The reference's side (its own process: 4 host devices)
# ---------------------------------------------------------------------------
def ref_layer(case, dtype, arrays, mesh):
    """The reference's ``moe_apply``: its EP path under ``mesh`` (the
    parameters and tokens placed by their partitions), its local oracle
    without one; (out, aux, {leaf: grad}) as float32 numpy."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    from repro.configs import get_smoke
    from repro.models import moe
    from repro.models.common import param_pspecs
    from repro.sharding import use_mesh
    cfg = layer_cfg(case, get_smoke)
    dt = jnp.bfloat16 if dtype == "bf16" else jnp.float32
    leaves = {k: jnp.asarray(arrays[k], jnp.float32 if k == "router" else dt)
              for k in LAYER_LEAVES}
    r = jnp.asarray(arrays["r"])

    def loss(lv):
        y, aux = moe.moe_apply(cfg, {k: lv[k] for k in LAYER_LEAVES[1:]},
                               lv["x"])
        return jnp.sum(y.astype(jnp.float32) * r) + aux, (y, aux)

    fn = jax.jit(jax.grad(loss, has_aux=True))
    if mesh is None:
        grads, (y, aux) = fn(leaves)
    else:
        with use_mesh(mesh):
            specs = param_pspecs(moe.moe_schema(cfg, 0), mesh)
            b = leaves["x"].shape[0]
            specs["x"] = PartitionSpec("data" if b % 2 == 0 else None)
            leaves = {k: jax.device_put(v, NamedSharding(mesh, specs[k]))
                      for k, v in leaves.items()}
            grads, (y, aux) = fn(leaves)
    return (np.asarray(y, np.float32), float(aux),
            {k: np.asarray(g, np.float32) for k, g in grads.items()})


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
    res = {"layer": {}}
    for case in MOE_CASES:
        for dtype in DTYPES:
            arrays = layer_inputs(out, case, dtype)
            for where, on in (("oracle", None), ("ep", mesh)):
                y, aux, grads = ref_layer(case, dtype, arrays, on)
                fam._save_np(out / f"ref_layer_{where}_{case}_{dtype}.npz",
                             dict(grads, out=y))
                res["layer"][f"{where}_{case}_{dtype}"] = aux
    for arch in ARCHS:
        cfg = ref_cfg(arch)
        params0 = jax.tree.map(jnp.asarray, ref_load(
            str(out / "params" / arch))[0]["params"])
        r = res[arch] = {}
        tb = {k: jnp.asarray(v) for k, v in fam.train_batch(cfg).items()}
        for where in ("one", "sharded"):
            tag = "" if where == "sharded" else "one_"
            try:
                with use_mesh(mesh) if where == "sharded" else \
                        fam._nullcontext():
                    params = (put(params0, R.pspecs(cfg, mesh))
                              if where == "sharded" else params0)
                    (loss, _), grads = jax.jit(jax.value_and_grad(
                        lambda p, b: R.loss_fn(cfg, p, b),
                        has_aux=True))(params, tb)
                    r[tag + "loss"] = float(loss)
                    fam._save_np(out / f"ref_{tag}grads_{arch}.npz",
                                 fam._jflat(grads))
                    # f32: the layers as a Python loop (a scan's carry
                    # would go from the bf16 embedding to f32)
                    f32 = cfg.replace(scan_layers=False)
                    (loss, _), grads = jax.jit(jax.value_and_grad(
                        lambda p, b: R.loss_fn(f32, p, b), has_aux=True))(
                        jax.tree.map(lambda a: a.astype(jnp.float32),
                                     params), tb)
                    r[tag + "f32_loss"] = float(loss)
                    fam._save_np(out / f"ref_{tag}f32_grads_{arch}.npz",
                                 fam._jflat(grads))
                    logits = fam._ref_serve(
                        cfg, params, mesh if where == "sharded" else None,
                        ref_build_step, ShapeCell, RServe, put, R)
                    fam._save_np(out / f"ref_{tag}logits_{arch}.npz",
                                 {str(i): x for i, x in enumerate(logits)})
            except Exception as e:   # recorded: the test says what it holds
                r[tag + "error"] = f"{type(e).__name__}: {e}"[:500]
    (out / "ref.json").write_text(json.dumps(res))


# ---------------------------------------------------------------------------
# The tests: one fixture runs every side at once
# ---------------------------------------------------------------------------
@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    import jax

    from repro.ckpt import save_pytree as ref_save
    from repro.configs import get_smoke as ref_smoke
    from repro.models import api as R
    from repro.models import moe as RMoE
    from repro.models.common import init_params as ref_init

    out = tmp_path_factory.mktemp("moe")
    for arch in ARCHS:
        ref_save({"params": R.init(ref_cfg(arch), jax.random.PRNGKey(0))},
                 str(out / "params" / arch), 0)
    for e in (8, 6):
        cfg = ref_smoke(ARCHS["moe"]).replace(n_experts=e)
        fam._save_np(out / f"layer_params_e{e}.npz", {
            k: np.asarray(v, np.float32) for k, v in ref_init(
                RMoE.moe_schema(cfg, 0), jax.random.PRNGKey(0)).items()})
    me = str(Path(__file__).resolve())
    logs = {"ref": out / "ref.log", "cli": out / "cli.log"}
    procs = {"ref": fam._start([sys.executable, me, "ref", str(out)],
                               logs["ref"], JAX_PLATFORMS="cpu",
                               XLA_FLAGS="--xla_force_host_platform_device_"
                                         "count=4")}
    for shape, (d, m) in MESHES.items():
        for r in range(d * m):
            logs[f"{shape}/{r}"] = out / f"port-{shape}-{r}.log"
            procs[f"{shape}/{r}"] = fam._start(
                [sys.executable, me, "port", shape, str(r), str(out)],
                logs[f"{shape}/{r}"])
    procs["cli"] = fam._start(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch",
         ARCHS["moe"], "--smoke", "--mesh", "2x2", "--steps", "2",
         "--batch", str(B), "--seq", str(SEQ), "--device", "cpu",
         "--ckpt-dir", str(out / "cli_ckpt")], logs["cli"])
    end = time.monotonic() + DEADLINE_S
    for p in procs.values():
        try:
            p.wait(timeout=max(1.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    text = {k: v.read_text() for k, v in logs.items()}

    def result(name):
        for k, p in procs.items():
            if k.startswith(name + "/") or k == name:
                assert p.returncode == 0, (k, text[k][-4000:])
        if name == "ref":
            return json.loads((out / "ref.json").read_text())
        if name == "cli":
            return text["cli"]
        return json.loads((out / name / "result.json").read_text())

    return {"out": out, "result": result}


def _layer(runs, side, case, dtype):
    """{"out": ..., leaf: grad} of one layer case: ``side`` one of
    "one", "mesh" (the port on 2x2; "mesh1" on 1x1), "oracle", "ep"."""
    out = runs["out"]
    if side in ("oracle", "ep"):
        runs["result"]("ref")
        return fam._load_np(out / f"ref_layer_{side}_{case}_{dtype}.npz")
    shape = "1x1" if side in ("one", "mesh1") else "2x2"
    runs["result"](shape)
    where = "one" if side == "one" else "mesh"
    return fam._load_np(out / shape / f"layer_{where}_{case}_{dtype}.npz")


def _layer_aux(runs, side, case, dtype):
    if side in ("oracle", "ep"):
        return runs["result"]("ref")["layer"][f"{side}_{case}_{dtype}"]
    shape = "1x1" if side in ("one", "mesh1") else "2x2"
    where = "one" if side == "one" else "mesh"
    return runs["result"](shape)["layer"][f"{where}_{case}_{dtype}"]


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("against", ["ep", "oracle"])
@pytest.mark.parametrize("case", list(MOE_CASES))
def test_moe_apply_on_2x2_matches_the_reference(runs, case, against, dtype):
    """The port's EP ``moe_apply`` (the local path for "d") on 2x2
    against the reference's EP path and its local oracle; where capacity
    drops rows, against the EP path alone (the oracle drops none)."""
    if against == "oracle" and case in DROPS:
        # the reference's own EP output parts from its oracle here: the
        # drop rule is what the EP comparison holds
        ep = _layer(runs, "ep", case, dtype)["out"]
        oracle = _layer(runs, "oracle", case, dtype)["out"]
        assert float(np.abs(ep - oracle).max()) > MOE_F32_TOL
        return
    got = _layer(runs, "mesh", case, dtype)
    want = _layer(runs, against, case, dtype)
    tol = MOE_BF16_TOL if dtype == "bf16" else MOE_F32_TOL
    d = float(np.abs(got["out"] - want["out"]).max())
    assert d < tol, (case, against, dtype, d)
    assert abs(_layer_aux(runs, "mesh", case, dtype)
               - _layer_aux(runs, against, case, dtype)) < AUX_TOL
    if dtype == "f32":
        for k in LAYER_LEAVES:
            err = fam._rel(got[k], want[k])
            assert err < MOE_GRAD_F32_TOL, (case, k, err)


def test_capacity_drops_rows_on_the_ep_path(runs):
    """At capacity factor 0.5 the reference's EP path drops rows (it
    parts from its oracle beyond bf16 rounding), so the cases in DROPS
    test the drop rule, and with it the expert block each rank holds."""
    for case in DROPS:
        ep = _layer(runs, "ep", case, "f32")["out"]
        oracle = _layer(runs, "oracle", case, "f32")["out"]
        assert float(np.abs(ep - oracle).max()) > 1e-3, case


@pytest.mark.parametrize("against", ["ref_sharded", "port_one"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_loss_and_grads_on_2x2_match(runs, arch, against):
    """bf16 parameters: the loss within LOSS_TOL, each gradient within
    GRAD_TOL of its leaf's largest entry or SPREAD_FACTOR times the
    leaf's spread (``_spread``): routing is discontinuous, and one bf16
    rounding that reorders two experts' probabilities moves the gradients
    of every leaf the routed rows reach by tens of percent."""
    res = runs["result"]("2x2")[arch]
    grads = fam._load_np(runs["out"] / "2x2" / f"grads_{arch}.npz")
    want_loss, want = _want(runs, arch, against, "")
    assert abs(res["loss"] - want_loss) < LOSS_TOL, (res["loss"], want_loss)
    assert set(grads) == set(want)
    spread = _spread(runs, arch)
    for k, w in want.items():
        err = fam._rel(grads[k], w)
        assert err < max(GRAD_TOL, SPREAD_FACTOR * spread[k]), \
            (k, err, spread[k])


@pytest.mark.parametrize("against", ["ref_sharded", "port_one"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_f32_loss_and_grads_on_2x2_match(runs, arch, against):
    """The same with every parameter in f32: no rounding reorders the
    routing, so the loss is held to F32_LOSS_TOL and every gradient to
    F32_GRAD_TOL of its leaf's largest entry — the test of the mesh
    path's gradients (the EP boundary's sum, the aux loss's global
    sums, the experts' placements).  A token's embedding still rounds to
    bf16 on every side, and so does the first layer's residual stream, so
    the gradients that pass them round by up to one bf16 step (2**-8 of
    their size; F32_GRAD_TOL is a few steps)."""
    res = runs["result"]("2x2")[arch]
    grads = fam._load_np(runs["out"] / "2x2" / f"f32_grads_{arch}.npz")
    want_loss, want = _want(runs, arch, against, "f32_")
    assert abs(res["f32_loss"] - want_loss) < F32_LOSS_TOL, \
        (res["f32_loss"], want_loss)
    assert set(grads) == set(want)
    for k, w in want.items():
        err = fam._rel(grads[k], w)
        assert err < F32_GRAD_TOL, (k, err)


def _want(runs, arch, against, tag):
    """(loss, gradients) the 2x2 mesh is held to: the reference's sharded
    step or the port's one device."""
    out = runs["out"]
    if against == "ref_sharded":
        ref = runs["result"]("ref")[arch]
        assert "error" not in ref, ref["error"]
        return (ref[tag + "loss"],
                fam._load_np(out / f"ref_{tag}grads_{arch}.npz"))
    one = runs["result"]("1x1")[arch]["one"]
    return (one[tag + "loss"],
            fam._load_np(out / "1x1" / f"one_{tag}grads_{arch}.npz"))


def _spread(runs, arch):
    """{leaf: how far two correct bf16 evaluations of its gradient lie
    apart, the mesh not involved}: the larger of the reference's sharded
    gradient's gap to its one-device one and the gap between the two
    packages' one-device gradients (the same math, other rounding)."""
    out = runs["out"]
    runs["result"]("1x1")
    one = fam._load_np(out / f"ref_one_grads_{arch}.npz")
    port_one = fam._load_np(out / "1x1" / f"one_grads_{arch}.npz")
    return {k: max(fam._rel(g, one[k]), fam._rel(port_one[k], one[k]))
            for k, g in fam._load_np(out / f"ref_grads_{arch}.npz").items()}


def _ref_logits(runs, arch):
    """The reference's sharded logits, or its one-device ones where its
    sharded serving raised on this JAX (the error is kept in ref.json)."""
    ref = runs["result"]("ref")[arch]
    out = runs["out"]
    if "error" in ref:
        return fam._logits(out / f"ref_one_logits_{arch}.npz")
    return fam._logits(out / f"ref_logits_{arch}.npz")


@pytest.mark.parametrize("against", ["ref_sharded", "port_one"])
@pytest.mark.parametrize("arch", list(ARCHS))
def test_prefill_and_decode_on_2x2_match(runs, arch, against):
    vocab = port_cfg(arch).vocab
    runs["result"]("2x2")
    got = fam._logits(runs["out"] / "2x2" / f"logits_{arch}.npz")
    if against == "ref_sharded":
        want = _ref_logits(runs, arch)
    else:
        runs["result"]("1x1")
        want = fam._logits(runs["out"] / "1x1" / f"one_logits_{arch}.npz")
    assert len(got) == len(want) == STEPS + 1
    assert all(np.isfinite(g[..., :vocab]).all() for g in got)
    d = fam._max_diff(got, want, vocab)
    assert d < LOGIT_TOL, f"{arch}: logits differ by {d}"


@pytest.mark.parametrize("arch", list(ARCHS))
def test_serve_engine_on_2x2_agrees_with_one_device(runs, arch):
    res = runs["result"]("2x2")[arch]
    assert np.asarray(res["gen"]).shape == (B, STEPS + 1)
    assert len(res["margins"]) == STEPS + 1
    assert max(res["margins"]) < 2 * LOGIT_TOL, res["margins"]


def _ref_cache_local_shapes(arch):
    """Each cache leaf's block shape under the reference's partition on a
    2x2 mesh."""
    from jax.sharding import AbstractMesh, PartitionSpec

    from repro.models import api as R
    cfg = ref_cfg(arch)
    amesh = AbstractMesh((2, 2), ("data", "model"))
    specs = fam._flat(R.cache_pspecs(cfg, B, MAX_SEQ, amesh), PartitionSpec)
    shapes = {k: list(v.shape) for k, v in
              fam._flat(R.abstract_cache(cfg, B, MAX_SEQ)).items()}
    return {k: fam._local_shape(shapes[k], tuple(specs[k])) for k in shapes}


@pytest.mark.parametrize("arch", list(ARCHS))
def test_the_cache_after_four_steps(runs, arch):
    """Each block has the reference's local shape; each new position is
    written on the ranks whose block holds it and equals one device's;
    every position past the last index is exactly zero (deepseek-v3's
    two caches, ``kv_dense`` and ``kv_moe``, both on ``kv_seq``)."""
    from repro_torch.models import api
    from repro_torch.models.common import tree_items
    res = runs["result"]("2x2")[arch]
    runs["result"]("1x1")
    one = fam._load_np(runs["out"] / "1x1" / f"one_cache_{arch}.npz")
    want_shapes = _ref_cache_local_shapes(arch)
    axes = {p: d.axes for p, d in tree_items(api.cache_schema(
        port_cfg(arch), B, MAX_SEQ))}
    assert all("kv_seq" in a for a in axes.values()), axes
    seen = set()
    for rank, offsets in enumerate(res["offsets"]):
        blocks = fam._load_np(runs["out"] / "2x2" /
                              f"cache_{arch}_r{rank}.npz")
        assert set(blocks) == set(one) == set(want_shapes)
        for path, blk in blocks.items():
            assert list(blk.shape) == want_shapes[path], (path, rank)
            lo = offsets[path]
            want = one[path][tuple(slice(o, o + n)
                                   for o, n in zip(lo, blk.shape))]
            tol = CACHE_TOL * max(1.0, float(np.abs(one[path]).max()))
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
                    seen.add((path, pos))
    assert {pos for _, pos in seen} == set(range(P, P + STEPS))


@pytest.mark.parametrize("arch", list(ARCHS))
def test_a_decode_step_gathers_no_cache_leaf(runs, arch):
    coll = runs["result"]("2x2")[arch]["collectives"]
    assert coll["calls"], "a decode step on 2x2 ran no collective"
    gathers = [s for s in coll["shapes"] if s[0].startswith("all_gather")]
    assert not any(MAX_SEQ in shape for s in gathers for shape in s[1:]), \
        gathers


@pytest.mark.parametrize("chunk", ["default", "small"])
def test_adafactor_on_2x2_matches_one_device(runs, chunk):
    """deepseek-v3 SMOKE's OPT_STEPS Adafactor steps on 2x2 against one
    device, the factored state placed as ``opt_state_pspecs`` places it;
    "small" updates most stacked leaves slice by slice on their placed
    blocks."""
    got = runs["result"]("2x2")["adafactor"][f"mesh_{chunk}"]
    want = runs["result"]("1x1")["adafactor"][f"one_{chunk}"]
    assert got["as_specs"]
    for g, w in zip(got["history"], want["history"]):
        assert abs(g["loss"] - w["loss"]) < STEP_TOL, (g, w)
        assert abs(g["grad_norm"] - w["grad_norm"]) \
            < NORM_TOL * abs(w["grad_norm"]), (g, w)
    out = runs["out"]
    p_got = fam._load_np(out / "2x2" / f"adafactor_mesh_{chunk}.npz")
    p_want = fam._load_np(out / "1x1" / f"adafactor_one_{chunk}.npz")
    assert set(p_got) == set(p_want)
    for k, w in p_want.items():
        assert float(np.abs(p_got[k] - w).max()) < PARAM_TOL, k


def _update(runs, shape, where, chunk):
    runs["result"](shape)
    return fam._load_np(runs["out"] / shape / f"update_{where}_{chunk}.npz")


@pytest.mark.parametrize("chunk", ["default", "small"])
def test_adafactor_update_on_2x2_matches_one_device(runs, chunk):
    """One ``adafactor_update`` of deepseek-v3 SMOKE's f32 leaves on 2x2,
    the gradients and the state distributed from the same arrays as one
    device's: every parameter and the whole of each factor as one
    device's, up to f32 rounding (each mean over a sharded dim and the
    update's RMS summed over the mesh dims that shard it)."""
    got = _update(runs, "2x2", "mesh", chunk)
    want = _update(runs, "1x1", "one", chunk)
    assert set(got) == set(want)
    for k, w in want.items():
        if k.startswith("param."):
            before = "before." + k[len("param."):]
            np.testing.assert_array_equal(got[before], want[before])
            step = np.abs(w - want[before]).max()
            assert step > 0, k
            assert np.abs(got[k] - w).max() <= UPDATE_TOL * step, k
        elif k.startswith("state."):
            assert (np.abs(got[k] - w) <= FACTOR_ULP * np.abs(w)).all(), k
    assert abs(got["norm"] - want["norm"]) <= NORM_F32_TOL * want["norm"]


def test_the_update_case_clips_every_leaf(runs):
    """The update case reaches the RMS clip on every leaf (its update's
    RMS is the learning rate's), so the RMS's reduction over the mesh
    moves the parameters."""
    want = _update(runs, "1x1", "one", "default")
    for k in want:
        if k.startswith("param."):
            delta = want[k] - want["before." + k[len("param."):]]
            rms = float(np.sqrt(np.mean(delta.astype(np.float64) ** 2)))
            assert abs(rms / UPDATE_LR - 1) < 1e-3, (k, rms)


def test_the_small_threshold_chunks(runs):
    """The lowered threshold changes the update (each slice's RMS is its
    own), so the "small" runs do take the per-slice path."""
    out = runs["out"]
    runs["result"]("1x1")
    a = fam._load_np(out / "1x1" / "adafactor_one_default.npz")
    b = fam._load_np(out / "1x1" / "adafactor_one_small.npz")
    assert any(not np.array_equal(a[k], b[k]) for k in a)


@pytest.mark.parametrize("kind", list(fam.STEP_CELLS))
@pytest.mark.parametrize("arch", list(ARCHS))
def test_build_step_places_and_runs_on_2x2(runs, arch, kind):
    got = runs["result"]("2x2")["build_step"][f"{arch}/{kind}"]
    assert got == {"placed": True, "finite": True}, got


def test_the_launcher_trains_an_moe_arch_on_a_2x2_mesh(runs):
    lines = runs["result"]("cli").splitlines()
    done = [l for l in lines if l.startswith("done: loss ")]
    assert len(done) == 1 and done[0].endswith(" stragglers"), lines[-20:]


@pytest.mark.parametrize("what", ["layer", "train", "serve", "adafactor",
                                  "update"])
def test_one_by_one_mesh_is_one_device_bit_for_bit(runs, what):
    res = runs["result"]("1x1")
    here = runs["out"] / "1x1"
    if what == "update":
        for chunk in ("default", "small"):
            got = _update(runs, "1x1", "mesh", chunk)
            want = _update(runs, "1x1", "one", chunk)
            assert set(got) == set(want)
            for k, w in want.items():
                np.testing.assert_array_equal(got[k], w, err_msg=k)
        return
    if what == "layer":
        for case in MOE_CASES:
            for dtype in DTYPES:
                tag = f"{case}_{dtype}"
                assert res["layer"][f"mesh_{tag}"] == \
                    res["layer"][f"one_{tag}"], tag
                got = _layer(runs, "mesh1", case, dtype)
                want = _layer(runs, "one", case, dtype)
                for k, w in want.items():
                    np.testing.assert_array_equal(got[k], w, err_msg=tag + k)
        return
    if what == "adafactor":
        for chunk in ("default", "small"):
            a = res["adafactor"]
            assert a[f"mesh_{chunk}"]["history"] == \
                a[f"one_{chunk}"]["history"]
            got = fam._load_np(here / f"adafactor_mesh_{chunk}.npz")
            want = fam._load_np(here / f"adafactor_one_{chunk}.npz")
            for k, w in want.items():
                np.testing.assert_array_equal(got[k], w, err_msg=k)
        return
    for arch in ARCHS:
        r = res[arch]
        if what == "train":
            for tag in ("", "f32_"):
                assert r[tag + "loss"] == r["one"][tag + "loss"]
                got = fam._load_np(here / f"{tag}grads_{arch}.npz")
                want = fam._load_np(here / f"one_{tag}grads_{arch}.npz")
                assert set(got) == set(want)
                for k, w in want.items():
                    np.testing.assert_array_equal(got[k], w, err_msg=k)
            continue
        for g, w in zip(fam._logits(here / f"logits_{arch}.npz"),
                        fam._logits(here / f"one_logits_{arch}.npz")):
            np.testing.assert_array_equal(g, w)
        assert r["gen"] == r["one"]["gen"]
        blocks = fam._load_np(here / f"cache_{arch}_r0.npz")
        one = fam._load_np(here / f"one_cache_{arch}.npz")
        assert set(blocks) == set(one)
        for k, w in one.items():
            np.testing.assert_array_equal(blocks[k], w, err_msg=k)


def test_a_plain_input_under_a_mesh_with_a_model_axis_raises():
    """The reference would run expert-parallel there: the port does not
    quietly take the local path on plain tensors."""
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import Mesh
    from repro_torch.models import api, moe
    from repro_torch.sharding import use_mesh
    cfg = get_smoke(ARCHS["moe"])
    p = {k: v[0] for k, v in api.init(cfg, 0, "cpu")["blocks"]["moe"]
         .items()}
    x = torch.zeros(2, 4, cfg.d_model, dtype=torch.bfloat16)
    with use_mesh(Mesh((2, 2), ("data", "model"), "cpu")):
        with pytest.raises(NotImplementedError, match="device mesh"):
            moe.moe_apply(cfg, p, x)
    with use_mesh(Mesh((4, 1), ("data", "model"), "cpu")):
        y, _ = moe.moe_apply(cfg, p, x)        # "model" of 1: local path
    assert y.shape == x.shape


def test_every_family_runs_on_a_mesh():
    """``api.MESH_FAMILIES`` holds the family of every config."""
    from repro_torch.configs import ARCHS as ALL, get_smoke
    from repro_torch.models import api
    assert {get_smoke(a).family for a in ALL} == set(api.MESH_FAMILIES)


if __name__ == "__main__":
    if sys.argv[1] == "port":
        port_rank(sys.argv[2], int(sys.argv[3]), Path(sys.argv[4]))
    else:
        ref_side(Path(sys.argv[2]))
    sys.exit(0)
