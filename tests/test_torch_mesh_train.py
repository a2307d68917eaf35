"""Dense LM training across a (data x model) mesh on the port (DTensor
over gloo ranks, one process per rank), held to the reference's sharded
step and to one device, on the CPU.

One module fixture starts everything at once and the tests read what it
wrote under ``tmp_path``:

- the port's ranks, each ``python tests/test_torch_mesh_train.py port
  SHAPE RANK DIR`` (gloo, a ``file://`` rendezvous under ``tmp_path``:
  parallel test workers would collide on fixed TCP ports), on 2x2, 1x2,
  2x1 and 1x1 meshes of granite-3-8b SMOKE;
- the reference's sharded side, ``... ref DIR``, with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4`` and a 2x2 mesh of
  ``AxisType.Auto`` axes (``jax.make_mesh``'s default ``Explicit`` axes
  refuse ``with_sharding_constraint``);
- the launcher, ``python -m repro_torch.launch.train --mesh 2x2``.

Every side starts from the reference's seed-0 parameters (its
checkpoint, placed by each rank with ``load_pytree(shardings=...)``) and
the same step-keyed batches.  Tolerances, as ``test_torch_train_loss.py``
and ``test_torch_train.py`` state them (bf16 parameters; the ranks and
XLA reduce in other orders): the loss to LOSS_TOL, each gradient to
GRAD_TOL of its leaf's largest entry, three AdamW steps' metrics to
STEP_TOL (``grad_norm`` to NORM_TOL of its size) and every parameter to
PARAM_TOL (an Adam step moves one by about lr whatever its gradient).
Checkpoints, restores, the 1x1 mesh and the replay are exact.
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
ARCH = "granite-3-8b"
LOSS_TOL = 1e-3
GRAD_TOL = 0.05
STEP_TOL = 2e-3
NORM_TOL = 1e-2
PARAM_TOL = 1e-2
LR = 1e-3
STEPS = 3
BATCH, SEQ = 8, 32
#: every port rank and the reference's side must finish within this
DEADLINE_S = 240
MESHES = {"2x2": (2, 2), "1x2": (1, 2), "2x1": (2, 1), "1x1": (1, 1)}


def tokens(i):
    """The step-keyed global batch ``i`` (every side builds the same)."""
    rng = np.random.default_rng(100 + i)
    return rng.integers(0, 256, (BATCH, SEQ + 1)).astype(np.int32)


# ---------------------------------------------------------------------------
# The port's ranks (no JAX here)
# ---------------------------------------------------------------------------
def _whole(tree):
    """{dotted path: a whole float32 numpy array} of a placed or plain
    tree (every rank joins each gather)."""
    from repro_torch.models.common import tree_items
    from repro_torch.sharding import placed
    return {p: (t.full_tensor() if placed(t) else t).float().numpy()
            for p, t in tree_items(tree)}


def _save_np(path, arrays):
    np.savez(path, **{k.replace(".", "|"): v for k, v in arrays.items()})


def _load_np(path):
    with np.load(path) as f:
        return {k.replace("|", "."): f[k] for k in f.files}


def port_rank(shape, rank, out):
    """One rank of the port on ``shape`` (``"DxM"``); rank 0 writes the
    results under ``OUT/<shape>/``."""
    d, m = MESHES[shape]
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(d * m),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.ckpt import load_pytree
    from repro_torch.configs import get_smoke
    from repro_torch.convert import lm_params_from_arrays
    from repro_torch.launch.mesh import init_distributed, make_device_mesh
    from repro_torch.models import api
    from repro_torch.models.common import tree_from_items, tree_items
    from repro_torch.sharding import use_mesh
    from repro_torch.train import opt_state_pspecs

    here = out / shape
    here.mkdir(parents=True, exist_ok=True)
    init_distributed("cpu", "file://" + str(out / f"rendezvous-{shape}"))
    mesh = make_device_mesh(d, m, device="cpu")
    cfg = get_smoke(ARCH)
    pspecs = api.pspecs(cfg, mesh)
    res = {}

    def ref_params():
        tree, _ = load_pytree(str(out / "ref_params"), shardings={
            "params": _named(pspecs, mesh)})
        return tree["params"]

    with use_mesh(mesh):
        # 1: local shapes of the placed leaves, from init and from arrays
        res["init_local"] = {p: list(t.to_local().shape) for p, t in
                             tree_items(api.init(cfg, 0, "cpu", mesh))}
        plain, _ = load_pytree(str(out / "ref_params"))
        conv = lm_params_from_arrays(cfg, tree_from_items(
            (p, _np_bf16(t)) for p, t in tree_items(plain["params"])),
            "cpu", mesh)
        got = dict(tree_items(ref_params()))
        res["convert_local"] = {p: list(t.to_local().shape)
                                for p, t in tree_items(conv)}
        res["convert_equals_load"] = all(
            torch.equal(t.to_local(), got[p].to_local())
            for p, t in tree_items(conv))
        if shape == "1x2":
            # 10: an MoE arch on a mesh of two devices, each rank's block
            # of every MoE leaf
            moe = api.init(get_smoke("qwen3-moe-30b-a3b"), 0, "cpu", mesh)
            res["moe"] = {p: list(t.to_local().shape) for p, t in
                          tree_items(moe["blocks"]["moe"])}
        if shape in ("2x2", "1x1"):
            _train_cases(cfg, mesh, ref_params, here, res)
        if shape in ("1x2", "2x1"):
            # 6: the 2x2 checkpoint restored onto this mesh
            src = out / "2x2" / "ckpt_mesh"
            _wait_for(src / "written")
            want = {"params": _named(pspecs, mesh),
                    "opt": _named(opt_state_pspecs(cfg, pspecs), mesh)}
            placed, _ = load_pytree(str(src), shardings=want)
            whole = _whole(placed)
            plain, _ = load_pytree(str(src))
            plain = dict(tree_items(plain))
            res["restore_exact"] = set(whole) == set(plain) and all(
                np.array_equal(whole[p], t.float().numpy())
                for p, t in plain.items())
            res["restore_sharded"] = sorted(
                p for p, t in tree_items(placed)
                if tuple(t.to_local().shape) != tuple(t.shape))
    if rank == 0:
        (here / "result.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def _named(specs, mesh):
    """A tree of ``spec_for`` tuples as ``NamedSharding``s on ``mesh``."""
    from repro_torch.models.common import tree_map
    from repro_torch.sharding import NamedSharding
    return tree_map(lambda s: NamedSharding(mesh, s), specs)


def _np_bf16(t):
    """A bf16 tensor as the numpy bfloat16 array the reference holds."""
    import ml_dtypes
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy().view(ml_dtypes.bfloat16)
    return t.numpy()


def _wait_for(path, timeout=DEADLINE_S):
    end = time.monotonic() + timeout
    while not path.exists():
        if time.monotonic() > end:
            raise TimeoutError(f"{path} never appeared")
        time.sleep(0.2)


def _plain(tree):
    """A placed tree's whole tensors (every rank joins each gather)."""
    from repro_torch.models.common import tree_map
    from repro_torch.sharding import placed
    return tree_map(lambda t: t.full_tensor() if placed(t) else t, tree)


def _train_cases(cfg, mesh, ref_params, here, res):
    """2: loss and gradients; 3 and 7: three AdamW steps through the
    TrainLoop, uninterrupted and with a crash at step 2; 5: the
    collectives of the first step; 6: checkpoints."""
    from repro_torch.ckpt import CheckpointManager, save_pytree
    from repro_torch.launch.roofline import CollectiveCounter
    from repro_torch.models import api
    from repro_torch.models.common import tree_from_items, tree_items
    from repro_torch.runtime import FailureInjector, TrainLoop
    from repro_torch.sharding import (distribute, named_sharding,
                                      replicate_plain)
    from repro_torch.train import make_train_step
    rank0 = torch.distributed.get_rank() == 0

    params = ref_params()
    toks = torch.from_numpy(tokens(0))
    paths, leaves = zip(*[(p, t.detach().requires_grad_())
                          for p, t in tree_items(params)])
    batch = {"tokens": distribute(toks, named_sharding(toks.shape,
                                                       ("batch", None)))}
    with torch.enable_grad(), replicate_plain():
        loss, _ = api.loss_fn(cfg, tree_from_items(zip(paths, leaves)),
                              batch)
        grads = torch.autograd.grad(loss, leaves)
    res["loss"] = float(loss.detach().full_tensor())
    grads = _whole(tree_from_items(zip(paths, grads)))
    if rank0:
        _save_np(here / "grads.npz", grads)

    def run(crash):
        params = ref_params()
        step = make_train_step(cfg, lr=LR,
                               params_pspecs=api.pspecs(cfg, mesh))
        counter = CollectiveCounter(mesh)

        def first_counted(p, s, b):
            if not counter.calls and not getattr(counter, "done", False):
                counter.done = True
                with counter:
                    return step(p, s, b)
            return step(p, s, b)

        loop = TrainLoop(
            step_fn=step if crash else first_counted,
            data_fn=lambda i: {"tokens": torch.from_numpy(tokens(i))},
            ckpt=CheckpointManager(str(here / f"loop_{int(crash)}"),
                                   keep=3),
            ckpt_every=1, injector=FailureInjector([2]) if crash else None)
        p, s, hist = loop.run(params, step.init_state(params), STEPS)
        loop.ckpt.async_ckpt.close()
        return p, s, hist, counter

    p, s, hist, counter = run(False)
    res["history"] = [{k: v for k, v in h.items() if k != "straggler"}
                      for h in hist]
    res["collectives"] = {"calls": counter.calls,
                          "bytes": counter.coll_bytes,
                          "by_dim": counter.by_dim}
    state = _whole({"params": p, "opt": s})
    if rank0:
        _save_np(here / "state.npz", state)
    # 6: the placed tree as it is, and its whole tensors as one device
    # writes them
    save_pytree({"params": p, "opt": s}, str(here / "ckpt_mesh"), STEPS)
    whole_tree = {"params": _plain(p), "opt": _plain(s)}
    if rank0:
        save_pytree(whole_tree, str(here / "ckpt_one"), STEPS)
        (here / "ckpt_mesh" / "written").write_text("")
    p2, s2, hist2, _ = run(True)
    again = _whole({"params": p2, "opt": s2})
    res["replay_steps"] = [h["step"] for h in hist2]
    res["replay_bit_exact"] = set(again) == set(state) and all(
        np.array_equal(state[k], again[k]) for k in state)
    res["replay_losses"] = [h["loss"] for h in hist2]


# ---------------------------------------------------------------------------
# The reference's sharded side (its own process: 4 host devices)
# ---------------------------------------------------------------------------
def ref_side(out):
    import jax
    import jax.numpy as jnp
    from jax.sharding import AxisType, NamedSharding

    from repro.configs import get_smoke
    from repro.models import api as R
    from repro.sharding import use_mesh
    from repro.train import make_train_step

    cfg = get_smoke(ARCH)
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    res = {}
    with use_mesh(mesh):
        pspec = R.pspecs(cfg, mesh)
        put = lambda: jax.tree.map(
            lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)),
            R.init(cfg, jax.random.PRNGKey(0)), pspec)
        params = put()
        batch = {"tokens": jnp.asarray(tokens(0))}
        (loss, _), grads = jax.jit(jax.value_and_grad(
            lambda p, b: R.loss_fn(cfg, p, b), has_aux=True))(params, batch)
        res["loss"] = float(loss)
        res["hlo_collectives"] = sorted({
            op for op in ("all-gather", "all-reduce", "reduce-scatter")
            if op in jax.jit(lambda p, b: R.loss_fn(cfg, p, b)[0]).lower(
                params, batch).compile().as_text()})
        flat = {".".join(str(getattr(k, "key", k)) for k in path):
                np.asarray(v, np.float32) for path, v in
                jax.tree_util.tree_flatten_with_path(grads)[0]}
        _save_np(out / "ref_grads.npz", flat)
        step = make_train_step(cfg, lr=LR, params_pspecs=pspec)
        params = put()
        state = step.init_state(params)
        jstep = jax.jit(step, donate_argnums=(0, 1))
        hist = []
        for i in range(STEPS):
            params, state, m = jstep(params, state,
                                     {"tokens": jnp.asarray(tokens(i))})
            hist.append({k: float(v) for k, v in m.items()})
        res["history"] = hist
        flat = {".".join(str(getattr(k, "key", k)) for k in path):
                np.asarray(v, np.float32) for path, v in
                jax.tree_util.tree_flatten_with_path(params)[0]}
        _save_np(out / "ref_state.npz", flat)
    (out / "ref.json").write_text(json.dumps(res))


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

    from repro.ckpt import save_pytree as ref_save
    from repro.configs import get_smoke as ref_smoke
    from repro.models import api as R
    from repro_torch.ckpt import load_pytree
    from repro_torch.configs import get_smoke
    from repro_torch.models import api
    from repro_torch.models.common import tree_from_items, tree_items
    from repro_torch.train import make_train_step

    out = tmp_path_factory.mktemp("mesh")
    rparams = R.init(ref_smoke(ARCH), jax.random.PRNGKey(0))
    ref_save({"params": rparams}, str(out / "ref_params"), 0)
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
    procs["cli"] = _start(
        [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
         "--smoke", "--mesh", "2x2", "--device", "cpu", "--steps", "4",
         "--ckpt-dir", str(out / "cli")], out / "cli.log")

    # meanwhile, here: one device, the port's and the reference's
    cfg = get_smoke(ARCH)
    plain, _ = load_pytree(str(out / "ref_params"))
    params = plain["params"]
    paths, leaves = zip(*[(p, t.detach().requires_grad_())
                          for p, t in tree_items(params)])
    with torch.enable_grad():
        loss, _ = api.loss_fn(cfg, tree_from_items(zip(paths, leaves)),
                              {"tokens": torch.from_numpy(tokens(0))})
        grads = torch.autograd.grad(loss, leaves)
    one = {"loss": float(loss), "grads": {p: g.float().numpy() for p, g in
                                          zip(paths, grads)}}
    step = make_train_step(cfg, lr=LR)
    state = step.init_state(params)
    one["history"] = []
    for i in range(STEPS):
        params, state, mt = step(params, state,
                                 {"tokens": torch.from_numpy(tokens(i))})
        one["history"].append({k: float(v) for k, v in mt.items()})
    one["state"] = {p: t.float().numpy() for p, t in
                    tree_items({"params": params, "opt": state})}
    rcfg = ref_smoke(ARCH)
    (rl, _), rg = jax.jit(jax.value_and_grad(
        lambda p, b: R.loss_fn(rcfg, p, b), has_aux=True))(
            rparams, {"tokens": jax.numpy.asarray(tokens(0))})
    one["ref_loss"] = float(rl)
    one["ref_grads"] = {".".join(str(getattr(k, "key", k)) for k in path):
                        np.asarray(v, np.float32) for path, v in
                        jax.tree_util.tree_flatten_with_path(rg)[0]}

    end = time.monotonic() + DEADLINE_S
    for p in procs.values():
        try:
            p.wait(timeout=max(1.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()
    logs = {k: (out / ("ref.log" if k == "ref" else "cli.log" if k == "cli"
                       else "port-%s-%s.log" % tuple(k.split("/"))))
            .read_text()[-4000:] for k in procs}

    def result(shape):
        for k, p in procs.items():
            if k.startswith(shape + "/") or k == shape:
                assert p.returncode == 0, (k, logs[k])
        if shape in ("ref", "cli"):
            return json.loads((out / "ref.json").read_text()) \
                if shape == "ref" else None
        return json.loads((out / shape / "result.json").read_text())

    return {"out": out, "one": one, "result": result, "procs": procs,
            "logs": logs}


def _ref_local_shape(shape, spec, mesh_shape):
    """The block shape the reference's partition ``spec`` gives each
    device of a (data, model) mesh."""
    sizes = dict(zip(("data", "model"), mesh_shape))
    out = list(shape)
    for d, ent in enumerate(spec):
        for a in ((ent,) if isinstance(ent, str) else ent or ()):
            out[d] //= sizes[a]
    return out


@pytest.mark.parametrize("shape", ["2x2", "1x2", "2x1"])
def test_placed_leaves_have_the_reference_local_shapes(runs, shape):
    from jax.sharding import AbstractMesh

    from repro.configs import get_smoke as ref_smoke
    from repro.models import api as R
    res = runs["result"](shape)
    amesh = AbstractMesh(MESHES[shape], ("data", "model"))
    cfg = ref_smoke(ARCH)
    flat = jax_flat(R.pspecs(cfg, amesh))
    shapes = {k: list(v.shape) for k, v in
              jax_flat(R.abstract(cfg)).items()}
    want = {k: _ref_local_shape(shapes[k], tuple(flat[k]), MESHES[shape])
            for k in shapes}
    assert res["init_local"] == want
    assert res["convert_local"] == want
    assert res["convert_equals_load"]
    assert any(want[k] != shapes[k] for k in want)


def jax_flat(tree):
    """{dotted path: leaf} of a reference pytree (PartitionSpecs whole)."""
    import jax
    from jax.sharding import PartitionSpec
    return {".".join(str(getattr(k, "key", k)) for k in path): v
            for path, v in jax.tree_util.tree_flatten_with_path(
                tree, is_leaf=lambda x: isinstance(x, PartitionSpec))[0]}


@pytest.mark.parametrize("against", ["ref_sharded", "ref_one", "port_one"])
def test_loss_and_grads_on_2x2_match(runs, against):
    res, one = runs["result"]("2x2"), runs["one"]
    grads = _load_np(runs["out"] / "2x2" / "grads.npz")
    if against == "ref_sharded":
        ref = runs["result"]("ref")
        assert ref["hlo_collectives"], "the reference's step is not sharded"
        want_loss = ref["loss"]
        want = _load_np(runs["out"] / "ref_grads.npz")
    elif against == "ref_one":
        want_loss, want = one["ref_loss"], one["ref_grads"]
    else:
        want_loss, want = one["loss"], one["grads"]
    assert abs(res["loss"] - want_loss) < LOSS_TOL, (res["loss"], want_loss)
    assert set(grads) == set(want)
    for k, w in want.items():
        err = float(np.abs(grads[k] - w).max()) / max(
            float(np.abs(w).max()), 1e-12)
        assert err < GRAD_TOL, (k, err)


@pytest.mark.parametrize("against", ["ref_sharded", "port_one"])
def test_three_adamw_steps_on_2x2_match(runs, against):
    res = runs["result"]("2x2")
    if against == "ref_sharded":
        want_hist = runs["result"]("ref")["history"]
        want = {"params." + k: v for k, v in
                _load_np(runs["out"] / "ref_state.npz").items()}
    else:
        want_hist = runs["one"]["history"]
        want = runs["one"]["state"]
    assert len(res["history"]) == STEPS
    for got, w in zip(res["history"], want_hist):
        for k, v in w.items():
            tol = NORM_TOL * v if k == "grad_norm" else STEP_TOL
            assert abs(got[k] - v) < tol, (k, got[k], v)
    state = _load_np(runs["out"] / "2x2" / "state.npz")
    for k, w in want.items():
        d = float(np.abs(state[k] - w).max())
        assert d < PARAM_TOL, (k, d)


def test_one_by_one_mesh_is_one_device_bit_for_bit(runs):
    res = runs["result"]("1x1")
    state = _load_np(runs["out"] / "1x1" / "state.npz")
    one = runs["one"]
    assert set(state) == set(one["state"])
    for k, w in one["state"].items():
        np.testing.assert_array_equal(state[k], w, err_msg=k)
    assert [h["loss"] for h in res["history"]] == \
        [h["loss"] for h in one["history"]]
    assert res["loss"] == one["loss"]


@pytest.mark.parametrize("shape", ["2x2", "1x1"])
def test_a_train_step_counts_its_collectives(runs, shape):
    coll = runs["result"](shape)["collectives"]
    if shape == "1x1":
        assert coll == {"calls": {}, "bytes": {}, "by_dim": {}}
        return
    calls, nbytes = coll["calls"], coll["bytes"]
    assert calls.get("all-gather", 0) + calls.get("reduce-scatter", 0) > 0
    assert all(nbytes[k] > 0 for k in calls) and sum(nbytes.values()) > 0
    assert {"data", "model"} <= set(coll["by_dim"])


def _members(directory):
    import zipfile
    with zipfile.ZipFile(directory / f"step_{STEPS:08d}" / "state.npz") as z:
        return {n: z.read(n) for n in z.namelist()}


def test_a_2x2_checkpoint_is_the_one_device_write(runs):
    runs["result"]("2x2")
    here = runs["out"] / "2x2"
    mesh, one = _members(here / "ckpt_mesh"), _members(here / "ckpt_one")
    assert set(mesh) == set(one) and mesh == one
    manifests = [json.loads((here / d / f"step_{STEPS:08d}" /
                             "manifest.json").read_text())["keys"]
                 for d in ("ckpt_mesh", "ckpt_one")]
    assert manifests[0] == manifests[1]


@pytest.mark.parametrize("onto", ["1x2", "2x1", "no mesh", "reference"])
def test_a_2x2_checkpoint_restores_onto_any_mesh(runs, onto):
    state = _load_np(runs["out"] / "2x2" / "state.npz")
    src = runs["out"] / "2x2" / "ckpt_mesh"
    if onto in ("1x2", "2x1"):
        res = runs["result"](onto)
        assert res["restore_exact"]
        assert res["restore_sharded"], "nothing was placed in blocks"
        return
    runs["result"]("2x2")
    if onto == "no mesh":
        from repro_torch.ckpt import load_pytree
        from repro_torch.models.common import tree_items
        tree, _ = load_pytree(str(src))
        got = {p: t.float().numpy() for p, t in tree_items(tree)}
    else:
        from repro.ckpt import load_pytree as ref_load
        tree, _ = ref_load(str(src))
        got = {k.replace("/", "."): np.asarray(v, np.float32)
               for k, v in jax_flat(tree).items()}
    assert set(got) == set(state)
    for k, w in state.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


def test_a_crash_on_2x2_replays_bit_exactly(runs):
    res = runs["result"]("2x2")
    assert res["replay_steps"] == [0, 1, 2]
    assert res["replay_bit_exact"]
    assert res["replay_losses"] == [h["loss"] for h in res["history"]]


def test_the_launcher_trains_on_a_2x2_mesh(runs):
    runs["result"]("cli")
    lines = runs["logs"]["cli"].splitlines()
    assert sum(l.startswith("filter: {'planner': 'deepfish'")
               for l in lines) == 1
    done = [l for l in lines if l.startswith("done: loss ")]
    assert len(done) == 1 and done[0].endswith(" stragglers"), lines


def test_an_moe_arch_on_a_mesh_raises(runs):
    """(It raised until the expert-parallel path, B2.11, was ported.)
    ``api.init`` places qwen3-moe SMOKE on 1x2: each rank holds half the
    experts (their "experts" dim on "model"), the router whole."""
    from repro_torch.configs import get_smoke
    cfg = get_smoke("qwen3-moe-30b-a3b")
    got = runs["result"]("1x2")["moe"]
    L, e, d, h = cfg.n_layers, cfg.n_experts, cfg.d_model, cfg.moe_d_ff
    assert got == {"router": [L, d, e], "w_in": [L, e // 2, d, 2 * h],
                   "w_out": [L, e // 2, h, d]}, got


if __name__ == "__main__":
    if sys.argv[1] == "port":
        port_rank(sys.argv[2], int(sys.argv[3]), Path(sys.argv[4]))
    else:
        ref_side(Path(sys.argv[2]))
    sys.exit(0)
