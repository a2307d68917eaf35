"""Int8 gradient compression and the "pod" axis on a DTensor mesh on the
port (gloo ranks, one process per rank), held to the reference's sharded
int8 step, to the reference's quantization and to one device, on the
CPU.

The harness is ``test_torch_mesh_train.py``'s (its helpers are imported
from it): one module fixture starts everything at once and the tests read
what it wrote under ``tmp_path``:

- the port's ranks, each ``python tests/test_torch_mesh_pod.py port SHAPE
  RANK DIR`` (gloo, a ``file://`` rendezvous under ``tmp_path``): a 2x2
  (data, model) mesh and a (pod=2, data=2, model=1) mesh run three int8
  AdamW steps of granite-3-8b SMOKE and check that every residual keeps
  its parameter's placements; the pod mesh also runs
  ``compressed_allreduce_mean(x, "pod")`` over its pod axis of 2 and over
  a (pod=4, data=1, model=1) mesh of the same four ranks, under the
  collective counter, and saves its int8 state, which a 1x4 mesh restores;
  a 1x1x1 mesh runs the three steps alone;
- the reference's sharded side, ``... ref DIR``, with
  ``XLA_FLAGS=--xla_force_host_platform_device_count=4``: its int8 step on
  a 2x2 and on a (2, 2, 1) mesh of ``AxisType.Auto`` axes.

Every side starts from the reference's seed-0 parameters and the same
step-keyed batches.  Tolerances: the wire primitive within 1 f32 ulp of
the reference's ``quantize_int8`` / ``dequantize_int8`` applied to each
shard and averaged (``ULP_TOL``; the mean's sum order), and within the
reference test's bound, max|g|/127 (``tests/test_dryrun_small.py``).
The steps as ``test_torch_mesh_train.py`` states them (bf16 parameters;
the ranks and XLA reduce in other orders): each step's loss to LOSS_TOL,
its metrics to STEP_TOL (``grad_norm`` to NORM_TOL of its size), every
parameter to PARAM_TOL; each error-feedback residual within one
quantization step of one device's (the larger of the two sides' last
scales for that leaf: a residual lies within half a step of zero, so a
flipped rounding moves it by at most one).  The 1x1x1 mesh and the
restores are exact.  One more case holds rwkv6's scan on a batch that
does not split over "data" to one device in f32 (F32_TOL).
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

import test_torch_mesh_train as mt  # noqa: E402  (the shared harness)

ROOT = Path(__file__).resolve().parents[1]
ARCH = mt.ARCH
LOSS_TOL, STEP_TOL, NORM_TOL, PARAM_TOL = (mt.LOSS_TOL, mt.STEP_TOL,
                                           mt.NORM_TOL, mt.PARAM_TOL)
LR, STEPS = mt.LR, mt.STEPS
#: the wire primitive against numpy's mean of the reference's per-shard
#: dequantization: 1 f32 ulp of the result (the mean's sum order)
ULP_TOL = 1
#: f32 logits on a mesh against one device's, of their scale (f32 sums
#: in another order)
F32_TOL = 1e-5
#: (pod, data, model) of each port mesh ("2x2" is (data, model))
MESHES = {"2x2": (0, 2, 2), "2x2x1": (2, 2, 1), "1x4": (0, 1, 4),
          "1x1x1": (1, 1, 1)}
#: the wire primitive's inputs: (rows, width), one row per pod
WIRE = {2: (2, 128), 4: (4, 128)}


def wire_input(pods):
    rows, width = WIRE[pods]
    return np.random.default_rng(7 + pods).standard_normal(
        (rows, width)).astype(np.float32)


# ---------------------------------------------------------------------------
# The port's ranks (no JAX here)
# ---------------------------------------------------------------------------
def port_rank(shape, rank, out):
    """One rank of the port on ``shape``; rank 0 writes the results under
    ``OUT/<shape>/``."""
    pod, d, m = MESHES[shape]
    world = max(pod, 1) * d * m
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(world),
                      LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.ckpt import load_pytree, save_pytree
    from repro_torch.configs import get_smoke
    from repro_torch.launch.mesh import init_distributed, make_device_mesh
    from repro_torch.models import api
    from repro_torch.sharding import use_mesh
    from repro_torch.train import opt_state_pspecs

    here = out / shape
    here.mkdir(parents=True, exist_ok=True)
    init_distributed("cpu", "file://" + str(out / f"rendezvous-{shape}"))
    mesh = make_device_mesh(d, m, pod=pod, device="cpu")
    cfg = get_smoke(ARCH)
    ps = api.pspecs(cfg, mesh)
    named = {"params": mt._named(ps, mesh),
             "opt": mt._named(opt_state_pspecs(cfg, ps, "int8"), mesh)}
    res = {"axes": list(mesh.device_mesh.mesh_dim_names)}
    with use_mesh(mesh):
        if shape == "1x4":
            src = out / "2x2x1" / "ckpt"
            mt._wait_for(src / "written")
            placed_tree, _ = load_pytree(str(src), shardings=named)
            whole = mt._whole(placed_tree)
            plain, _ = load_pytree(str(src))
            plain = {p: t.float().numpy() for p, t in
                     mt_items(plain)}
            res["restore_exact"] = set(whole) == set(plain) and all(
                np.array_equal(whole[p], plain[p]) for p in plain)
            res["restore_sharded"] = sorted(
                p for p, t in mt_items(placed_tree)
                if tuple(t.to_local().shape) != tuple(t.shape))
        else:
            params, _ = load_pytree(str(out / "ref_params"),
                                    shardings={"params": named["params"]})
            res["quantize"] = placed_quantize(mesh)
            if shape == "2x2":
                res["rows_unsplit"] = rows_unsplit(mesh)
            p, s, hist, scales, res["placements"] = int8_steps(
                cfg, params["params"], mesh)
            res["history"] = hist
            state = mt._whole({"params": p, "opt": s})
            if rank == 0:
                mt._save_np(here / "state.npz", state)
                mt._save_np(here / "scales.npz", scales)
            if shape == "2x2x1":
                res["wire"] = {str(n): wire_case(n, mesh)
                               for n in sorted(WIRE)}
                save_pytree({"params": p, "opt": s}, str(here / "ckpt"),
                            STEPS)
                if rank == 0:
                    (here / "ckpt" / "written").write_text("")
    if rank == 0:
        (here / "result.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


def placed_quantize(mesh):
    """``quantize_int8`` of a seeded (8, 64) f32 array placed over every
    mesh dim that splits it (its largest entry in the last rank's block)
    against the same array's on one device: whether the gathered payload
    and the scale are bit-equal."""
    from repro_torch.sharding import NamedSharding, distribute, spec_for
    from repro_torch.train.compress import quantize_int8
    x = torch.from_numpy(np.random.default_rng(3).standard_normal(
        (8, 64)).astype(np.float32))
    x[-1, -1] = 9.0
    spec = spec_for(x.shape, ("batch", "embed"), mesh)
    q, scale = quantize_int8(distribute(x, NamedSharding(mesh, spec)))
    q1, scale1 = quantize_int8(x)
    return {"spec": [list(e) if isinstance(e, tuple) else e for e in spec],
            "equal": bool(torch.equal(q.full_tensor(), q1)
                          and torch.equal(scale, scale1))}


def rows_unsplit(mesh):
    """rwkv6-1.6b SMOKE's prefill logits in f32 (parameters cast) on a
    batch of one row, which does not split over "data" (its row-parallel
    projections leave partial sums there), against one device's: the
    largest difference and the logits' scale."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import api
    from repro_torch.models.common import tree_map
    from repro_torch.sharding import distribute, named_sharding, placed
    cfg = get_smoke("rwkv6-1.6b")
    toks = torch.from_numpy(np.random.default_rng(5).integers(
        0, cfg.vocab, (1, 16)).astype(np.int32))
    f32 = lambda tree: tree_map(lambda t: t.float(), tree)
    with torch.no_grad():
        one = api.prefill(cfg, f32(api.init(cfg, 0, "cpu")),
                          {"tokens": toks})[0]
        got = api.prefill(cfg, f32(api.init(cfg, 0, "cpu", mesh=mesh)), {
            "tokens": distribute(toks, named_sharding(toks.shape,
                                                      ("batch", None)))})[0]
    got = got.full_tensor() if placed(got) else got
    return [float((got - one).abs().max()), float(one.abs().max())]


def mt_items(tree):
    from repro_torch.models.common import tree_items
    return tree_items(tree)


def placements_of(tree):
    """{path: [placement names]} of a placed tree."""
    return {p: [repr(x) for x in t.placements] for p, t in mt_items(tree)}


def recorded_scales(run):
    """``run()`` with the int8 quantizer's scales recorded in call order:
    (its result, [scale as a float])."""
    from repro_torch.train import compress
    got, quantize = [], compress.quantize_int8

    def spy(x):
        q, scale = quantize(x)
        got.append(float(scale))
        return q, scale
    compress.quantize_int8 = spy
    try:
        return run(), got
    finally:
        compress.quantize_int8 = quantize


def int8_steps(cfg, params, mesh=None):
    """Three int8 AdamW steps from ``params``: (params, state, history,
    {path: the last step's scale}, placements or None).  The placements
    are those of the residuals at init and after the steps, and the
    parameters'."""
    from repro_torch.models import api
    from repro_torch.train import make_train_step
    step = make_train_step(cfg, lr=LR, grad_compression="int8",
                           params_pspecs=None if mesh is None
                           else api.pspecs(cfg, mesh))
    state = step.init_state(params)
    places = None
    if mesh is not None:
        places = {"init": placements_of(state["ef_residual"]),
                  "params": placements_of(params)}
    hist = []
    for i in range(STEPS):
        batch = {"tokens": torch.from_numpy(mt.tokens(i))}
        if i == STEPS - 1:
            (params, state, m), scales = recorded_scales(
                lambda: step(params, state, batch))
        else:
            params, state, m = step(params, state, batch)
        hist.append({k: float(v) for k, v in m.items()})
    if mesh is not None:
        places["after"] = placements_of(state["ef_residual"])
    paths = [p for p, _ in mt_items(params)]
    assert len(scales) == len(paths)
    return params, state, hist, {p: np.float32(s) for p, s in
                                 zip(paths, scales)}, places


def wire_case(pods, mesh):
    """``compressed_allreduce_mean`` over "pod" on ``pods`` pods of the
    four ranks (the mesh's own pod axis, or a (4, 1, 1) mesh), this rank's
    row of ``wire_input``, under the collective counter."""
    from torch.distributed.device_mesh import init_device_mesh

    from repro_torch.launch.mesh import Mesh
    from repro_torch.launch.roofline import CollectiveCounter
    from repro_torch.sharding import use_mesh
    from repro_torch.train.compress import compressed_allreduce_mean
    if mesh.shape["pod"] != pods:
        shape = (pods, 1, 1)
        dm = init_device_mesh("cpu", shape, mesh_dim_names=mesh.axis_names)
        mesh = Mesh(shape, mesh.axis_names, "cpu", device_mesh=dm)
    coord = mesh.device_mesh.get_coordinate()[0]
    x = torch.from_numpy(wire_input(pods)[coord])
    counter = CollectiveCounter(mesh)
    with use_mesh(mesh), counter:
        got = compressed_allreduce_mean(x, "pod")
    return {"got": got.tolist(), "by_dim": counter.by_dim,
            "calls": counter.calls}


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
    from repro.train import make_train_step, opt_state_pspecs

    cfg = get_smoke(ARCH)
    res = {}
    for name, shape, axes in (("2x2", (2, 2), ("data", "model")),
                              ("2x2x1", (2, 2, 1), ("pod", "data", "model"))):
        mesh = jax.make_mesh(shape, axes,
                             axis_types=(AxisType.Auto,) * len(shape))
        with use_mesh(mesh):
            pspec = R.pspecs(cfg, mesh)
            put = lambda tree, specs: jax.tree.map(
                lambda x, sp: jax.device_put(x, NamedSharding(mesh, sp)),
                tree, specs)
            params = put(R.init(cfg, jax.random.PRNGKey(0)), pspec)
            step = make_train_step(cfg, lr=LR, grad_compression="int8",
                                   params_pspecs=pspec)
            state = step.init_state(params)
            state = put(state, opt_state_pspecs(cfg, pspec, "int8",
                                                mesh=mesh))
            jstep = jax.jit(step, donate_argnums=(0, 1))
            hist, text = [], None
            for i in range(STEPS):
                batch = {"tokens": jnp.asarray(mt.tokens(i))}
                if text is None:
                    text = jstep.lower(params, state, batch).compile() \
                        .as_text()
                params, state, m = jstep(params, state, batch)
                hist.append({k: float(v) for k, v in m.items()})
            res[name] = {"history": hist, "hlo_collectives": sorted({
                op for op in ("all-gather", "all-reduce", "reduce-scatter")
                if op in text})}
            flat = {".".join(str(getattr(k, "key", k)) for k in path):
                    np.asarray(v, np.float32) for path, v in
                    jax.tree_util.tree_flatten_with_path(params)[0]}
            mt._save_np(out / f"ref_state_{name}.npz", flat)
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
    from repro_torch.ckpt import load_pytree
    from repro_torch.configs import get_smoke

    out = tmp_path_factory.mktemp("pod")
    ref_save({"params": R.init(ref_smoke(ARCH), jax.random.PRNGKey(0))},
             str(out / "ref_params"), 0)
    me = str(Path(__file__).resolve())
    procs = {"ref": mt._start([sys.executable, me, "ref", str(out)],
                              out / "ref.log", JAX_PLATFORMS="cpu",
                              XLA_FLAGS="--xla_force_host_platform_device_"
                                        "count=4")}
    for shape, (pod, d, m) in MESHES.items():
        for r in range(max(pod, 1) * d * m):
            procs[f"{shape}/{r}"] = mt._start(
                [sys.executable, me, "port", shape, str(r), str(out)],
                out / f"port-{shape}-{r}.log")

    # meanwhile, here: one device
    cfg = get_smoke(ARCH)
    plain, _ = load_pytree(str(out / "ref_params"))
    p, s, hist, scales, _ = int8_steps(cfg, plain["params"])
    one = {"history": hist, "scales": scales,
           "state": {k: t.float().numpy() for k, t in
                     mt_items({"params": p, "opt": s})}}

    end = time.monotonic() + mt.DEADLINE_S
    for proc in procs.values():
        try:
            proc.wait(timeout=max(1.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            proc.kill()
            proc.wait()
    logs = {k: (out / ("ref.log" if k == "ref" else
                       "port-%s-%s.log" % tuple(k.split("/"))))
            .read_text()[-4000:] for k in procs}

    def result(shape):
        for k, proc in procs.items():
            if k.startswith(shape + "/") or k == shape:
                assert proc.returncode == 0, (k, logs[k])
        name = "ref.json" if shape == "ref" else f"{shape}/result.json"
        return json.loads((out / name).read_text())

    return {"out": out, "one": one, "result": result}


@pytest.mark.parametrize("pods", sorted(WIRE))
def test_compressed_allreduce_mean_over_pod(runs, pods):
    """The wire primitive over "pod" against the reference's quantization
    applied to each pod's shard and averaged."""
    import jax.numpy as jnp

    from repro.train.compress import dequantize_int8, quantize_int8
    got = runs["result"]("2x2x1")["wire"][str(pods)]
    g = wire_input(pods)
    deq = np.stack([np.asarray(dequantize_int8(*quantize_int8(
        jnp.asarray(row)))) for row in g])
    want = deq.mean(axis=0, dtype=np.float32)
    out = np.asarray(got["got"], np.float32)
    np.testing.assert_array_max_ulp(out, want, maxulp=ULP_TOL)
    err = float(np.abs(out - g.mean(axis=0)).max())
    assert err <= float(np.abs(g).max()) / 127.0 + 1e-6, err
    rows, width = WIRE[pods]
    # int8 payloads (1 B per element) and f32 scales, gathered over "pod"
    assert got["by_dim"] == {"pod": {"all-gather": rows * width + rows * 4}}
    assert got["calls"] == {"all-gather": 2}


@pytest.mark.parametrize("shape", ["2x2", "2x2x1"])
def test_residuals_keep_the_parameters_placements(runs, shape):
    places = runs["result"](shape)["placements"]
    assert places["init"] == places["params"] == places["after"]
    assert any("Shard" in str(v) for v in places["params"].values())
    if shape == "2x2x1":
        # no parameter rule names "pod": every leaf is whole over it
        assert all(v[0] == "Replicate()" for v in places["params"].values())


@pytest.mark.parametrize("shape", ["2x2", "2x2x1"])
def test_placed_quantization_is_one_devices(runs, shape):
    """One scale from the global max: a placed leaf quantizes bit for bit
    as one device quantizes the whole leaf."""
    got = runs["result"](shape)["quantize"]
    assert got["spec"][0] is not None      # the rows are split
    assert got["equal"]


def test_rwkv_rows_that_do_not_split_over_data(runs):
    """A batch of one row on 2x2: the rwkv scan gets its streams whole
    over "data" (not the projections' partial sums), so its f32 logits
    are one device's up to f32 rounding (F32_TOL)."""
    diff, scale = runs["result"]("2x2")["rows_unsplit"]
    assert diff < F32_TOL * max(scale, 1.0), (diff, scale)


def test_a_pod_mesh_splits_the_batch_over_pod_and_data(runs):
    from torch.distributed.tensor import Replicate, Shard

    from repro_torch.launch.mesh import make_host_mesh
    from repro_torch.sharding import placements, spec_for
    assert runs["result"]("2x2x1")["axes"] == ["pod", "data", "model"]
    mesh = make_host_mesh(2, 1, pod=2)
    spec = spec_for((8, 33), ("batch", None), mesh)
    assert spec == (("pod", "data"),)
    assert placements(spec, mesh) == (Shard(0), Shard(0), Replicate())


def _state(runs, against, shape):
    if against == "ref_sharded":
        ref = runs["result"]("ref")[shape]
        assert ref["hlo_collectives"], "the reference's step is not sharded"
        return ref["history"], {"params." + k: v for k, v in mt._load_np(
            runs["out"] / f"ref_state_{shape}.npz").items()}
    one = runs["one"]
    return one["history"], {k: v for k, v in one["state"].items()
                            if k.startswith("params.")}


@pytest.mark.parametrize("against", ["ref_sharded", "port_one"])
@pytest.mark.parametrize("shape", ["2x2", "2x2x1"])
def test_three_int8_steps_match(runs, shape, against):
    res = runs["result"](shape)
    want_hist, want = _state(runs, against, shape)
    assert len(res["history"]) == STEPS
    for got, w in zip(res["history"], want_hist):
        assert abs(got["loss"] - w["loss"]) < LOSS_TOL, (got, w)
        for k, v in w.items():
            tol = NORM_TOL * v if k == "grad_norm" else STEP_TOL
            assert abs(got[k] - v) < tol, (k, got[k], v)
    state = mt._load_np(runs["out"] / shape / "state.npz")
    for k, w in want.items():
        d = float(np.abs(state[k] - w).max())
        assert d < PARAM_TOL, (k, d)


@pytest.mark.parametrize("shape", ["2x2", "2x2x1"])
def test_residuals_within_one_quantization_step(runs, shape):
    one = runs["one"]
    state = mt._load_np(runs["out"] / shape / "state.npz")
    scales = mt._load_np(runs["out"] / shape / "scales.npz")
    prefix = "opt.ef_residual."
    keys = [k for k in one["state"] if k.startswith(prefix)]
    assert len(keys) == len(one["scales"]) > 0
    for k in keys:
        path = k[len(prefix):]
        step = max(one["scales"][path], scales[path])
        d = float(np.abs(state[k] - one["state"][k]).max())
        assert d <= step, (k, d, step)
        assert float(np.abs(one["state"][k]).max()) <= one["scales"][path]


def test_one_by_one_by_one_is_one_device_bit_for_bit(runs):
    res = runs["result"]("1x1x1")
    state = mt._load_np(runs["out"] / "1x1x1" / "state.npz")
    one = runs["one"]
    assert set(state) == set(one["state"])
    for k, w in one["state"].items():
        np.testing.assert_array_equal(state[k], w, err_msg=k)
    assert res["history"] == one["history"]


@pytest.mark.parametrize("onto", ["1x4", "one device"])
def test_the_int8_state_restores_onto_another_mesh(runs, onto):
    state = mt._load_np(runs["out"] / "2x2x1" / "state.npz")
    assert any(k.startswith("opt.ef_residual.") for k in state)
    if onto == "1x4":
        res = runs["result"]("1x4")
        assert res["restore_exact"]
        assert any(p.startswith("opt.ef_residual.")
                   for p in res["restore_sharded"])
        return
    from repro_torch.ckpt import load_pytree
    tree, _ = load_pytree(str(runs["out"] / "2x2x1" / "ckpt"))
    got = {p: t.float().numpy() for p, t in mt_items(tree)}
    assert set(got) == set(state)
    for k, w in state.items():
        np.testing.assert_array_equal(got[k], w, err_msg=k)


if __name__ == "__main__":
    if sys.argv[1] == "port":
        port_rank(sys.argv[2], int(sys.argv[3]), Path(sys.argv[4]))
    else:
        ref_side(Path(sys.argv[2]))
    sys.exit(0)
