"""The port's dry-run traced on real placements: one rank of a fake
process group of the mesh's size, its parameters, optimizer state, batch,
token and cache DTensors of ``meta`` blocks, its collectives counted.

Every fake group runs in a subprocess (``python
tests/test_torch_dryrun_placed.py fake DIR``), so pytest's own process
joins no group; one module fixture starts every side at once:

- the fake side: granite-3-8b, qwen3-moe-30b-a3b and zamba2-1.2b SMOKE
  train and decode cells on a fake 4x4 mesh (the mirror of the
  reference's ``tests/test_dryrun_small.py`` first check), granite-3-8b
  SMOKE on the 16x16 and 2x16x16 production meshes and on 2x2 and 1x1
  host meshes, each record with what the partitions say its rank holds,
  and the 1x1 cells' one-device traces;
- four gloo ranks, ``... real RANK DIR``, which run granite-3-8b SMOKE's
  train and decode steps on real CPU tensors placed on a 2x2 mesh under
  the same counter, and call ``run_cell`` from inside their group;
- the reference's side, ``... ref DIR``, its ``build_step`` compiled on a
  2x2 mesh of ``AxisType.Auto`` axes (4 host devices): its
  ``memory_analysis()`` and its HLO's collective bytes.

The trace on ``meta`` equals the real run exactly (flops, bytes, and
collective bytes by kind and mesh dim: the same ops on the same shapes);
arguments and aliases equal the partition arithmetic and the reference's
compile exactly.  GSPMD and DTensor choose different collectives, so the
reference's HLO collective bytes are reported beside the port's, not
held to them.
"""
import json
import os
import subprocess
import sys
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("granite-3-8b", "qwen3-moe-30b-a3b", "zamba2-1.2b")
#: (name, seq_len, global_batch, kind) of the reference test's cells
CELLS = {"train": ("t", 64, 8, "train"), "decode": ("d", 64, 8, "decode")}
#: the production meshes' cells: a batch that splits over 2 x 16
PROD_CELLS = {"train": ("t", 64, 32, "train"),
              "decode": ("d", 64, 32, "decode")}
DEADLINE_S = 240


def _cell(spec):
    from repro_torch.models.config import ShapeCell
    return ShapeCell(*spec)


def _measured(m):
    return {"flops": m.flops, "bytes": m.bytes_accessed, "coll": m.coll,
            "coll_by_dim": m.coll_by_dim}


def _from_record(rec):
    return {"flops": rec["cost_analysis"]["flops"],
            "bytes": rec["cost_analysis"]["bytes accessed"],
            "coll": rec["coll"], "coll_by_dim": rec["coll_by_dim"]}


# ---------------------------------------------------------------------------
# The fake side: every fake group of this file, in this one process
# ---------------------------------------------------------------------------
def fake_side(out):
    import torch.distributed as dist

    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import make_host_mesh, make_production_mesh
    from repro_torch.sharding import use_mesh
    res = {"small": {}, "prod": {}, "host2x2": {}, "one": {},
           "left_a_group": False}

    def cell(arch, spec, mesh):
        rec = dryrun.run_cell(arch, _cell(spec), False, False,
                              cfg_override=get_smoke(arch), mesh=mesh)
        res["left_a_group"] |= dist.is_initialized()
        return {k: v for k, v in rec.items() if k != "traceback"} \
            if rec["status"] == "ok" else rec

    for arch in ARCHS:
        for kind, spec in CELLS.items():
            res["small"][f"{arch}:{kind}"] = cell(arch, spec,
                                                  make_host_mesh(4, 4))
    cfg = get_smoke("granite-3-8b")
    for kind, spec in CELLS.items():
        res["host2x2"][kind] = cell("granite-3-8b", spec,
                                    make_host_mesh(2, 2))
        m = dryrun.measure_cell(cfg, _cell(spec), make_host_mesh())[3]
        res["one"][kind] = {"placed": cell("granite-3-8b", spec,
                                           make_host_mesh(1, 1)),
                            "flops": m.flops, "peak": m.peak_bytes}
    for name, mesh in (("16x16", make_production_mesh()),
                       ("2x16x16", make_production_mesh(multi_pod=True))):
        for kind, spec in PROD_CELLS.items():
            t0 = time.time()
            rec = cell("granite-3-8b", spec, mesh)
            rec["wall_s"] = time.time() - t0
            with use_mesh(mesh):
                fn, args = dryrun.build_step(cfg, _cell(spec), mesh)
            rec["want"] = {
                "argument_bytes": dryrun.tree_bytes(args, fn.in_specs, mesh),
                "alias_bytes": sum(dryrun.tree_bytes(args[i], fn.in_specs[i],
                                                     mesh)
                                   for i in fn.donate_argnums)}
            res["prod"][f"{name}:{kind}"] = rec
    (out / "fake.json").write_text(json.dumps(res))


# ---------------------------------------------------------------------------
# The real side: four gloo ranks of a 2x2 mesh
# ---------------------------------------------------------------------------
def real_rank(rank, out):
    os.environ.update(RANK=str(rank), WORLD_SIZE="4", LOCAL_RANK=str(rank))
    torch.set_num_threads(1)
    import torch.distributed as dist

    from repro_torch.configs import get_smoke
    from repro_torch.launch import dryrun
    from repro_torch.launch.mesh import (forget_device_meshes,
                                         init_distributed, make_device_mesh,
                                         make_host_mesh)
    from repro_torch.launch.roofline import trace_step
    from repro_torch.sharding import use_mesh
    init_distributed("cpu", "file://" + str(out / "rendezvous"))
    mesh = make_device_mesh(2, 2, device="cpu")
    cfg = get_smoke("granite-3-8b")
    res = {"rank": rank}
    for kind, spec in CELLS.items():
        # on DTensor's fresh plan caches, as each fake cell runs (a plan
        # cached by an earlier step can place an op's result otherwise)
        forget_device_meshes()
        with use_mesh(mesh):
            fn, args = dryrun.build_step(cfg, _cell(spec), mesh,
                                         device="cpu")
        res[kind] = _measured(trace_step(fn, *args, mesh=mesh)[1])
    try:
        dryrun.run_cell("granite-3-8b", _cell(CELLS["train"]), False, False,
                        cfg_override=cfg, mesh=make_host_mesh(2, 2))
        res["inside_a_group"] = "ran"
    except RuntimeError as e:
        res["inside_a_group"] = str(e)
    # the group is intact: one more collective on it
    t = torch.ones(1)
    dist.all_reduce(t)
    res["group_after"] = [dist.is_initialized(), float(t)]
    (out / f"real-{rank}.json").write_text(json.dumps(res))
    dist.barrier()
    dist.destroy_process_group()


# ---------------------------------------------------------------------------
# The reference's side (its own process: 4 host devices)
# ---------------------------------------------------------------------------
def ref_side(out):
    import jax
    from jax.sharding import AxisType

    jax.devices()       # the backend starts with 4 devices, before the
    from repro.configs import get_smoke      # dry-run module's XLA_FLAGS
    from repro.launch.dryrun import build_step
    from repro.launch.roofline import collective_bytes
    from repro.models.config import ShapeCell
    from repro.sharding import use_mesh
    mesh = jax.make_mesh((2, 2), ("data", "model"),
                         axis_types=(AxisType.Auto,) * 2)
    res = {}
    for kind, spec in CELLS.items():
        with use_mesh(mesh):
            fn, args = build_step(get_smoke("granite-3-8b"),
                                  ShapeCell(*spec), mesh)
            compiled = fn.lower(*args).compile()
        ma = compiled.memory_analysis()
        res[kind] = {"argument_bytes": ma.argument_size_in_bytes,
                     "alias_bytes": ma.alias_size_in_bytes,
                     "collective_bytes": collective_bytes(
                         compiled.as_text())}
    (out / "ref.json").write_text(json.dumps(res))


# ---------------------------------------------------------------------------
# The tests
# ---------------------------------------------------------------------------
def _start(argv, log, **env):
    with open(log, "w") as f:
        return subprocess.Popen(argv, cwd=ROOT, stdout=f, stderr=f,
                                env=dict(os.environ, PYTHONPATH=str(
                                    ROOT / "src"), OMP_NUM_THREADS="1",
                                         **env))


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    out = tmp_path_factory.mktemp("placed")
    me = str(Path(__file__).resolve())
    procs = {"fake": _start([sys.executable, me, "fake", str(out)],
                            out / "fake.log"),
             "ref": _start([sys.executable, me, "ref", str(out)],
                           out / "ref.log", JAX_PLATFORMS="cpu",
                           XLA_FLAGS="--xla_force_host_platform_device_"
                                     "count=4")}
    for r in range(4):
        procs[f"real-{r}"] = _start([sys.executable, me, "real", str(r),
                                     str(out)], out / f"real-{r}.log")
    end = time.monotonic() + DEADLINE_S
    for p in procs.values():
        try:
            p.wait(timeout=max(1.0, end - time.monotonic()))
        except subprocess.TimeoutExpired:
            p.kill()
            p.wait()

    def result(name):
        log = (out / f"{name}.log").read_text()[-4000:]
        assert procs[name].returncode == 0, (name, log)
        return json.loads((out / f"{name}.json").read_text())
    return result


@pytest.mark.parametrize("kind", list(CELLS))
@pytest.mark.parametrize("arch", ARCHS)
def test_smoke_cells_trace_on_a_fake_4x4_mesh(runs, arch, kind):
    fake = runs("fake")
    rec = fake["small"][f"{arch}:{kind}"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == "4x4"
    assert rec["rank"] == (0 if kind == "train" else 3)
    if kind == "train":
        assert rec["coll"]["total"] > 0
        assert {"data", "model"} <= set(rec["coll_by_dim"])
    assert "collectives" not in rec
    assert not fake["left_a_group"]


@pytest.mark.parametrize("kind", list(CELLS))
def test_a_fake_2x2_trace_equals_a_real_2x2_run(runs, kind):
    rec = runs("fake")["host2x2"][kind]
    assert rec["status"] == "ok", rec.get("traceback")
    real = runs(f"real-{rec['rank']}")[kind]
    got = _from_record(rec)
    assert got["coll"]["total"] > 0
    assert got == real


@pytest.mark.parametrize("kind", list(CELLS))
def test_a_1x1_trace_is_one_devices(runs, kind):
    """A one-rank mesh runs the step's products and holds its storage as
    one device does: DTensor's own shape work (fake tensors of the
    global shapes) counts for nothing."""
    one = runs("fake")["one"][kind]
    rec = one["placed"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["cost_analysis"]["flops"] == one["flops"]
    assert rec["memory"]["temp_bytes"] == one["peak"]


def test_run_cell_inside_a_group_raises_and_keeps_it(runs):
    for r in range(4):
        res = runs(f"real-{r}")
        assert "already belongs to a process group" in \
            res["inside_a_group"]
        assert res["group_after"] == [True, 4.0]


@pytest.mark.parametrize("kind", list(PROD_CELLS))
@pytest.mark.parametrize("mesh", ["16x16", "2x16x16"])
def test_production_mesh_bytes_are_the_partition_arithmetic(runs, mesh,
                                                             kind):
    rec = runs("fake")["prod"][f"{mesh}:{kind}"]
    assert rec["status"] == "ok", rec.get("traceback")
    assert rec["mesh"] == mesh
    for k, want in rec["want"].items():
        assert rec["memory"][k] == want, (k, rec["memory"][k], want)
    assert rec["coll"]["total"] > 0


@pytest.mark.parametrize("kind", list(CELLS))
def test_host_2x2_bytes_equal_the_reference_compile(runs, kind):
    rec = runs("fake")["host2x2"][kind]
    ref = runs("ref")[kind]
    why = (f"collective bytes per device: port {rec['coll']} by dim "
           f"{rec['coll_by_dim']}, the reference's HLO "
           f"{ref['collective_bytes']}")
    assert rec["memory"]["argument_bytes"] == ref["argument_bytes"], why
    assert rec["memory"]["alias_bytes"] == ref["alias_bytes"], why


if __name__ == "__main__":
    if sys.argv[1] == "fake":
        fake_side(Path(sys.argv[2]))
    elif sys.argv[1] == "real":
        real_rank(int(sys.argv[2]), Path(sys.argv[3]))
    else:
        ref_side(Path(sys.argv[2]))
    sys.exit(0)
