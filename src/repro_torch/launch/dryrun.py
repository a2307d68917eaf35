"""Dry-run: trace every (arch x shape x mesh) cell's step on ``meta``,
as one rank of the cell's mesh.

The reference lowers and compiles each cell on 256 or 512 host
placeholder devices.  Here the process joins a ``"fake"`` process group of
the mesh's size (:func:`repro_torch.launch.mesh.fake_mesh`: a collective
returns at once and moves nothing) and runs one rank's step once on
DTensors whose blocks are ``meta`` tensors (shapes and dtypes only:
nothing is allocated, no CUDA context starts) under the counter of
:func:`repro_torch.launch.roofline.trace_step`.  Per cell it:

  1. builds the mesh (16x16 single-pod / 2x16x16 multi-pod, or the one
     given) and its ``DeviceMesh`` over the fake group,
  2. builds the cell's step (train_step / prefill / decode) over abstract
     parameters and inputs placed by the logical-axis rules: parameters,
     optimizer state, batch, token and cache are DTensors of their
     ``meta`` blocks, so placing them issues no collective
     (:func:`build_step`),
  3. traces it once: success is the deliverable,
  4. records one rank's own numbers: memory (its blocks of the arguments,
     the outputs and the donated aliases; temporaries the peak of the
     live storage its ops create), the cost (``flops`` and ``bytes
     accessed`` of its local ops) and the collectives DTensor issues
     (``coll``: bytes by kind; ``coll_by_dim``: by mesh dim and kind),
  5. (optionally, --roofline) traces the reference's small analysis
     variants the same way, solves and extrapolates the roofline terms
     against the H100 (see launch.roofline), the collective term at
     ``LINK_BW``.

The traced rank is 0 (the largest blocks: torch splits unevenly with the
larger blocks first); a decode cell traces the rank whose cache block
holds the written position, which writes it beside everything rank 0
does.  The record names it (``rank``).  A process already in a process
group (a rank of ``launch.train``) cannot trace a cell: :func:`run_cell`
raises.

Where the trace differs from the reference's compile, the record says so:

* ``moe: "dense surrogate"``: an MoE arch's group sizes cannot be read on
  ``meta``, so its experts run the same-work dense surrogate
  (``cfg.moe_dense_analysis``), as the reference's analysis variants do.
* ``rwkv_lengths``: rwkv's time loop is one step per token, too slow to
  trace at a cell's length.  Its forward is linear in the sequence
  length (it has no attention); its backward's bytes are quadratic
  (autograd's ``select_backward`` writes a zero gradient of a whole
  (B, S, H, P) stream for each token's slice, and the accumulation adds
  them).  So a train or prefill cell is traced at three short lengths at
  the cell's batch, and its flops, bytes, collectives and peak are the
  quadratic through them at the cell's length (exact for a polynomial of
  degree two or less).

Usage:
  python -m repro_torch.launch.dryrun --arch yi-9b --shape train_4k \
      [--multi-pod] [--roofline]
  python -m repro_torch.launch.dryrun --all [--multi-pod] [--roofline]
Results are appended as JSON lines to ``--out``.
"""
import argparse
import ast
import json
import math
import os
import time
import traceback
from typing import Optional

import torch

from ..configs import ARCHS, get_config
from ..models import SHAPES, api, supports_shape
from ..models.common import tree_from_items, tree_items, tree_map
from ..models.config import LMConfig, ShapeCell
from ..sharding import (NamedSharding, current_rules, distribute, spec_for,
                        use_mesh)
from ..train import make_train_step, opt_state_pspecs
from .mesh import fake_mesh, make_production_mesh
from .roofline import (Measurement, analysis_variants, roofline_terms,
                       solve_units, trace_step)
from .specs import input_shardings, input_specs

#: the sequence lengths an rwkv train or prefill cell is traced at
RWKV_LENGTHS = (32, 64, 128)
#: the bytes of the reference's int32 decode index (a host int here)
INDEX_BYTES = 4


class Step:
    """A cell's step function with what the reference's ``jax.jit`` is
    given: each argument's partition tree (``in_specs``), the result's
    (``out_specs(result)``) and the donated arguments; ``None`` in a
    partition tree replicates the whole subtree.  A donated argument is
    updated in place and returned as (part of) the result.
    :func:`build_step` places the arguments it makes on a mesh with a
    ``device_mesh`` by these partitions, and the step then runs under
    that mesh (``mesh``) and the rules it was built with (``rules``)."""

    def __init__(self, fn, in_specs, out_specs, donate_argnums=(),
                 mesh=None, rules=None):
        self.fn = fn
        self.in_specs = in_specs
        self.out_specs = out_specs
        self.donate_argnums = donate_argnums
        self.mesh = mesh
        self.rules = rules

    def __call__(self, *args):
        if getattr(self.mesh, "device_mesh", None) is None:
            return self.fn(*args)
        with use_mesh(self.mesh, self.rules):
            return self.fn(*args)


def _specs(shardings):
    """NamedSharding tree -> spec tree."""
    if isinstance(shardings, dict):
        return {k: _specs(v) for k, v in shardings.items()}
    return shardings.spec


def _like_schema(tree, schema, mesh):
    """The partitions of ``tree`` (a step's result) from the logical axes
    of the schema leaf at the same path, at the result's own shapes;
    replicated where the schema has no such leaf."""
    axes = {p: d.axes for p, d in tree_items(schema)}
    return tree_from_items((p, spec_for(t.shape, axes[p], mesh)
                            if p in axes and len(axes[p]) == t.dim() else ())
                           for p, t in tree_items(tree))


def _real_batch(cfg: LMConfig, batch, device, seed: int):
    gen = torch.Generator(device=device).manual_seed(seed)

    def make(t):
        if t.dtype == torch.int32:
            return torch.randint(0, cfg.vocab, t.shape, generator=gen,
                                 dtype=torch.int32, device=device)
        return torch.randn(t.shape, generator=gen, dtype=t.dtype,
                           device=device)
    return tree_map(make, batch)


def _placed(tree, specs, mesh):
    """A tree of whole (``meta``) tensors as DTensors on ``mesh``, each
    leaf by the spec tuple at its path: every rank keeps its own block."""
    return tree_map(lambda t, sp: distribute(t, NamedSharding(mesh, sp)),
                    tree, specs)


def build_step(cfg: LMConfig, cell: ShapeCell, mesh, device="meta",
               seed: int = 0):
    """Returns (step, example args tuple): abstract (``meta``) arguments,
    or with ``device="cuda"`` / ``"cpu"`` real ones of the same shapes
    made from ``seed``.  The partitions come from the rules of the active
    ``use_mesh`` (or the defaults) on ``mesh``.  On a mesh that carries a
    ``device_mesh`` the arguments are placed by them, as the reference's
    ``in_shardings`` place its arguments: real parameters and a real
    decode cache by ``api.init(mesh=)`` / ``api.init_cache(mesh=)``,
    abstract ones as DTensors of ``meta`` blocks, the optimizer state as
    its parameters, the batch and the token by ``sharding.distribute``;
    the step then runs on DTensors, under ``mesh``."""
    meta = torch.device(device).type == "meta"
    on = None if getattr(mesh, "device_mesh", None) is None else mesh
    params = api.abstract(cfg) if meta else api.init(cfg, seed, device,
                                                     mesh=on)
    pspec = api.pspecs(cfg, mesh)
    if meta and on is not None:
        params = _placed(params, pspec, on)
    b, s = cell.global_batch, cell.seq_len
    rules = current_rules()

    if cell.kind in ("train", "prefill"):
        batch = input_specs(cfg, cell)["batch"]
        shards = input_shardings(cfg, cell, mesh)["batch"]
        if not meta:
            batch = _real_batch(cfg, batch, device, seed)
        if on is not None:
            batch = {k: distribute(v, shards[k]) for k, v in batch.items()}
        batch_spec = _specs(shards)

    if cell.kind == "train":
        step = make_train_step(cfg, params_pspecs=pspec)
        opt = step.init_state(params)
        opt_spec = opt_state_pspecs(cfg, pspec)
        fn = Step(step, (pspec, opt_spec, batch_spec),
                  lambda out: (pspec, opt_spec, None), donate_argnums=(0, 1),
                  mesh=on, rules=rules)
        return fn, (params, opt, batch)

    if cell.kind == "prefill":
        cache_schema = api.cache_schema(cfg, b, s)
        fn = Step(lambda p, bt: api.prefill(cfg, p, bt), (pspec, batch_spec),
                  lambda out: (spec_for(out[0].shape, ("batch", "vocab"),
                                        mesh),
                               _like_schema(out[1], cache_schema, mesh)),
                  mesh=on, rules=rules)
        return fn, (params, batch)

    # decode: the port's index is a host int (api.decode); the last
    # position, as every position costs the same
    spec = input_specs(cfg, cell)
    shards = input_shardings(cfg, cell, mesh)
    if meta:
        token, cache = spec["token"], spec["cache"]
        if on is not None:
            cache = _placed(cache, shards["cache"], on)
    else:
        token = _real_batch(cfg, {"t": spec["token"]}, device, seed)["t"]
        cache = api.init_cache(cfg, b, s, device, mesh=on)
    if on is not None:
        token = distribute(token, shards["token"])
    fn = Step(lambda p, t, c, i: api.decode(cfg, p, t, c, i),
              (pspec, shards["token"].spec, shards["cache"],
               shards["index"].spec),
              lambda out: (spec_for(out[0].shape, ("batch", None, "vocab"),
                                    mesh), shards["cache"]),
              donate_argnums=(2,), mesh=on, rules=rules)
    return fn, (params, token, cache, s - 1)


# ---------------------------------------------------------------------------
# Bytes per device
# ---------------------------------------------------------------------------
def _device_bytes(t: torch.Tensor, spec, mesh) -> int:
    """A leaf's bytes on one device: each dim divided by the product of
    the mesh axes its spec entry names."""
    n = t.element_size()
    for i, d in enumerate(t.shape):
        e = spec[i] if spec and i < len(spec) else None
        axes = () if e is None else (e,) if isinstance(e, str) else e
        n *= -(-d // math.prod(mesh.shape[a] for a in axes))
    return n


def tree_bytes(tree, specs, mesh) -> int:
    """Bytes on one device of a tree of tensors (a host int counts as the
    reference's int32 scalar) with a parallel partition tree."""
    if isinstance(tree, dict):
        return sum(tree_bytes(v, None if specs is None else specs[k], mesh)
                   for k, v in tree.items())
    if isinstance(tree, (tuple, list)):
        return sum(tree_bytes(v, None if specs is None else sp, mesh)
                   for v, sp in zip(tree, specs or [None] * len(tree)))
    if isinstance(tree, int):
        return INDEX_BYTES
    return _device_bytes(tree, specs or (), mesh)


def local_bytes(tree) -> int:
    """Bytes this rank holds of a tree of tensors: each plain tensor
    whole, each DTensor's local block (a host int counts as the
    reference's int32 scalar)."""
    if isinstance(tree, dict):
        return sum(local_bytes(v) for v in tree.values())
    if isinstance(tree, (tuple, list)):
        return sum(local_bytes(v) for v in tree)
    if isinstance(tree, int):
        return INDEX_BYTES
    if isinstance(tree, torch.Tensor):
        t = tree.to_local() if hasattr(tree, "to_local") else tree
        return t.numel() * t.element_size()
    return 0


def memory_record(fn: Step, args, out, temp_bytes: float) -> dict:
    """The reference's ``memory_analysis()`` fields of one rank: its
    blocks of the arguments, the results and the donated arguments, and
    ``temp_bytes`` (the trace's peak of live created storage)."""
    arg = local_bytes(args)
    outb = local_bytes(out)
    alias = sum(local_bytes(args[i]) for i in fn.donate_argnums)
    temp = int(temp_bytes)
    return {"argument_bytes": arg, "output_bytes": outb, "temp_bytes": temp,
            "alias_bytes": alias, "code_bytes": 0,
            "total_bytes": arg + outb + temp - alias}


# ---------------------------------------------------------------------------
# Tracing a cell
# ---------------------------------------------------------------------------
def _traced(cfg: LMConfig, cell: ShapeCell, mesh, rules=None):
    """The step built under the mesh's rules and traced once.  On a mesh
    with a ``device_mesh`` (the fake group's, :func:`run_cell`) it runs
    there on placed ``meta`` blocks, and the counts are this rank's; on
    one without (a host mesh) it runs as one device's step."""
    with use_mesh(mesh, rules=rules):
        fn, args = build_step(cfg, cell, mesh)
    out, m = trace_step(fn, *args, mesh=fn.mesh)
    return fn, args, out, m


def _quadratic_at(xs, ys, x: float) -> float:
    """The polynomial of degree len(xs) - 1 through (xs, ys) at x
    (Lagrange's form)."""
    return sum(y * math.prod((x - xj) / (xi - xj)
                             for j, xj in enumerate(xs) if j != i)
               for i, (xi, y) in enumerate(zip(xs, ys)))


def measure_cell(cfg: LMConfig, cell: ShapeCell, mesh, rules=None):
    """(step, args, output, Measurement, traced lengths or None) of the
    cell's step on ``meta``.  An rwkv train or prefill cell longer than
    ``RWKV_LENGTHS`` is traced at those lengths (the cell's batch), and its
    flops, bytes, collectives and peak are the quadratic through them at
    its length; its results' shapes do not depend on the length."""
    if not (cfg.family == "rwkv" and cell.kind != "decode"
            and cell.seq_len > RWKV_LENGTHS[-1]):
        return (*_traced(cfg, cell, mesh, rules), None)
    outs, got = zip(*[_traced(cfg, ShapeCell(cell.name, n, cell.global_batch,
                                             cell.kind), mesh, rules)[2:]
                      for n in RWKV_LENGTHS])
    at = lambda ys: _quadratic_at(RWKV_LENGTHS, ys, cell.seq_len)
    coll = {k: at([m.coll.get(k, 0.0) for m in got])
            for k in sorted({k for m in got for k in m.coll})}
    by_dim = {d: {k: at([m.coll_by_dim.get(d, {}).get(k, 0.0) for m in got])
                  for k in sorted({k for m in got
                                   for k in m.coll_by_dim.get(d, {})})}
              for d in sorted({d for m in got for d in m.coll_by_dim})}
    m = Measurement(at([m.flops for m in got]),
                    at([m.bytes_accessed for m in got]), coll,
                    at([m.peak_bytes for m in got]), by_dim)
    with use_mesh(mesh, rules=rules):
        fn, args = build_step(cfg, cell, mesh)
    return fn, args, outs[-1], m, list(RWKV_LENGTHS)


def _mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape.values())


def traced_rank(cfg: LMConfig, cell: ShapeCell, mesh, rules=None) -> int:
    """The rank whose step :func:`run_cell` traces: 0, or for a decode
    cell the rank at the last block of every mesh axis that splits the
    cache's positions (``kv_seq``), which owns the written position."""
    if cell.kind != "decode":
        return 0
    with use_mesh(mesh, rules=rules):
        ent = spec_for((cell.seq_len,), ("kv_seq",), mesh)
    axes = () if not ent or ent[0] is None else (
        (ent[0],) if isinstance(ent[0], str) else ent[0])
    rank = 0
    for a in mesh.axis_names:
        rank = rank * mesh.shape[a] + (mesh.shape[a] - 1 if a in axes else 0)
    return rank


def traced_config(cfg: LMConfig):
    """(config, rules) that a cell of ``cfg`` is traced with: an MoE
    arch's dense surrogate (``moe_dense_analysis``), its experts over
    "model" x "data" under ``ep_over_data``, and the embedding whole
    without FSDP."""
    rules = {}
    if cfg.ep_over_data:
        rules["experts"] = ("model", "data")
    if not cfg.fsdp:
        rules["embed"] = None
    if cfg.n_experts:
        cfg = cfg.replace(moe_dense_analysis=True)
    return cfg, rules or None


def _check_dims(by_dim, mesh) -> None:
    """Raises unless every mesh dim of a collective breakdown is one of
    ``mesh``'s axes (a group of an earlier fake mesh is counted by its
    own name)."""
    stray = sorted(set(by_dim) - set(mesh.axis_names))
    if stray:
        raise RuntimeError(f"collectives on groups {stray} that are no "
                           f"dim of the mesh {tuple(mesh.axis_names)}")


def roofline_record(cfg: LMConfig, cell: ShapeCell, placed, rules) -> dict:
    """The roofline of a cell of ``cfg`` (as :func:`traced_config` gives
    it) on ``placed`` (the mesh :func:`fake_mesh` yields): the
    reference's analysis variants traced as this rank, the unit solve's
    extrapolation to the cell's depth, and the terms against the H100,
    the collective term at ``LINK_BW`` (``coll_by_dim`` beside them)."""
    variants, full_counts = analysis_variants(cfg, cell)
    measured = [(counts, measure_cell(vcfg, cell, placed, rules)[3])
                for vcfg, counts in variants]
    m = solve_units(measured, full_counts)
    _check_dims(m.coll_by_dim, placed)
    rl = roofline_terms(m, cfg, cell, placed.devices.size).as_dict()
    rl["coll_by_dim"] = m.coll_by_dim
    return rl


def run_cell(arch: str, shape, multi_pod: bool, do_roofline: bool,
             cfg_override: Optional[LMConfig] = None, tag: str = "",
             mesh=None):
    """One cell's record, the trace of :func:`traced_rank` on a fake group
    of the mesh's size.  ``shape``: a name of ``SHAPES`` or a
    ``ShapeCell``; ``mesh``: the production mesh unless given.  Raises in
    a process that already belongs to a group."""
    cfg = cfg_override or get_config(arch)
    cell = shape if isinstance(shape, ShapeCell) else SHAPES[shape]
    mesh = mesh or make_production_mesh(multi_pod=multi_pod)
    rec = {"arch": arch, "shape": cell.name, "mesh": _mesh_name(mesh),
           "tag": tag, "status": "skipped", "time_s": 0.0}
    if not supports_shape(cfg, cell.name):
        rec["reason"] = ("pure full-attention arch: no sub-quadratic "
                         "long-context path (DESIGN §Arch-applicability)")
        return rec
    t0 = time.time()
    cfg, rules = traced_config(cfg)
    rank = traced_rank(cfg, cell, mesh, rules)
    rec.update(traced="meta", rank=rank, per_device="one rank's trace on a "
               "fake group of the mesh's size: its blocks of the arguments, "
               "outputs and aliases, the peak of its live storage, its "
               "local ops' flops and bytes, the collectives it issues")
    if cfg.n_experts:
        rec["moe"] = "dense surrogate"
    with fake_mesh(mesh, rank) as placed:
        try:
            fn, args, out, m, lengths = measure_cell(cfg, cell, placed,
                                                     rules)
            _check_dims(m.coll_by_dim, placed)
            if lengths:
                rec["rwkv_lengths"] = lengths
            rec["memory"] = memory_record(fn, args, out, m.peak_bytes)
            rec["cost_analysis"] = {"flops": m.flops,
                                    "bytes accessed": m.bytes_accessed}
            rec["coll"] = m.coll
            rec["coll_by_dim"] = m.coll_by_dim
            if do_roofline:
                rec["roofline"] = roofline_record(cfg, cell, placed, rules)
            rec["status"] = "ok"
        except Exception as e:
            rec["status"] = "error"
            rec["error"] = f"{type(e).__name__}: {e}"
            rec["traceback"] = traceback.format_exc()[-4000:]
    rec["time_s"] = round(time.time() - t0, 1)
    return rec


def _override(v: str):
    """A ``--set`` value: a Python literal, ``true`` / ``false`` in any
    case as a bool (``--set seq_parallel_proj=false`` turns it off), or
    else the string."""
    if v.lower() in ("true", "false"):
        return v.lower() == "true"
    try:
        return ast.literal_eval(v)
    except (ValueError, SyntaxError):
        return v


def main(argv=None):
    """The reference's CLI; returns the records it appended to ``--out``."""
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", choices=ARCHS)
    ap.add_argument("--shape", choices=list(SHAPES))
    ap.add_argument("--all", action="store_true")
    ap.add_argument("--multi-pod", action="store_true")
    ap.add_argument("--roofline", action="store_true")
    ap.add_argument("--out", default="experiments/dryrun.jsonl")
    ap.add_argument("--tag", default="", help="label for this record")
    ap.add_argument("--set", action="append", default=[],
                    help="config override key=value (perf iterations)")
    args = ap.parse_args(argv)

    overrides = {}
    for kv in args.set:
        k, v = kv.split("=", 1)
        overrides[k] = _override(v)

    if args.all:
        cells = [(a, s) for a in ARCHS for s in SHAPES]
    else:
        if not (args.arch and args.shape):
            ap.error("--arch/--shape or --all required")
        cells = [(args.arch, args.shape)]

    os.makedirs(os.path.dirname(args.out) or ".", exist_ok=True)
    records = []
    for arch, shape in cells:
        cfg_override = (get_config(arch).replace(**overrides)
                        if overrides else None)
        rec = run_cell(arch, shape, args.multi_pod, args.roofline,
                       cfg_override=cfg_override, tag=args.tag)
        line = {k: v for k, v in rec.items() if k != "traceback"}
        print(json.dumps({k: line[k] for k in
                          ("arch", "shape", "mesh", "status", "time_s")}),
              flush=True)
        if rec["status"] == "error":
            print(rec["error"])
            print(rec.get("traceback", "")[-2000:])
        with open(args.out, "a") as f:
            f.write(json.dumps(rec) + "\n")
        records.append(rec)
    return records


if __name__ == "__main__":
    main()
