"""Dry-run: trace every (arch x shape x mesh) cell's step on ``meta``.

The reference lowers and compiles each cell on 256 or 512 host
placeholder devices.  The port runs each step on one device, so here the
step runs once on ``meta`` tensors (shapes and dtypes only: nothing is
allocated, no CUDA context starts) under the counter of
:func:`repro_torch.launch.roofline.trace_step`.  Per cell it:

  1. builds the production mesh (16x16 single-pod / 2x16x16 multi-pod) of
     ``meta`` placeholders,
  2. builds the cell's step (train_step / prefill / decode) over abstract
     parameters and inputs, with the partition of every argument from the
     logical-axis rules, recorded (applied only to real arguments on a
     mesh that carries a ``device_mesh``: :func:`build_step`),
  3. traces it once: success is the deliverable,
  4. records the memory per device (arguments, outputs and donated
     aliases by their partitions; temporaries the traced step's peak of
     live storage split evenly) and the cost (``flops``, ``bytes
     accessed``),
  5. (optionally, --roofline) traces the reference's small analysis
     variants, solves and extrapolates the roofline terms against the
     H100 (see launch.roofline), split evenly over the mesh's devices.

Where the trace differs from the reference's compile, the record says so:

* ``collectives: "one device"``: the step has no collective.
* ``moe: "dense surrogate"``: an MoE arch's group sizes cannot be read on
  ``meta``, so its experts run the same-work dense surrogate
  (``cfg.moe_dense_analysis``), as the reference's analysis variants do.
* ``rwkv_lengths``: rwkv's time loop is one step per token, too slow to
  trace at a cell's length.  Its forward is linear in the sequence
  length (it has no attention); its backward's bytes are quadratic
  (autograd's ``select_backward`` writes a zero gradient of a whole
  (B, S, H, P) stream for each token's slice, and the accumulation adds
  them).  So a train or prefill cell is traced at three short lengths at
  the cell's batch, and its flops, bytes and peak are the quadratic
  through them at the cell's length (exact for a polynomial of degree
  two or less).

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
from ..sharding import distribute, spec_for, use_mesh
from ..train import make_train_step, opt_state_pspecs
from .mesh import make_production_mesh
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
    updated in place and returned as (part of) the result.  The
    partitions are recorded; :func:`build_step` applies them to the
    arguments it makes on a mesh with a ``device_mesh``, and the step then
    runs under that mesh (``mesh``)."""

    def __init__(self, fn, in_specs, out_specs, donate_argnums=(),
                 mesh=None):
        self.fn = fn
        self.in_specs = in_specs
        self.out_specs = out_specs
        self.donate_argnums = donate_argnums
        self.mesh = mesh

    def __call__(self, *args):
        if getattr(self.mesh, "device_mesh", None) is None:
            return self.fn(*args)
        with use_mesh(self.mesh):
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


def build_step(cfg: LMConfig, cell: ShapeCell, mesh, device="meta",
               seed: int = 0):
    """Returns (step, example args tuple): abstract (``meta``) arguments,
    or with ``device="cuda"`` / ``"cpu"`` real ones of the same shapes
    made from ``seed``.  The partitions come from the rules of the active
    ``use_mesh`` (or the defaults) on ``mesh``.  Real arguments on a mesh
    that carries a ``device_mesh`` are placed by them, as the reference's
    ``in_shardings`` place its arguments: parameters and the decode cache
    by ``api.init(mesh=)`` / ``api.init_cache(mesh=)``, the optimizer state
    as its parameters, the batch and the token by ``sharding.distribute``;
    the step then runs on DTensors, under ``mesh``."""
    meta = torch.device(device).type == "meta"
    on = None if meta or getattr(mesh, "device_mesh", None) is None \
        else mesh
    params = api.abstract(cfg) if meta else api.init(cfg, seed, device,
                                                     mesh=on)
    pspec = api.pspecs(cfg, mesh)
    b, s = cell.global_batch, cell.seq_len

    if cell.kind in ("train", "prefill"):
        batch = input_specs(cfg, cell)["batch"]
        shards = input_shardings(cfg, cell, mesh)["batch"]
        if not meta:
            batch = _real_batch(cfg, batch, device, seed)
            if on is not None:
                batch = {k: distribute(v, shards[k])
                         for k, v in batch.items()}
        batch_spec = _specs(shards)

    if cell.kind == "train":
        step = make_train_step(cfg, params_pspecs=pspec)
        opt = step.init_state(params)
        opt_spec = opt_state_pspecs(cfg, pspec)
        fn = Step(step, (pspec, opt_spec, batch_spec),
                  lambda out: (pspec, opt_spec, None), donate_argnums=(0, 1),
                  mesh=on)
        return fn, (params, opt, batch)

    if cell.kind == "prefill":
        cache_schema = api.cache_schema(cfg, b, s)
        fn = Step(lambda p, bt: api.prefill(cfg, p, bt), (pspec, batch_spec),
                  lambda out: (spec_for(out[0].shape, ("batch", "vocab"),
                                        mesh),
                               _like_schema(out[1], cache_schema, mesh)),
                  mesh=on)
        return fn, (params, batch)

    # decode: the port's index is a host int (api.decode); the last
    # position, as every position costs the same
    spec = input_specs(cfg, cell)
    shards = input_shardings(cfg, cell, mesh)
    if meta:
        token, cache = spec["token"], spec["cache"]
    else:
        token = _real_batch(cfg, {"t": spec["token"]}, device, seed)["t"]
        if on is not None:
            token = distribute(token, shards["token"])
        cache = api.init_cache(cfg, b, s, device, mesh=on)
    fn = Step(lambda p, t, c, i: api.decode(cfg, p, t, c, i),
              (pspec, shards["token"].spec, shards["cache"],
               shards["index"].spec),
              lambda out: (spec_for(out[0].shape, ("batch", None, "vocab"),
                                    mesh), shards["cache"]),
              donate_argnums=(2,), mesh=on)
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


def memory_record(fn: Step, args, out, temp_bytes: float, mesh) -> dict:
    """The reference's ``memory_analysis()`` fields, per device."""
    arg = tree_bytes(args, fn.in_specs, mesh)
    outb = tree_bytes(out, fn.out_specs(out), mesh)
    alias = sum(tree_bytes(args[i], fn.in_specs[i], mesh)
                for i in fn.donate_argnums)
    temp = int(temp_bytes)
    return {"argument_bytes": arg, "output_bytes": outb, "temp_bytes": temp,
            "alias_bytes": alias, "code_bytes": 0,
            "total_bytes": arg + outb + temp - alias}


# ---------------------------------------------------------------------------
# Tracing a cell
# ---------------------------------------------------------------------------
def _traced(cfg: LMConfig, cell: ShapeCell, mesh, rules=None):
    """The step is built under the mesh's rules and traced outside them,
    as one device's step on ``meta`` (the production mesh places nothing;
    an MoE layer under a mesh with a "model" axis would need placed
    tensors: real placements are ROADMAP A14e)."""
    with use_mesh(mesh, rules=rules):
        fn, args = build_step(cfg, cell, mesh)
    out, m = trace_step(fn, *args)
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
    flops, bytes and peak are the quadratic through them at its length;
    its results' shapes do not depend on the length."""
    if not (cfg.family == "rwkv" and cell.kind != "decode"
            and cell.seq_len > RWKV_LENGTHS[-1]):
        return (*_traced(cfg, cell, mesh, rules), None)
    got = [_traced(cfg, ShapeCell(cell.name, n, cell.global_batch,
                                  cell.kind), mesh, rules)[2:]
           for n in RWKV_LENGTHS]
    at = lambda f: _quadratic_at(RWKV_LENGTHS, [getattr(m, f)
                                                for _, m in got],
                                 cell.seq_len)
    m = Measurement(at("flops"), at("bytes_accessed"), {"total": 0.0},
                    at("peak_bytes"))
    with use_mesh(mesh, rules=rules):
        fn, args = build_step(cfg, cell, mesh)
    return fn, args, got[-1][0], m, list(RWKV_LENGTHS)


def _mesh_name(mesh) -> str:
    return "x".join(str(n) for n in mesh.shape.values())


def run_cell(arch: str, shape, multi_pod: bool, do_roofline: bool,
             cfg_override: Optional[LMConfig] = None, tag: str = "",
             mesh=None):
    """One cell's record.  ``shape``: a name of ``SHAPES`` or a
    ``ShapeCell``; ``mesh``: the production mesh unless given."""
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
    n_dev = mesh.devices.size
    rules = {}
    if cfg.ep_over_data:
        rules["experts"] = ("model", "data")
    if not cfg.fsdp:
        rules["embed"] = None
    rules = rules or None
    rec.update(collectives="one device", traced="meta",
               per_device="arguments, outputs and aliases by their "
               "partitions; temp, flops and bytes an even split of the "
               "one-device step")
    if cfg.n_experts:
        cfg = cfg.replace(moe_dense_analysis=True)
        rec["moe"] = "dense surrogate"
    try:
        fn, args, out, m, lengths = measure_cell(cfg, cell, mesh, rules)
        if lengths:
            rec["rwkv_lengths"] = lengths
        with use_mesh(mesh, rules=rules):
            rec["memory"] = memory_record(fn, args, out,
                                          m.peak_bytes / n_dev, mesh)
        rec["cost_analysis"] = {"flops": m.flops / n_dev,
                                "bytes accessed": m.bytes_accessed / n_dev}
        if do_roofline:
            variants, full_counts = analysis_variants(cfg, cell)
            measured = [(counts, measure_cell(vcfg, cell, mesh, rules)[3])
                        for vcfg, counts in variants]
            m_full = solve_units(measured, full_counts)
            rl = roofline_terms(m_full.scale(1.0 / n_dev), cfg, cell, n_dev)
            rec["roofline"] = rl.as_dict()
        rec["status"] = "ok"
    except Exception as e:
        rec["status"] = "error"
        rec["error"] = f"{type(e).__name__}: {e}"
        rec["traceback"] = traceback.format_exc()[-4000:]
    rec["time_s"] = round(time.time() - t0, 1)
    return rec


def _override(v: str):
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
