"""Roofline analysis of one step traced on the ``meta`` device, against the
NVIDIA H100's published peaks.

Hardware target: one NVIDIA H100 SXM (NVIDIA's H100 data sheet, dense
rates): 989 TFLOP/s bf16 on the tensor cores, 3.35 TB/s HBM3, and
NVLink 4 at 900 GB/s per GPU in both directions together, 450 GB/s each
way.

Three terms per (arch, shape, mesh), all in seconds:
    compute    = flops_per_device / PEAK_FLOPS
    memory     = bytes_per_device / HBM_BW
    collective = collective_bytes_per_device / LINK_BW

Methodology:

* :func:`measure_step` runs the step once on ``meta`` tensors (shapes and
  dtypes, no data, no allocation) under one dispatch mode that sees every
  aten op the eager port runs.  ``flops`` are those of the matrix
  products and attention in ``torch.utils.flop_counter``'s registry;
  elementwise work is not counted (XLA's ``cost_analysis`` counts it).
  ``bytes_accessed`` is each op's tensor arguments read plus its tensor
  results written, what the eager (unfused) port moves.  ``peak_bytes`` is
  the peak of the storages the step creates that are alive at once, each
  storage counted once across its views.
* Collectives are counted where they are called: :class:`CollectiveCounter`
  sees every ``_c10d_functional`` op DTensor's redistributions issue on a
  mesh (calls and bytes by kind and by mesh dim; ``CommDebugMode`` counts
  only calls), ``coll`` holds its bytes by kind and ``coll_by_dim`` by
  mesh dim and kind.  The dry-run traces one rank of a fake group of the
  mesh's size on placed ``meta`` blocks, so its counts are that rank's,
  collectives included; a step on one device has ``{"total": 0.0}``.
  :func:`collective_bytes` (the reference's HLO-text parser) is kept for
  parity and for reading the reference's HLO.
* The port's layers are a Python loop, so a full-depth trace counts every
  layer; nothing is counted once as XLA counts a ``lax.scan`` body.
  :func:`analysis_variants` and :func:`solve_units` still give the
  reference's unit solve over small variants.  rwkv's time loop is traced
  too, so :func:`rwkv_scan_correction` is kept for parity and never added.
"""
from __future__ import annotations

import dataclasses
import re
import weakref
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch
from torch._subclasses.fake_tensor import FakeTensor
from torch.multiprocessing.reductions import StorageWeakRef
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils.flop_counter import flop_registry

from ..models.config import LMConfig, ShapeCell

# --- hardware constants (one NVIDIA H100 SXM, NVIDIA's data sheet) ---
PEAK_FLOPS = 989e12          # bf16 dense, tensor cores
HBM_BW = 3.35e12             # bytes/s, HBM3
LINK_BW = 450e9              # bytes/s, NVLink 4 one way (900 GB/s both);
                             # the reference's ICI_BW

_DTYPE_BYTES = {"pred": 1, "s8": 1, "u8": 1, "s16": 2, "u16": 2, "bf16": 2,
                "f16": 2, "s32": 4, "u32": 4, "f32": 4, "s64": 8, "u64": 8,
                "f64": 8, "c64": 8, "c128": 16}

_COLL_RE = re.compile(
    r"=\s*(?:\()?\s*([a-z0-9]+)\[([0-9,]*)\][^ ]*\s+"
    r"(all-reduce|all-gather|reduce-scatter|all-to-all|collective-permute)"
    r"(?:-start)?\(")


def collective_bytes(hlo_text: str) -> Dict[str, float]:
    """Sum result bytes of collective ops in (post-optimization) HLO text."""
    out: Dict[str, float] = {}
    for line in hlo_text.splitlines():
        m = _COLL_RE.search(line)
        if not m:
            continue
        dtype, dims, op = m.groups()
        if op.endswith("-done"):
            continue
        nbytes = _DTYPE_BYTES.get(dtype, 4)
        n = 1
        if dims:
            for d in dims.split(","):
                n *= int(d)
        wire = n * nbytes
        if op == "all-reduce":
            wire *= 2           # ring RS+AG wire bytes
        out[op] = out.get(op, 0.0) + wire
    out["total"] = sum(v for k, v in out.items() if k != "total")
    return out


@dataclass
class Measurement:
    """A step's work.  ``peak_bytes`` is the peak of one traced call;
    ``coll`` holds collective bytes by kind, ``coll_by_dim`` by mesh dim
    and kind."""
    flops: float = 0.0
    bytes_accessed: float = 0.0
    coll: Dict[str, float] = field(default_factory=dict)
    peak_bytes: float = 0.0
    coll_by_dim: Dict[str, Dict[str, float]] = field(default_factory=dict)


# ---------------------------------------------------------------------------
# Measuring a traced step
# ---------------------------------------------------------------------------
#: ops that allocate without writing
_ALLOC = {torch.ops.aten.empty.memory_format,
          torch.ops.aten.empty_strided.default,
          torch.ops.aten.new_empty.default,
          torch.ops.aten.new_empty_strided.default}
#: in-place ops that write their first argument without reading it
_WRITE_ONLY = {torch.ops.aten.copy_.default, torch.ops.aten.fill_.Scalar,
               torch.ops.aten.fill_.Tensor, torch.ops.aten.zero_.default}


def _is_wait(func) -> bool:
    """A functional collective's wait: it returns its input when the
    collective is done, and moves nothing (the collective's own op counts
    its input read and its result written)."""
    return func.namespace == "_c10d_functional" and \
        func._schema.name.endswith("wait_tensor")


def _nbytes(t: torch.Tensor) -> int:
    """The bytes a tensor view can touch: its elements, at most its
    storage (an expanded view reads its storage once)."""
    return min(t.numel() * t.element_size(), t.untyped_storage().nbytes())


def _dtensor_type():
    """DTensor's class once ``torch.distributed.tensor`` is imported (no
    DTensor exists before), else None."""
    import sys
    return getattr(sys.modules.get("torch.distributed.tensor"), "DTensor",
                   None)


def _tensors(tree, out=None) -> List[torch.Tensor]:
    """The tensors in nested lists, tuples and dicts (a DTensor's local
    block)."""
    out = [] if out is None else out
    dt = _dtensor_type()
    if dt is not None and isinstance(tree, dt):
        out.append(tree.to_local())
    elif isinstance(tree, torch.Tensor):
        out.append(tree)
    elif isinstance(tree, (list, tuple)):
        for x in tree:
            _tensors(x, out)
    elif isinstance(tree, dict):
        for x in tree.values():
            _tensors(x, out)
    return out


#: the functional collectives DTensor issues, by the reference's HLO names
#: (``_dtensor.shard_dim_alltoall``: a Shard-to-Shard move on a mesh of
#: cards; on a CPU mesh DTensor all-gathers and chunks instead)
_COLL_KINDS = {"all_gather_into_tensor": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "all_reduce": "all-reduce",
               "all_to_all_single": "all-to-all",
               "shard_dim_alltoall": "all-to-all"}


def _ranks(group) -> Tuple[int, ...]:
    import torch.distributed as dist
    return tuple(sorted(dist.get_process_group_ranks(group)))


class CollectiveCounter(TorchDispatchMode):
    """Calls and bytes of the collectives run under it: every
    ``_c10d_functional`` op and DTensor's ``shard_dim_alltoall``, by kind
    (the reference's names) and by the mesh dim whose group it runs on
    (``mesh``: a ``Mesh`` with a ``device_mesh``, or a ``DeviceMesh``: a
    group is that dim's when it holds the same ranks, as DTensor may run a
    dim's collectives on the groups of an equal mesh made earlier; other
    groups by name).  Bytes as
    the reference's :func:`collective_bytes` counts them: each result's
    bytes, twice for an all-reduce (a ring's reduce-scatter and
    all-gather).  An op on DTensors is let through (``NotImplemented``) so
    that DTensor runs it and its local ops and collectives come back here.
    """

    def __init__(self, mesh=None):
        super().__init__()
        self.calls: Dict[str, int] = {}
        self.coll_bytes: Dict[str, float] = {}
        self.by_dim: Dict[str, Dict[str, float]] = {}
        dm = getattr(mesh, "device_mesh", mesh)
        self._dims: Dict[str, str] = {}
        self._by_ranks = {} if dm is None else {
            _ranks(dm.get_group(i)): name
            for i, name in enumerate(dm.mesh_dim_names)}
        self._dtensor = _dtensor_type()

    def _dim(self, group: str) -> str:
        if group not in self._dims:
            from torch.distributed import distributed_c10d as c10d
            try:
                ranks = _ranks(c10d._resolve_process_group(group))
            except (AttributeError, ValueError, RuntimeError):
                ranks = None
            self._dims[group] = self._by_ranks.get(ranks, group)
        return self._dims[group]

    def _defer(self, types) -> bool:
        return self._dtensor is not None and any(
            issubclass(t, self._dtensor) for t in types)

    def _count(self, func, args, out) -> None:
        if func.namespace not in ("_c10d_functional", "_dtensor"):
            return
        kind = _COLL_KINDS.get(func._schema.name.split("::")[-1])
        if kind is None:
            return
        n = sum(map(_nbytes, _tensors(out))) * (2 if kind == "all-reduce"
                                                 else 1)
        dim = self._dim(next((a for a in reversed(args)
                              if isinstance(a, str)), ""))
        self.calls[kind] = self.calls.get(kind, 0) + 1
        self.coll_bytes[kind] = self.coll_bytes.get(kind, 0.0) + n
        per = self.by_dim.setdefault(dim, {})
        per[kind] = per.get(kind, 0.0) + n

    def coll(self) -> Dict[str, float]:
        """Bytes by kind and their ``"total"`` (``Measurement.coll``)."""
        return dict(self.coll_bytes,
                    total=float(sum(self.coll_bytes.values())))

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self._defer(types):
            return NotImplemented
        out = func(*args, **(kwargs or {}))
        self._count(func, args, out)
        return out


class _StepCounter(CollectiveCounter):
    """FLOPs, bytes moved and the peak of live created storage of every
    aten op run under it, and its collectives (:class:`CollectiveCounter`).

    A storage is held by weak reference (``StorageWeakRef``, which keeps
    its address from reuse) with the count of its op results still alive
    in Python.  When that count drops to 0 the storage may still be held
    from C++ (a tensor autograd saved), so it is only marked pending; the
    live total is an upper bound until a sweep drops the pending storages
    that expired.  A sweep runs whenever the bound passes the peak, so the
    peak is exact."""

    def __init__(self, args, mesh=None):
        super().__init__(mesh)
        self.flops = 0
        self.bytes = 0
        self.peak = 0
        self._known = {t.untyped_storage()._cdata for t in _tensors(args)}
        # address -> [weak reference, bytes, op results alive in Python]
        self._live: Dict[int, list] = {}
        self._pending = set()
        self._bound = 0

    def _dropped(self, key: int):
        entry = self._live.get(key)
        if entry is not None:
            entry[2] -= 1
            if entry[2] == 0:
                self._pending.add(key)

    def _sweep(self):
        for key in list(self._pending):
            ref, n, held = self._live[key]
            if ref.expired():
                self._bound -= n
                del self._live[key]
            if held == 0 and key in self._live:
                continue
            self._pending.discard(key)

    def _track(self, t: torch.Tensor):
        st = t.untyped_storage()
        key = st._cdata
        if key in self._known:
            return
        entry = self._live.get(key)
        if entry is None:
            entry = self._live[key] = [StorageWeakRef(st), st.nbytes(), 0]
            self._bound += entry[1]
            if self._bound > self.peak:
                self._sweep()
                self.peak = max(self.peak, self._bound)
        entry[2] += 1
        weakref.finalize(t, self._dropped, key)

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        if self._defer(types):
            return NotImplemented
        kwargs = kwargs or {}
        out = func(*args, **kwargs)
        outs = _tensors(out)
        if any(isinstance(t, FakeTensor) for t in outs):
            # DTensor working out an op's global shape on fake tensors of
            # the global shapes: no step's work, and nothing allocated
            return out
        self._count(func, args, out)
        packet = func.overloadpacket
        if packet in flop_registry:
            self.flops += flop_registry[packet](*args, **kwargs, out_val=out)
        if not (func.is_view or func in _ALLOC or _is_wait(func)):
            reads = _tensors((args[1:], kwargs) if func in _WRITE_ONLY
                             else (args, kwargs))
            self.bytes += sum(map(_nbytes, reads)) + sum(map(_nbytes, outs))
        for t in outs:
            self._track(t)
        return out


def trace_step(fn, *args, mesh=None):
    """``fn(*args)`` once under the counter: ``(its output, Measurement)``.
    On ``meta`` arguments nothing is allocated and no data is read; on a
    ``mesh`` (real ranks, or the dry-run's fake group) the counts are
    this rank's (its local ops) and ``coll`` / ``coll_by_dim`` hold the
    collectives' bytes by kind and by mesh dim."""
    counter = _StepCounter(args, mesh)
    with counter:
        out = fn(*args)
    return out, Measurement(float(counter.flops), float(counter.bytes),
                            counter.coll(), float(counter.peak),
                            {d: dict(per) for d, per in
                             counter.by_dim.items()})


def measure_step(fn, *args, mesh=None) -> Measurement:
    """The port's counterpart of the reference's ``measure_compiled``: one
    call of ``fn(*args)`` (``meta`` arguments: no allocation) counted op by
    op.  ``flops``: matrix products and attention only; elementwise work is
    not counted, unlike XLA's ``cost_analysis``.  ``bytes_accessed``:
    every op's tensor arguments read and results written (an in-place
    op's destination both; views, allocations and a collective's wait
    move nothing).
    ``peak_bytes``: the peak of storage the step creates that is alive at
    once.  ``coll``: the collectives' bytes by kind and their total
    (``{"total": 0.0}`` on one device) and ``coll_by_dim`` by mesh dim;
    ``mesh`` names the dims (:class:`CollectiveCounter`)."""
    return trace_step(fn, *args, mesh=mesh)[1]


# ---------------------------------------------------------------------------
# Unit-solve variants per family
# ---------------------------------------------------------------------------
def analysis_variants(cfg: LMConfig,
                      cell: Optional[ShapeCell] = None
                      ) -> Tuple[List[Tuple[LMConfig, Dict]], Dict]:
    """Returns ([(variant_cfg, unit_counts)], full_counts).

    Every variant is full-width, microbatch=1, with the MoE layer's dense
    surrogate and single-block attention / single-chunk SSD (the
    reference's settings; ``scan_layers`` is kept and ignored by the
    port).  The solver fits measured = base + sum_r counts_r * unit_r.
    """
    base = dict(scan_layers=False, microbatch=1, moe_dense_analysis=True)
    if cell is not None and cell.kind in ("train", "prefill"):
        s = cell.seq_len
        base.update(attn_block_q=s, attn_block_kv=s,
                    ssm_chunk=max(s, cfg.ssm_chunk))
    f = cfg.family
    if f in ("dense", "moe", "mla", "rwkv"):
        v = [(cfg.replace(n_layers=1, **base), {"layer": 1}),
             (cfg.replace(n_layers=2, **base), {"layer": 2})]
        return v, {"layer": cfg.n_layers}
    if f == "mla_moe":
        v = [(cfg.replace(n_layers=2, first_dense_layers=1, **base),
              {"dense": 1, "moe": 1}),
             (cfg.replace(n_layers=3, first_dense_layers=2, **base),
              {"dense": 2, "moe": 1}),
             (cfg.replace(n_layers=3, first_dense_layers=1, **base),
              {"dense": 1, "moe": 2})]
        return v, {"dense": cfg.first_dense_layers,
                   "moe": cfg.n_layers - cfg.first_dense_layers}
    if f == "vlm":
        v = [(cfg.replace(n_layers=2, cross_every=2, **base),
              {"self": 1, "cross": 1}),
             (cfg.replace(n_layers=4, cross_every=4, **base),
              {"self": 3, "cross": 1}),
             (cfg.replace(n_layers=4, cross_every=2, **base),
              {"self": 2, "cross": 2})]
        ncross = cfg.n_layers // cfg.cross_every
        return v, {"self": cfg.n_layers - ncross, "cross": ncross}
    if f == "zamba":
        v = [(cfg.replace(n_layers=1, attn_every=1, **base),
              {"mamba": 1, "attn": 1}),
             (cfg.replace(n_layers=2, attn_every=2, **base),
              {"mamba": 2, "attn": 1}),
             (cfg.replace(n_layers=2, attn_every=1, **base),
              {"mamba": 2, "attn": 2})]
        return v, {"mamba": cfg.n_layers,
                   "attn": cfg.n_layers // cfg.attn_every}
    if f == "encdec":
        v = [(cfg.replace(n_layers=1, enc_layers=1, **base),
              {"enc": 1, "dec": 1}),
             (cfg.replace(n_layers=1, enc_layers=2, **base),
              {"enc": 2, "dec": 1}),
             (cfg.replace(n_layers=2, enc_layers=1, **base),
              {"enc": 1, "dec": 2})]
        return v, {"enc": cfg.enc_layers, "dec": cfg.n_layers}
    raise ValueError(f)


def solve_units(variants: List[Tuple[Dict, Measurement]],
                full_counts: Dict) -> Measurement:
    """Least-squares solve base+units, extrapolate to full_counts."""
    unit_names = sorted(full_counts)
    a = np.array([[1.0] + [float(c.get(u, 0)) for u in unit_names]
                  for c, _ in variants])
    x_full = np.array([1.0] + [float(full_counts[u]) for u in unit_names])

    def extrapolate(vals: np.ndarray) -> float:
        coef, *_ = np.linalg.lstsq(a, vals, rcond=None)
        coef = np.maximum(coef, 0.0)        # guard tiny negative solves
        return float(x_full @ coef)

    flops = extrapolate(np.array([m.flops for _, m in variants]))
    byts = extrapolate(np.array([m.bytes_accessed for _, m in variants]))
    keys = sorted({k for _, m in variants for k in m.coll})
    coll = {k: extrapolate(np.array([m.coll.get(k, 0.0)
                                     for _, m in variants])) for k in keys}
    dims = sorted({d for _, m in variants for d in m.coll_by_dim})
    by_dim = {d: {k: extrapolate(np.array([m.coll_by_dim.get(d, {}).get(
        k, 0.0) for _, m in variants])) for k in sorted(
            {k for _, m in variants for k in m.coll_by_dim.get(d, {})})}
        for d in dims}
    return Measurement(flops, byts, coll, coll_by_dim=by_dim)


# ---------------------------------------------------------------------------
# Analytic model FLOPs (per step, GLOBAL not per-device)
# ---------------------------------------------------------------------------
def model_params_active(cfg: LMConfig) -> Tuple[float, float]:
    """(total params N, active params N_active) excluding embeddings."""
    from ..models import api
    total = api.n_params(cfg)
    emb = cfg.vocab * cfg.d_model * (1 if cfg.family == "encdec" else 2)
    n = total - emb
    if cfg.n_experts:
        expert_p = (cfg.n_layers - cfg.first_dense_layers) * cfg.n_experts \
            * 3 * cfg.d_model * cfg.moe_d_ff
        active_share = expert_p * (cfg.top_k / cfg.n_experts - 1.0)
        n_active = n + active_share
    else:
        n_active = n
    return float(n), float(n_active)


def model_flops(cfg: LMConfig, cell: ShapeCell) -> float:
    """6·N_active·D for train; 2·N_active·D for inference tokens."""
    _, n_active = model_params_active(cfg)
    tokens = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    mult = 6.0 if cell.kind == "train" else 2.0
    return mult * n_active * tokens


def rwkv_scan_correction(cfg: LMConfig, cell: ShapeCell,
                         n_devices: int) -> float:
    """Per-device FLOPs hidden inside the reference's rwkv time scan (wkv
    recurrence), which XLA counts once.  The port traces its time loop
    step by step, so this is never added to a port measurement.

    Per token per layer: ~6·H·P² mults (kv outer, u·kv, r·(S+..), w·S, +adds).
    """
    if cfg.family != "rwkv":
        return 0.0
    h = cfg.n_heads
    p = cfg.d_model // h
    toks = cell.global_batch * (cell.seq_len if cell.kind != "decode" else 1)
    per_tok = 6.0 * h * p * p * cfg.n_layers
    mult = 3.0 if cell.kind == "train" else 1.0     # fwd+bwd ~3x fwd
    return mult * per_tok * toks / n_devices


# ---------------------------------------------------------------------------
# Terms
# ---------------------------------------------------------------------------
@dataclass
class Roofline:
    compute_s: float
    memory_s: float
    collective_s: float
    flops_per_dev: float
    bytes_per_dev: float
    coll_bytes_per_dev: float
    model_flops: float
    hlo_total_flops: float
    useful_ratio: float
    bottleneck: str
    coll_breakdown: Dict[str, float] = field(default_factory=dict)

    def as_dict(self):
        return dataclasses.asdict(self)


def roofline_terms(m: Measurement, cfg: LMConfig, cell: ShapeCell,
                   n_devices: int, microbatch_scale: int = 1) -> Roofline:
    """m: per-device measurement of one full step.  Unlike the
    reference's, no rwkv scan correction is added: the trace counted the
    time loop.  ``hlo_total_flops`` keeps the reference's name: the
    traced FLOPs of all devices."""
    scale = microbatch_scale
    flops = m.flops * scale
    byts = m.bytes_accessed * scale
    coll = {k: v * scale for k, v in m.coll.items()}
    coll_total = coll.get("total", 0.0)
    compute_s = flops / PEAK_FLOPS
    memory_s = byts / HBM_BW
    collective_s = coll_total / LINK_BW
    mf = model_flops(cfg, cell)
    hlo_total = flops * n_devices
    terms = {"compute": compute_s, "memory": memory_s,
             "collective": collective_s}
    return Roofline(
        compute_s=compute_s, memory_s=memory_s, collective_s=collective_s,
        flops_per_dev=flops, bytes_per_dev=byts,
        coll_bytes_per_dev=coll_total,
        model_flops=mf, hlo_total_flops=hlo_total,
        useful_ratio=mf / hlo_total if hlo_total else 0.0,
        bottleneck=max(terms, key=terms.get),
        coll_breakdown=coll,
    )
