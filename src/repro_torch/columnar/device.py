"""Device-resident plan execution: compiled tapes through the CUDA kernels.

``DeviceTapeBackend`` keeps every record bitmap a plan touches *on the
device* and talks to the host exactly once per query.  :meth:`run_tape`
takes a :class:`~repro_torch.core.tape.PlanTape` and runs its ops in
order: a slot file of ``i32[N, W]`` packed bitmaps plus per-block
``i32[N]`` popcounts, ATOM ops through ``predicate_scan`` (K1), CHAIN ops
through ``fused_chain_scan`` (K3), SETOPs through ``bitmap_setop`` (K2)
and dictionary-membership ATOMs through ``dict_lookup_scan`` (K4).  Each
kernel also returns its output's per-block popcounts, which feed the next
kernel's dead-block skip.  At the end the per-op record / touched-block /
pruned-block / output-popcount counters and the result words are gathered
into one int32 buffer on the device and fetched with a single copy: one
host sync per query.

Whole-tape programs.  As the reference runs an all-device tape as one
jitted program, cached by the tape's structural key, the port runs it as
one CUDA-graph replay: the backend keeps one :class:`_TapeProgram` per
key (the tape's structural key, which ops blend zone verdicts, the lookup
masks' shape, the block count and the identity of the tensors the graph
reads by address), LRU-bounded at 256 as the reference's cache is.  A
program owns static device buffers for the tape's constants, lookup masks
and zone rows; the kernels read them when they run (K1 and K3 take their
constants by device address), so key-equal tapes with other constants
replay one graph.  A query stages its inputs with one pinned copy,
replays the graph and fetches the result: on the card three host calls
and no Python per kernel.  The graph is captured at the program's first
run, on a side stream, without a host sync.  ``device_dispatches`` counts
device programs started (one per all-device ``run_tape``); the port-only
``tape_programs``, ``graph_captures`` and ``graph_replays`` count programs
made, captures and replays; the kernels' launch counters
(``repro_torch.kernels.LAUNCHES``) count the launches a replay makes.

On ``device="cpu"`` the same program runs the kernels' plain PyTorch
versions eagerly over the same buffers (no graph); nothing falls back from
the card to the CPU, and a capture or replay that fails raises.

Layout: columns upload once per backend, **record-major** ``f32[N, B]``
(row n is block n), so word w's 32 records are 128 consecutive bytes,
which the kernels' compare-and-pack step loads as 8 ``float4`` and packs
into a word whose bit i is record ``w*32+i`` — the reference bitmap
layout.  The block count is padded to a power of two
as in the reference: padded blocks carry zero bitmaps (popcount 0, so the
kernels skip them) and zero column values.

Zone verdicts (per-block NONE/ALL/MAYBE for an op's atom group) are made
on the host from the zone maps.  An op with a decided block runs its
kernel with the popcounts masked to its MAYBE blocks, then blends: ALL
blocks take the source bits, NONE blocks zeros.  ``records_evaluated``
stays the pre-prune paper metric; live non-MAYBE blocks land in
``blocks_pruned``.  Per-query inputs (zone rows, lookup masks, constants)
upload from pinned memory without a host sync.

Every tensor operation runs part by part over the blocks' parts (see
"placement" in the class): one part here, one per shard on the sharded
backend (:mod:`repro_torch.columnar.shard`), which overrides only where
the parts lie, ``refresh`` and the growth of a cached set.

Tapes with ops no kernel runs (UDF atoms, unrewritten non-numeric
columns) go op by op and make no program: each such op pulls its source
set to the host (one sync), gathers and evaluates there, and pushes the
result back; the counters still ride one final bundled fetch.
``host_fallbacks`` counts those ops.

The backend is also a device-resident :class:`~repro_torch.core.sets.
SetBackend`, which the lockstep ``QuerySession`` drives (every
``StreamSession`` drain runs it): BestD's set algebra through
``bitmap_setop_grouped`` (K2, see "Deferred set operations" below), an
atom wanted by Q queries in the same round
through ``predicate_scan_multi`` (K5) or ``dict_lookup_scan_multi`` (K6)
over the Q stacked sets, cached shared atoms through the stacked AND
``bitmap_inter_multi``, and the union a multi-set atom needs for its cost
accounting through ``bitmap_union_reduce``, whose launch also writes the
stacked copy of the Q sets that K5 / K6 read.  Both read the Q sets by
pointer where they lie, with no stacked copy before the launch.  Nothing
leaves the device until the batch's one bundled :meth:`materialize`.
After a table append :meth:`refresh` uploads only the dirty tail blocks
and :meth:`extend_set` splices appended rows into cached sets, neither
with a host sync.

Deferred set operations.  ``inter`` / ``union`` / ``diff`` launch
nothing: each allocates its output, queues ``(a, b, out, opcode)`` with a
dependency level (one more than the deepest pending input) and returns
the output set at once.  The queue holds its inputs' tensors, so no input
goes back to the caching allocator (to be handed out as a later pending
output) before the launch that reads it is enqueued.  The first method
that reads a pending set's words or popcounts (``apply_atom[_multi]``,
``inter_multi``, ``count``, ``extend_set``, the host fallbacks) flushes
the queue, and ``materialize`` always does: one ``bitmap_setop_grouped``
launch per level, in level order, without a host sync.  The reference's
counters keep their meaning (``stats.setops`` and ``device_dispatches``
count one per set operation); the port-only ``setops_deferred``,
``setop_launches``, ``setop_flushes`` and ``setop_level_max`` count the
queued operations, the grouped launches, the flushes and the largest
level.  The tape paths run their SETOPs one by one: inside the tape's
graph on the all-device path, launched from Python on the mixed path.
"""
from __future__ import annotations

from collections import OrderedDict
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch

from ..core.feedback import group_selectivity
from ..core.predicate import (Atom, ZONE_ALL, ZONE_MAYBE, ZONE_NONE,
                              atom_key, decode_column)
from ..core.sets import SetBackend, Stats
from ..core.tape import (ATOM, CHAIN, CMP_OPCODE, EMPTY, FULL, IN_OPCODE,
                         OP_AND, OP_ANDNOT, OP_OR, PlanTape, SETOP,
                         device_atom, lookup_atom, op_observation_meta)
from ..kernels.bitmap_ops import (SetOp, bitmap_inter_multi, bitmap_setop,
                                  bitmap_setop_grouped, bitmap_union_reduce)
from ..kernels.dict_lookup import dict_lookup_scan, dict_lookup_scan_multi
from ..kernels import _build as _kbuild
from ..kernels.fused_chain import (MAX_STATIC_K, fused_chain_scan,
                                   fused_chain_table)
from ..kernels.predicate_scan import predicate_scan, predicate_scan_multi
from ..runtime import faults as _faults
from .bitmap import (WORD, bitmap_full, extend_bitmap, live_block_count,
                     n_words, next_pow2, pack_bits, popcount, row_popcounts,
                     unpack_bits)
from .executor import _ZonePruner
from .ingest import dirty_tail
from .table import Table


class _DevSet(NamedTuple):
    """A device-resident record set: packed bitmap + per-block popcounts."""

    bits: torch.Tensor        # i32[N, W]
    pops: torch.Tensor        # i32[N]


def torch_device(name: str) -> torch.device:
    """The ``torch.device`` an engine named ``name`` runs on: ``"cpu"``, or
    a CUDA device with its index (an index-less ``"cuda"`` is the current
    device).  Raises on ``"cuda"`` without a GPU."""
    dev = torch.device(name)
    if dev.type == "cuda":
        if not torch.cuda.is_available():
            raise RuntimeError(
                f"device {name!r}: no CUDA device is available; pass "
                "device='cpu' for the plain PyTorch path")
        if dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
    elif dev.type != "cpu":
        raise ValueError(f"unsupported device {name!r}")
    return dev


def _costed_eval(kind: str, opcodes, cols, values, lmask, conj: bool,
                 bits: torch.Tensor, pops: torch.Tensor, table=None):
    """One ATOM / CHAIN / lookup op on source ``bits``, with ``pops`` as the
    kernels' dead-block input.  ``values`` are the op's constants (host
    numbers, or an f32[K] tensor on the device); ``table`` a wide chain's
    prebuilt device table.  Returns (bits, pops) of the output."""
    if opcodes[0] == IN_OPCODE:
        return dict_lookup_scan(cols[0], bits, pops, lmask)
    if kind == ATOM:
        return predicate_scan(cols[0], bits, pops, values[0], opcodes[0])
    return fused_chain_scan(cols, bits, pops, values, opcodes, conj,
                            table=table)


def _zone_blend(evaluate, bits: torch.Tensor, pops: torch.Tensor,
                zone: Optional[torch.Tensor]):
    """Run ``evaluate(eval_pops)`` and blend with per-block zone verdicts.

    ``bits`` is one set ``i32[N, W]`` or Q stacked sets ``i32[Q, N, W]``
    (``pops`` ``i32[N]`` or ``i32[Q, N]``); ``zone`` is None when every
    block is MAYBE (plain evaluation), else one shared device ``i32[N]``
    of NONE/ALL/MAYBE (verdicts depend on the atom, not on the set).  The
    evaluation sees popcounts masked to the MAYBE blocks, so the kernels
    skip every other block and write zeros there; ALL blocks then take the
    source bits unchanged and NONE blocks keep those zeros."""
    if zone is None:
        return evaluate(pops)
    out0, p0 = evaluate(torch.where(zone == ZONE_MAYBE, pops, 0))
    allm = zone == ZONE_ALL
    return (torch.where(allm[:, None], bits, out0),
            torch.where(allm, pops, p0))


def _op_counters(srcs: List[torch.Tensor], outs: List[torch.Tensor],
                 zrows: Optional[torch.Tensor], device) -> torch.Tensor:
    """``i32[4, M]``: per costed op the source popcount (pre-prune
    records), live MAYBE blocks (touched), live decided blocks (pruned)
    and the output popcount — stacked so they ride the result's fetch."""
    if not srcs:
        return torch.zeros((4, 0), dtype=torch.int32, device=device)
    s = torch.stack(srcs)
    live = s > 0
    if zrows is None:
        blk = live.sum(dim=1)
        prn = torch.zeros_like(blk)
    else:
        maybe = zrows == ZONE_MAYBE
        blk = (live & maybe).sum(dim=1)
        prn = (live & ~maybe).sum(dim=1)
    rec = s.sum(dim=1)
    out = torch.stack(outs).sum(dim=1)
    return torch.stack([rec, blk, prn, out]).to(torch.int32)


def _tape_forward(ops, meta, result: int, n_slots: int, cols,
                  values: torch.Tensor, lmasks, zrows,
                  blend: Sequence[bool], full: "_DevSet",
                  tables: Optional[Dict[int, torch.Tensor]] = None
                  ) -> torch.Tensor:
    """The whole-tape op loop.

    ``cols`` are the bound device columns, ``values`` the f32 constants on
    the device (a CHAIN's K constants are consecutive), ``lmasks`` the
    device ``i32[L, U]`` lookup masks, ``zrows`` the device ``i32[M, N]``
    zone rows (None when no op is pruned), ``blend[m]`` says costed op
    ``m`` has a decided block and ``tables`` maps a wide CHAIN's op index
    to its prebuilt device table.  Every kernel reads its constants, masks
    and zone rows from these tensors when it runs, so a captured graph of
    this loop serves new values at each replay.  Returns the device
    ``i32`` buffer ``[rec | blk | prn | out (M each) | result words (all
    N * W)]``: :meth:`DeviceTapeBackend.run_tape` fetches its prefix
    through the last real word with one copy.
    """
    bits: List[Optional[torch.Tensor]] = [None] * n_slots
    pops: List[Optional[torch.Tensor]] = [None] * n_slots
    srcs: List[torch.Tensor] = []
    outs: List[torch.Tensor] = []
    mi = 0
    for oi, op in enumerate(ops):
        if op.kind == FULL:
            b, p = full.bits, full.pops
        elif op.kind == EMPTY:
            b = torch.zeros_like(full.bits)
            p = torch.zeros_like(full.pops)
        elif op.kind == SETOP:
            b, p = bitmap_setop(bits[op.a], bits[op.b], op.setop,
                                pops[op.a], pops[op.b])
        else:
            cixs, vixs, opcodes = meta[oi]
            sb, sp = bits[op.a], pops[op.a]
            zone = zrows[mi] if blend[mi] else None
            mi += 1
            srcs.append(sp)
            ocols = [cols[c] for c in cixs]
            if opcodes[0] == IN_OPCODE:
                ovals, lm = (), lmasks[vixs[0]]
            else:
                ovals, lm = values[vixs[0]: vixs[0] + len(vixs)], None
            table = tables.get(oi) if tables else None
            b, p = _zone_blend(
                lambda ep: _costed_eval(op.kind, opcodes, ocols, ovals, lm,
                                        op.conj, sb, ep, table),
                sb, sp, zone)
            outs.append(p)
        bits[op.dst] = b
        pops[op.dst] = p
    counters = _op_counters(srcs, outs, zrows, full.bits.device)
    return torch.cat([counters.reshape(-1), bits[result].reshape(-1)])


class _TapeProgram:
    """One tape's program on a backend: what the reference's jitted
    whole-tape program is, as a CUDA graph on the card.

    It owns the tape's static inputs in one device buffer, ``values``
    f32[V] (every ATOM / CHAIN constant), ``lmasks`` i32[L, U] and, when
    an op blends, ``zrows`` i32[M, N], and holds every tensor the loop
    reads by address (the bound columns, ``full`` and a wide chain's
    table), since a CUDA graph keeps none alive.  :meth:`stage` packs a
    run's inputs into one pinned host buffer and copies it in with one
    non-blocking copy; :meth:`run` replays the graph (captured once, when
    the backend makes the program, on a side stream into the memory pool
    of its part) or, on the CPU, runs :func:`_tape_forward` eagerly over
    the same buffers.  On a sharded backend a program runs one shard's
    block rows: its ``full`` set gives their device and count.  The
    kernels' launch counts of the capture are taken back out and added at
    each replay.  A capture or replay that fails raises.
    """

    def __init__(self, be: "DeviceTapeBackend", tape: PlanTape, meta, cols,
                 n_values: int, lmask_shape: Tuple[int, int],
                 blend: Sequence[bool], full: "_DevSet", part: int = 0):
        self.backend, self.part = be, part
        self.ops, self.meta = tape.ops, meta
        self.result, self.n_slots = tape.result, tape.n_slots
        self.cols, self.full, self.blend = list(cols), full, tuple(blend)
        n_l, u = lmask_shape
        # the blocks this program runs over (a shard's, on a sharded
        # backend) and their device: those of the full set it reads
        m, nblocks = len(blend), full.bits.shape[0]
        zr = m * nblocks if any(blend) else 0
        self.sizes = (n_values, n_l * u, zr)
        dev = full.bits.device
        self.inputs = torch.zeros(max(sum(self.sizes), 1), dtype=torch.int32,
                                  device=dev)
        v, lw = n_values, n_l * u
        self.values = self.inputs[:v].view(torch.float32)
        self.lmasks = self.inputs[v: v + lw].view(n_l, u) if n_l else None
        self.zrows = (self.inputs[v + lw: v + lw + zr].view(m, nblocks)
                      if zr else None)
        self.tables: Dict[int, torch.Tensor] = {}
        if dev.type == "cuda":
            for oi, op in enumerate(tape.ops):
                cixs, _, opcodes = meta[oi]
                if op.kind == CHAIN and len(cixs) > MAX_STATIC_K:
                    self.tables[oi] = fused_chain_table(
                        [self.cols[c] for c in cixs], opcodes)
        self.graph: Optional[torch.cuda.CUDAGraph] = None
        self.out: Optional[torch.Tensor] = None
        self.launches: Dict[str, int] = {}

    def _forward(self) -> torch.Tensor:
        return _tape_forward(self.ops, self.meta, self.result, self.n_slots,
                             self.cols, self.values, self.lmasks, self.zrows,
                             self.blend, self.full, self.tables)

    def capture(self) -> None:
        """Capture the op loop into a CUDA graph on the backend's side
        stream (no host sync), keeping its output buffer."""
        be = self.backend
        dev = self.inputs.device
        _kbuild.lib()               # built and its kernels loaded before
        side = be._capture_stream(dev)
        side.wait_stream(torch.cuda.current_stream(dev))
        graph = torch.cuda.CUDAGraph()
        before = dict(_kbuild.LAUNCHES)
        try:
            with torch.cuda.device(dev), torch.cuda.stream(side):
                graph.capture_begin(pool=be._graph_pool(self.part))
                try:
                    out = self._forward()
                finally:
                    graph.capture_end()
        finally:
            launches = _kbuild.take_launches(before)
        torch.cuda.current_stream(dev).wait_stream(side)
        self.graph, self.out, self.launches = graph, out, launches
        be.graph_captures += 1

    def stage(self, values: np.ndarray, lmasks: np.ndarray,
              zrows: Optional[np.ndarray]) -> None:
        """Pack one run's constants, lookup masks and zone rows into one
        host buffer (pinned on CUDA) and copy it into the static inputs."""
        total = sum(self.sizes)
        if not total:
            return
        cuda = self.inputs.device.type == "cuda"
        host = torch.empty(total, dtype=torch.int32, pin_memory=cuda)
        h = host.numpy()
        v, lw, zr = self.sizes
        h[:v].view(np.float32)[:] = values
        if lw:
            h[v: v + lw] = lmasks.view(np.int32).reshape(-1)
        if zr:
            h[v + lw:] = zrows.reshape(-1)
        self.inputs[:total].copy_(host, non_blocking=cuda)

    def replay(self) -> torch.Tensor:
        """One run over the staged inputs (on the card, a replay of the
        graph :meth:`capture` made, on its device's current stream, with no
        host sync); returns the output buffer.  The buffer is reused by the
        next replay of this program, and the backend's other programs of
        the same part (which share its memory pool) may reuse it, so it is
        read before either runs."""
        if self.inputs.device.type != "cuda":
            return self._forward()
        with torch.cuda.device(self.inputs.device):
            self.graph.replay()
        _kbuild.add_launches(self.launches)
        self.backend.graph_replays += 1
        return self.out

    def run(self, n: int) -> np.ndarray:
        """:meth:`replay`, then the first ``n`` int32 words of its output
        fetched to the host: the run's one host sync."""
        return self.replay()[:n].cpu().numpy()


class _PartsProgram:
    """A tape's program on a backend whose blocks lie in several parts (a
    sharded backend's shards): one :class:`_TapeProgram` per part, each
    over its own block rows on its own device.  :meth:`stage` gives each
    part its columns of the zone rows; :meth:`run` replays every part with
    no fetch between, then gathers on the backend's lead device (the
    parts' ``4 * M`` counter prefixes summed, their result words joined in
    block order) and fetches once.  Each part's graphs have a memory pool
    of their own, so no part's replay can reuse another's output buffer
    before the gather has read it."""

    def __init__(self, be: "DeviceTapeBackend", progs: List[_TapeProgram]):
        self.backend, self.progs = be, progs

    def stage(self, values: np.ndarray, lmasks: np.ndarray,
              zrows: Optional[np.ndarray]) -> None:
        for (lo, hi, _), p in zip(self.backend._spans(), self.progs):
            p.stage(values, lmasks, None if zrows is None else
                    zrows[:, lo:hi])

    def run(self, n: int) -> np.ndarray:
        be = self.backend
        outs = [p.replay() for p in self.progs]
        m4 = 4 * len(self.progs[0].blend)
        cnt = be._sum_to_lead([o[:m4] for o in outs]).to(torch.int32)
        words = be._to_lead([o[m4:] for o in outs])
        return torch.cat([cnt, words])[:n].cpu().numpy()


#: programs a backend keeps (least recently used dropped first), as the
#: reference bounds its whole-tape program cache
_TAPE_PROGRAM_CAP = 256


#: bound on a backend's undrained observation log — sessions drain it every
#: batch; standalone benchmark loops must not grow it without bound
_OP_LOG_CAP = 4096


class DeviceTapeBackend(SetBackend):
    """Device-resident executor of compiled tapes.

    Parameters
    ----------
    table:      the columnar table (numeric columns are uploaded once, as
                record-major f32 blocks, and cached for the backend's
                lifetime)
    block:      records per block (multiple of 32; the padded block count
                is bucketed to a power of two)
    zone_prune: use the table's zone maps to decide blocks on the host
    device:     ``"cuda"`` (default; raises without a GPU) runs the CUDA
                kernels, ``"cpu"`` their plain PyTorch versions
    """

    def __init__(self, table: Table, block: int = 8192,
                 zone_prune: bool = True, device: str = "cuda"):
        if block % WORD:
            raise ValueError("block must be a multiple of 32")
        self.device = torch_device(device)
        self.table = table
        self.n = table.n_records
        self.block = block
        self.wpb = block // WORD
        self.nblocks = next_pow2((self.n + block - 1) // block)
        self._padded = self.nblocks * block
        self.stats = Stats()
        self.blocks_touched = 0.0
        self.records_touched = 0.0
        self.blocks_pruned = 0.0      # blocks decided by zone maps alone
        self.host_syncs = 0
        self.host_fallbacks = 0
        self.device_dispatches = 0
        self.uploaded_bytes = 0       # host->device column traffic
        # port-only: the bytes that really moved host->device (equal to
        # uploaded_bytes here; a sharded refresh moves only the real tail)
        self.transferred_bytes = 0
        # deferred set operations (port-only counters, see the module doc)
        self.setops_deferred = 0
        self.setop_launches = 0
        self.setop_flushes = 0
        self.setop_level_max = 0
        self._setop_queue: List[Tuple[int, SetOp]] = []
        self._pending: Dict[int, int] = {}   # id(out bits) -> its level
        # whole-tape programs (port-only counters, see run_tape): programs
        # made, CUDA graphs captured and graph replays
        self.tape_programs = 0
        self.graph_captures = 0
        self.graph_replays = 0
        self._programs: "OrderedDict[tuple, _TapeProgram]" = OrderedDict()
        self._side_streams: Dict[torch.device, "torch.cuda.Stream"] = {}
        self._pools: Dict[int, tuple] = {}
        self.last_tape: Optional[PlanTape] = None
        self._cols: Dict[str, object] = {}
        self._full: Optional[_DevSet] = None
        self._empty: Optional[_DevSet] = None
        # zone-verdict pruner (f32: the kernels compare in float32, so the
        # verdicts must round the same way)
        self._zones = (_ZonePruner(table, block, f32=True)
                       if zone_prune else None)
        # device-side pending cost counters, flushed by materialize()
        self._pend_records: List[torch.Tensor] = []
        self._pend_k: List[int] = []
        self._pend_weights: List[float] = []
        self._pend_blocks: List[torch.Tensor] = []
        self._pend_pruned: List[torch.Tensor] = []
        # realized-selectivity observations (the Q-Error feedback channel):
        # op_log holds host-resolved (atom_keys, est, src, out) tuples;
        # device-resident src/out popcount scalars queue in _fb_* and ride
        # the same bundled transfer materialize() makes
        self.op_log: List[Tuple] = []
        self._fb_meta: List[Tuple[Tuple, float]] = []
        self._fb_src: List[torch.Tensor] = []
        self._fb_out: List[torch.Tensor] = []

    # -- placement: the parts the blocks lie in ---------------------------------
    # This backend holds every block on one device, as one part.
    # ShardedTapeBackend (columnar.shard) holds block rows [s*B, (s+1)*B) on
    # shard s's device: it overrides _spans / _parts / _join, and every
    # method below runs its tensor work part by part, so sets, columns and
    # zone rows are one tensor here and a tuple of parts there.

    def _spans(self) -> List[Tuple[int, int, torch.device]]:
        """(first block, end block, device) of each part, in block order."""
        return [(0, self.nblocks, self.device)]

    def _parts(self, x) -> Sequence:
        """The per-part pieces of a set, a column or a zone row."""
        return (x,)

    def _join(self, parts: Sequence):
        """A set, column or zone row from its per-part pieces."""
        return parts[0]

    def _key(self, d) -> int:
        """A set's identity in the deferred set operations' queue: that of
        its first part's words, which the queue holds while it is
        pending."""
        return id(self._parts(d)[0].bits)

    def _to_lead(self, ts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The parts' 1-D pieces joined in order on the lead device
        (:attr:`device`).  A copy from another card is ordered after the
        work queued on its stream and before later work on the lead's
        stream by CUDA events, with no host sync."""
        ts = [t.to(self.device) for t in ts]
        return ts[0] if len(ts) == 1 else torch.cat(ts)

    def _sum_to_lead(self, ts: Sequence[torch.Tensor]) -> torch.Tensor:
        """The parts' equal-shaped pieces summed on the lead device."""
        if len(ts) == 1:
            return ts[0]
        return torch.stack([t.to(self.device) for t in ts]).sum(dim=0)

    def _place(self, arr: np.ndarray, device=None) -> torch.Tensor:
        """Small host array -> device tensor (on ``device``, else the
        lead's) without a host sync: pinned staging and a non-blocking
        copy on CUDA (the copy stays ordered before every later kernel on
        the stream).  uint32 words are passed as their int32 view."""
        device = self.device if device is None else device
        t = torch.from_numpy(np.ascontiguousarray(arr))
        if device.type == "cuda":
            return t.pin_memory().to(device, non_blocking=True)
        return t

    def _rows(self, arr: np.ndarray):
        """A host array whose leading axis is the block axis, placed part
        by part."""
        return self._join([self._place(arr[lo:hi], dev)
                           for lo, hi, dev in self._spans()])

    def _replicated(self, arr: np.ndarray):
        """A host array every part reads whole (a lookup mask), placed once
        per device."""
        placed: Dict[torch.device, torch.Tensor] = {}
        for _, _, dev in self._spans():
            if dev not in placed:
                placed[dev] = self._place(arr, dev)
        return self._join([placed[dev] for _, _, dev in self._spans()])

    def _zero(self, device) -> torch.Tensor:
        return torch.zeros((), dtype=torch.int64, device=device)

    def _col_recmajor(self, name: str) -> Optional[torch.Tensor]:
        """Column as record-major ``f32[N, B]`` device blocks (None if the
        column is not numeric).  Resolves derived dictionary-code columns
        through ``Table.column_data``, so rewritten string atoms upload the
        int32 codes and run the same comparison kernels.  The upload is
        set-up work, once per column per backend."""
        col = self._cols.get(name)
        if col is None:
            raw = self.table.column_data(name)
            if not np.issubdtype(raw.dtype, np.number):
                self._cols[name] = False
                return None
            arr = np.zeros(self._padded, dtype=np.float32)
            arr[: self.n] = raw.astype(np.float32)
            self.uploaded_bytes += arr.nbytes
            self.transferred_bytes += arr.nbytes
            arr = arr.reshape(self.nblocks, self.block)
            col = self._join([torch.from_numpy(arr[lo:hi]).to(dev)
                              for lo, hi, dev in self._spans()])
            self._cols[name] = col
        elif col is False:
            return None
        return col

    def _lookup_mask(self, atom: Atom) -> Optional[np.ndarray]:
        """Packed ``u32[U]`` hit bitmask for a dictionary-membership atom:
        bit ``c`` set iff code ``c`` is in the atom's value set.  ``U`` is
        the dictionary's word count padded to a power of two, so modest
        dictionary growth under appends keeps the kernel shape stable.
        None when the atom's column is not a dictionary-code column of
        this table."""
        base = decode_column(atom.column)
        if base is None or base not in self.table.columns:
            return None
        dc = self.table.dict_column(base)
        if dc is None:
            return None
        nbits = WORD * next_pow2(n_words(max(dc.n, 1)))
        hits = np.zeros(nbits, dtype=bool)
        idx = np.asarray([int(v) for v in atom.value], dtype=np.int64)
        idx = idx[(idx >= 0) & (idx < dc.n)]
        hits[idx] = True
        return pack_bits(hits)

    def _zone_mask(self, atoms: Sequence[Atom], conj: bool = True,
                   exact: bool = False) -> Optional[np.ndarray]:
        """Combined ``i32[nblocks]`` NONE/ALL/MAYBE verdicts for one
        ATOM/CHAIN op's atom group, or None when nothing prunes (no zone
        maps, every block MAYBE, or a stale map mid-append).  CHAIN groups
        combine per-atom verdicts with the group's own connective: under
        AND a single NONE decides the block and ALL needs every atom ALL;
        under OR dually.  Power-of-two padding blocks get NONE — they
        carry zero bitmaps either way.  ``exact=True`` skips the f32
        rounding of the verdicts — required by the host-gather fallback,
        which evaluates in float64."""
        if self._zones is None:
            return None
        real = (self.n + self.block - 1) // self.block
        out = None
        any_verdict = False
        for a in atoms:
            v = self._zones.verdicts(a, exact=exact)
            if v is None:
                v = np.full(real, ZONE_MAYBE, dtype=np.int8)
            elif len(v) != real:
                return None   # zone map describes a different snapshot
            else:
                any_verdict = True
            if out is None:
                out = v.astype(np.int32)
                continue
            if conj:
                none = (out == ZONE_NONE) | (v == ZONE_NONE)
                alls = (out == ZONE_ALL) & (v == ZONE_ALL)
            else:
                alls = (out == ZONE_ALL) | (v == ZONE_ALL)
                none = (out == ZONE_NONE) & (v == ZONE_NONE)
            out = np.full(real, ZONE_MAYBE, dtype=np.int32)
            out[alls] = ZONE_ALL
            out[none] = ZONE_NONE
        if not any_verdict or (out == ZONE_MAYBE).all():
            return None
        pad = np.full(self.nblocks, ZONE_NONE, dtype=np.int32)
        pad[:real] = out
        return pad

    # -- appends (the streaming delta path) -------------------------------------
    def refresh(self) -> int:
        """Grow the backend after a pure table *append*: device-resident
        columns keep every block below the append boundary and upload only
        the dirty tail (the power-of-two block-count bucket may grow, in
        which case the new padding blocks ride along as zeros).  A column
        whose bucket did not grow is updated in place, and so is the set
        :meth:`full` returned: a holder of it sees the appended rows.
        Caller must have proven the append via :meth:`Table.delta_since`.
        Returns the bytes uploaded."""
        _faults.trip("device.upload", backend=self)
        self._flush()
        if self._zones:
            self._zones.clear()
        n_new = self.table.n_records
        if n_new == self.n:
            return 0
        dirty = self.n // self.block
        self.n = n_new
        nblocks = next_pow2((n_new + self.block - 1) // self.block)
        if nblocks == self.nblocks:
            # in place, as the columns are: the tape programs, which read
            # both by address, stay valid
            if self._full is not None:
                full = self._from_flat(bitmap_full(n_new))
                self._full.bits.copy_(full.bits)
                self._full.pops.copy_(full.pops)
        else:
            # the columns are reallocated below: drop the programs that
            # hold the old ones
            self._full = self._empty = None
            self._programs.clear()
        self.nblocks = nblocks
        self._padded = self.nblocks * self.block
        up = 0
        for name, col in list(self._cols.items()):
            if col is False:
                continue               # non-numeric: still host-resident
            raw = self.table.column_data(name)
            tail = dirty_tail(raw, dirty, self.nblocks, self.block)
            up += tail.nbytes
            tail = self._place(tail.reshape(self.nblocks - dirty, self.block))
            if col.shape[0] == self.nblocks:
                col[dirty:] = tail
            else:
                self._cols[name] = torch.cat([col[:dirty], tail])
        self.uploaded_bytes += up
        self.transferred_bytes += up
        return up

    def extend_set(self, s: _DevSet, old_n: int, delta_hits) -> _DevSet:
        """Splice the appended rows' hit mask into a cached device set (the
        streaming delta path): the old bitmap's blocks stay on device and
        only the words of the blocks the delta touches upload — one OR
        launch per part, no host sync."""
        self._ready(s)
        delta_hits = np.asarray(delta_hits, dtype=bool)
        flat = extend_bitmap(np.zeros(n_words(old_n), dtype=np.uint32),
                             old_n, delta_hits, old_n + len(delta_hits))
        b0 = old_n // self.block          # first block the delta touches
        words = np.zeros((self.nblocks - b0) * self.wpb, dtype=np.uint32)
        tail = flat[b0 * self.wpb:]
        words[: len(tail)] = tail
        words = words.reshape(-1, self.wpb)
        # the delta's popcounts are counted on the host, as _from_flat's
        tpops = row_popcounts(words)
        outs = []
        for (lo, hi, dev), p in zip(self._spans(),
                                    self._parts(self._regrow(s))):
            r0 = max(lo, b0)
            dpops = np.zeros(hi - lo, dtype=np.int32)
            delta = torch.zeros((hi - lo, self.wpb), dtype=torch.int32,
                                device=dev)
            if r0 < hi:               # the part holds appended rows
                dpops[r0 - lo:] = tpops[r0 - b0: hi - b0]
                delta[r0 - lo:] = self._place(
                    words[r0 - b0: hi - b0].view(np.int32), dev)
            outs.append(_DevSet(*bitmap_setop(p.bits, delta, OP_OR, p.pops,
                                              self._place(dpops, dev))))
        self.device_dispatches += 1
        return self._join(outs)

    def _regrow(self, s: _DevSet) -> _DevSet:
        """A set made before :meth:`refresh` grew the block bucket, padded
        with empty blocks to the new bucket."""
        bits, pops = s.bits, s.pops
        if bits.shape[0] < self.nblocks:
            grow = self.nblocks - bits.shape[0]
            bits = torch.cat([bits, torch.zeros(
                (grow, self.wpb), dtype=torch.int32, device=self.device)])
            pops = torch.cat([pops, torch.zeros(
                grow, dtype=torch.int32, device=self.device)])
        return _DevSet(bits, pops)

    def _from_flat(self, words: np.ndarray) -> _DevSet:
        """Host flat packed words -> device blocked set (popcounts counted
        on the host, so no kernel runs)."""
        padded = np.zeros((self.nblocks, self.wpb), dtype=np.uint32)
        padded.reshape(-1)[: n_words(self.n)] = words
        bits = self._rows(padded.view(np.int32))
        pops = self._rows(row_popcounts(padded))
        return self._join([_DevSet(b, p) for b, p in
                           zip(self._parts(bits), self._parts(pops))])

    def _pull_flat(self, d: _DevSet) -> np.ndarray:
        """One host sync: fetch a device set as host flat packed words."""
        self._ready(d)
        self.host_syncs += 1
        words = self._to_lead([p.bits.reshape(-1) for p in self._parts(d)])
        flat = words[: n_words(self.n)].cpu().numpy()
        return flat.view(np.uint32).copy()

    # -- SetBackend ------------------------------------------------------------
    def full(self) -> _DevSet:
        if self._full is None:
            self._full = self._from_flat(bitmap_full(self.n))
        return self._full

    def empty(self) -> _DevSet:
        if self._empty is None:
            self._empty = self._join([_DevSet(
                torch.zeros((hi - lo, self.wpb), dtype=torch.int32,
                            device=dev),
                torch.zeros((hi - lo,), dtype=torch.int32, device=dev))
                for lo, hi, dev in self._spans()])
        return self._empty

    def _setop(self, a: _DevSet, b: _DevSet, code: int) -> _DevSet:
        """Queue ``a OP b`` (see "Deferred set operations" in the module
        doc), one :class:`SetOp` per part; the output set is returned at
        once and computed at the next flush."""
        self.stats.setops += 1
        self.device_dispatches += 1
        self.setops_deferred += 1
        outs, ops = [], []
        for x, y in zip(self._parts(a), self._parts(b)):
            o = _DevSet(torch.empty_like(x.bits), torch.empty_like(x.pops))
            outs.append(o)
            ops.append(SetOp(x.bits, x.pops, y.bits, y.pops, o.bits, o.pops,
                             code))
        out = self._join(outs)
        level = 1 + max(self._pending.get(self._key(a), 0),
                        self._pending.get(self._key(b), 0))
        self._setop_queue.append((level, ops))
        self._pending[self._key(out)] = level
        return out

    def _flush(self) -> None:
        """Launch every queued set operation: one grouped launch per
        dependency level and part, in level order, with no host sync."""
        if not self._setop_queue:
            return
        queue, self._setop_queue, self._pending = self._setop_queue, [], {}
        depth = max(level for level, _ in queue)
        n_parts = len(queue[0][1])
        levels: List[List[List[SetOp]]] = [[[] for _ in range(depth)]
                                           for _ in range(n_parts)]
        for level, ops in queue:
            for j, op in enumerate(ops):
                levels[j][level - 1].append(op)
        self.setop_flushes += 1
        self.setop_launches += depth * n_parts
        self.setop_level_max = max(self.setop_level_max,
                                   max(len(lv) for lv in levels[0]))
        for part in levels:
            bitmap_setop_grouped(part)

    def _ready(self, *sets: _DevSet) -> None:
        """Flush the queue if one of ``sets`` is still pending."""
        if self._pending and any(self._key(d) in self._pending
                                 for d in sets):
            self._flush()

    def inter(self, a, b):
        return self._setop(a, b, OP_AND)

    def union(self, a, b):
        return self._setop(a, b, OP_OR)

    def diff(self, a, b):
        return self._setop(a, b, OP_ANDNOT)

    def count(self, d: _DevSet) -> float:
        self._ready(d)
        self.host_syncs += 1
        return float(self._sum_to_lead([p.pops.sum() for p in
                                        self._parts(d)]).item())

    def inter_multi(self, a: _DevSet, ds: Sequence[_DevSet]
                    ) -> List[_DevSet]:
        """Q cached-atom intersections in one stacked launch per part (the
        lockstep executor's atom-cache hit path: per-query setops would
        otherwise cost a launch each)."""
        if len(ds) == 1:
            return [self.inter(a, ds[0])]
        self._ready(a, *ds)
        self.stats.setops += len(ds)
        self.device_dispatches += 1
        per_part = [bitmap_inter_multi(x.bits, x.pops, ys) for x, ys in
                    zip(self._parts(a),
                        zip(*[self._parts(d) for d in ds]))]
        return [self._join([_DevSet(out[j], pops[j])
                            for out, pops in per_part])
                for j in range(len(ds))]

    def _account(self, atoms: Sequence[Atom], d: _DevSet,
                 device: bool = True, zone=None):
        """Queue device-side cost counters for one costed application of
        ``atoms`` to set ``d`` (K > 1 for a fused chain: every chain atom
        evaluates on all of d's live blocks, so counts scale by K), one
        scalar per part; :meth:`materialize` sums the parts.

        ``device=False`` (host fallback) still counts records_evaluated —
        count(D) is engine-independent — but leaves blocks/records_touched
        to the fallback's own gather accounting.  ``zone`` (the op's device
        NONE/ALL/MAYBE verdicts) splits the live blocks into touched
        (MAYBE: the kernel pays for them) and pruned (decided by the zone
        map alone); ``records_evaluated`` stays the *pre-prune* count.
        """
        self.stats.atom_applications += len(atoms)
        parts = self._parts(d)
        self._pend_records.append([p.pops.sum() for p in parts])
        self._pend_k.append(len(atoms))
        self._pend_weights.append(sum(a.cost_factor for a in atoms))
        if not device:
            zeros = [self._zero(p.pops.device) for p in parts]
            self._pend_blocks.append(zeros)
            self._pend_pruned.append(zeros)
        elif zone is None:
            self._pend_blocks.append([(p.pops > 0).sum() for p in parts])
            self._pend_pruned.append([self._zero(p.pops.device)
                                      for p in parts])
        else:
            blk, prn = [], []
            for p, z in zip(parts, self._parts(zone)):
                maybe = z == ZONE_MAYBE
                live = p.pops > 0
                blk.append((live & maybe).sum())
                prn.append((live & ~maybe).sum())
            self._pend_blocks.append(blk)
            self._pend_pruned.append(prn)

    # -- realized-selectivity feedback (rides the existing syncs) --------------
    def _log_op(self, keys: Tuple, est: float, src: int, out: int) -> None:
        """Record one host-resolved observation ``(atom_keys, estimated
        fraction, source popcount, output popcount)``; capped so undrained
        standalone loops stay bounded."""
        self.op_log.append((keys, float(est), int(src), int(out)))
        if len(self.op_log) > _OP_LOG_CAP:
            del self.op_log[: len(self.op_log) - _OP_LOG_CAP]

    def _fb_queue(self, atoms: Sequence[Atom], conj: bool, src: List,
                  out: List) -> None:
        """Queue one observation whose src/out popcounts are still device
        scalars (or stacked ``[Q]`` vectors, one per lockstep query), one
        per part; they ride the bundled transfer :meth:`materialize` makes
        (which sums the parts) — no extra sync."""
        est = group_selectivity([a.selectivity for a in atoms], conj)
        self._fb_meta.append((tuple(atom_key(a) for a in atoms), est))
        self._fb_src.append(src)
        self._fb_out.append(out)

    def drain_op_log(self) -> List[Tuple]:
        """Pop accumulated ``(keys, est, src, out)`` observations."""
        out = self.op_log
        self.op_log = []
        return out

    def _host_gather(self, grp: Sequence[Atom], conj: bool,
                     sw: np.ndarray) -> Tuple[np.ndarray, int, int]:
        """Zone-pruned gather-evaluate-scatter for a host-fallback atom
        group: exact float64 zone verdicts (combined under the group's
        connective) restrict the gather to MAYBE blocks — NONE blocks
        contribute nothing, ALL blocks pass their source bits through
        without touching the records.  Returns ``(packed result words,
        source popcount, output popcount)``."""
        wpb = self.wpb
        u2 = np.zeros((self.nblocks, wpb), dtype=np.uint32)
        u2.reshape(-1)[: n_words(self.n)] = sw
        src_count = int(popcount(sw))
        verd = self._zone_mask(grp, conj=conj, exact=True)
        all_rows = None
        all_bits = None
        if verd is not None:
            live = (u2 != 0).any(axis=1)
            maybe = verd == ZONE_MAYBE
            self.blocks_pruned += float((live & ~maybe).sum())
            all_rows = verd == ZONE_ALL
            all_bits = u2[all_rows].copy()
            u2[~maybe] = 0
        uw = u2.reshape(-1)[: n_words(self.n)]
        mask = unpack_bits(uw, self.n)
        idx = np.nonzero(mask)[0]
        acc = None
        for a in grp:
            hits = self.table.eval_atom(a, idx)
            acc = hits if acc is None else (
                (acc & hits) if conj else (acc | hits))
        out = np.zeros(self.n, dtype=bool)
        if len(idx):
            out[idx[acc]] = True
        words = pack_bits(out)
        if all_bits is not None and all_bits.size:
            o2 = np.zeros((self.nblocks, wpb), dtype=np.uint32)
            o2.reshape(-1)[: n_words(self.n)] = words
            o2[all_rows] |= all_bits
            words = o2.reshape(-1)[: n_words(self.n)].copy()
        # gather cost: post-prune records, block-granular touch count
        self.records_touched += len(idx) * len(grp)
        self.blocks_touched += live_block_count(uw, self.nblocks, wpb)
        return words, src_count, int(popcount(words))

    def _apply_host(self, atom: Atom, ds: Sequence[_DevSet],
                    union: _DevSet) -> List[_DevSet]:
        """Host-gather fallback for atoms a device kernel cannot run."""
        self.host_fallbacks += 1
        uw = self._pull_flat(union)
        words, src_count, out_count = self._host_gather([atom], True, uw)
        self._log_op((atom_key(atom),), atom.selectivity, src_count,
                     out_count)
        sat = self._from_flat(words)
        return [self._setop(sat, d, OP_AND) for d in ds]

    def _bind_atom(self, atom: Atom):
        """(column blocks, lookup mask or None) for a device-executable
        atom; (None, None) when the atom needs the host fallback."""
        if lookup_atom(atom):
            mask = self._lookup_mask(atom)
            if mask is None:
                return None, None
            return self._col_recmajor(atom.column), mask
        if device_atom(atom):
            return self._col_recmajor(atom.column), None
        return None, None

    def _bind_zone(self, atom: Atom, col):
        """The atom's device zone verdicts (per part), or None (nothing
        prunes, or the atom runs on the host)."""
        zone = self._zone_mask([atom]) if col is not None else None
        return None if zone is None else self._rows(zone)

    def _zone_parts(self, zone) -> Sequence:
        return ([None] * len(self._spans()) if zone is None
                else self._parts(zone))

    def apply_atom(self, atom: Atom, d: _DevSet) -> _DevSet:
        self._ready(d)
        col, lmask = self._bind_atom(atom)
        zone = self._bind_zone(atom, col)
        self._account([atom], d, device=col is not None, zone=zone)
        if col is None:
            return self._apply_host(atom, [d], d)[0]
        self.device_dispatches += 1
        lms = (self._parts(self._replicated(lmask.view(np.int32)))
               if lmask is not None else None)
        value, opcode = ((None, None) if lms is not None else
                         (float(atom.value), CMP_OPCODE[atom.op]))
        parts = self._parts(d)
        outs = []
        for j, (p, c, z) in enumerate(zip(parts, self._parts(col),
                                          self._zone_parts(zone))):
            if lms is not None:
                evaluate = (lambda ep, c=c, p=p, lm=lms[j]:
                            dict_lookup_scan(c, p.bits, ep, lm))
            else:
                evaluate = (lambda ep, c=c, p=p:
                            predicate_scan(c, p.bits, ep, value, opcode))
            outs.append(_DevSet(*_zone_blend(evaluate, p.bits, p.pops, z)))
        self._fb_queue([atom], True, [p.pops.sum() for p in parts],
                       [o.pops.sum() for o in outs])
        return self._join(outs)

    def apply_atom_multi(self, atom: Atom, ds: Sequence[_DevSet]
                         ) -> List[_DevSet]:
        """Q device record sets against one atom in one stacked kernel
        launch per part (K5, or K6 for a lookup atom)."""
        if len(ds) == 1:
            return [self.apply_atom(atom, ds[0])]
        self._ready(*ds)
        # one reduce launch per part (not Q-1 setops): the union only
        # feeds the fallback path and cost accounting; the same launch
        # writes the stacked copy of the sets that the stacked scan and the
        # zone blend read
        self.device_dispatches += 1
        reduced = [bitmap_union_reduce(rows)
                   for rows in zip(*[self._parts(d) for d in ds])]
        union = self._join([_DevSet(ub, up) for ub, up, _, _ in reduced])
        col, lmask = self._bind_atom(atom)
        zone = self._bind_zone(atom, col)
        self._account([atom], union, device=col is not None, zone=zone)
        if col is None:
            return self._apply_host(atom, ds, union)
        self.device_dispatches += 1
        lms = (self._parts(self._replicated(lmask.view(np.int32)))
               if lmask is not None else None)
        value, opcode = ((None, None) if lms is not None else
                         (float(atom.value), CMP_OPCODE[atom.op]))
        outs, srcs, dsts = [], [], []
        for j, ((_, _, bits, pops), c, z) in enumerate(zip(
                reduced, self._parts(col), self._zone_parts(zone))):
            q, n, w = bits.shape
            flat = bits.reshape(q * n, w)

            def evaluate(ep, c=c, flat=flat, q=q, n=n, w=w, j=j):
                if lms is not None:
                    o, p = dict_lookup_scan_multi(c, flat, ep.reshape(-1),
                                                  lms[j])
                else:
                    o, p = predicate_scan_multi(c, flat, ep.reshape(-1),
                                                value, opcode)
                return o.reshape(q, n, w), p.reshape(q, n)

            out, opops = _zone_blend(evaluate, bits, pops, z)
            outs.append((out, opops))
            srcs.append(pops.sum(dim=-1))
            dsts.append(opops.sum(dim=-1))
        self._fb_queue([atom], True, srcs, dsts)
        return [self._join([_DevSet(out[j], opops[j]) for out, opops in outs])
                for j in range(len(ds))]

    # -- the single end-of-query (or end-of-batch) host sync -------------------
    def materialize(self, sets: Sequence[_DevSet]) -> List[np.ndarray]:
        """Fetch result bitmaps AND flush pending cost counters in one
        bundled transfer — the query's (or lockstep batch's) single host
        sync.  Queued observations may be scalars or stacked ``[Q]``
        vectors; each is flattened, and split back into one observation
        per query after the fetch."""
        _faults.trip("device.dispatch", backend=self, where="materialize")
        self._flush()
        nw = n_words(self.n)
        m = len(self._pend_records)
        fb_lens = [t[0].numel() for t in self._fb_src]
        f = sum(fb_lens)
        parts = [self._to_lead([p.bits.reshape(-1) for p in
                                self._parts(d)])[:nw] for d in sets]
        # per part: its counters and observations, summed across the parts
        counters = []
        for j in range(len(self._spans())):
            v = []
            if m:
                v.append(torch.stack([e[j] for e in self._pend_records
                                      + self._pend_blocks
                                      + self._pend_pruned]).to(torch.int32))
            if f:
                v.append(torch.cat([t[j].reshape(-1) for t in
                                    self._fb_src + self._fb_out])
                         .to(torch.int32))
            counters.append(v)
        if len(counters) == 1:
            parts += counters[0]
        elif m or f:
            parts.append(self._sum_to_lead([torch.cat(v) for v in counters])
                         .to(torch.int32))
        self.host_syncs += 1
        host = (torch.cat(parts).cpu().numpy() if parts
                else np.zeros(0, dtype=np.int32))
        flats = [host[j * nw: (j + 1) * nw].view(np.uint32).copy()
                 for j in range(len(sets))]
        cnt = host[len(sets) * nw: len(sets) * nw + 3 * m].astype(np.float64)
        rec, blk, prn = cnt[:m], cnt[m: 2 * m], cnt[2 * m:]
        fb = host[len(sets) * nw + 3 * m:]
        fsrc, fout = fb[:f], fb[f:]
        ks = np.asarray(self._pend_k, dtype=np.float64)
        self.stats.records_evaluated += float((rec * ks).sum())
        self.stats.weighted_cost += float(
            (rec * np.asarray(self._pend_weights)).sum())
        self.blocks_touched += float((blk * ks).sum())
        self.records_touched += float((blk * ks).sum() * self.block)
        self.blocks_pruned += float((prn * ks).sum())
        self._pend_records, self._pend_weights = [], []
        self._pend_k, self._pend_blocks, self._pend_pruned = [], [], []
        off = 0
        for (keys, est), k in zip(self._fb_meta, fb_lens):
            for s, o in zip(fsrc[off: off + k], fout[off: off + k]):
                self._log_op(keys, est, int(s), int(o))
            off += k
        self._fb_meta, self._fb_src, self._fb_out = [], [], []
        return flats

    def _host_atom_group(self, op, src: _DevSet) -> _DevSet:
        """Host fallback for a tape ATOM/CHAIN op: zone-pruned gather of
        src's records, evaluate the group's atoms on them, combine (∧/∨),
        scatter (see :meth:`_host_gather`)."""
        atoms = self.last_tape.tree.atoms
        grp = [atoms[a] for a in op.aids]
        self.host_fallbacks += 1
        self._account(grp, src, device=False)
        sw = self._pull_flat(src)
        words, src_count, out_count = self._host_gather(grp, op.conj, sw)
        est = group_selectivity([a.selectivity for a in grp], op.conj)
        self._log_op(tuple(atom_key(a) for a in grp), est, src_count,
                     out_count)
        return self._from_flat(words)

    # -- whole-tape execution --------------------------------------------------
    def _tape_bindings(self, tape: PlanTape):
        """Column tensors, value vector, lookup bitmasks and per-op metadata.

        Returns (cols, values, lmasks, meta, device_ok) where meta[i] is
        (col_indices, value_indices, opcodes) for op i (empty for SETOPs)
        and device_ok[i] says a kernel can run op i.  A dictionary-
        membership ATOM op carries opcode :data:`IN_OPCODE` and its value
        index points into ``lmasks`` (stacked packed hit bitmasks, padded
        to a common word count) instead of ``values``.
        """
        atoms = tape.tree.atoms
        col_ix: Dict[str, int] = {}
        cols: List[torch.Tensor] = []
        values: List[float] = []
        lmask_rows: List[np.ndarray] = []
        meta: List[Tuple[tuple, tuple, tuple]] = []
        device_ok: List[bool] = []
        for op in tape.ops:
            if op.kind not in (ATOM, CHAIN):
                meta.append(((), (), ()))
                device_ok.append(True)
                continue
            if len(op.aids) == 1 and lookup_atom(atoms[op.aids[0]]):
                a = atoms[op.aids[0]]
                col = self._col_recmajor(a.column)
                mask = self._lookup_mask(a)
                if col is None or mask is None:
                    meta.append(((), (), ()))
                    device_ok.append(False)
                    continue
                if a.column not in col_ix:
                    col_ix[a.column] = len(cols)
                    cols.append(col)
                meta.append(((col_ix[a.column],), (len(lmask_rows),),
                             (IN_OPCODE,)))
                lmask_rows.append(mask)
                device_ok.append(True)
                continue
            ok = all(device_atom(atoms[a]) for a in op.aids)
            bound = []
            if ok:
                for a in op.aids:
                    c = self._col_recmajor(atoms[a].column)
                    if c is None:
                        ok = False
                        break
                    bound.append(atoms[a].column)
            if not ok:
                meta.append(((), (), ()))
                device_ok.append(False)
                continue
            cixs, vixs, opcodes = [], [], []
            for a, name in zip(op.aids, bound):
                if name not in col_ix:
                    col_ix[name] = len(cols)
                    cols.append(self._col_recmajor(name))
                cixs.append(col_ix[name])
                vixs.append(len(values))
                values.append(float(atoms[a].value))
                opcodes.append(CMP_OPCODE[atoms[a].op])
            meta.append((tuple(cixs), tuple(vixs), tuple(opcodes)))
            device_ok.append(True)
        if lmask_rows:
            u = max(len(m) for m in lmask_rows)
            lmasks = np.zeros((len(lmask_rows), u), dtype=np.uint32)
            for j, m in enumerate(lmask_rows):
                lmasks[j, : len(m)] = m
        else:
            lmasks = np.zeros((0, 1), dtype=np.uint32)
        return cols, values, lmasks, meta, device_ok

    def _tape_zone_masks(self, tape: PlanTape):
        """Per costed op (tape order) its ``i32[nblocks]`` zone row and
        whether it has a decided (non-MAYBE) block.

        Returns ``(rows, blend)``: ``rows`` is ``i32[M, nblocks]`` (ops
        nothing prunes get an all-MAYBE row) or None when pruning is off
        or no op has a decided block; ``blend[m]`` selects the masked
        evaluation and blend for op ``m``.
        """
        costed = tape.costed_ops()
        if self._zones is None:
            return None, [False] * len(costed)
        atoms = tape.tree.atoms
        rows, blend = [], []
        for op in costed:
            z = self._zone_mask([atoms[a] for a in op.aids], conj=op.conj)
            blend.append(z is not None)
            rows.append(np.full(self.nblocks, ZONE_MAYBE, np.int32)
                        if z is None else z)
        if not any(blend):
            return None, blend
        return np.stack(rows).astype(np.int32), blend

    def _capture_stream(self, device: torch.device) -> "torch.cuda.Stream":
        """The side stream this backend captures its graphs on ``device``
        on."""
        if device not in self._side_streams:
            self._side_streams[device] = torch.cuda.Stream(device)
        return self._side_streams[device]

    def _graph_pool(self, part: int = 0):
        """The memory pool the graphs of one part share.  Sharing is safe
        because a part's replays are serialized on one stream and each
        replay's output is read (fetched, or gathered with the other parts')
        before the part's next replay; the parts' pools are apart, since a
        run replays every part before the gather reads any output.  A pool
        lives only while one of its graphs does, so a backend that holds no
        program (none made yet, all dropped, or the only capture failed)
        takes fresh pools."""
        if not self._programs:
            self._pools.clear()
        if part not in self._pools:
            self._pools[part] = torch.cuda.graph_pool_handle()
        return self._pools[part]

    def _program(self, tape: PlanTape, meta, cols, n_values: int,
                 lmask_shape: Tuple[int, int], blend: Sequence[bool]):
        """The tape's program, made (and on the card captured) at its first
        run: one :class:`_TapeProgram` per part (a :class:`_PartsProgram`
        over them when there are several).  Keyed as the reference keys
        its jitted programs — the tape's structural key, its pruning shape
        (which ops blend) and the runtime inputs' shapes (U, the block
        count) — plus the part's index and the identity of every tensor a
        captured graph reads by address (the part's bound columns and
        ``full``), which the program holds: key-equal tapes with other
        constants, lookup masks or zone rows share one program.  Least
        recently used programs past :data:`_TAPE_PROGRAM_CAP` are dropped;
        :meth:`refresh` drops them all when the columns move."""
        full = self.full()
        progs = []
        for j, f in enumerate(self._parts(full)):
            pcols = [self._parts(c)[j] for c in cols]
            key = (tape.key, tuple(blend), tuple(lmask_shape), self.nblocks,
                   j, tuple(id(c) for c in pcols), id(f.bits), id(f.pops))
            prog = self._programs.get(key)
            if prog is not None:
                self._programs.move_to_end(key)
            else:
                prog = _TapeProgram(self, tape, meta, pcols, n_values,
                                    lmask_shape, blend, f, part=j)
                if f.bits.device.type == "cuda":
                    prog.capture()
                self._programs[key] = prog
                self.tape_programs += 1
                if len(self._programs) > _TAPE_PROGRAM_CAP:
                    self._programs.popitem(last=False)
            progs.append(prog)
        return progs[0] if len(progs) == 1 else _PartsProgram(self, progs)

    def run_tape(self, tape: PlanTape) -> np.ndarray:
        """Execute a compiled tape; returns the host packed result bitmap.

        All-device tapes — including dictionary-rewritten string atoms —
        run as one device program (``device_dispatches`` += 1) with one
        host sync: on the card one CUDA-graph replay of the tape's kernel
        sequence, after one staging copy of its constants, lookup masks and
        zone rows, and before the one fetch; on the CPU the same program
        runs the plain versions eagerly.  ``tape_programs``,
        ``graph_captures`` and ``graph_replays`` count programs made,
        graphs captured and replays.  Tapes with host-fallback ops (opaque
        UDF atoms, unrewritten non-numeric columns) run op-by-op with
        device slots and make no program, syncing only at each fallback
        and at the end.
        """
        _faults.trip("device.dispatch", backend=self, where="run_tape")
        self.last_tape = tape
        cols, values, lmasks, meta, device_ok = self._tape_bindings(tape)
        if not all(device_ok):
            return self._run_tape_mixed(tape, values, lmasks, meta,
                                        device_ok)
        atoms = tape.tree.atoms
        costed = tape.costed_ops()
        # a K-atom CHAIN evaluates K atoms on all of src's live blocks:
        # counts scale by K, matching the fused +evaluations trade
        ks = np.asarray([len(op.aids) for op in costed], dtype=np.float64)
        self.stats.atom_applications += int(ks.sum())
        self.stats.setops += sum(1 for op in tape.ops if op.kind == SETOP)
        zrows, blend = self._tape_zone_masks(tape)
        prog = self._program(tape, meta, cols, len(values), lmasks.shape,
                             blend)
        prog.stage(np.asarray(values, dtype=np.float32), lmasks, zrows)
        self.device_dispatches += 1
        m = len(costed)
        nw = n_words(self.n)
        self.host_syncs += 1
        # a fresh host array (the fetch's own, or the CPU run's output):
        # the result is a view of it, not a copy
        host = prog.run(4 * m + nw)
        cnt = host[: 4 * m].reshape(4, m)
        res = host[4 * m:].view(np.uint32)
        rec = cnt[0].astype(np.float64)
        weights = np.asarray([sum(atoms[a].cost_factor for a in op.aids)
                              for op in costed])
        self.stats.records_evaluated += float((rec * ks).sum())
        self.stats.weighted_cost += float((rec * weights).sum())
        blk_total = float((cnt[1].astype(np.float64) * ks).sum())
        self.blocks_touched += blk_total
        self.records_touched += blk_total * self.block
        self.blocks_pruned += float((cnt[2].astype(np.float64) * ks).sum())
        # per-op realized selectivities rode the same fetch: (keys, est)
        # metadata is tape-order aligned with rec/outs
        for (opm, keys, est), s, o in zip(op_observation_meta(tape),
                                          cnt[0], cnt[3]):
            self._log_op(keys, est, int(s), int(o))
        return res

    def _run_tape_mixed(self, tape: PlanTape, values, lmasks, meta,
                        device_ok) -> np.ndarray:
        """Op-by-op tape execution with host fallbacks interleaved."""
        slots: List[Optional[_DevSet]] = [None] * tape.n_slots
        atoms = tape.tree.atoms
        for oi, op in enumerate(tape.ops):
            if op.kind == FULL:
                s = self.full()
            elif op.kind == EMPTY:
                s = self.empty()
            elif op.kind == SETOP:
                # a tape's SETOPs form one dependent chain: launched one
                # by one, as on the all-device tape path
                self.stats.setops += 1
                self.device_dispatches += 1
                s = self._join([_DevSet(*bitmap_setop(
                    a.bits, b.bits, op.setop, a.pops, b.pops)) for a, b in
                    zip(self._parts(slots[op.a]), self._parts(slots[op.b]))])
            else:
                src = slots[op.a]
                cixs, vixs, opcodes = meta[oi]
                if not device_ok[oi]:
                    s = self._host_atom_group(op, src)
                else:
                    grp = [atoms[a] for a in op.aids]
                    zone = self._zone_mask(grp, conj=op.conj)
                    zj = None if zone is None else self._rows(zone)
                    self._account(grp, src, zone=zj)
                    cols = [self._parts(self._col_recmajor(a.column))
                            for a in grp]
                    if opcodes[0] == IN_OPCODE:
                        vals = ()
                        lms = self._parts(self._replicated(
                            lmasks[vixs[0]].view(np.int32)))
                    else:
                        vals = [np.float32(values[v]) for v in vixs]
                        lms = [None] * len(cols[0])
                    self.device_dispatches += 1
                    outs = []
                    for j, (p, z) in enumerate(zip(self._parts(src),
                                                   self._zone_parts(zj))):
                        pc = [c[j] for c in cols]
                        outs.append(_DevSet(*_zone_blend(
                            lambda ep, pc=pc, p=p, lm=lms[j]: _costed_eval(
                                op.kind, opcodes, pc, vals, lm, op.conj,
                                p.bits, ep),
                            p.bits, p.pops, z)))
                    self._fb_queue(grp, op.conj,
                                   [p.pops.sum() for p in self._parts(src)],
                                   [o.pops.sum() for o in outs])
                    s = self._join(outs)
            slots[op.dst] = s
        return self.materialize([slots[tape.result]])[0]
