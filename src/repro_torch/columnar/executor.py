"""Plan executors over columnar tables, and the one entry point.

``BitmapBackend``    numpy oracle — gathers exactly the selected records
                     (cost ∝ count(D), the paper's model) and evaluates the
                     atom on them.  Ground truth for tests + paper figures.
                     A copy of the reference package's oracle.

``BlockBackend``     the per-step block engine (``engine="jax"`` /
                     ``"pallas"``), the counterpart of the reference's
                     ``JaxBlockBackend``: record sets stay host-resident
                     packed words, and each atom application runs one
                     step on the device over the *live* blocks only — a
                     live-block scan (K2) and one fused (compare ∧ bitmap)
                     kernel (K1, or K5 for Q stacked sets), two host syncs.
                     In the port ``"jax"`` and ``"pallas"`` are two names
                     for one path, as ``"tape"`` and ``"tape-pallas"`` are:
                     on ``device="cuda"`` both launch the hand-written CUDA
                     kernels, on ``"cpu"`` both run their plain versions.

``DeviceTapeBackend`` (``columnar.device``) runs a compiled tape on the
card through the hand-written CUDA kernels, or on the CPU through their
plain versions.  Sharded execution (``ExecConfig(shards=S)`` or
``mesh=``) runs the tape on each shard's column blocks through
``ShardedTapeBackend`` (``columnar.shard``), which :func:`resolve_backend`
builds.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from ..core.plan import Plan, execute_plan
from ..core.predicate import (Atom, PredicateTree, ZONE_ALL, ZONE_MAYBE,
                              ZONE_NONE, atom_key, zone_verdicts)
from ..core.sets import SetBackend, Stats
from ..core.tape import CMP_OPCODE
from ..kernels import ops as kops
from ..kernels import ref as kref
from ..kernels.bitmap_ops import AND
from .bitmap import (WORD, bitmap_and, bitmap_andnot, bitmap_empty,
                     bitmap_full, bitmap_or, extend_bitmap, live_block_count,
                     n_words, next_pow2, pack_bits, popcount, row_popcounts,
                     unpack_bits)
from .config import UNSET, ConfigError, ExecConfig, config_from_kwargs
from .ingest import dirty_tail
from .table import Table, rewrite_string_atoms


def _f32_atom(atom: Atom) -> Atom:
    """Round an atom's constant(s) through float32 — the zone-verdict copy
    used by the f32 block engines, so pruning decisions match what the
    kernels (which compare in f32) actually compute."""
    v = atom.value
    try:
        if atom.op in ("in", "not_in"):
            v = tuple(float(np.float32(x)) for x in v)
        else:
            v = float(np.float32(v))
    except (TypeError, ValueError):
        return atom
    return dataclasses.replace(atom, value=v, aid=atom.aid)


class _ZonePruner:
    """Shared per-backend zone-verdict cache (atom key -> verdicts).

    Valid only while the underlying table is unchanged — owners clear it on
    refresh/rebuild, exactly like uploaded columns.
    """

    def __init__(self, table: Table, block: int, f32: bool):
        self.table = table
        self.block = block
        self.f32 = f32
        self._cache: Dict[tuple, Optional[np.ndarray]] = {}

    def clear(self) -> None:
        self._cache.clear()

    def verdicts(self, atom: Atom,
                 exact: bool = False) -> Optional[np.ndarray]:
        """``exact=True`` bypasses the f32 rounding — required whenever the
        pruned evaluation itself runs in exact arithmetic (the host-gather
        fallback), where f32-rounded ALL/NONE verdicts could contradict
        the float64 ``eval_atom`` they stand in for."""
        if atom.fn is not None:
            return None
        f32 = self.f32 and not exact
        key = (atom_key(atom), f32)
        if key in self._cache:
            return self._cache[key]
        zm = self.table.zone_map(atom.column, self.block)
        if zm is None:
            verd = None
        else:
            a = _f32_atom(atom) if f32 else atom
            mins, maxs = zm.mins, zm.maxs
            if f32:
                mins = mins.astype(np.float32).astype(np.float64)
                maxs = maxs.astype(np.float32).astype(np.float64)
            verd = zone_verdicts(a, mins, maxs)
        self._cache[key] = verd
        return verd


class _HostOpLog:
    """Realized-selectivity observation log shared by the host engines.

    Host engines already hold every popcount on the host (they sync per
    step), so logging ``(atom_keys, estimated fraction, source popcount,
    output popcount)`` per costed application is free.  Sessions drain the
    log each batch and feed it to the Q-Error feedback loop; the cap bounds
    undrained standalone use.  Mirrors ``DeviceTapeBackend.op_log``, where
    the popcounts instead ride the one bundled device transfer.
    """

    _OP_LOG_CAP = 4096

    def _log_op(self, atom: Atom, src: float, out: float) -> None:
        log = self.__dict__.setdefault("op_log", [])
        log.append(((atom_key(atom),), float(atom.selectivity),
                    int(src), int(out)))
        if len(log) > self._OP_LOG_CAP:
            del log[: len(log) - self._OP_LOG_CAP]

    def drain_op_log(self) -> List[Tuple]:
        log = self.__dict__.setdefault("op_log", [])
        self.op_log = []
        return log


class BitmapBackend(_HostOpLog, SetBackend):
    """Numpy oracle engine on packed record bitmaps.

    ``scan_threshold``: optional fraction above which an atom application
    switches from gather-the-selected-records to a full-column vectorized
    scan ∧ bitmap (the paper's HDD sequential-vs-random crossover, §2.4 —
    measured 1.4-1.7x wall-clock on the CPU engine, see EXPERIMENTS §Perf).
    Default off = the paper-faithful count(D) gather engine.
    ``records_touched`` accounts actual records read (== records_evaluated
    for the gather engine; |R| per full-scanned atom otherwise).

    ``zone_block``: optional block size enabling zone-map pre-pruning of the
    gather (streaming-ingest zone maps, ``columnar.ingest``): blocks whose
    min/max bounds decide the atom outright skip the gather — NONE blocks
    contribute nothing, ALL blocks pass their input bits through.  Off by
    default so the oracle stays the paper-faithful count(D) engine; the
    paper's cost metrics (``stats``) are accounted *before* pruning either
    way, so plan-quality comparisons are unaffected.
    """

    def __init__(self, table: Table, scan_threshold: Optional[float] = None,
                 zone_block: Optional[int] = None):
        self.table = table
        self.n = table.n_records
        self.scan_threshold = scan_threshold
        self.stats = Stats()
        self.records_touched = 0.0
        self.blocks_pruned = 0
        self._zones = (_ZonePruner(table, zone_block, f32=False)
                       if zone_block else None)

    def full(self):
        return bitmap_full(self.n)

    def empty(self):
        return bitmap_empty(self.n)

    def inter(self, a, b):
        self.stats.setops += 1
        return bitmap_and(a, b)

    def union(self, a, b):
        self.stats.setops += 1
        return bitmap_or(a, b)

    def diff(self, a, b):
        self.stats.setops += 1
        return bitmap_andnot(a, b)

    def count(self, d) -> float:
        return float(popcount(d))

    def _eval_packed(self, atom: Atom, d, cnt: int):
        """Evaluate ``atom`` on the records of packed set ``d`` (one column
        touch, gather or threshold-crossed full scan); returns packed D ∧ P."""
        if (self.scan_threshold is not None
                and cnt > self.scan_threshold * self.n):
            self.records_touched += self.n
            hits = self.table.eval_atom(atom, None)    # sequential scan
            return pack_bits(hits) & d
        verd = self._zones.verdicts(atom) if self._zones else None
        if verd is not None and (verd != ZONE_MAYBE).any():
            return self._eval_pruned(atom, d, verd)
        self.records_touched += cnt
        mask = unpack_bits(d, self.n)
        idx = np.nonzero(mask)[0]
        hits = self.table.eval_atom(atom, idx)
        out = np.zeros(self.n, dtype=bool)
        out[idx[hits]] = True
        return pack_bits(out)

    def _eval_pruned(self, atom: Atom, d, verd: np.ndarray):
        """Gather restricted to MAYBE blocks; ALL blocks pass ``d`` bits
        through, NONE blocks contribute nothing."""
        wpb = self._zones.block // WORD
        nblocks = len(verd)
        d2 = np.zeros((nblocks, wpb), dtype=np.uint32)
        d2.reshape(-1)[: n_words(self.n)] = d
        live = (d2 != 0).any(axis=1)
        self.blocks_pruned += int((live & (verd != ZONE_MAYBE)).sum())
        ev = d2.copy()
        ev[verd != ZONE_MAYBE] = 0
        mask = unpack_bits(ev.reshape(-1)[: n_words(self.n)], self.n)
        idx = np.nonzero(mask)[0]
        self.records_touched += len(idx)
        hits = self.table.eval_atom(atom, idx)
        out = np.zeros(self.n, dtype=bool)
        out[idx[hits]] = True
        sat = np.zeros((nblocks, wpb), dtype=np.uint32)
        sat.reshape(-1)[: n_words(self.n)] = pack_bits(out)
        sat[verd == ZONE_ALL] |= d2[verd == ZONE_ALL]
        return sat.reshape(-1)[: n_words(self.n)].copy()

    def extend_set(self, s, old_n: int, delta_hits):
        return extend_bitmap(s, old_n, delta_hits, self.table.n_records)

    def apply_atom(self, atom: Atom, d):
        cnt = popcount(d)
        self.stats.atom_applications += 1
        self.stats.records_evaluated += cnt
        self.stats.weighted_cost += atom.cost_factor * cnt
        sat = self._eval_packed(atom, d, cnt)
        self._log_op(atom, cnt, popcount(sat))
        return sat

    def apply_atom_multi(self, atom: Atom, ds):
        """Batched apply: evaluate ``atom`` once on the *union* of the record
        sets, then mask per set — one column touch for the whole group."""
        if len(ds) == 1:
            return [self.apply_atom(atom, ds[0])]
        union = ds[0]
        for d in ds[1:]:
            union = bitmap_or(union, d)
        cnt = popcount(union)
        self.stats.atom_applications += 1
        self.stats.records_evaluated += cnt
        self.stats.weighted_cost += atom.cost_factor * cnt
        sat = self._eval_packed(atom, union, cnt)
        self._log_op(atom, cnt, popcount(sat))
        return [bitmap_and(sat, d) for d in ds]


class BlockBackend(_HostOpLog, SetBackend):
    """The per-step block engine: the reference's ``JaxBlockBackend``
    (``repro.columnar.executor``) on the port's kernels.

    Record sets are host-resident numpy ``u32`` words, and the set algebra
    runs on the host.  Columns upload once, record-major ``f32[nblocks,
    block]`` (``nblocks = ceil(n / block)``, not bucketed).  An atom
    application on a numeric column is one step on the device:

    1. the live-block scan: the union's words upload and K2
       (``kops.bitmap_op(u, u, AND)``) returns their per-block popcounts,
       fetched to the host (one sync) to find the live blocks;
    2. the zone verdicts drop the live blocks they decide (ALL blocks pass
       their bits through on the host);
    3. the remaining live blocks gather into a power-of-two bucket of N
       rows (``col[lpad]``, and the sets' words with their popcounts, from
       the K2 scan at Q = 1 and counted on the host at Q > 1; padding
       rows carry zero words and popcount 0, so the kernels skip them),
       K1 (``kops.predicate_blocks``) or K5 (``kops.predicate_blocks_multi``
       for Q stacked sets) runs, and its live rows are fetched (one sync).

    Every upload goes through pinned staging with a non-blocking copy, so
    the two fetches are a step's only host syncs; a staging buffer is
    written again only after the step that read it has fetched.  Words
    cross as ``np.uint32`` <-> ``torch.int32`` views.  LIKE / UDF /
    categorical-string atoms take the reference's host gather with exact
    zone verdicts; the kernel path compares in f32 with f32-rounded
    verdicts.  On ``device="cuda"`` nothing runs a plain version; on
    ``"cpu"`` the same steps run the kernels' plain versions.

    Counters keep the reference's meaning: ``stats``, ``blocks_touched``,
    ``records_touched``, ``blocks_pruned``, ``kernel_invocations`` (K1 /
    K5 launches), ``host_syncs`` (fetches), ``uploaded_bytes`` (columns)
    and the op log.  The port-only ``staged_bytes`` and ``fetched_bytes``
    count the per-step words and indices sent to the device and fetched
    back.
    """

    def __init__(self, table: Table, block: int = 8192, engine: str = "jax",
                 zone_prune: bool = True, device: str = "cuda"):
        from .device import torch_device
        if block % WORD:
            raise ValueError("block must be a multiple of 32")
        self.device = torch_device(device)
        self.table = table
        self.n = table.n_records
        self.block = block
        self.engine = engine
        self.stats = Stats()
        self.blocks_touched = 0
        self.records_touched = 0.0
        self.blocks_pruned = 0        # blocks decided by zone maps alone
        self.kernel_invocations = 0   # fused predicate kernel launches
        self.host_syncs = 0           # device->host transfers (per-step tax)
        self.uploaded_bytes = 0       # host->device column traffic
        self.staged_bytes = 0         # per-step words / indices uploaded
        self.fetched_bytes = 0        # per-step popcounts / words fetched
        self._cols: Dict[str, torch.Tensor] = {}
        self._zones = (_ZonePruner(table, block, f32=True)
                       if zone_prune else None)
        self._stage: Optional[torch.Tensor] = None
        self._size()
        # preallocated padded bitmap scratch, reused across applies (grown
        # on demand for larger lockstep groups)
        self._words = np.zeros((1, self.nblocks * (block // WORD)),
                               dtype=np.uint32)

    def _size(self) -> None:
        """Block count and the buffers sized by it: the union's pinned
        staging words and the all-live popcounts of the K2 scan."""
        self.nblocks = (self.n + self.block - 1) // self.block
        self._padded = self.nblocks * self.block
        self._uw_t = self._pinned(self.nblocks * (self.block // WORD))
        self._uw = self._uw_t.numpy().view(np.uint32)
        self._ones = torch.ones(self.nblocks, dtype=torch.int32,
                                device=self.device)

    def _pinned(self, n: int) -> torch.Tensor:
        """An i32[n] host staging buffer, pinned on the card."""
        return torch.zeros(n, dtype=torch.int32,
                           pin_memory=self.device.type == "cuda")

    def _to_device(self, t: torch.Tensor) -> torch.Tensor:
        """Host tensor -> the backend's device without a host sync: a
        non-blocking copy from pinned memory (an unpinned ``t`` is copied
        into torch's pinned caching allocator first, which keeps the block
        until the copy has run).  On the CPU, ``t`` itself."""
        if self.device.type != "cuda":
            return t
        if not t.is_pinned():
            t = t.pin_memory()
        return t.to(self.device, non_blocking=True)

    def _fetch(self, t: torch.Tensor) -> np.ndarray:
        """One host sync: a device tensor's words or popcounts on the host."""
        self.host_syncs += 1
        self.fetched_bytes += t.numel() * 4
        return t.cpu().numpy()

    def refresh(self) -> int:
        """Grow the backend after a pure table *append*: uploaded columns
        keep every block below the append boundary and upload only the
        dirty tail (the boundary block plus appended blocks).  Caller must
        have proven the append via :meth:`Table.delta_since`.  Returns the
        bytes uploaded."""
        n_new = self.table.n_records
        if self._zones:
            self._zones.clear()
        if n_new == self.n:
            return 0
        dirty = self.n // self.block
        self.n = n_new
        self._size()
        self._words = np.zeros((self._words.shape[0],
                                self.nblocks * (self.block // WORD)),
                               dtype=np.uint32)
        up = 0
        for name, col in list(self._cols.items()):
            raw = self.table.column_data(name)
            tail = dirty_tail(raw, dirty, self.nblocks, self.block)
            up += tail.nbytes
            tail = self._to_device(torch.from_numpy(
                tail.reshape(self.nblocks - dirty, self.block)))
            self._cols[name] = (torch.cat([col[:dirty], tail])
                                if dirty else tail)
        self.uploaded_bytes += up
        return up

    def extend_set(self, s, old_n: int, delta_hits):
        return extend_bitmap(s, old_n, delta_hits, self.n)

    # -- set algebra (host, packed words) -------------------------------------
    def full(self):
        return bitmap_full(self.n)

    def empty(self):
        return bitmap_empty(self.n)

    def inter(self, a, b):
        self.stats.setops += 1
        return bitmap_and(a, b)

    def union(self, a, b):
        self.stats.setops += 1
        return bitmap_or(a, b)

    def diff(self, a, b):
        self.stats.setops += 1
        return bitmap_andnot(a, b)

    def count(self, d) -> float:
        return float(popcount(d))

    # -- the costed action -----------------------------------------------------
    def _blocked_column(self, name: str) -> Optional[torch.Tensor]:
        col = self._cols.get(name)
        if col is None:
            # column_data resolves derived dictionary-code columns, so
            # rewritten string atoms run the fused numeric kernels
            raw = self.table.column_data(name)
            if not np.issubdtype(raw.dtype, np.number):
                return None
            arr = np.zeros(self._padded, dtype=np.float32)
            arr[: self.n] = raw.astype(np.float32)
            self.uploaded_bytes += arr.nbytes
            col = self._to_device(torch.from_numpy(
                arr.reshape(self.nblocks, self.block)))
            self._cols[name] = col
        return col

    def _live_blocks(self, union) -> Tuple[np.ndarray, np.ndarray]:
        """Indices of blocks with any live record in ``union``, and every
        block's popcount: K2 counts them on the device (its input
        popcounts all 1, so every row is read) and only the i32[nblocks]
        vector returns to the host — not the full unpacked bitmap."""
        uw = self._uw
        uw[:] = 0
        uw[: n_words(self.n)] = union
        self.staged_bytes += uw.nbytes
        uw2d = self._to_device(self._uw_t).view(self.nblocks,
                                                self.block // WORD)
        _, pops = kops.bitmap_op(uw2d, uw2d, AND, self._ones, self._ones)
        pops = self._fetch(pops)
        return np.nonzero(pops > 0)[0], pops

    def _staging(self, n: int) -> torch.Tensor:
        """The step's pinned staging buffer, at least ``n`` words."""
        if self._stage is None or self._stage.numel() < n:
            self._stage = self._pinned(next_pow2(n))
        return self._stage[:n]

    def _scan_live(self, col: torch.Tensor, atom: Atom, opcode: int,
                   words3d: np.ndarray, live: np.ndarray,
                   block_pops: np.ndarray) -> np.ndarray:
        """K1 (Q = 1) or K5 (Q > 1) over the ``live`` blocks of the Q sets
        in ``words3d`` (``u32[Q, nblocks, W]``), gathered into a
        power-of-two bucket; returns the live rows' ``u32[Q, L, W]``."""
        q, _, wpb = words3d.shape
        nl = len(live)
        pb = next_pow2(nl)
        nbits, npops = q * pb * wpb, q * pb
        stage = self._staging(nbits + npops + pb)
        host = stage.numpy()
        bits = host[:nbits].reshape(q, pb, wpb)
        bits[:, nl:] = 0
        bits[:, :nl] = words3d[:, live, :].view(np.int32)
        pops = host[nbits: nbits + npops].reshape(q, pb)
        pops[:, nl:] = 0
        pops[:, :nl] = (block_pops[live] if q == 1
                        else row_popcounts(words3d[:, live, :]))
        lpad = host[nbits + npops:]
        lpad[:] = 0
        lpad[:nl] = live
        self.staged_bytes += stage.numel() * 4
        dev = self._to_device(stage)
        col_live = col.index_select(0, dev[nbits + npops:])
        value = kref.f32(atom.value)
        if q == 1:
            res = kops.predicate_blocks(col_live, dev[:nbits].view(pb, wpb),
                                        value, opcode,
                                        pops=dev[nbits: nbits + npops])
            res = res[None]
        else:
            res = kops.predicate_blocks_multi(
                col_live, dev[:nbits].view(q, pb, wpb), value, opcode,
                pops=dev[nbits: nbits + npops].view(q, pb))
        self.kernel_invocations += 1
        return self._fetch(res[:, :nl]).view(np.uint32)

    def _eval_blocked(self, atom: Atom, ds, union):
        """One column touch: evaluate ``atom`` on the blocks live in
        ``union`` against each packed set in ``ds`` (ds[j] ⊆ union)."""
        opcode = CMP_OPCODE.get(atom.op)
        col = self._blocked_column(atom.column) if opcode is not None else None
        # the kernel path compares in f32, the fallback in exact float64 —
        # verdicts must match the arithmetic of the evaluation they prune
        verd = (self._zones.verdicts(atom, exact=col is None)
                if self._zones else None)
        if verd is not None and len(verd) != self.nblocks:
            verd = None      # backend not yet refreshed onto this snapshot
        if col is None:
            # LIKE/UDF/categorical-string fallback: gather only the union's
            # records on the host (cost ∝ count(union), the oracle path).
            # Accounted identically on both block engines: count(union)
            # records, block-granular touch count.  Zone maps (numeric
            # IN/NOT-IN atoms) prune the gather to MAYBE blocks; ALL blocks
            # pass their input bits straight through.
            wpb = self.block // WORD
            u2 = np.zeros((self.nblocks, wpb), dtype=np.uint32)
            u2.reshape(-1)[: n_words(self.n)] = union
            all_bits = None
            if verd is not None and (verd != ZONE_MAYBE).any():
                live = (u2 != 0).any(axis=1)
                self.blocks_pruned += int((live
                                           & (verd != ZONE_MAYBE)).sum())
                # ALL blocks: every record satisfies the atom, so the
                # union's bits survive without touching the column — save
                # them before zeroing the non-MAYBE rows out of the gather
                all_bits = u2[verd == ZONE_ALL].copy()
                u2[verd != ZONE_MAYBE] = 0
            uw = u2.reshape(-1)[: n_words(self.n)]
            mask = unpack_bits(uw, self.n)
            idx = np.nonzero(mask)[0]
            self.records_touched += len(idx)
            self.blocks_touched += live_block_count(
                uw, self.nblocks, wpb)
            hits = self.table.eval_atom(atom, idx)
            out = np.zeros(self.n, dtype=bool)
            out[idx[hits]] = True
            sat2 = np.zeros((self.nblocks, wpb), dtype=np.uint32)
            sat2.reshape(-1)[: n_words(self.n)] = pack_bits(out)
            if all_bits is not None:
                sat2[verd == ZONE_ALL] |= all_bits
            sat = sat2.reshape(-1)[: n_words(self.n)].copy()
            return [bitmap_and(sat, d) for d in ds]

        q = len(ds)
        wpb = self.block // WORD
        if q > self._words.shape[0]:
            self._words = np.zeros((q, self.nblocks * wpb), dtype=np.uint32)
        words = self._words[:q]
        words[:] = 0
        for j, d in enumerate(ds):
            words[j, : n_words(self.n)] = d
        words3d = words.reshape(q, self.nblocks, wpb)
        live, block_pops = self._live_blocks(union)
        all_blocks = np.zeros(0, dtype=live.dtype)
        if verd is not None and len(live):
            lv = verd[live]
            all_blocks = live[lv == ZONE_ALL]
            self.blocks_pruned += int((lv != ZONE_MAYBE).sum())
            live = live[lv == ZONE_MAYBE]
        self.blocks_touched += len(live)
        self.records_touched += len(live) * self.block
        out3d = np.zeros((q, self.nblocks, wpb), dtype=np.uint32)
        if len(all_blocks):
            # zone-ALL blocks: D ∧ P == D there, no kernel work needed
            out3d[:, all_blocks, :] = words3d[:, all_blocks, :]
        if len(live):
            out3d[:, live, :] = self._scan_live(col, atom, opcode, words3d,
                                                live, block_pops)
        # copy: results escape into Xi/Delta maps and caches — a view would
        # pin the whole (q, nblocks, wpb) buffer per retained bitmap
        return [out3d[j].reshape(-1)[: n_words(self.n)].copy()
                for j in range(q)]

    def apply_atom(self, atom: Atom, d):
        self.stats.atom_applications += 1
        cnt = popcount(d)
        self.stats.records_evaluated += cnt
        self.stats.weighted_cost += atom.cost_factor * cnt
        res = self._eval_blocked(atom, [d], d)[0]
        self._log_op(atom, cnt, popcount(res))
        return res

    def apply_atom_multi(self, atom: Atom, ds):
        """Batched apply: Q record sets against one atom in one fused kernel
        launch (``predicate_blocks_multi``, K5) — the column blocks live
        in any of the sets are loaded once for the whole group."""
        if len(ds) == 1:
            return [self.apply_atom(atom, ds[0])]
        union = ds[0]
        for d in ds[1:]:
            union = bitmap_or(union, d)
        cnt = popcount(union)
        self.stats.atom_applications += 1
        self.stats.records_evaluated += cnt
        self.stats.weighted_cost += atom.cost_factor * cnt
        res = self._eval_blocked(atom, ds, union)
        for d, r in zip(ds, res):
            self._log_op(atom, popcount(d), popcount(r))
        return res


def resolve_backend(table: Table, config: ExecConfig, reuse=None):
    """The single backend factory every entry point funnels through.

    Maps ``config.engine`` (plus the shard axis) to its backend class,
    validates ``reuse`` against the config (table identity, backend class,
    per-step engine name, device), and constructs a fresh backend from the
    config's block / zone_prune / shards / mesh / device knobs when
    ``reuse`` is None.  Every mismatch is a :class:`ConfigError`.
    ``"jax"`` and ``"pallas"`` both build a :class:`BlockBackend`, which
    keeps the name it was asked for; a sharded config (``shards > 1`` or a
    ``mesh``, engine ``"tape"`` only) builds a
    :class:`~repro_torch.columnar.shard.ShardedTapeBackend`.
    """
    from .device import DeviceTapeBackend, torch_device
    eng = config.engine
    if reuse is not None and reuse.table is not table:
        raise ConfigError("backend was built for a different table")
    if eng == "numpy":
        if reuse is not None:
            if not isinstance(reuse, BitmapBackend):
                raise ConfigError("engine 'numpy' needs a BitmapBackend")
            return reuse
        return BitmapBackend(table)
    if config.sharded:
        from .shard import ShardedTapeBackend
        if reuse is None:
            return ShardedTapeBackend(table, block=config.block,
                                      zone_prune=config.zone_prune,
                                      shards=config.shards, mesh=config.mesh,
                                      device=config.device)
        if not isinstance(reuse, ShardedTapeBackend):
            raise ConfigError(
                f"sharded engine {eng!r} (shards={config.shards}) needs a "
                "ShardedTapeBackend")
    tape = eng in ("tape", "tape-pallas")
    if reuse is not None:
        if tape and not isinstance(reuse, DeviceTapeBackend):
            raise ConfigError(f"engine {eng!r} needs a DeviceTapeBackend")
        if not tape and not (isinstance(reuse, BlockBackend)
                             and reuse.engine == eng):
            raise ConfigError(f"engine {eng!r} needs a matching "
                              "BlockBackend")
        if reuse.device != torch_device(config.device):
            raise ConfigError(
                f"backend lives on {reuse.device}, config asks for "
                f"{config.device!r}")
        return reuse
    if tape:
        return DeviceTapeBackend(table, block=config.block,
                                 zone_prune=config.zone_prune,
                                 device=config.device)
    return BlockBackend(table, block=config.block, engine=eng,
                        zone_prune=config.zone_prune, device=config.device)


def run_query(tree: PredicateTree, table: Table, planner=UNSET, engine=UNSET,
              model=UNSET, backend=None, rewrite_strings=UNSET,
              config: Optional[ExecConfig] = None) -> tuple:
    """Plan + execute; returns (record bitmap, plan, backend-with-stats).

    The construction path is ``config=ExecConfig(...)``; the legacy
    ``planner`` / ``engine`` / ``model`` / ``rewrite_strings`` kwargs keep
    working through the deprecation shim (one warning per kwarg name per
    process — see :mod:`repro_torch.columnar.config`).

    Engines: ``tape`` / ``tape-pallas`` (the default; plan compiled to a
    tape and executed through the kernels with a single host sync — see
    ``core.tape`` / ``columnar.device``), ``jax`` / ``pallas`` (the
    per-step block engine, :class:`BlockBackend`: two host syncs per atom
    application) — each pair two names for one path — and ``numpy`` (the
    host oracle, ``device="cpu"`` only).  ``config.device`` places the
    device engines: ``"cuda"`` (default) runs the CUDA kernels and raises
    without a GPU, ``"cpu"`` runs their plain versions.  ``backend``
    optionally reuses an existing engine backend (keeps device-resident
    columns warm across calls); it must match the config —
    :func:`resolve_backend` validates it.

    ``rewrite_strings`` (default on) rewrites dict-encodable string atoms
    into numeric comparisons over the columns' dictionary codes before
    planning (:func:`~repro_torch.columnar.table.rewrite_string_atoms`), so
    mixed numeric/string plans stay on the fused device path — results
    are bit-identical either way.
    """
    from ..core import deepfish, nooropt, optimal_plan, shallowfish
    from ..core.cost import PerAtomCostModel
    cfg = config_from_kwargs(config, planner=planner, engine=engine,
                             model=model, rewrite_strings=rewrite_strings)
    cost_model = cfg.model or PerAtomCostModel()
    if cfg.rewrite_strings:
        tree = rewrite_string_atoms(tree, table)
    name = cfg.planner
    if name == "auto":
        name = "shallowfish" if tree.depth <= 2 else "deepfish"
    planners = {"shallowfish": shallowfish, "deepfish": deepfish,
                "optimal": optimal_plan, "nooropt": nooropt}
    plan = planners[name](tree, cost_model, total_records=table.n_records)
    be = resolve_backend(table, cfg, reuse=backend)
    if cfg.engine in ("tape", "tape-pallas"):
        from ..core.tape import compile_tape
        result = be.run_tape(compile_tape(plan))
    else:
        result = execute_plan(plan, be)
    # tombstone deletes apply at materialize time on every engine: the
    # engines evaluate the predicate over all physical rows (caches stay
    # prefix-valid), the live mask ANDs the dead rows away at the end
    lw = table.live_words()
    return (result if lw is None else result & lw), plan, be
