"""Block-sharded whole-tape execution across a mesh of devices.

:class:`ShardedTapeBackend` scales the single-device
:class:`~repro_torch.columnar.device.DeviceTapeBackend` past one device's
memory by partitioning the *block axis* — the leading axis of every tensor
the tape program touches — across a 1-D ``("shards",)`` mesh
(:func:`repro_torch.launch.mesh.make_shard_mesh`):

* columns upload as record-major ``f32[B, block]`` slices with block rows
  ``[s*B, (s+1)*B)`` on shard ``s``'s device (``B = nblocks / shards``;
  the power-of-two bucket is padded up to at least one block per shard),
* bitmaps ``i32[B, W]`` and popcounts ``i32[B]`` split the same way,
* zone-verdict rows ``i32[M, nblocks]`` split along their *trailing*
  (block) axis, so each shard receives its blocks' verdicts as runtime
  inputs of its program.

One process drives every shard (single-controller, as the reference's JAX
mesh is): a set is the tuple of its shards' parts, and every operation of
the base class runs part by part (see "placement" in ``columnar.device``).
An all-device tape runs as one :class:`~repro_torch.columnar.device.
_TapeProgram` per shard — on the card one CUDA graph per shard, captured
on its device's side stream into a memory pool of its own — replayed in
turn with no fetch between; then the shards' counter prefixes are summed
and their result words joined in block order on the lead device (the
first shard's), through device-to-device copies that CUDA events order
after each shard's replay, and fetched with one copy: ``host_syncs == 1``
per query, as the reference's one collective.  The forward has no
cross-block operation and padding blocks have popcount 0, so sharding
changes no answer and no counter.  The lockstep path (``QuerySession(
batched=True)``, every ``StreamSession`` drain) launches its stacked
kernels and its grouped set operations once per shard and keeps its one
bundled fetch per batch; host fallbacks gather the shards in block order
and scatter back.

Appends stay shard-local: :meth:`refresh` uploads only the real dirty
tail blocks, to the shards that own them (``delta_upload_shards`` counts
them: a small append lands on ONE shard), and inside the block bucket
updates the columns and the full set in place, so no program is made
again.  When the bucket grows the partition changes: the surviving prefix
moves device to device, never from the host again, and the programs are
dropped.  ``uploaded_bytes`` (and so a session's ``upload_bytes``) keeps
the reference's count, the blocks from the dirty one to the end of the
bucket; the port-only ``transferred_bytes`` counts the real tail moved.

Select it with ``ExecConfig(engine="tape", shards=S)`` (or an explicit
``mesh=``), which :func:`repro_torch.columnar.executor.resolve_backend`
routes here; sessions, streams and ``explain_analyze`` compose with it
unchanged.  Unlike the reference (whose ``shard_map`` partitions only its
jnp kernels), the shards run the port's own CUDA kernels on the card and
their plain versions on host shards.
"""
from __future__ import annotations

from typing import List, Optional, Sequence, Tuple

import numpy as np
import torch

from ..runtime import faults as _faults
from .bitmap import bitmap_full, n_words, next_pow2, row_popcounts
from .config import ConfigError
from .device import DeviceTapeBackend, _DevSet, torch_device
from .ingest import dirty_tail
from .table import Table


class _ShardSet(tuple):
    """A sharded set, column or zone row: its parts, one per shard, in
    block order."""

    __slots__ = ()


class ShardedTapeBackend(DeviceTapeBackend):
    """Multi-device tape executor: block-sharded columns and sets, one host
    sync per query and per lockstep batch.

    Parameters mirror :class:`DeviceTapeBackend` plus:

    shards:  shard count (power of two); builds a mesh over the first
             ``shards`` devices of ``device`` when ``mesh`` is not given
    mesh:    an existing 1-D mesh with a ``"shards"`` axis to place onto
             (``shards`` then defaults to its size), such as a
             :class:`~repro_torch.launch.mesh.ShardMesh`, whose devices
             may repeat
    device:  ``"cuda"`` (default) or ``"cpu"`` (host shards); with a
             ``mesh``, None takes the mesh's devices, and a device that
             disagrees with them is a :class:`ConfigError`
    """

    def __init__(self, table: Table, block: int = 8192,
                 zone_prune: bool = True, shards: int = 1, mesh=None,
                 device: Optional[str] = None):
        if mesh is None:
            from ..launch.mesh import make_shard_mesh
            mesh = make_shard_mesh(shards, device=device or "cuda")
        if "shards" not in getattr(mesh, "axis_names", ()):
            raise ConfigError(
                f"mesh axes {getattr(mesh, 'axis_names', None)} lack the "
                "'shards' axis (build one with launch.mesh.make_shard_mesh)")
        size = len(mesh.devices)
        if shards > 1 and size != shards:
            raise ConfigError(f"mesh has {size} devices but "
                              f"shards={shards}")
        if size & (size - 1):
            raise ConfigError(f"shard count must be a power of two, "
                              f"got {size}")
        named = [torch.device(d) for d in mesh.devices]
        if device is not None:
            want = torch.device(device)
            if any(d.type != want.type for d in named) or (
                    want.index is not None and named[0] != want):
                raise ConfigError(
                    f"mesh devices {[str(d) for d in named]} disagree "
                    f"with device={device!r}")
        devices = [torch_device(str(d)) for d in named]
        self.mesh = mesh
        self.shards = size
        self.devices = devices
        super().__init__(table, block=block, zone_prune=zone_prune,
                         device=str(devices[0]))
        # at least one block per shard: pad the power-of-two bucket up
        # (padding blocks carry zero bitmaps / NONE verdicts either way)
        if self.nblocks < self.shards:
            self.nblocks = self.shards
            self._padded = self.nblocks * block
        # shards the appended dirty tail landed on (cumulative, the
        # shard-local delta re-upload metric)
        self.delta_upload_shards = 0

    # -- placement: block rows [s*B, (s+1)*B) on shard s ------------------------
    def _spans(self) -> List[Tuple[int, int, torch.device]]:
        b = self.nblocks // self.shards
        return [(s * b, (s + 1) * b, dev)
                for s, dev in enumerate(self.devices)]

    def _parts(self, x) -> Sequence:
        if type(x) is not _ShardSet:
            raise TypeError(f"{type(x).__name__} is not a set, column or "
                            "zone row of a sharded backend")
        return x

    def _join(self, parts: Sequence):
        return _ShardSet(parts)

    def _repartition(self, old: Sequence[torch.Tensor], keep: int,
                     tail: Optional[np.ndarray] = None):
        """Parts under the current partition of a block-leading tensor
        whose ``old`` parts (equal block counts, in block order) hold its
        rows below ``keep``: those rows move device to device, the host
        ``tail`` (rows from ``keep`` on) uploads to the shards that own
        them, and the rest are zeros."""
        ob = old[0].shape[0]
        n_tail = 0 if tail is None else len(tail)
        parts = []
        for lo, hi, dev in self._spans():
            pieces = []
            for i, t in enumerate(old):
                a, b = max(lo, i * ob), min(hi, (i + 1) * ob, keep)
                if a < b:
                    pieces.append(t[a - i * ob: b - i * ob].to(dev))
            a, b = max(lo, keep), min(hi, keep + n_tail)
            if a < b:
                pieces.append(self._place(tail[a - keep: b - keep], dev))
            rows = sum(p.shape[0] for p in pieces)
            if rows < hi - lo:
                pieces.append(torch.zeros((hi - lo - rows,) + old[0].shape[1:],
                                          dtype=old[0].dtype, device=dev))
            parts.append(torch.cat(pieces) if len(pieces) > 1 else pieces[0])
        return self._join(parts)

    def _regrow(self, s):
        parts = self._parts(s)
        if parts[0].bits.shape[0] * self.shards == self.nblocks:
            return s
        keep = parts[0].bits.shape[0] * len(parts)
        bits = self._repartition([p.bits for p in parts], keep)
        pops = self._repartition([p.pops for p in parts], keep)
        return self._join([_DevSet(b, p) for b, p in zip(bits, pops)])

    # -- shard-local delta re-upload -------------------------------------------
    def refresh(self) -> int:
        """Grow after a pure append, shard-locally: only the real dirty
        tail blocks upload, each to the shard that owns it, and the other
        shards' columns are untouched.  Inside the block bucket the columns
        and the full set update in place (the programs read them by
        address and stay); when the bucket grows the partition changes,
        the surviving prefix moves device to device and the programs are
        dropped.  ``uploaded_bytes`` and the return value count what the
        reference's unsharded backend uploads, every block from the dirty
        one to the end of the (new) bucket; ``transferred_bytes`` counts
        the real dirty tail that moved."""
        _faults.trip("device.upload", backend=self)
        self._flush()
        if self._zones:
            self._zones.clear()
        n_new = self.table.n_records
        if n_new == self.n:
            return 0
        dirty = self.n // self.block
        self.n = n_new
        real = self.table.n_blocks(self.block)
        nblocks = max(next_pow2(real), self.shards)
        grew = nblocks != self.nblocks
        self.nblocks, self._padded = nblocks, nblocks * self.block
        # under the (new) partition the tail [dirty, real) intersects
        # exactly these shards' block ranges
        bps = nblocks // self.shards
        self.delta_upload_shards += (real - 1) // bps - dirty // bps + 1
        if grew:
            self._full = self._empty = None
            self._programs.clear()
        elif self._full is not None:
            padded = np.zeros((nblocks, self.wpb), dtype=np.uint32)
            padded.reshape(-1)[: n_words(n_new)] = bitmap_full(n_new)
            pops = row_popcounts(padded)
            self._write_rows([p.bits for p in self._full],
                             padded.view(np.int32), dirty, real)
            self._write_rows([p.pops for p in self._full], pops, dirty, real)
        up = moved = 0
        for name, col in list(self._cols.items()):
            if col is False:
                continue               # non-numeric: still host-resident
            tail = dirty_tail(self.table.column_data(name), dirty, real,
                              self.block).reshape(real - dirty, self.block)
            up += (nblocks - dirty) * self.block * 4
            moved += tail.nbytes
            if grew:
                self._cols[name] = self._repartition(col, dirty, tail)
            else:
                self._write_rows(col, tail, dirty, real, offset=dirty)
        self.uploaded_bytes += up
        self.transferred_bytes += moved
        return up

    def _write_rows(self, parts: Sequence[torch.Tensor], rows: np.ndarray,
                    lo: int, hi: int, offset: int = 0) -> None:
        """Upload global block rows ``[lo, hi)`` (``rows[r - offset]`` is
        row ``r``) into the shards that own them, in place."""
        for (slo, shi, dev), t in zip(self._spans(), parts):
            a, b = max(lo, slo), min(hi, shi)
            if a < b:
                t[a - slo: b - slo] = self._place(
                    rows[a - offset: b - offset], dev)
