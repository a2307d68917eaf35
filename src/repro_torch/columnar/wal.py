"""Durable ingest: checksummed write-ahead log + crash-consistent snapshots.

Everything above this module keeps *derived* state durable — plans, tapes
and the FeedbackStore persist through :mod:`~repro_torch.columnar.persist` — but
the table data itself died with the process: a crash silently rewound
every acknowledged append/delete/compact.  This module makes the data
plane crash-safe with the classic pairing:

**Write-ahead log** (:class:`WriteAheadLog`) — an append-only, segmented
record log.  Every :class:`~repro_torch.columnar.table.Table` mutation
(``append`` / ``delete`` / ``compact`` / ``col`` a.k.a. ``set_column``)
rides the table's existing ``_log_mutation`` choke point into a WAL
record carrying the *full* mutation payload (the cast append tails, the
newly tombstoned row indices, the rewritten column).  Records are framed
``crc32 | length | seq`` + pickled body; the CRC covers the sequence
number and body, so replay stops — and physically truncates — at the
first torn record (a partial final write never poisons recovery, it only
drops the unacknowledged suffix).  Durability is *explicit*: ``log()``
buffers, :meth:`WriteAheadLog.commit` flushes + ``fsync``\\ s and advances
``committed_seq`` — the group-commit boundary the serving layer batches
per drain (``wal_sync="group"``) instead of paying an fsync per append.

**Snapshots** (:meth:`Durability.snapshot`) — a pickled full-table state
written with the atomic-directory discipline hardened for
crash-consistency: tmp dir, per-file ``fsync``, directory ``fsync``,
``os.rename``, parent ``fsync``.  The manifest CRCs the state blob, so a
corrupt snapshot is *skipped* at recovery (the previous one + a longer
WAL replay serves instead — ``keep_snapshots`` retains a fallback).
Snapshot state is everything the block-epoch contract needs to survive a
crash: columns, ``version``, the bounded mutation log, tombstone mask +
epoch, *built* dictionary columns (values/codes/counts/``sorted_n`` — the
exact streaming-merge state, so recovered code spaces match pre-crash
bit-for-bit), and the zone-map / quantile-sketch prefixes with the
versions they were stamped at (re-keyed to the recovered arrays, so the
first post-recovery query *extends* them through ``delta_since`` instead
of rebuilding).

**Recovery** (:meth:`Durability.recover`) — load the newest valid
snapshot, replay WAL records past its covered sequence through the normal
``Table`` mutation methods (the WAL sink is attached only *after* replay,
so replay never re-logs).  Replay rebuilds ``version`` and the mutation
log deterministically — one version bump per mutation — which is what
keeps every persisted cache honest across the crash.

**Data epoch** — the directory carries a UUID (``META.json``) naming the
data lineage.  :mod:`~repro_torch.columnar.persist` stamps cache files with it
and refuses to warm-start a session from caches derived against a
*different* lineage (cold-starting cleanly); recovered caches from the
same lineage still hit, because plan/feedback keys are content-derived
and the recovered table is bit-identical to the state they were learned
on.

**Formats and reading** — the record framing, ``META.json``, the
``snap-<seq>`` directories, the segment names and the snapshot state are
the reference package's, byte for byte: the state holds only numpy arrays
and builtins, so a durability directory written by either package
recovers in the other.  Every pickle this package reads (WAL records,
snapshots, the warm-restart caches of :mod:`~repro_torch.columnar.persist`)
goes through :func:`restricted_loads`, which refuses any module outside
``repro_torch``, numpy and the pickle protocol's own helpers.  A refused
WAL record is a torn record (recovery truncates the log at it), a refused
snapshot is skipped like a corrupt one.  Any other failure to decode a
record propagates and leaves the disk as it was.
"""
from __future__ import annotations

import io
import json
import os
import pickle
import shutil
import signal
import struct
import time
import uuid as _uuid
import zlib
from typing import Dict, Iterator, List, Optional, Tuple

import numpy as np

from .ingest import QuantileSketch, ZoneMap
from .table import DictColumn, Table

#: segment preamble — a partially written preamble invalidates the whole
#: (necessarily record-free) segment
MAGIC = b"RWAL1\n"

#: record header: crc32(seq_le64 + body), body length, sequence number
_HDR = struct.Struct("<IIQ")
_SEQ = struct.Struct("<Q")

#: bump when the record body / snapshot state layout changes
WAL_FORMAT = 1
SNAP_FORMAT = 1

META_FILE = "META.json"
WAL_DIR = "wal"
SNAP_DIR = "snapshots"

_PROTO = pickle.HIGHEST_PROTOCOL


#: modules a pickle read by this package may name: its own classes, numpy's,
#: and the helpers of the pickle protocol itself.  A file that names any
#: other module (the reference package's classes, and through them its
#: framework) is refused like a corrupt one.
_PICKLE_MODULES = frozenset(("builtins", "collections", "copyreg", "numpy",
                             "repro_torch"))
_PICKLE_PACKAGES = ("repro_torch.", "numpy.")
#: builtins that would reach a module outside the allow-list
_PICKLE_DENIED = frozenset(("__import__", "eval", "exec", "compile",
                            "getattr", "open"))


class RefusedPickle(pickle.UnpicklingError):
    """A pickle names a module outside the allow-list.  ``seq`` is set
    when the pickle is a WAL record's body."""

    seq: Optional[int] = None


class _PortUnpickler(pickle.Unpickler):
    def find_class(self, module, name):
        if ((module in _PICKLE_MODULES or module.startswith(_PICKLE_PACKAGES))
                and not (module == "builtins" and name in _PICKLE_DENIED)):
            return super().find_class(module, name)
        raise RefusedPickle(
            f"refusing {module}.{name}: not a class of repro_torch, numpy "
            f"or the pickle protocol")


def restricted_loads(data: bytes):
    """``pickle.loads`` limited to the allow-listed modules; raises
    :class:`RefusedPickle` on a pickle that names any other.  The one way
    this package unpickles anything."""
    return _PortUnpickler(io.BytesIO(data)).load()


class DurabilityError(RuntimeError):
    """Raised on durable-directory misuse (attach over existing state,
    recover from an empty directory) — never during replay of torn/corrupt
    tails, which degrade by design."""


def _fsync_file(f) -> None:
    f.flush()
    os.fsync(f.fileno())


def _fsync_path(path: str) -> None:
    """fsync a path (works for directories — the POSIX way to make a
    rename / new directory entry durable)."""
    fd = os.open(path, os.O_RDONLY)
    try:
        os.fsync(fd)
    finally:
        os.close(fd)


# ---------------------------------------------------------------------------
# the log
# ---------------------------------------------------------------------------

class WriteAheadLog:
    """Segmented, checksummed, append-only record log.

    Segments are ``wal-<first_seq>.log`` files: a :data:`MAGIC` preamble
    followed by framed records.  Opening scans every segment in order,
    validating frame CRCs and sequence continuity; the first torn/corrupt
    record *truncates its file at that offset* and drops any later
    segments (they can only hold unacknowledged writes — rotation fsyncs
    before a new segment opens).  ``truncated_records`` /
    ``truncated_bytes`` report what the scan dropped.

    ``sync`` policy: ``"group"`` buffers records until :meth:`commit`
    (the serving layer calls it once per drain), ``"always"`` commits
    every record.  ``group_max_records`` bounds how far the uncommitted
    suffix may grow under ``"group"`` before an automatic commit.
    """

    def __init__(self, directory: str, *, sync: str = "group",
                 group_max_records: Optional[int] = 4096):
        if sync not in ("group", "always"):
            raise ValueError("sync must be 'group' or 'always'")
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.sync = sync
        self.group_max_records = group_max_records
        # lifetime counters (telemetry surface)
        self.records_logged = 0
        self.commits = 0
        self.commit_s = 0.0
        self.bytes_written = 0
        self.truncated_records = 0
        self.truncated_bytes = 0
        self.segments_gced = 0
        # chaos-harness failpoint: write only this many bytes of the next
        # record, fsync, then SIGKILL the process (exercises the
        # torn-record truncation path deterministically)
        self._test_torn_bytes: Optional[int] = None
        self._tail = None
        self._tail_path: Optional[str] = None
        self.last_seq = self._scan_and_repair()
        # everything that survived the scan is on disk by definition
        self.committed_seq = self.last_seq

    # -- segment bookkeeping ---------------------------------------------------
    def _segments(self) -> List[Tuple[int, str]]:
        """``(first_seq, path)`` of every segment file, in seq order."""
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("wal-") and name.endswith(".log"):
                try:
                    first = int(name[4:-4])
                except ValueError:
                    continue
                out.append((first, os.path.join(self.directory, name)))
        out.sort()
        return out

    def _create_segment(self, first_seq: int) -> None:
        path = os.path.join(self.directory, f"wal-{first_seq:020d}.log")
        self._tail = open(path, "ab")
        self._tail_path = path
        if self._tail.tell() == 0:
            self._tail.write(MAGIC)
            _fsync_file(self._tail)
            _fsync_path(self.directory)

    def _scan_and_repair(self) -> int:
        """Validate every segment; truncate at the first torn record and
        drop later segments.  Returns the last valid sequence number and
        leaves the newest surviving segment open for append."""
        segs = self._segments()
        last_seq = 0
        for i, (first, path) in enumerate(segs):
            good_off, seqs = self._scan_segment(path, expect=first)
            size = os.path.getsize(path)
            if good_off < 0:
                # preamble never made it to disk: the segment holds no
                # committed record — drop it and everything after
                self.truncated_bytes += size
                os.unlink(path)
                for _, later in segs[i + 1:]:
                    self.truncated_bytes += os.path.getsize(later)
                    os.unlink(later)
                _fsync_path(self.directory)
                break
            # an intact but record-free segment still pins the sequence
            # floor through its name (rotation names it last_seq + 1) —
            # without this, post-rotation recoveries would mint sequence
            # numbers a snapshot already covers
            last_seq = max(last_seq, first - 1,
                           seqs[-1] if seqs else 0)
            if good_off < size:
                # torn record: keep the valid prefix, drop the tail and
                # any later segments (only unacknowledged writes can
                # follow a torn frame)
                self._cut(segs, i, good_off)
                return last_seq
            if i == len(segs) - 1:
                self._tail = open(path, "ab")
                self._tail_path = path
        return last_seq

    def _cut(self, segs: List[Tuple[int, str]], i: int, off: int) -> None:
        """Truncate segment ``segs[i]`` at ``off``, drop every later
        segment and leave the truncated one open for append."""
        path = segs[i][1]
        self.truncated_records += 1
        self.truncated_bytes += os.path.getsize(path) - off
        with open(path, "r+b") as f:
            f.truncate(off)
            _fsync_file(f)
        for _, later in segs[i + 1:]:
            self.truncated_bytes += os.path.getsize(later)
            os.unlink(later)
        _fsync_path(self.directory)
        self._tail = open(path, "ab")
        self._tail_path = path

    def truncate_from(self, seq: int) -> None:
        """Drop record ``seq`` and every later one, as the open-time scan
        drops a torn record: recovery's answer to a record whose body
        :func:`restricted_loads` refuses."""
        if self._tail is not None:
            self._tail.close()
            self._tail = None
        segs = self._segments()
        i = max(j for j, (first, _) in enumerate(segs) if first <= seq)
        off, _ = self._scan_segment(segs[i][1], expect=segs[i][0], stop=seq)
        self._cut(segs, i, off)
        self.last_seq = self.committed_seq = seq - 1

    @staticmethod
    def _scan_segment(path: str, expect: int, stop: Optional[int] = None
                      ) -> Tuple[int, List[int]]:
        """``(first_bad_offset, valid_seqs)`` for one segment file;
        ``first_bad_offset == size`` means fully valid, ``-1`` means the
        preamble itself is missing/torn.  With ``stop``, the frame of
        sequence ``stop`` counts as the first bad one."""
        seqs: List[int] = []
        with open(path, "rb") as f:
            if f.read(len(MAGIC)) != MAGIC:
                return -1, seqs
            off = len(MAGIC)
            while True:
                hdr = f.read(_HDR.size)
                if not hdr:
                    return off, seqs
                if len(hdr) < _HDR.size:
                    return off, seqs
                crc, length, seq = _HDR.unpack(hdr)
                if seq == stop:
                    return off, seqs
                body = f.read(length)
                if (len(body) < length or seq != expect
                        or zlib.crc32(_SEQ.pack(seq) + body) != crc):
                    return off, seqs
                seqs.append(seq)
                expect = seq + 1
                off += _HDR.size + length

    # -- the write path --------------------------------------------------------
    def log(self, kind: str, payload: dict) -> int:
        """Frame + buffer one record; returns its sequence number.
        Durability happens at :meth:`commit` (or immediately under
        ``sync="always"``)."""
        if self._tail is None:
            self._create_segment(self.last_seq + 1)
        seq = self.last_seq + 1
        body = pickle.dumps((kind, payload), protocol=_PROTO)
        rec = _HDR.pack(zlib.crc32(_SEQ.pack(seq) + body), len(body),
                        seq) + body
        if self._test_torn_bytes is not None:               # chaos failpoint
            self._tail.write(rec[: self._test_torn_bytes])
            _fsync_file(self._tail)
            os.kill(os.getpid(), signal.SIGKILL)
        self._tail.write(rec)
        self.last_seq = seq
        self.records_logged += 1
        self.bytes_written += len(rec)
        if self.sync == "always" or (
                self.group_max_records is not None
                and seq - self.committed_seq >= self.group_max_records):
            self.commit()
        return seq

    def commit(self) -> Optional[float]:
        """Flush + fsync the buffered suffix; returns the fsync wall time
        in milliseconds, or None when nothing was uncommitted (a no-op —
        per-drain group commits on an idle stream cost nothing)."""
        if self._tail is None or self.committed_seq == self.last_seq:
            return None
        t0 = time.perf_counter()
        _fsync_file(self._tail)
        dt = time.perf_counter() - t0
        self.commits += 1
        self.commit_s += dt
        self.committed_seq = self.last_seq
        return dt * 1000.0

    @property
    def uncommitted(self) -> int:
        return self.last_seq - self.committed_seq

    # -- the read path ---------------------------------------------------------
    def replay(self, after_seq: int = 0
               ) -> Iterator[Tuple[int, str, dict]]:
        """Yield ``(seq, kind, payload)`` for every valid record with
        ``seq > after_seq`` — the open-time scan already truncated torn
        tails, so this walk is over clean frames only.  A body that names
        a module outside the allow-list raises :class:`RefusedPickle` with
        its ``seq``."""
        for first, path in self._segments():
            with open(path, "rb") as f:
                if f.read(len(MAGIC)) != MAGIC:
                    return
                while True:
                    hdr = f.read(_HDR.size)
                    if len(hdr) < _HDR.size:
                        break
                    crc, length, seq = _HDR.unpack(hdr)
                    body = f.read(length)
                    if (len(body) < length
                            or zlib.crc32(_SEQ.pack(seq) + body) != crc):
                        return
                    if seq > after_seq:
                        try:
                            rec = restricted_loads(body)
                        except RefusedPickle as e:
                            e.seq = seq
                            raise
                        yield (seq,) + rec

    # -- rotation --------------------------------------------------------------
    def rotate(self, covered_seq: int) -> None:
        """Start a fresh segment and drop segments every record of which
        is ``<= covered_seq`` (i.e. captured by a durable snapshot)."""
        if self._tail is not None:
            self.commit()
            self._tail.close()
        self._create_segment(self.last_seq + 1)
        segs = self._segments()
        for i, (first, path) in enumerate(segs[:-1]):
            if segs[i + 1][0] - 1 <= covered_seq \
                    and path != self._tail_path:
                os.unlink(path)
                self.segments_gced += 1
        _fsync_path(self.directory)

    def close(self) -> None:
        if self._tail is not None:
            self.commit()
            self._tail.close()
            self._tail = None


# ---------------------------------------------------------------------------
# table state <-> snapshot payload
# ---------------------------------------------------------------------------

def _table_state(table: Table) -> dict:
    """Picklable full state of ``table`` — everything the block-epoch
    contract needs on the far side of a crash (see module docstring)."""
    dicts = {}
    for name, (col, dc) in table._dicts.items():
        if col is not table.columns.get(name):
            continue                    # stale rebind: rebuilt lazily anyway
        dicts[name] = {"values": dc.values, "codes": dc.codes,
                       "counts": dc.counts, "sorted_n": dc.sorted_n}
    zones = []
    for (name, block), (ver, _cid, zm) in table._zones.items():
        zones.append({"name": name, "block": block, "version": ver,
                      "mins": zm.mins, "maxs": zm.maxs, "nulls": zm.nulls,
                      "n_rows": zm.n_rows})
    sketches = []
    for name, (ver, _cid, sk) in table._qsketch.items():
        sketches.append({"name": name, "version": ver, "chunk": sk.chunk,
                         "grids": sk.grids, "counts": sk.counts,
                         "n_rows": sk.n_rows, "anchors": sk.anchors})
    return {"columns": dict(table.columns),
            "n_records": table.n_records,
            "version": table.version,
            "mutlog": list(table._mutlog),
            "mutlog_base": table._mutlog_base,
            "tombstones": table._tombstones,
            "tombstone_epoch": table.tombstone_epoch,
            "dicts": dicts, "zones": zones, "sketches": sketches}


def _table_from_state(st: dict) -> Table:
    """Rebuild a :class:`Table` from :func:`_table_state` output,
    re-keying zone-map / sketch stamps onto the recovered arrays so the
    first post-recovery query extends them via ``delta_since`` exactly as
    a live process would."""
    table = Table(dict(st["columns"]))
    table.version = st["version"]
    table._mutlog = list(st["mutlog"])
    table._mutlog_base = st["mutlog_base"]
    table._tombstones = st["tombstones"]
    table._live_words = None
    table.tombstone_epoch = st["tombstone_epoch"]
    for name, d in st["dicts"].items():
        col = table.columns.get(name)
        if col is None:
            continue
        counts = d["counts"]
        dc = DictColumn(values=d["values"], codes=d["codes"],
                        freqs=counts / max(len(d["codes"]), 1),
                        counts=counts, sorted_n=d["sorted_n"])
        table._dicts[name] = (col, dc)
    for z in st["zones"]:
        try:
            col = table.column_data(z["name"])
        except KeyError:
            continue
        zm = ZoneMap(block=z["block"], mins=z["mins"], maxs=z["maxs"],
                     nulls=z["nulls"], n_rows=z["n_rows"])
        table._zones[(z["name"], z["block"])] = (z["version"], id(col), zm)
    for s in st["sketches"]:
        try:
            col = table.column_data(s["name"])
        except KeyError:
            continue
        sk = QuantileSketch(chunk=s["chunk"], grids=s["grids"],
                            counts=s["counts"], n_rows=s["n_rows"],
                            anchors=s["anchors"])
        table._qsketch[s["name"]] = (s["version"], id(col), sk)
    return table


def _apply_record(table: Table, kind: str, payload: dict) -> None:
    """Re-run one logged mutation through the normal table methods —
    replay rebuilds ``version`` and the mutation log deterministically
    (one bump per record, exactly like the live path)."""
    if kind == "append":
        table.append(payload["rows"])
    elif kind == "delete":
        table.delete(payload["rows"])
    elif kind == "compact":
        table.compact()
    elif kind == "col":
        table.set_column(payload["name"], payload["values"])
    else:
        raise DurabilityError(f"unknown WAL record kind {kind!r}")


# ---------------------------------------------------------------------------
# the durability manager
# ---------------------------------------------------------------------------

class Durability:
    """WAL + snapshots + recovery for one table, rooted at ``directory``.

    Lifecycle: a *fresh* directory gets :meth:`attach`\\ ed a table (the
    initial state lands as a ``create`` record, committed immediately —
    attach over a directory that already holds records raises, preventing
    split-brain); a directory with prior state gets
    :meth:`Durability.recover`\\ ed.  After either, every table mutation
    flows through the WAL sink automatically; the owner calls
    :meth:`commit` at its acknowledgement boundary (the stream layer:
    once per drain) and :meth:`snapshot` / :meth:`maybe_snapshot` to
    bound replay length.
    """

    def __init__(self, directory: str, *, sync: str = "group",
                 snapshot_every: Optional[int] = 512,
                 keep_snapshots: int = 2,
                 group_max_records: Optional[int] = 4096):
        os.makedirs(directory, exist_ok=True)
        self.directory = directory
        self.snapshot_every = snapshot_every
        self.keep_snapshots = max(1, keep_snapshots)
        self.wal = WriteAheadLog(os.path.join(directory, WAL_DIR),
                                 sync=sync,
                                 group_max_records=group_max_records)
        self.epoch = self._load_or_create_meta()
        self.table: Optional[Table] = None
        self.snapshots = 0
        self.snapshot_s = 0.0
        self.records_since_snapshot = 0
        # chaos failpoints: "snapshot_pre_rename" / "snapshot_post_rename"
        self._test_crash_point: Optional[str] = None

    # -- identity --------------------------------------------------------------
    def _load_or_create_meta(self) -> str:
        path = os.path.join(self.directory, META_FILE)
        try:
            with open(path) as f:
                meta = json.load(f)
            if isinstance(meta, dict) and isinstance(meta.get("uuid"), str):
                return meta["uuid"]
        except Exception:
            pass                        # missing/torn META: re-mint below
        epoch = _uuid.uuid4().hex
        tmp = path + ".tmp"
        with open(tmp, "w") as f:
            json.dump({"format": WAL_FORMAT, "uuid": epoch}, f)
            _fsync_file(f)
        os.replace(tmp, path)
        _fsync_path(self.directory)
        return epoch

    @property
    def snap_dir(self) -> str:
        return os.path.join(self.directory, SNAP_DIR)

    def _snapshot_entries(self) -> List[Tuple[int, str]]:
        """``(covered_seq, path)`` of every snapshot dir, newest first."""
        d = self.snap_dir
        if not os.path.isdir(d):
            return []
        out = []
        for name in os.listdir(d):
            if name.startswith("snap-"):
                try:
                    out.append((int(name[5:]), os.path.join(d, name)))
                except ValueError:
                    continue
        out.sort(reverse=True)
        return out

    def has_state(self) -> bool:
        """True when the directory holds anything recoverable."""
        return self.wal.last_seq > 0 or bool(self._snapshot_entries())

    # -- the sink --------------------------------------------------------------
    def attach(self, table: Table) -> None:
        """Adopt a fresh table: log its full state as the ``create``
        record (committed immediately — creation is always acknowledged)
        and install this manager as the table's WAL sink."""
        if self.has_state():
            raise DurabilityError(
                f"{self.directory} already holds durable state; recover "
                f"it (table=None) instead of attaching a new table")
        self.wal.log("create", _table_state(table))
        self.wal.commit()
        self.table = table
        table._wal = self
        self.records_since_snapshot = 0

    def on_mutation(self, kind: str, payload: dict) -> int:
        """The ``Table._log_mutation`` forwarding target."""
        seq = self.wal.log(kind, payload)
        self.records_since_snapshot += 1
        return seq

    def commit(self) -> Optional[float]:
        """Group-commit boundary — see :meth:`WriteAheadLog.commit`."""
        return self.wal.commit()

    # -- snapshots -------------------------------------------------------------
    def snapshot(self) -> str:
        """Write a crash-consistent snapshot covering everything logged
        so far; rotates the WAL and drops fully-covered segments and old
        snapshots (keeping :attr:`keep_snapshots` as corruption
        fallbacks).  Returns the snapshot path."""
        if self.table is None:
            raise DurabilityError("no table attached")
        t0 = time.perf_counter()
        self.wal.commit()               # a snapshot never outruns its log
        seq = self.wal.last_seq
        os.makedirs(self.snap_dir, exist_ok=True)
        final = os.path.join(self.snap_dir, f"snap-{seq:020d}")
        tmp = os.path.join(self.snap_dir, f".tmp-{seq}-{os.getpid()}")
        if os.path.isdir(tmp):
            shutil.rmtree(tmp)
        os.makedirs(tmp)
        blob = pickle.dumps(_table_state(self.table), protocol=_PROTO)
        with open(os.path.join(tmp, "state.pkl"), "wb") as f:
            f.write(blob)
            _fsync_file(f)
        manifest = {"format": SNAP_FORMAT, "seq": seq,
                    "crc": zlib.crc32(blob), "size": len(blob),
                    "n_records": self.table.n_records,
                    "version": self.table.version}
        with open(os.path.join(tmp, "manifest.json"), "w") as f:
            json.dump(manifest, f)
            _fsync_file(f)
        _fsync_path(tmp)
        if self._test_crash_point == "snapshot_pre_rename":    # chaos
            os.kill(os.getpid(), signal.SIGKILL)
        if os.path.isdir(final):
            shutil.rmtree(final)        # re-snapshot at an unmoved seq
        os.rename(tmp, final)
        _fsync_path(self.snap_dir)
        if self._test_crash_point == "snapshot_post_rename":   # chaos
            os.kill(os.getpid(), signal.SIGKILL)
        for cov, path in self._snapshot_entries()[self.keep_snapshots:]:
            shutil.rmtree(path, ignore_errors=True)
        # GC only past the OLDEST retained snapshot: if this one turns
        # out corrupt, recovery falls back to an older snapshot and must
        # still find the WAL records between the two
        retained = self._snapshot_entries()
        floor = retained[-1][0] if retained else seq
        self.wal.rotate(floor)
        self.snapshots += 1
        self.snapshot_s += time.perf_counter() - t0
        self.records_since_snapshot = 0
        return final

    def maybe_snapshot(self) -> Optional[str]:
        """Snapshot when ``snapshot_every`` records accumulated since the
        last one (the serving layer's per-drain call)."""
        if (self.snapshot_every is not None
                and self.records_since_snapshot >= self.snapshot_every):
            return self.snapshot()
        return None

    # -- recovery --------------------------------------------------------------
    @classmethod
    def recover(cls, directory: str, *, sync: str = "group",
                snapshot_every: Optional[int] = 512,
                keep_snapshots: int = 2,
                group_max_records: Optional[int] = 4096
                ) -> Tuple["Durability", Table, dict]:
        """Rebuild the table from ``directory``: newest valid snapshot +
        WAL tail replay.  Returns ``(durability, table, info)`` where
        ``info`` carries the recovery counters the telemetry plane and
        ``/healthz`` surface.  Raises :class:`DurabilityError` when the
        directory holds nothing recoverable."""
        t0 = time.perf_counter()
        d = cls(directory, sync=sync, snapshot_every=snapshot_every,
                keep_snapshots=keep_snapshots,
                group_max_records=group_max_records)
        table: Optional[Table] = None
        covered = 0
        skipped = 0
        for cov, path in d._snapshot_entries():
            st = _load_snapshot(path, cov)
            if st is None:
                skipped += 1
                continue
            table = _table_from_state(st)
            covered = cov
            break
        replayed = 0
        try:
            for seq, kind, payload in d.wal.replay(after_seq=covered):
                if kind == "create":
                    table = _table_from_state(payload)
                else:
                    if table is None:
                        raise DurabilityError(
                            f"{directory}: WAL starts mid-history (seq "
                            f"{seq}) with no valid snapshot")
                    _apply_record(table, kind, payload)
                replayed += 1
        except RefusedPickle as e:
            # a record naming a module outside the allow-list: torn, as
            # the scan treats a bad frame (nothing after it is kept)
            d.wal.truncate_from(e.seq)
        if table is None:
            raise DurabilityError(f"{directory}: no durable state")
        d.table = table
        table._wal = d
        # a torn post-rotation segment can leave the scan floor below the
        # snapshot's coverage — new records must still sequence past it
        d.wal.last_seq = max(d.wal.last_seq, covered)
        d.wal.committed_seq = d.wal.last_seq
        d.records_since_snapshot = max(0, d.wal.last_seq - covered)
        info = {"snapshot_seq": covered,
                "snapshots_skipped": skipped,
                "replayed_records": replayed,
                "truncated_records": d.wal.truncated_records,
                "truncated_bytes": d.wal.truncated_bytes,
                "last_seq": d.wal.last_seq,
                "n_records": table.n_records,
                "version": table.version,
                "epoch": d.epoch,
                "recovery_ms": (time.perf_counter() - t0) * 1000.0}
        return d, table, info

    # -- telemetry -------------------------------------------------------------
    def scalars(self) -> Dict[str, float]:
        """Scalar durability state (``repro_wal_*`` gauge payload)."""
        w = self.wal
        return {"records": w.records_logged, "commits": w.commits,
                "commit_ms_total": w.commit_s * 1000.0,
                "bytes_written": w.bytes_written,
                "uncommitted": w.uncommitted,
                "last_seq": w.last_seq,
                "committed_seq": w.committed_seq,
                "truncated_records": w.truncated_records,
                "segments_gced": w.segments_gced,
                "snapshots": self.snapshots,
                "snapshot_ms_total": self.snapshot_s * 1000.0,
                "records_since_snapshot": self.records_since_snapshot}

    def publish(self, registry, labels=None) -> None:
        from ..runtime.telemetry import publish_scalars
        publish_scalars(registry, "repro_wal", self.scalars(), labels,
                        help="write-ahead-log durability state")

    def close(self) -> None:
        self.wal.close()


def _load_snapshot(path: str, covered: int) -> Optional[dict]:
    """Validated snapshot state, or None on any corruption (format drift,
    CRC mismatch, truncation) — the caller falls back to an older
    snapshot or a full-WAL replay."""
    try:
        with open(os.path.join(path, "manifest.json")) as f:
            manifest = json.load(f)
        if (not isinstance(manifest, dict)
                or manifest.get("format") != SNAP_FORMAT
                or manifest.get("seq") != covered):
            return None
        with open(os.path.join(path, "state.pkl"), "rb") as f:
            blob = f.read()
        if (len(blob) != manifest.get("size")
                or zlib.crc32(blob) != manifest.get("crc")):
            return None
        st = restricted_loads(blob)
        return st if isinstance(st, dict) else None
    except Exception:
        return None
