"""Background drain scheduling for :class:`~repro_torch.columnar.stream.StreamSession`.

The cooperative stream layer drains only when a caller forces it:
``submit`` at ``max_pending``, or ``result()`` on a pending future.  That
is fine for batch jobs but wrong for serving — a lone query admitted into
an idle session waits forever unless its own caller blocks on it.  This
module adds the missing half: a daemon thread that watches the pending
lanes and drains them on *deadlines*, so admit-to-result latency is
bounded by policy instead of by traffic.

Two lanes with distinct wait targets implement priority:

* ``interactive`` — short deadline (:attr:`DrainPolicy.interactive_wait_ms`).
  When only interactive work is due, the drainer drains that lane *alone*,
  leaving bulk queries to keep accumulating toward a fatter (cheaper
  per-query) batch.
* ``bulk`` — long deadline (:attr:`DrainPolicy.max_wait_ms`).  When bulk
  comes due, any waiting interactive queries ride along in the same batch
  (joining a drain is never slower than waiting for the next one).

Either lane's deadline, or total pending reaching ``max_pending``, wakes
the thread; ``submit`` notifies the shared condition so a fresh
interactive query re-arms the timer immediately instead of waiting out a
stale bulk deadline.

:class:`LatencyWindow` is the bounded reservoir behind the stream's
admit-to-result p50/p99 — O(capacity) memory regardless of uptime.
"""
from __future__ import annotations

import math
import threading
import time
from dataclasses import dataclass
from typing import List, Optional, Tuple

#: admission lanes, in drain order (interactive work resolves first
#: within a combined batch)
LANES: Tuple[str, str] = ("interactive", "bulk")


@dataclass(frozen=True)
class DrainPolicy:
    """Deadline policy for the background drainer (milliseconds).

    ``max_wait_ms`` bounds how long *any* admitted query can sit pending;
    ``interactive_wait_ms`` is the tighter bound for the interactive lane.
    A lane drains when its oldest pending query exceeds its wait target,
    or immediately when total pending reaches the session's
    ``max_pending``.

    ``starvation_factor`` is the bulk-lane fairness valve.  Interactive
    preemption is *strict*: an interactive-due drain excludes the
    still-accumulating bulk batch even when bulk is past its own
    deadline, so under sustained interactive overload back-to-back
    preemptions can keep pushing the bulk drain out indefinitely.  The
    valve is the hard ceiling: once bulk's oldest admit has aged past
    ``starvation_factor × max_wait_ms``, the next interactive drain
    force-drains bulk in the same batch (``bulk_force_drains`` counts
    the valve firing; the session publishes ``bulk_starved_s``, the
    oldest pending bulk admit's age at each drain, as the SLO gauge).
    """

    max_wait_ms: float = 50.0
    interactive_wait_ms: float = 5.0
    starvation_factor: float = 4.0

    def wait_s(self, lane: str) -> float:
        ms = self.interactive_wait_ms if lane == "interactive" \
            else self.max_wait_ms
        return ms / 1000.0

    def starvation_s(self) -> float:
        """Bulk age past which an interactive-only drain is forbidden."""
        return self.starvation_factor * self.max_wait_ms / 1000.0


class LatencyWindow:
    """Bounded ring of recent latency samples with percentile readout.

    Keeps the last ``capacity`` samples (enough for a stable p99 at
    serving batch sizes) in O(capacity) memory; ``percentile`` sorts a
    snapshot on demand — readout is a stats/bench path, not a hot path.
    Mutation is expected to happen under the owning session's admission
    lock; readout copies before sorting so a concurrent reader never sees
    a half-updated slot matter.
    """

    def __init__(self, capacity: int = 4096):
        if capacity < 1:
            raise ValueError("capacity must be >= 1")
        self.capacity = capacity
        self._buf: List[float] = []
        self._idx = 0
        self.count = 0          # lifetime samples, not just retained ones

    def add(self, value: float) -> None:
        if len(self._buf) < self.capacity:
            self._buf.append(value)
        else:
            self._buf[self._idx] = value
            self._idx = (self._idx + 1) % self.capacity
        self.count += 1

    def percentile(self, p: float) -> float:
        """The p-th percentile (0..100) of retained samples; 0.0 if empty
        (nearest-rank — p99 of 10 samples is their max, not an
        extrapolation)."""
        snap = sorted(self._buf)
        if not snap:
            return 0.0
        rank = min(len(snap) - 1,
                   max(0, math.ceil(p / 100.0 * len(snap)) - 1))
        return snap[rank]

    @property
    def p50(self) -> float:
        return self.percentile(50.0)

    @property
    def p99(self) -> float:
        return self.percentile(99.0)


class BackgroundDrainer:
    """Daemon thread that drains a stream session on deadline.

    Owns no state of its own beyond the stop flag: pending lanes, admit
    times, and the condition variable all live on the session — the
    thread just computes "what is due and when" under the session's
    admission lock and calls back into ``session._drain_lanes`` with the
    lock *released* (drains execute queries; holding the admission lock
    across one would stall every ``submit``).
    """

    def __init__(self, session, policy: DrainPolicy):
        self._session = session
        self.policy = policy
        self._stop = False
        self._thread = threading.Thread(
            target=self._loop, name="stream-drainer", daemon=True)
        self.wakeups = 0
        self.deadline_drains = 0
        self.bulk_force_drains = 0

    def start(self) -> None:
        self._thread.start()

    def stop(self) -> None:
        """Idempotent; returns after the thread has exited."""
        cond = self._session._admit
        with cond:
            self._stop = True
            cond.notify_all()
        if self._thread.is_alive():
            self._thread.join()

    @property
    def running(self) -> bool:
        return self._thread.is_alive()

    # -- scheduling ------------------------------------------------------------
    def _deadline_locked(self, now: float) -> Optional[float]:
        """Earliest time any lane must drain (None = nothing pending).
        Caller holds the session's admission lock."""
        s = self._session
        total = sum(len(s._lanes[lane]) for lane in LANES)
        if total >= s.max_pending:
            return now
        deadline = None
        for lane in LANES:
            pend = s._lanes[lane]
            if not pend:
                continue
            due = pend[0].t_admit + self.policy.wait_s(lane)
            if deadline is None or due < deadline:
                deadline = due
        return deadline

    def _due_lanes_locked(self, now: float) -> Tuple[str, ...]:
        """Which lanes to drain right now.  Interactive-due preempts
        strictly — it drains without flushing the still-accumulating
        bulk batch even when bulk is past its own deadline — *unless*
        the oldest bulk admit has aged past the policy's starvation
        ceiling, in which case the fairness valve force-drains bulk in
        the same batch.  Bulk-due with interactive idle (or max_pending)
        drains everything."""
        s = self._session
        total = sum(len(s._lanes[lane]) for lane in LANES)
        if total >= s.max_pending:
            return LANES
        bulk = s._lanes["bulk"]
        inter = s._lanes["interactive"]
        if inter and now - inter[0].t_admit >= \
                self.policy.wait_s("interactive"):
            if bulk and now - bulk[0].t_admit >= self.policy.starvation_s():
                self.bulk_force_drains += 1
                return LANES
            return ("interactive",)
        if bulk and now - bulk[0].t_admit >= self.policy.wait_s("bulk"):
            return LANES
        return ()

    def _loop(self) -> None:
        cond = self._session._admit
        while True:
            with cond:
                if self._stop:
                    return
                now = time.perf_counter()
                deadline = self._deadline_locked(now)
                if deadline is None:
                    cond.wait()         # submit()/stop() notify
                    continue
                if deadline > now:
                    cond.wait(deadline - now)
                    continue
                lanes = self._due_lanes_locked(now)
                self.wakeups += 1
            if lanes:
                self.deadline_drains += 1
                tr = getattr(self._session, "tracer", None)
                if tr is not None:
                    # deadline drains run on this daemon thread; the span
                    # parents the session's stream.drain/batch.* spans
                    with tr.span("drainer.deadline_drain",
                                 lanes=",".join(lanes)):
                        self._session._drain_lanes(lanes)
                else:
                    self._session._drain_lanes(lanes)
