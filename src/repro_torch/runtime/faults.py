"""Injectable fault plane for the serving path.

The serving-hardening story (background drainer, degradation ladder,
quarantine — ``columnar.stream``) is only as credible as the failures it
is tested against.  This module is the single switchboard: production
code calls :func:`trip` at its failure-prone sites (device dispatch,
tail-block upload, per-query planning) — a no-op unless a test/bench has
*armed* a matching :class:`FaultSpec` — and the recovery policies are
then exercised against real exceptions raised at the real sites instead
of monkeypatched stand-ins.

Sites wired in this repo:

``device.dispatch``  raised from ``DeviceTapeBackend.run_tape`` /
                     ``materialize`` (the bundled sync) — models a device
                     OOM / runtime abort mid-drain.
``device.upload``    raised from ``DeviceTapeBackend.refresh()`` — a
                     failed tail-block upload after an append.
``query.plan``       raised from ``QuerySession.execute`` while planning
                     one query (``ctx: index``) — a poisoned plan that
                     must fail only its own future.

Fault classification drives the stream layer's degradation ladder
(retry -> host fallback -> quarantine):

* :class:`TransientFault` (or a spec armed ``transient=True``) — retry
  with exponential backoff is expected to clear it.
* :class:`DeviceFault`, and the CUDA runtime errors
  :func:`is_device_fault` recognises — the device engine is suspect; the
  batch re-executes bit-identically on the host bitmap engine.
* anything else — no engine will save it; quarantine isolates the
  poisoned query.
"""
from __future__ import annotations

import threading
from contextlib import contextmanager
from dataclasses import dataclass, field
from typing import Callable, Dict, Optional


class DeviceFault(RuntimeError):
    """Injected device-side failure (stands in for a device OOM/abort)."""


class TransientFault(DeviceFault):
    """Injected failure expected to clear on retry."""


@dataclass
class FaultSpec:
    """One armed fault: raise ``exc`` at ``site`` for the next ``times``
    matching trips.  ``match`` optionally narrows to specific trip
    contexts (e.g. ``lambda ctx: ctx.get("index") == 3`` poisons one
    query of a batch); non-matching trips neither raise nor consume a
    shot."""

    site: str
    exc: Callable[[], BaseException] = DeviceFault
    times: int = 1
    match: Optional[Callable[[dict], bool]] = None
    fired: int = 0


@dataclass
class FaultPlaneStats:
    armed: int = 0
    fired: Dict[str, int] = field(default_factory=dict)


class FaultPlane:
    """Registry of armed faults; thread-safe (drains fire concurrently
    with arming test threads)."""

    def __init__(self):
        self._lock = threading.Lock()
        self._specs: list[FaultSpec] = []
        self.stats = FaultPlaneStats()

    def arm(self, site: str, exc: Callable[[], BaseException] = DeviceFault,
            times: int = 1, match: Optional[Callable[[dict], bool]] = None
            ) -> FaultSpec:
        """Arm ``exc`` (an exception *factory*: class or zero-arg callable)
        to fire on the next ``times`` matching trips of ``site``."""
        spec = FaultSpec(site=site, exc=exc, times=times, match=match)
        with self._lock:
            self._specs.append(spec)
            self.stats.armed += 1
        return spec

    def clear(self) -> None:
        with self._lock:
            self._specs.clear()

    @property
    def active(self) -> bool:
        return bool(self._specs)

    def trip(self, site: str, **ctx) -> None:
        """Raise the first armed fault matching ``site``/``ctx`` (and
        consume one of its shots); no-op when nothing matches."""
        if not self._specs:           # fast path: nothing armed
            return
        with self._lock:
            for spec in self._specs:
                if spec.site != site:
                    continue
                if spec.match is not None and not spec.match(ctx):
                    continue
                spec.fired += 1
                if spec.fired >= spec.times:
                    self._specs.remove(spec)
                self.stats.fired[site] = self.stats.fired.get(site, 0) + 1
                try:
                    # observability: armed trips are test/bench events,
                    # so the global registry is the right sink (best
                    # effort — a broken registry must not mask the fault)
                    from .telemetry import registry
                    registry().counter(
                        "repro_faults_fired_total",
                        "armed fault-plane trips by site").inc(1, site=site)
                except Exception:       # pragma: no cover - defensive
                    pass
                raise spec.exc()


#: process-global plane the production hooks consult.  Tests arm specs on
#: it (or use :func:`inject`); ``trip`` is a single attribute load + falsy
#: check when nothing is armed, so the hooks cost nothing in production.
_PLANE = FaultPlane()


def fault_plane() -> FaultPlane:
    return _PLANE


def trip(site: str, **ctx) -> None:
    """Production-site hook: raise if a matching fault is armed."""
    _PLANE.trip(site, **ctx)


@contextmanager
def inject(site: str, exc: Callable[[], BaseException] = DeviceFault,
           times: int = 1, match: Optional[Callable[[dict], bool]] = None):
    """Scoped arming: the spec is withdrawn on exit even if unfired."""
    spec = _PLANE.arm(site, exc=exc, times=times, match=match)
    try:
        yield spec
    finally:
        with _PLANE._lock:
            if spec in _PLANE._specs:
                _PLANE._specs.remove(spec)


def is_transient(exc: BaseException) -> bool:
    """Should the ladder retry this in place (backoff, same engine)?"""
    return isinstance(exc, TransientFault)


def is_device_fault(exc: BaseException) -> bool:
    """Should the ladder re-execute the batch on the host engine?  True
    for an injected :class:`DeviceFault`, for
    ``torch.cuda.OutOfMemoryError``, and for a ``RuntimeError``
    (``torch.AcceleratorError`` is one) whose message carries "CUDA
    error": a refused kernel launch, an illegal address, a lost device."""
    if isinstance(exc, DeviceFault):
        return True
    import torch
    if isinstance(exc, torch.cuda.OutOfMemoryError):
        return True
    accel = getattr(torch, "AcceleratorError", RuntimeError)
    return isinstance(exc, (RuntimeError, accel)) and "CUDA error" in str(exc)
