"""Runtime services: the fault plane the columnar engines call into
(``faults``: armed failure injection at the device dispatch / upload
sites), the process-global metrics registry (``telemetry``), both
stdlib-only copies of the reference package's modules, and the
fault-tolerant training loop (``loop``: ``TrainLoop``,
``StragglerWatchdog``, ``FailureInjector``).  The loop pulls in the model
and checkpoint stack, so it loads lazily on first attribute access and
the columnar hot path does not import it."""
from .faults import (DeviceFault, FaultPlane, TransientFault, fault_plane,
                     inject, is_device_fault, is_transient)
from .telemetry import (Counter, Gauge, Histogram, MetricsRegistry,
                        parse_prometheus, registry)

__all__ = ["TrainLoop", "StragglerWatchdog", "FailureInjector",
           "FaultPlane", "DeviceFault", "TransientFault", "fault_plane",
           "inject", "is_device_fault", "is_transient",
           "MetricsRegistry", "Counter", "Gauge", "Histogram",
           "registry", "parse_prometheus"]

_LOOP_EXPORTS = ("TrainLoop", "StragglerWatchdog", "FailureInjector")


def __getattr__(name):
    if name in _LOOP_EXPORTS:
        from . import loop
        return getattr(loop, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
