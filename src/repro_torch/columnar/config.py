"""ExecConfig: the single construction path for every execution surface.

Three entry points (``run_query``, :class:`QuerySession`,
:class:`StreamSession`) historically accreted ~30 overlapping kwargs with
blind ``**session_kwargs`` passthrough, three copies of backend matching,
and two different error types for the same bad planner name.  This module
collapses all of it into one frozen dataclass:

* :class:`ExecConfig` — every knob an execution surface accepts, validated
  once in ``__post_init__``.  Invalid combinations (unknown planner name,
  ``shards > 1`` on a host engine, non-word-aligned block) raise
  :class:`ConfigError` at construction time, before any table is touched.
* :func:`config_from_kwargs` — the deprecation shim.  Entry points keep
  their legacy kwargs as ``_UNSET``-sentinel parameters; any explicitly
  passed legacy kwarg warns **once per kwarg name per process** and is
  folded into an :class:`ExecConfig`.  Mixing ``config=`` with legacy
  kwargs is an error (there is no sane precedence).

:class:`ConfigError` subclasses :class:`ValueError`, so callers that
matched the old ``QuerySession`` ``ValueError`` keep working; the old
``run_query`` ``KeyError`` path (unknown planner) is gone — both surfaces
now raise the same type from the same check.
"""
from __future__ import annotations

import dataclasses
import warnings
from dataclasses import dataclass
from typing import Any, Optional, Union

#: Planner names every surface accepts.  ``auto`` picks shallowfish /
#: deepfish per tree depth (sessions always supported it; ``run_query``
#: gains it with this module).
PLANNER_NAMES = ("auto", "shallowfish", "deepfish", "optimal", "nooropt")

#: Engine names every surface accepts.
ENGINE_NAMES = ("numpy", "jax", "pallas", "tape", "tape-pallas")


class ConfigError(ValueError):
    """Invalid :class:`ExecConfig` field or combination (one error type for
    every entry point — replaces the old KeyError/ValueError split)."""


class _Unset:
    """Sentinel for 'legacy kwarg not passed' (distinct from None)."""

    _instance: Optional["_Unset"] = None

    def __new__(cls):
        if cls._instance is None:
            cls._instance = super().__new__(cls)
        return cls._instance

    def __repr__(self) -> str:  # pragma: no cover - cosmetic
        return "<unset>"


UNSET: Any = _Unset()


def _is_pow2(n: int) -> bool:
    return n >= 1 and (n & (n - 1)) == 0


@dataclass(frozen=True)
class ExecConfig:
    """Every execution knob, in one frozen, validated object.

    Field groups (see ``docs/architecture.md`` §7 for the full surface):

    planning
        ``planner`` / ``model`` / ``annotate`` / ``rewrite_strings`` /
        ``plan_cache`` / ``persist_atom_cache``
    engine
        ``engine`` / ``block`` / ``zone_prune`` / ``batched``
    sharing
        ``share_threshold`` / ``share_margin``
    feedback
        ``feedback`` / ``feedback_absorb``
    sharding
        ``shards`` / ``mesh`` — ``shards > 1`` (or a ``mesh``, a
        :class:`~repro_torch.launch.mesh.ShardMesh`) runs the compiled
        tape block-sharded over a 1-D mesh of devices
        (:class:`~repro_torch.columnar.shard.ShardedTapeBackend`); only
        ``engine="tape"`` shards, as in the reference.  ``device`` says
        which devices: ``"cpu"`` host shards, or the first ``shards``
        CUDA devices; a mesh whose devices disagree with it is a
        :class:`ConfigError`.
    placement
        ``device`` — where the device engines' tensors live (the tape
        engines ``"tape"`` / ``"tape-pallas"`` and the per-step block
        engines ``"jax"`` / ``"pallas"``; each pair is two names for one
        path in the port): ``"cuda"`` (the default: the hand-written CUDA
        kernels) or ``"cpu"`` (their plain PyTorch versions, used by the
        tests).  ``"cuda"`` without a GPU raises; nothing falls back to the
        CPU.  The default engine is ``"tape"``, so ``ExecConfig()`` runs on
        the card; the host oracle ``engine="numpy"`` must be asked for by
        name, with ``device="cpu"``.

    Mutable collaborators (``model``, ``plan_cache``, ``mesh``, a
    ``FeedbackStore`` passed as ``feedback``) are typed ``Any`` and
    excluded from hashing — the config is frozen, the collaborators are
    shared by reference.
    """

    planner: str = "shallowfish"
    engine: str = "tape"
    block: int = 8192
    zone_prune: bool = True
    rewrite_strings: bool = True
    batched: Union[bool, str] = "auto"
    annotate: bool = True
    persist_atom_cache: bool = True
    share_threshold: int = 2
    share_margin: Optional[float] = 1.0
    feedback: Any = True              # bool | FeedbackStore
    feedback_absorb: bool = False
    model: Any = None                 # CostModel | None
    plan_cache: Any = None            # LRUPlanCache | None
    shards: int = 1
    mesh: Any = None                  # ShardMesh | None
    # observability: both accept bool or a caller-owned object.
    # telemetry=True publishes per-batch deltas + snapshots into the
    # process-global MetricsRegistry; trace=True emits host wall-clock
    # spans into the process-global Tracer ring.  Neither adds host syncs
    # or device work — device numbers ride the bundled transfer the batch
    # already pays for (docs/architecture.md §8).
    telemetry: Any = True             # bool | MetricsRegistry
    trace: Any = True                 # bool | Tracer
    device: str = "cuda"              # "cuda" | "cuda:<i>" | "cpu"

    def __post_init__(self) -> None:
        if self.planner not in PLANNER_NAMES:
            raise ConfigError(
                f"unknown planner {self.planner!r}; expected one of "
                f"{PLANNER_NAMES}")
        if self.engine not in ENGINE_NAMES:
            raise ConfigError(
                f"unknown engine {self.engine!r}; expected one of "
                f"{ENGINE_NAMES}")
        if not isinstance(self.block, int) or self.block <= 0 \
                or self.block % 32:
            raise ConfigError(
                f"block must be a positive multiple of 32, got "
                f"{self.block!r}")
        if self.batched not in (True, False, "auto"):
            raise ConfigError(
                f"batched must be True/False/'auto', got {self.batched!r}")
        if not isinstance(self.share_threshold, int) \
                or self.share_threshold < 1:
            raise ConfigError(
                f"share_threshold must be an int >= 1, got "
                f"{self.share_threshold!r}")
        if not isinstance(self.shards, int) or not _is_pow2(self.shards):
            raise ConfigError(
                f"shards must be a power-of-two int >= 1, got "
                f"{self.shards!r}")
        if (self.shards > 1 or self.mesh is not None) \
                and self.engine != "tape":
            raise ConfigError(
                f"sharded execution (shards={self.shards}, "
                f"mesh={'set' if self.mesh is not None else None}) requires "
                f"engine='tape'; engine {self.engine!r} does not shard "
                "(host/per-step engines have no mesh path, kernel flavors "
                "do not shard)")
        if self.mesh is not None:
            size = getattr(self.mesh, "size", None)
            if size is not None and self.shards > 1 and size != self.shards:
                raise ConfigError(
                    f"mesh has {size} devices but shards={self.shards}")
        if self.telemetry not in (True, False, None) \
                and not (hasattr(self.telemetry, "counter")
                         and hasattr(self.telemetry, "gauge")):
            raise ConfigError(
                "telemetry must be a bool or a MetricsRegistry-like object "
                f"(counter/gauge accessors), got {self.telemetry!r}")
        if self.trace not in (True, False, None) \
                and not hasattr(self.trace, "span"):
            raise ConfigError(
                "trace must be a bool or a Tracer-like object (span() "
                f"context manager), got {self.trace!r}")
        if not isinstance(self.device, str) or not (
                self.device in ("cpu", "cuda")
                or (self.device.startswith("cuda:")
                    and self.device[5:].isdigit())):
            raise ConfigError(
                f"device must be 'cuda', 'cuda:<index>' or 'cpu', got "
                f"{self.device!r}")
        if self.engine == "numpy" and self.device != "cpu":
            raise ConfigError(
                "engine 'numpy' is the host oracle and runs on the CPU: "
                f"pass device='cpu' (got device={self.device!r})")

    def replace(self, **changes: Any) -> "ExecConfig":
        """Return a copy with ``changes`` applied (re-validated)."""
        return dataclasses.replace(self, **changes)

    @property
    def sharded(self) -> bool:
        return self.shards > 1 or self.mesh is not None


# ---------------------------------------------------------------------------
# Legacy-kwarg deprecation shim
# ---------------------------------------------------------------------------

#: kwarg names that have already warned this process (warn once per name)
_WARNED: set = set()


def reset_legacy_warnings() -> None:
    """Clear the warn-once registry (tests only)."""
    _WARNED.clear()


def _warn_legacy(name: str) -> None:
    if name in _WARNED:
        return
    _WARNED.add(name)
    warnings.warn(
        f"{name}= is deprecated; pass config=ExecConfig({name}=...) "
        "instead (repro_torch.columnar.ExecConfig is the single construction "
        "path for run_query / QuerySession / StreamSession)",
        DeprecationWarning, stacklevel=4)


def config_from_kwargs(config: Optional[ExecConfig],
                       defaults: Optional[ExecConfig] = None,
                       **legacy: Any) -> ExecConfig:
    """Resolve ``config=`` vs legacy kwargs into one :class:`ExecConfig`.

    ``defaults`` is the entry point's base config (e.g. ``StreamSession``
    defaults to ``engine='tape', batched=True``); legacy kwargs left at
    ``UNSET`` are dropped, explicitly passed ones warn once per name and
    override the base.  Passing both ``config=`` and any legacy kwarg is a
    :class:`ConfigError` — there is no precedence to guess.
    """
    passed = {k: v for k, v in legacy.items() if v is not UNSET}
    if config is not None:
        if passed:
            raise ConfigError(
                "pass either config= or legacy kwargs, not both "
                f"(got config= plus {sorted(passed)})")
        if not isinstance(config, ExecConfig):
            raise ConfigError(
                f"config must be an ExecConfig, got {type(config).__name__}")
        return config
    base = defaults if defaults is not None else ExecConfig()
    if not passed:
        return base
    for name in passed:
        _warn_legacy(name)
    return base.replace(**passed)
