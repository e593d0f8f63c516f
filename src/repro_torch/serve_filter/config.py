"""Declarative serving configuration and the tenant lifecycle vocabulary.

A frozen :class:`ServeConfig` composed of small orthogonal sub-configs,
each naming the subsystem it parameterizes, as in
``repro.serve_filter.config``:

* :class:`BucketConfig`    — the scheduler's padding-bucket ladder;
* :class:`PlacementConfig` — the device the tenants live on (``None``
  means ``cuda``; the CPU only when named);
* :class:`~repro_torch.serve_filter.plan.ProbeConfig` — fixup-probe
  flavor (plain PyTorch vs the CUDA kernel);
* :class:`MetricsConfig`   — the JSONL metrics sink and span tracing;
* :class:`~repro_torch.serve_filter.faults.FaultConfig` and
  :class:`~repro_torch.serve_filter.faults.ReliabilityConfig`.

Four switches of the JAX package's vocabulary are not ported yet and
raise ``NotImplementedError`` naming their ROADMAP item when turned on:
``PlacementConfig.mesh`` (sharded placement), ``DispatchConfig.
async_dispatch``, ``GroupingConfig.enabled`` and ``QuantConfig.enabled``.

:class:`TenantState` is the per-tenant lifecycle the registry drives::

    ADMITTED -> HYDRATING -> SERVING -> DRAINING -> RETIRED
                    ^  |         |
                    |  v         |
                    +- DEGRADED -+ (reload recovers; drain retires)
"""
from __future__ import annotations

import dataclasses
import enum
from typing import Optional, Sequence, Tuple

from repro_torch.core import existence
from repro_torch.serve_filter.faults import FaultConfig, ReliabilityConfig
from repro_torch.serve_filter.plan import ProbeConfig

DEFAULT_BUCKETS = (64, 256, 1024, 4096)


class TenantState(enum.Enum):
    """Lifecycle of one tenant inside a registry/server."""
    ADMITTED = "admitted"      # spec accepted, nothing on device yet
    HYDRATING = "hydrating"    # loading + placing arrays (also: reloading)
    SERVING = "serving"        # live, accepting submissions
    DRAINING = "draining"      # submissions rejected, queued work finishing
    RETIRED = "retired"        # gone from the registry
    DEGRADED = "degraded"      # hydration exhausted: last-good epoch or
                               # backup-Bloom-only answers until a reload


# legal transitions; None is the pre-admission pseudo-state
LIFECYCLE_TRANSITIONS = {
    None: (TenantState.ADMITTED,),
    TenantState.ADMITTED: (TenantState.HYDRATING,),
    TenantState.HYDRATING: (TenantState.SERVING,
                            TenantState.RETIRED,    # failed fresh hydration
                            TenantState.DEGRADED),  # retries exhausted
    TenantState.SERVING: (TenantState.HYDRATING,   # hot-reload re-entry
                          TenantState.DRAINING),
    TenantState.DRAINING: (TenantState.RETIRED,),
    TenantState.RETIRED: (),
    TenantState.DEGRADED: (TenantState.HYDRATING,  # reload recovery
                           TenantState.DRAINING),
}


@dataclasses.dataclass(frozen=True)
class BucketConfig:
    """The scheduler's padding-bucket ladder: every dispatch is padded
    up to the smallest bucket that fits."""
    sizes: Tuple[int, ...] = DEFAULT_BUCKETS

    def __post_init__(self):
        sizes = tuple(sorted(int(b) for b in self.sizes))
        if not sizes or sizes[0] < 1:
            raise ValueError("buckets must be a non-empty ladder of "
                             "positive sizes")
        object.__setattr__(self, "sizes", sizes)


@dataclasses.dataclass(frozen=True)
class PlacementConfig:
    """Where tenants' arrays live: ``device=None`` is the card
    (``cuda``); pass ``"cpu"`` to serve on the CPU. A ``mesh`` (sharded
    placement, ROADMAP Queue 1 item 9) raises."""
    device: Optional[str] = None
    mesh: Optional[object] = None


@dataclasses.dataclass(frozen=True)
class DispatchConfig:
    """Dispatch is synchronous; ``async_dispatch=True`` (the CUDA-stream
    double buffer, ROADMAP Queue 1 item 5) raises."""
    async_dispatch: bool = False


@dataclasses.dataclass(frozen=True)
class GroupingConfig:
    """Plan-group megabatching; ``enabled=True`` (ROADMAP Queue 1 item 6)
    raises."""
    enabled: bool = False


@dataclasses.dataclass(frozen=True)
class QuantConfig:
    """Compressed-arena storage; ``enabled=True`` (ROADMAP Queue 1
    item 7) raises."""
    enabled: bool = False


@dataclasses.dataclass(frozen=True)
class MetricsConfig:
    """JSONL metrics sink (``runtime.MetricsLogger``) and span tracing
    (``runtime.trace.Tracer``), as in the JAX package."""
    path: Optional[str] = None
    echo: bool = False
    trace: bool = False
    trace_path: Optional[str] = None
    trace_events: int = 65536

    @property
    def enabled(self) -> bool:
        return bool(self.path or self.echo)

    @property
    def trace_enabled(self) -> bool:
        return bool(self.trace or self.trace_path)


@dataclasses.dataclass(frozen=True)
class ServeConfig:
    """Frozen, declarative configuration for a whole ``FilterServer``."""
    budget_mb: Optional[float] = None
    buckets: BucketConfig = BucketConfig()
    placement: PlacementConfig = PlacementConfig()
    dispatch: DispatchConfig = DispatchConfig()
    grouping: GroupingConfig = GroupingConfig()
    probe: ProbeConfig = ProbeConfig()
    quant: QuantConfig = QuantConfig()
    metrics: MetricsConfig = MetricsConfig()
    faults: FaultConfig = FaultConfig()
    reliability: ReliabilityConfig = ReliabilityConfig()

    @classmethod
    def from_kwargs(cls, *, device: Optional[str] = None,
                    budget_mb: Optional[float] = None,
                    buckets: Sequence[int] = DEFAULT_BUCKETS,
                    use_kernel: bool = False,
                    mesh: Optional[object] = None,
                    async_dispatch: bool = False,
                    grouped: bool = False,
                    quantized: bool = False,
                    metrics_path: Optional[str] = None,
                    metrics_echo: bool = False,
                    trace: bool = False,
                    trace_path: Optional[str] = None) -> "ServeConfig":
        """Flat keyword form (``FilterServer(device="cpu", ...)``)."""
        return cls(
            budget_mb=budget_mb,
            buckets=BucketConfig(tuple(buckets)),
            placement=PlacementConfig(device=device, mesh=mesh),
            dispatch=DispatchConfig(async_dispatch=bool(async_dispatch)),
            grouping=GroupingConfig(enabled=bool(grouped)),
            probe=ProbeConfig(use_kernel=bool(use_kernel)),
            quant=QuantConfig(enabled=bool(quantized)),
            metrics=MetricsConfig(path=metrics_path,
                                  echo=bool(metrics_echo),
                                  trace=bool(trace),
                                  trace_path=trace_path))


@dataclasses.dataclass(frozen=True, eq=False)
class TenantSpec:
    """Declarative description of one tenant: id, source, placement
    hints. Exactly one source must be given — an in-memory ``index``,
    or a ``checkpoint`` directory (the tenant hydrates from
    ``<checkpoint>/<tenant>``, optionally at a specific ``step``).
    ``pinned`` tenants are never LRU-evicted by the memory budget."""
    tenant: str
    index: Optional[existence.ExistenceIndex] = None
    checkpoint: Optional[str] = None
    step: Optional[int] = None
    pinned: bool = False

    def __post_init__(self):
        if not self.tenant or not isinstance(self.tenant, str):
            raise ValueError("tenant must be a non-empty string")
        if (self.index is None) == (self.checkpoint is None):
            raise ValueError(
                f"tenant {self.tenant!r} needs exactly one source: an "
                "in-memory index or a checkpoint directory")
        if self.step is not None and self.checkpoint is None:
            raise ValueError("step only applies to a checkpoint source")
