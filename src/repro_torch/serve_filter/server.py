"""Top-level filter server: declarative config, tenant handles, futures.

``FilterServer`` is the serving facade, configured by ONE frozen
:class:`~repro_torch.serve_filter.config.ServeConfig` (or its flat
keyword form, ``FilterServer(device="cpu", use_kernel=True)``). Tenants
are declared as :class:`~repro_torch.serve_filter.config.TenantSpec`\\ s
and admitted through :meth:`FilterServer.admit`, which returns a
:class:`TenantHandle` — the live control surface for that tenant's
lifecycle (``ADMITTED -> HYDRATING -> SERVING -> DRAINING -> RETIRED``):
``handle.submit`` / ``query`` / ``reload`` / ``retire`` / ``save``.

Tenants live on ``config.placement.device`` (default ``cuda``); a
server asked for CUDA on a machine without it raises. With
``ProbeConfig(use_kernel=True)`` the fixup probe of every dispatch runs
in the CUDA kernel of ``kernels/bloom_query``.

``stats_snapshot()`` returns the same key set as the JAX package's
server; the keys of features this slice does not port (grouped arenas,
quantized storage, async overlap) read 0.
"""
from __future__ import annotations

import time
from typing import Dict, Optional

import numpy as np

from repro_torch.core import existence
from repro_torch.runtime.metrics import MetricsLogger
from repro_torch.runtime.trace import Tracer
from repro_torch.serve_filter import executors as executors_lib
from repro_torch.serve_filter.config import (ServeConfig, TenantSpec,
                                             TenantState)
from repro_torch.serve_filter.faults import NULL_INJECTOR, FaultInjector
from repro_torch.serve_filter.registry import FilterEntry, FilterRegistry
from repro_torch.serve_filter.scheduler import QueryFuture, QueryScheduler
from repro_torch.serve_filter.stats import ServeStats


class TenantHandle:
    """Live control surface for one admitted tenant.

    Returned by :meth:`FilterServer.admit`; stays valid across
    reloads (the tenant's ``epoch`` counts them) and reports
    ``TenantState.RETIRED`` once the tenant has left the registry.
    """

    def __init__(self, server: "FilterServer", spec: TenantSpec):
        self._server = server
        self._spec = spec
        self._last_epoch = 0

    def __repr__(self) -> str:
        return (f"TenantHandle({self.tenant!r}, state="
                f"{self.state.value}, epoch={self.epoch})")

    # ------------------------------------------------------------- state
    @property
    def tenant(self) -> str:
        return self._spec.tenant

    @property
    def spec(self) -> TenantSpec:
        """The most recent spec admitted for this tenant (reloads
        update it)."""
        return self._spec

    @property
    def state(self) -> TenantState:
        return self._server.registry.state_of(self.tenant)

    @property
    def entry(self) -> Optional[FilterEntry]:
        """The current registry entry (None once retired)."""
        return self._server.registry.peek(self.tenant)

    @property
    def epoch(self) -> int:
        """How many reloads this tenant has seen (0 = as admitted);
        the last live epoch once retired."""
        entry = self.entry
        if entry is not None:
            self._last_epoch = entry.epoch
        return self._last_epoch

    # ----------------------------------------------------------- queries
    def submit(self, ids: np.ndarray, *,
               deadline_ms: Optional[float] = None) -> QueryFuture:
        return self._server.submit(self.tenant, ids,
                                   deadline_ms=deadline_ms)

    def stats(self) -> Dict[str, float]:
        """This tenant's observability snapshot: cumulative / rolling /
        EWMA stage rates and the drift score vs its admit-time baseline
        (see :meth:`FilterServer.tenant_snapshot`)."""
        return self._server.tenant_snapshot(self.tenant)

    def query(self, ids: np.ndarray) -> np.ndarray:
        """Synchronous convenience, scoped to this request: submit one
        block and drive the scheduler until IT retires (other tenants'
        pending work stays queued)."""
        return self.submit(ids).result()

    # --------------------------------------------------------- lifecycle
    def reload(self, index: Optional[existence.ExistenceIndex] = None, *,
               checkpoint: Optional[str] = None,
               step: Optional[int] = None) -> "TenantHandle":
        """Atomically swap in a re-fitted index — from memory or from
        ``<checkpoint>/<tenant>`` — under live traffic, with no drain:
        rows dispatched before the swap answer from the old index,
        rows prepared after answer from the new one, none are dropped.
        The tenant passes SERVING -> HYDRATING -> SERVING and its
        ``epoch`` increments; swap latency lands in
        ``ServeStats.record_reload``.
        """
        if self._server.registry.peek(self.tenant) is None:
            # RETIRED is terminal: resurrecting through a stale handle
            # would silently reset the epoch and bypass the lifecycle —
            # a retired tenant comes back only via an explicit admit()
            raise RuntimeError(
                f"tenant {self.tenant!r} is retired; admit a new "
                "TenantSpec instead of reloading a stale handle")
        spec = TenantSpec(tenant=self.tenant, index=index,
                          checkpoint=checkpoint, step=step,
                          pinned=self._spec.pinned)
        # server.admit owns the reload bookkeeping (metrics + spec
        # update) and returns the tenant's live handle — this object
        return self._server.admit(spec)

    def retire(self, *, drain: bool = True,
               max_steps: int = 100_000) -> None:
        """Remove the tenant. ``drain=True`` (default) first moves it
        to DRAINING — new submissions are rejected while its queued
        rows finish answering — then retires it. ``drain=False``
        force-retires: queued requests fail now (their futures resolve
        with an error). Idempotent once retired."""
        server = self._server
        entry = server.registry.peek(self.tenant)
        if entry is None:
            return
        self._last_epoch = entry.epoch  # snapshot before the entry goes
        sched = server.scheduler
        if drain:
            server.registry.begin_drain(self.tenant)
            steps = 0
            while sched.pending_rows_for(self.tenant):
                if steps >= max_steps or not sched.step():
                    break
                steps += 1
        else:
            sched.cancel_tenant(
                self.tenant, f"tenant {self.tenant!r} force-retired")
        server.registry.evict(self.tenant)   # RETIRED hook reaps the handle

    # ------------------------------------------------------- persistence
    def save(self, directory: str, *, step: int = 0) -> str:
        """Persist the CURRENT epoch's index under
        ``directory/<tenant>``."""
        return self._server.registry.save(self.tenant, directory,
                                          step=step)


class FilterServer:
    """Registry + scheduler + stats behind one declarative config."""

    def __init__(self, config: Optional[ServeConfig] = None, **kwargs):
        if kwargs:
            if config is not None:
                raise TypeError("pass either a ServeConfig or keyword "
                                "options, not both")
            config = ServeConfig.from_kwargs(**kwargs)
        elif config is None:
            config = ServeConfig()
        self.config = config
        self.stats = ServeStats()
        self.tracer = Tracer(maxlen=config.metrics.trace_events,
                             enabled=config.metrics.trace_enabled)
        self.faults = (FaultInjector(config.faults)
                       if config.faults.enabled else NULL_INJECTOR)
        self.registry = FilterRegistry(
            config.budget_mb, probe=config.probe,
            placement=config.placement, grouping=config.grouping,
            quant=config.quant, reliability=config.reliability,
            on_transition=self._on_transition, tracer=self.tracer,
            injector=self.faults, stats=self.stats)
        self.scheduler = QueryScheduler(
            self.registry, buckets=config.buckets.sizes, stats=self.stats,
            async_dispatch=config.dispatch.async_dispatch,
            tracer=self.tracer, injector=self.faults,
            reliability=config.reliability)
        if config.faults.enabled:
            # first calls happen inside the process-global executor
            # cache, so the compile site installs process-globally too
            executors_lib.set_fault_injector(self.faults)
        self.metrics = (MetricsLogger(config.metrics.path,
                                      echo=config.metrics.echo)
                        if config.metrics.enabled else None)
        self._handles: Dict[str, TenantHandle] = {}
        self._log_step = 0
        self._closed = False

    def _on_transition(self, tenant: str, frm, to: TenantState) -> None:
        """Registry lifecycle hook: count the transition and, at
        RETIRED, reap the tenant's handle."""
        self.stats.record_transition(tenant, frm, to)
        if to is TenantState.RETIRED:
            handle = self._handles.pop(tenant, None)
            if handle is not None:
                entry = self.registry.peek(tenant)   # still present here
                if entry is not None:
                    handle._last_epoch = entry.epoch

    # ----------------------------------------------------------- tenants
    def admit(self, spec: TenantSpec) -> TenantHandle:
        """Admit a declared tenant (hydrating from its source) and
        return its handle. Admitting an already-serving tenant IS a
        hot-reload: the swap latency lands in the reload metrics and the
        tenant's EXISTING handle is updated and returned."""
        live = self.registry.peek(spec.tenant) is not None
        t0 = time.perf_counter()
        self.registry.admit(spec)
        if live:
            self.stats.record_reload(time.perf_counter() - t0)
            self.stats.reset_tenant_baseline(spec.tenant)
        handle = self._handles.get(spec.tenant)
        if handle is None:
            handle = TenantHandle(self, spec)
            self._handles[spec.tenant] = handle
        else:
            handle._spec = spec
        return handle

    def save(self, tenant: str, directory: str, *, step: int = 0) -> str:
        return self.registry.save(tenant, directory, step=step)

    def evict(self, tenant: str) -> None:
        """Drop a tenant immediately (queued requests fail on the
        scheduler's next pass)."""
        self.registry.evict(tenant)

    # ------------------------------------------------------------ queries
    def submit(self, tenant: str, ids: np.ndarray, *,
               deadline_ms: Optional[float] = None) -> QueryFuture:
        """Admit one query block; returns its future."""
        return QueryFuture(
            self.scheduler.submit(tenant, ids, deadline_ms=deadline_ms),
            self.scheduler)

    def step(self) -> bool:
        return self.scheduler.step()

    def run_until_drained(self, max_steps: int = 100_000) -> int:
        n = self.scheduler.run_until_drained(max_steps)
        if self.metrics is not None:
            self._log_step += 1
            self.stats.log_to(self.metrics, self._log_step)
        return n

    # ------------------------------------------------------------ readout
    def tenant_snapshot(self, tenant: str) -> Dict[str, float]:
        """One tenant's per-stage rates and drift score."""
        return self.stats.tenant_snapshot(tenant)

    def stats_snapshot(self) -> Dict[str, float]:
        """Flat float dict with the JAX server's key set. Grouped-arena
        and quantized-storage gauges read 0: those features are not
        ported yet."""
        self.stats.set_degraded_tenants(sum(
            1 for t in self.registry.tenants
            if self.registry.state_of(t) is TenantState.DEGRADED))
        snap = self.stats.snapshot()
        snap["registered_filters"] = float(len(self.registry))
        snap["registry_mb"] = self.registry.total_mb
        snap["compiled_programs"] = float(
            executors_lib.compiled_program_count())
        hits, misses = executors_lib.cache_stats()
        snap["compile_count"] = float(executors_lib.compile_count())
        snap["compile_ms_total"] = \
            executors_lib.compile_time_total() * 1e3
        snap["executor_cache_hits"] = float(hits)
        snap["executor_cache_misses"] = float(misses)
        snap["trace_events"] = float(len(self.tracer))
        for key in ("plan_groups", "arena_holes", "arena_dead_words",
                    "arena_slot_occupancy", "arena_compactions",
                    "arena_growths", "arena_mb", "arena_host_mb",
                    "arena_quant_mb", "tenants_per_gb"):
            snap[key] = 0.0
        return snap

    def dump_trace(self, path: Optional[str] = None) -> str:
        """Export the span buffer as Chrome trace-event JSON."""
        path = path or self.config.metrics.trace_path
        if not path:
            raise ValueError(
                "no trace path: pass one or set "
                "MetricsConfig(trace_path=...)")
        return self.tracer.to_chrome_trace(path)

    # ----------------------------------------------------------- shutdown
    def close(self) -> None:
        """Close the metrics logger and dump the trace when the config
        names a ``trace_path``. Idempotent."""
        if self._closed:
            return
        self._closed = True
        if self.config.faults.enabled:
            executors_lib.set_fault_injector(None)
        if self.config.metrics.trace_path and len(self.tracer):
            self.tracer.to_chrome_trace(self.config.metrics.trace_path)
        if self.metrics is not None:
            self.metrics.close()

    def __enter__(self) -> "FilterServer":
        return self

    def __exit__(self, *exc) -> bool:
        self.close()
        return False
