"""Filter registry: placement + an explicit tenant lifecycle.

Each tenant id maps to a :class:`FilterEntry` bundling its
``ExistenceIndex``, its :class:`~repro_torch.serve_filter.plan.QueryPlan`,
the (cached) executor for that plan, the tenant's device-placed arrays
(:class:`~repro_torch.serve_filter.executors.PlacedFilter`) and its
memory accounting. A registry optionally enforces a total memory budget
with LRU eviction (``pinned`` tenants are exempt), and hydrates tenants
from checkpoints written by either package. Evicting the last tenant
on a plan releases the plan's cached executor.

Every tenant moves through the lifecycle of
:class:`~repro_torch.serve_filter.config.TenantState`::

    ADMITTED -> HYDRATING -> SERVING -> DRAINING -> RETIRED

:meth:`FilterRegistry.admit` drives the left half; re-admitting a
SERVING tenant is the hot-reload path (a fresh ``PlacedFilter`` is
swapped in, ``epoch`` bumped, no drain). :meth:`begin_drain` +
:meth:`evict` drive the right half. Every transition is validated
against ``config.LIFECYCLE_TRANSITIONS`` and reported through the
``on_transition`` hook.

Reliability, as in the reference: under a ``ReliabilityConfig`` with
``retries > 0`` transient hydration failures are retried on the seeded
capped-backoff schedule; with ``degraded=True`` an exhausted tenant
enters ``DEGRADED`` — a reloading tenant keeps its last-good epoch, a
never-hydrated one answers from its fixup/backup Bloom bitset alone
(model treated as all-positive: zero false negatives, FPR ~1).

This slice has local placement only; plan-group arenas, quantized
storage and mesh placement raise ``NotImplementedError``.
"""
from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Callable, Dict, List, Optional

import torch

from repro_torch.core import existence, fixup as fixup_lib, memory
from repro_torch.runtime import device as device_lib
from repro_torch.runtime.trace import NULL_TRACER, Tracer
from repro_torch.serve_filter import executors as executors_lib
from repro_torch.serve_filter.config import (GroupingConfig,
                                             LIFECYCLE_TRANSITIONS,
                                             PlacementConfig, QuantConfig,
                                             TenantSpec, TenantState)
from repro_torch.serve_filter.faults import (NULL_INJECTOR,
                                             CheckpointCorruption,
                                             FaultInjector, InjectedFault,
                                             ReliabilityConfig,
                                             backoff_delays)
from repro_torch.serve_filter.plan import (ProbeConfig, QueryPlan,
                                           not_ported, plan_query)

# hydration failure kinds the retry loop treats as TRANSIENT
TRANSIENT_HYDRATION_ERRORS = (InjectedFault, CheckpointCorruption)

# hook signature: (tenant, from_state_or_None, to_state)
TransitionHook = Callable[[str, Optional[TenantState], TenantState], None]


@dataclasses.dataclass
class FilterEntry:
    tenant: str
    index: Optional[existence.ExistenceIndex]  # None: backup-only entry
    plan: Optional[QueryPlan]       # None when backup-only
    executor: object                # None when backup-only
    placed: Optional[executors_lib.PlacedFilter]
    model_mb: float
    fixup_mb: float
    last_used: int = 0              # registry LRU clock tick
    state: TenantState = TenantState.SERVING
    pinned: bool = False            # exempt from LRU budget eviction
    epoch: int = 0                  # bumped on every hot-reload
    backup_only: Optional[fixup_lib.FixupFilter] = None  # degraded path
    n_cols_hint: int = 0            # query width when index is None
    device: Optional[torch.device] = None

    def run(self, raw_ids: torch.Tensor):
        """One dispatch: (n, n_cols) int32 ids on the entry's device ->
        (answers, model_yes, backup_yes) bool tensors, not synchronized.

        A backup-only (DEGRADED, never-hydrated) entry has no model: it
        treats the model as all-positive — zero false negatives, FPR ~1
        until a reload restores the model — and still reports its real
        backup-Bloom probe so the stage decomposition stays observable.
        """
        if self.executor is None:
            ones = torch.ones(raw_ids.shape[0], dtype=torch.bool,
                              device=raw_ids.device)
            return ones, ones, self.backup_only.query(raw_ids)
        return self.executor(self.placed, self.index.tau, raw_ids)

    @property
    def total_mb(self) -> float:
        return self.model_mb + self.fixup_mb

    @property
    def n_cols(self) -> int:
        if self.index is None:
            return self.n_cols_hint
        return self.index.cfg.plan.n_columns


class FilterRegistry:
    """Loads/owns fitted indexes keyed by tenant id, on one device.

    ``budget_mb`` bounds the summed per-filter memory (weights + packed
    fixup bitset); admitting past the budget evicts least-recently-used
    unpinned tenants first. ``probe`` selects the fixup-probe flavor for
    all tenants' plans; ``placement.device`` (default ``cuda``) is where
    every tenant's arrays are placed.
    """

    def __init__(self, budget_mb: Optional[float] = None, *,
                 probe: ProbeConfig = ProbeConfig(),
                 placement: PlacementConfig = PlacementConfig(),
                 grouping: GroupingConfig = GroupingConfig(),
                 quant: QuantConfig = QuantConfig(),
                 reliability: ReliabilityConfig = ReliabilityConfig(),
                 on_transition: Optional[TransitionHook] = None,
                 tracer: Optional[Tracer] = None,
                 injector: FaultInjector = NULL_INJECTOR,
                 stats=None):
        if grouping.enabled:
            raise not_ported("plan-group megabatching (grouping)",
                             "1 item 6")
        if quant.enabled:
            raise not_ported("quantized (compressed-arena) serving",
                             "1 item 7")
        if placement.mesh is not None:
            raise not_ported("mesh-sharded placement", "1 item 9")
        dev = device_lib.resolve(placement.device)
        if dev.type == "cuda" and dev.index is None:
            dev = torch.device("cuda", torch.cuda.current_device())
        self.device = dev
        self.budget_mb = budget_mb
        self.probe = probe
        self.placement = placement
        self.reliability = reliability
        self.on_transition = on_transition
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self.injector = injector
        self.stats = stats              # ServeStats or None (counters)
        self._entries: Dict[str, FilterEntry] = {}
        self._clock = itertools.count(1)
        self.evictions: List[str] = []

    # ------------------------------------------------------------ access
    def __contains__(self, tenant: str) -> bool:
        return tenant in self._entries

    def __len__(self) -> int:
        return len(self._entries)

    @property
    def tenants(self) -> List[str]:
        return list(self._entries)

    @property
    def total_mb(self) -> float:
        return sum(e.total_mb for e in self._entries.values())

    def get(self, tenant: str) -> FilterEntry:
        """Fetch + touch (bumps LRU recency)."""
        entry = self._entries[tenant]
        entry.last_used = next(self._clock)
        return entry

    def peek(self, tenant: str) -> Optional[FilterEntry]:
        """Fetch WITHOUT touching LRU recency."""
        return self._entries.get(tenant)

    def tick(self) -> int:
        """Next LRU clock value (``entry.last_used = registry.tick()``)."""
        return next(self._clock)

    def state_of(self, tenant: str) -> TenantState:
        """The tenant's lifecycle state (RETIRED once gone)."""
        entry = self._entries.get(tenant)
        return entry.state if entry is not None else TenantState.RETIRED

    # --------------------------------------------------------- lifecycle
    def _transition(self, tenant: str, frm: Optional[TenantState],
                    to: TenantState) -> None:
        if to not in LIFECYCLE_TRANSITIONS[frm]:
            raise RuntimeError(
                f"illegal lifecycle transition for tenant {tenant!r}: "
                f"{frm.value if frm else None} -> {to.value}")
        if self.on_transition is not None:
            self.on_transition(tenant, frm, to)

    def plan_for(self, index: existence.ExistenceIndex) -> QueryPlan:
        """The plan this registry's planner assigns an index."""
        return plan_query(index.cfg, index.fixup_filter.params,
                          device=str(self.device), probe=self.probe)

    def admit(self, spec: TenantSpec) -> FilterEntry:
        """Drive a tenant spec through ADMITTED -> HYDRATING -> SERVING.

        Re-admitting a SERVING (or DEGRADED) tenant is the hot-reload
        path: HYDRATING, a fresh placement swapped in atomically, back
        to SERVING with ``epoch + 1`` — no drain. Evicts LRU unpinned
        tenants if over budget.
        """
        tenant = spec.tenant
        prev = self._entries.get(tenant)
        prev_state = prev.state if prev is not None else None
        if prev is None:
            self._transition(tenant, None, TenantState.ADMITTED)
            self._transition(tenant, TenantState.ADMITTED,
                             TenantState.HYDRATING)
        else:
            if prev.state not in (TenantState.SERVING,
                                  TenantState.DEGRADED):
                raise RuntimeError(
                    f"tenant {tenant!r} is {prev.state.value}; only a "
                    "serving or degraded tenant can be reloaded")
            self._transition(tenant, prev.state, TenantState.HYDRATING)
            prev.state = TenantState.HYDRATING
        try:
            with self.tracer.span(
                    "reload" if prev is not None else "admit",
                    cat="lifecycle", tenant=tenant):
                entry = self._hydrate_with_retries(spec, prev)
        except BaseException as err:
            # resolve every failure point so the tenant never dangles in
            # HYDRATING
            cur = self._entries.get(tenant)
            degrade = (self.reliability.degraded
                       and isinstance(err, TRANSIENT_HYDRATION_ERRORS))
            if prev is not None and cur is prev:
                if degrade:
                    # a live tenant keeps answering on its last-good epoch
                    self._transition(tenant, TenantState.HYDRATING,
                                     TenantState.DEGRADED)
                    prev.state = TenantState.DEGRADED
                else:
                    # failed before the swap: roll back to where it was
                    self._transition(tenant, TenantState.HYDRATING,
                                     prev_state)
                    prev.state = prev_state
            elif prev is None and cur is None:
                if degrade:
                    fallback = self._install_degraded(spec)
                    if fallback is not None:
                        self._transition(tenant, TenantState.HYDRATING,
                                         TenantState.DEGRADED)
                        fallback.state = TenantState.DEGRADED
                        self._enforce_budget(keep=tenant)
                        return fallback
                self._transition(tenant, TenantState.HYDRATING,
                                 TenantState.RETIRED)
            elif cur is not None and cur is not prev:
                # the new entry landed; the failure came from releasing
                # the old one — the swap is complete
                self._transition(tenant, TenantState.HYDRATING,
                                 TenantState.SERVING)
                cur.state = TenantState.SERVING
            raise
        self._transition(tenant, TenantState.HYDRATING, TenantState.SERVING)
        entry.state = TenantState.SERVING
        self._enforce_budget(keep=tenant)
        return entry

    def _hydrate_with_retries(self, spec: TenantSpec,
                              prev: Optional[FilterEntry]) -> FilterEntry:
        """One admit/reload hydration under the retry policy."""
        tenant = spec.tenant
        rel = self.reliability
        delays = backoff_delays(rel, self.injector.config.seed, tenant)
        attempt = 0
        while True:
            t0 = time.monotonic()
            try:
                return self._hydrate_once(spec, prev)
            except TRANSIENT_HYDRATION_ERRORS as err:
                if (isinstance(err, CheckpointCorruption)
                        and self.stats is not None):
                    self.stats.record_checksum_failure()
                if attempt >= len(delays):
                    raise
                if (rel.attempt_timeout_s is not None
                        and time.monotonic() - t0 > rel.attempt_timeout_s):
                    raise       # slow failure: classified non-transient
                if self._entries.get(tenant) is not prev:
                    raise       # partial swap landed; do not re-install
                if self.stats is not None:
                    self.stats.record_hydration_retry()
                time.sleep(delays[attempt])
                attempt += 1

    def _hydrate_once(self, spec: TenantSpec,
                      prev: Optional[FilterEntry]) -> FilterEntry:
        tenant = spec.tenant
        index = spec.index
        if index is None:
            self.injector.check("checkpoint_read", tenant)
            index = existence.load_index(
                os.path.join(spec.checkpoint, tenant), step=spec.step,
                device=self.device)
        self.injector.check("hydrate", tenant)
        return self._install(tenant, index, prev, pinned=spec.pinned)

    def _install_degraded(self, spec: TenantSpec
                          ) -> Optional[FilterEntry]:
        """Best-effort backup-only entry for a fresh admission whose
        hydration exhausted its retries; None when even the backup
        bitset is unreachable."""
        tenant = spec.tenant
        try:
            if spec.index is not None:
                cfg = spec.index.cfg
                fx = spec.index.fixup_filter
            else:
                cfg, fx = existence.load_fixup_only(
                    os.path.join(spec.checkpoint, tenant), step=spec.step)
        except Exception:
            return None
        entry = FilterEntry(
            tenant=tenant, index=None, plan=None, executor=None,
            placed=None, model_mb=0.0, fixup_mb=fx.size_mb,
            last_used=next(self._clock), state=TenantState.HYDRATING,
            pinned=spec.pinned, backup_only=fx, n_cols_hint=cfg.plan.n_columns,
            device=self.device)
        self._entries[tenant] = entry
        return entry

    # ------------------------------------------------- mutation plumbing
    def _install(self, tenant: str, index: existence.ExistenceIndex,
                 prev: Optional[FilterEntry], *,
                 pinned: bool) -> FilterEntry:
        """Place an index's arrays and swap the new entry in (a dict
        assignment: every dispatch after it binds the new arrays)."""
        mem = memory.accounting(index.cfg)
        plan = self.plan_for(index)
        executor = executors_lib.acquire_executor(plan)
        try:
            self.injector.check("device_put", tenant)
            placed = executor.place(index)
        except BaseException:
            executors_lib.release_executor(plan)
            raise
        entry = FilterEntry(
            tenant=tenant, index=index, plan=plan, executor=executor,
            placed=placed, model_mb=mem.weights_mb,
            fixup_mb=index.fixup_filter.size_mb,
            last_used=next(self._clock), state=TenantState.HYDRATING,
            pinned=pinned, epoch=prev.epoch + 1 if prev is not None else 0,
            device=self.device)
        self._entries[tenant] = entry
        if prev is not None:    # replaced: give back the old entry's ref
            self._release_entry(prev)
        return entry

    def begin_drain(self, tenant: str) -> None:
        """SERVING -> DRAINING: queued rows still answer, new
        submissions are rejected; :meth:`evict` finishes retirement."""
        entry = self._entries.get(tenant)
        if entry is None or entry.state is TenantState.DRAINING:
            return
        self._transition(tenant, entry.state, TenantState.DRAINING)
        entry.state = TenantState.DRAINING

    def evict(self, tenant: str) -> None:
        """Drop a tenant (-> RETIRED)."""
        entry = self._entries.get(tenant)
        if entry is None:
            return
        if entry.state in (TenantState.SERVING, TenantState.DEGRADED):
            self._transition(tenant, entry.state, TenantState.DRAINING)
            entry.state = TenantState.DRAINING
        self._transition(tenant, entry.state, TenantState.RETIRED)
        entry.state = TenantState.RETIRED
        del self._entries[tenant]
        self.evictions.append(tenant)
        self._release_entry(entry)

    def _release_entry(self, entry: FilterEntry) -> None:
        """Drop the entry's executor reference (the last one, process-
        wide, forgets the cached executor)."""
        if entry.executor is not None:
            executors_lib.release_executor(entry.plan)

    def _enforce_budget(self, keep: str) -> None:
        if self.budget_mb is None:
            return
        while self.total_mb > self.budget_mb and len(self._entries) > 1:
            victim = min(
                (e for t, e in self._entries.items()
                 if t != keep and not e.pinned),
                key=lambda e: e.last_used, default=None)
            if victim is None:      # everything else is pinned
                return
            self.evict(victim.tenant)

    # ------------------------------------------------------- persistence
    def save(self, tenant: str, directory: str, *, step: int = 0) -> str:
        """Write a tenant's index under ``directory/<tenant>`` (v2)."""
        path = os.path.join(directory, tenant)
        existence.save_index(path, self._entries[tenant].index, step=step)
        return path
