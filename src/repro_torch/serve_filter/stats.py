"""Serving metrics: QPS, occupancy, latencies, stage FPRs, tenant drift.

``ServeStats`` is the single metrics surface for the filter server.
Batch-level facts are recorded on the dispatch path (cheap Python
counters, a bounded latency window, and a mergeable log-bucketed
histogram from ``runtime/metrics.py``); ``snapshot()`` condenses them
into a flat dict that feeds ``runtime.MetricsLogger`` unchanged (floats
only), so serving metrics land in the same JSONL stream as training
metrics.

Reading the JSONL stream
------------------------
Each line is one snapshot. The load-bearing keys:

* throughput — ``qps`` (cumulative, since server construction; decays
  while idle) and ``qps_interval`` (since the PREVIOUS snapshot — the
  number to plot and the one the bench's measurement windows use);
  ``batch_occupancy`` = valid rows / padded rows (how much of each
  padded bucket was real work).
* latency — ``batch_*`` (one fused dispatch, wall), ``request_*``
  (submit -> answer, end to end), ``queue_*`` (submit -> FIRST
  dispatch: time spent waiting in the scheduler, the SLO-scheduling
  signal), ``reload_*`` (hot-swap cost). All in milliseconds,
  p50/p99/max; queue percentiles come from a full-history histogram,
  not a window.
* stage FPR decomposition — ``model_pos_rate`` (learned model's
  yes-rate at tau), ``fixup_hit_rate`` (backup Bloom filter's), and
  ``positive_rate`` (their union). For keys NOT in the set, these
  decompose the composite false-positive rate of the paper's §3.3
  sandwiched construction: FPR = p_model + (1 - p_model) * p_backup —
  the model's share is cheap to re-train away, the backup filter's is
  bought with bits. Watching the two components separately (and per
  tenant — see below) is what tells an operator WHICH side drifted.
* compile/cache/arena telemetry (server snapshot) — ``compile_count``
  / ``compile_ms_total`` (first calls per (plan, bucket) shape, whose
  wall time carries the lazy CUDA kernel build and library warm-up),
  ``executor_cache_hits``/``_misses``, and ``arena_*`` gauges (grouped
  megabatch arenas are not ported yet, so these read 0).

Per-tenant drift
----------------
:class:`TenantStats` tracks the same three stage rates PER TENANT, in
three horizons: cumulative (sums consistently with the global rates),
a rolling window of recent batches, and an EWMA. The EWMA observed
shortly after admit (or hot-reload) is frozen as the tenant's
**baseline**; ``drift_score`` is the largest absolute gap between the
live EWMA and that baseline across the three rates — the exact signal
a drift-driven refit loop polls (Ada-BF, arXiv 1910.09131, shows the
model-vs-backup split is where the compression-FPR tradeoff lives).
Surfaced via ``server.tenant_snapshot(id)`` / ``TenantHandle.stats()``.

Span traces
-----------
Counters cannot show OVERLAP. The server's ``MetricsConfig(trace=True)``
attaches a ``runtime.trace.Tracer`` to the scheduler's hot path;
``server.dump_trace(path)`` writes Chrome trace-event JSON — open it at
https://ui.perfetto.dev. The ``host`` thread shows prepare / dispatch /
device_block / scatter_retire spans; the synthetic ``device`` track
shows each batch's compute window. With ``async_dispatch=True`` the
prepare span of batch *t+1* sits UNDER device-compute of batch *t*.

Lifecycle observability: the registry reports every tenant-state
transition (``ADMITTED -> HYDRATING -> SERVING -> DRAINING ->
RETIRED``) through :meth:`ServeStats.record_transition` — cumulative
per-state counters land in the snapshot (``lifecycle_*``), and a
bounded event log keeps the most recent transitions inspectable.
Hot-reloads (the SERVING -> HYDRATING -> SERVING loop) additionally
record their swap latency via :meth:`ServeStats.record_reload`
(``reloads``, ``reload_p50_ms``/``p99``/``max``), so re-fit churn shows
up in the same JSONL stream as throughput.
"""
from __future__ import annotations

import collections
import dataclasses
import time
from typing import Dict, Optional, Tuple

import numpy as np

from repro_torch.runtime.metrics import Histogram, LatencyWindow, MetricsLogger
from repro_torch.serve_filter.config import TenantState

# TenantStats defaults: window of recent batches for the rolling rates,
# rows observed before the EWMA freezes into the drift baseline, and
# the EWMA's per-batch step
TENANT_WINDOW_BATCHES = 128
BASELINE_ROWS = 256
EWMA_ALPHA = 0.2


@dataclasses.dataclass
class _Counters:
    queries: int = 0            # valid (non-padding) rows answered
    batches: int = 0            # fused dispatches
    padded_rows: int = 0        # total rows incl. padding
    requests: int = 0
    model_pos: int = 0
    fixup_pos: int = 0
    final_pos: int = 0
    overlapped: int = 0         # batches retired with another in flight
    grouped: int = 0            # batches whose rows spanned > 1 tenant
    reloads: int = 0            # zero-drain hot-swaps completed
    shed_rows: int = 0          # rows refused by Overloaded backpressure
    deadline_expired: int = 0   # requests retired past their deadline
    hydration_retries: int = 0  # transient hydration failures retried
    checksum_failures: int = 0  # checkpoint arrays failing CRC at load


class TenantStats:
    """One tenant's stage-positive rates in three horizons + drift.

    ``record`` takes per-batch stage sums (rows, model-positive,
    fixup-positive, final-positive) attributed to this tenant.
    Cumulative counts sum exactly with the global ``ServeStats``
    counters; the rolling window and EWMA react to recent traffic; the
    baseline is the EWMA frozen after :data:`BASELINE_ROWS` rows since
    admit / the last :meth:`reset_baseline` (i.e. the tenant's behavior
    right after its model was (re)fitted)."""

    def __init__(self, window_batches: int = TENANT_WINDOW_BATCHES,
                 baseline_rows: int = BASELINE_ROWS,
                 alpha: float = EWMA_ALPHA):
        self.rows = 0
        self.model_pos = 0
        self.fixup_pos = 0
        self.final_pos = 0
        self.batches = 0
        self._alpha = float(alpha)
        self._baseline_rows = int(baseline_rows)
        self._window: collections.deque = \
            collections.deque(maxlen=window_batches)
        self._ewma: Optional[Tuple[float, float, float]] = None
        self._baseline: Optional[Tuple[float, float, float]] = None
        self._rows_since_reset = 0

    # --------------------------------------------------------- recording
    def record(self, rows: int, model_pos: int, fixup_pos: int,
               final_pos: int) -> None:
        if rows <= 0:
            return
        self.rows += rows
        self.model_pos += model_pos
        self.fixup_pos += fixup_pos
        self.final_pos += final_pos
        self.batches += 1
        self._window.append((rows, model_pos, fixup_pos, final_pos))
        rates = (model_pos / rows, fixup_pos / rows, final_pos / rows)
        if self._ewma is None:
            self._ewma = rates
        else:
            a = self._alpha
            self._ewma = tuple((1 - a) * e + a * r
                               for e, r in zip(self._ewma, rates))
        self._rows_since_reset += rows
        if (self._baseline is None
                and self._rows_since_reset >= self._baseline_rows):
            self._baseline = self._ewma

    def reset_baseline(self) -> None:
        """Forget the drift baseline AND the EWMA — called on
        hot-reload, so drift is measured against the refreshed model's
        own early behavior, not the stale one's."""
        self._baseline = None
        self._ewma = None
        self._rows_since_reset = 0

    # ----------------------------------------------------------- readout
    def _window_rates(self) -> Tuple[float, float, float]:
        rows = sum(w[0] for w in self._window)
        if not rows:
            return (0.0, 0.0, 0.0)
        return (sum(w[1] for w in self._window) / rows,
                sum(w[2] for w in self._window) / rows,
                sum(w[3] for w in self._window) / rows)

    @property
    def drift_score(self) -> float:
        """Largest |EWMA - baseline| across the three stage rates; 0.0
        until the baseline freezes."""
        if self._baseline is None or self._ewma is None:
            return 0.0
        return max(abs(e - b)
                   for e, b in zip(self._ewma, self._baseline))

    def snapshot(self) -> Dict[str, float]:
        r = max(self.rows, 1)
        wm, wf, wp = self._window_rates()
        em, ef, ep = self._ewma or (0.0, 0.0, 0.0)
        bm, bf, bp = self._baseline or (0.0, 0.0, 0.0)
        return {
            "rows": float(self.rows),
            "batches": float(self.batches),
            "model_pos": float(self.model_pos),
            "fixup_pos": float(self.fixup_pos),
            "final_pos": float(self.final_pos),
            # cumulative rates: sum consistently with the global rates
            "model_pos_rate": self.model_pos / r,
            "fixup_hit_rate": self.fixup_pos / r,
            "positive_rate": self.final_pos / r,
            # rolling-window rates: recent traffic only
            "window_model_pos_rate": wm,
            "window_fixup_hit_rate": wf,
            "window_positive_rate": wp,
            # EWMA vs the admit/reload-time baseline
            "ewma_model_pos_rate": em,
            "ewma_fixup_hit_rate": ef,
            "ewma_positive_rate": ep,
            "baseline_model_pos_rate": bm,
            "baseline_fixup_hit_rate": bf,
            "baseline_positive_rate": bp,
            "has_baseline": float(self._baseline is not None),
            "drift_score": self.drift_score,
        }


class ServeStats:
    def __init__(self, latency_maxlen: int = 4096,
                 clock=time.perf_counter):
        self._clock = clock
        self.t_start = clock()
        self.totals = _Counters()
        self.batch_latency = LatencyWindow(latency_maxlen)
        self.request_latency = LatencyWindow(latency_maxlen)
        self.reload_latency = LatencyWindow(latency_maxlen)
        # queue time (submit -> first dispatch) keeps FULL history in a
        # log-bucketed histogram: queue spikes are exactly what a
        # bounded window forgets
        self.queue_time = Histogram()
        self.per_tenant: Dict[str, int] = {}      # tenant -> valid rows
        self.tenants: Dict[str, TenantStats] = {}
        self.last_bucket: Optional[int] = None
        # previous snapshot's (time, queries), for interval qps
        self._last_snap: Tuple[float, int] = (self.t_start, 0)
        # cumulative per-target-state transition counts + bounded log
        self.lifecycle: Dict[TenantState, int] = \
            {s: 0 for s in TenantState}
        self.lifecycle_events: collections.deque = \
            collections.deque(maxlen=256)    # (tenant, frm, to)
        # grouped-arena membership by storage dtype: part of the pinned
        # snapshot schema; grouped arenas are not ported, so they stay 0
        self.arena_tenants_int8 = 0
        self.arena_tenants_fp32 = 0
        self.arena_tenants_int4 = 0
        # live DEGRADED-tenant gauge (set by the server per snapshot)
        self.degraded_tenants = 0

    # ---------------------------------------------------------- recording
    def tenant(self, name: str) -> TenantStats:
        ts = self.tenants.get(name)
        if ts is None:
            ts = self.tenants[name] = TenantStats()
        return ts

    def record_batch(self, tenant: str, n_valid: int, bucket: int,
                     latency_s: float, answers: np.ndarray,
                     model_yes: np.ndarray, backup_yes: np.ndarray,
                     inflight: int = 0,
                     per_tenant: Optional[Dict[str, int]] = None,
                     per_tenant_stages: Optional[
                         Dict[str, Tuple[int, int, int, int]]] = None):
        """One fused dispatch. Stage arrays are the VALID slice only;
        ``inflight`` is the number of OTHER batches still in flight at
        retirement (> 0 means the async double buffer overlapped);
        ``per_tenant`` breaks the valid rows down by owning tenant when
        one grouped dispatch carried several tenants' rows (defaults to
        attributing everything to ``tenant``); ``per_tenant_stages``
        additionally breaks the stage-positive counts down per tenant
        as ``(rows, model_pos, fixup_pos, final_pos)`` tuples — when
        omitted, the whole batch's stage sums are attributed to
        ``tenant``."""
        t = self.totals
        model_pos = int(np.asarray(model_yes).sum())
        fixup_pos = int(np.asarray(backup_yes).sum())
        final_pos = int(np.asarray(answers).sum())
        t.queries += int(n_valid)
        t.batches += 1
        t.padded_rows += int(bucket)
        t.model_pos += model_pos
        t.fixup_pos += fixup_pos
        t.final_pos += final_pos
        if inflight > 0:
            t.overlapped += 1
        if per_tenant is None:
            per_tenant = {tenant: int(n_valid)}
        if len(per_tenant) > 1:
            t.grouped += 1
        for name, n in per_tenant.items():
            self.per_tenant[name] = self.per_tenant.get(name, 0) + int(n)
        if per_tenant_stages is None:
            per_tenant_stages = {tenant: (int(n_valid), model_pos,
                                          fixup_pos, final_pos)}
        for name, (rows, mp, fp, pp) in per_tenant_stages.items():
            self.tenant(name).record(int(rows), int(mp), int(fp),
                                     int(pp))
        self.batch_latency.record(latency_s)
        self.last_bucket = int(bucket)

    def record_request(self, latency_s: float):
        self.totals.requests += 1
        self.request_latency.record(latency_s)

    def record_queue_time(self, latency_s: float):
        """Submit -> FIRST dispatch wait for one request (recorded when
        the scheduler first dispatches any of the request's rows)."""
        self.queue_time.record(latency_s)

    def record_transition(self, tenant: str,
                          frm: Optional[TenantState],
                          to: TenantState):
        """One tenant lifecycle transition (the registry's
        ``on_transition`` hook points here)."""
        self.lifecycle[to] += 1
        self.lifecycle_events.append((tenant, frm, to))

    def record_reload(self, latency_s: float):
        """One completed zero-drain hot-reload (swap latency = admit
        call time: hydrate + place + install)."""
        self.totals.reloads += 1
        self.reload_latency.record(latency_s)

    def record_shed(self, rows: int) -> None:
        """Rows refused at submit by ``max_queued_rows`` backpressure."""
        self.totals.shed_rows += int(rows)

    def record_deadline_expired(self) -> None:
        """One request retired with ``DeadlineExceeded``."""
        self.totals.deadline_expired += 1

    def record_hydration_retry(self) -> None:
        """One transient hydration failure that will be retried."""
        self.totals.hydration_retries += 1

    def record_checksum_failure(self) -> None:
        """One checkpoint load rejected by CRC verification."""
        self.totals.checksum_failures += 1

    def set_degraded_tenants(self, n: int) -> None:
        """Gauge: live tenants currently in the DEGRADED state."""
        self.degraded_tenants = int(n)

    def reset_tenant_baseline(self, tenant: str) -> None:
        """Restart a tenant's drift baseline (called on hot-reload)."""
        ts = self.tenants.get(tenant)
        if ts is not None:
            ts.reset_baseline()

    def transitions_of(self, tenant: str
                       ) -> Tuple[Tuple[Optional[TenantState],
                                        TenantState], ...]:
        """The (frm, to) transitions recorded for one tenant, oldest
        first (bounded by the event-log window)."""
        return tuple((frm, to) for t, frm, to in self.lifecycle_events
                     if t == tenant)

    # ----------------------------------------------------------- readout
    def tenant_snapshot(self, tenant: str) -> Dict[str, float]:
        """One tenant's stage-rate / drift snapshot (empty-tenant
        snapshot — all zeros — when the tenant has served no rows)."""
        ts = self.tenants.get(tenant)
        return (ts or TenantStats()).snapshot()

    def snapshot(self) -> Dict[str, float]:
        t = self.totals
        now = self._clock()
        elapsed = max(now - self.t_start, 1e-9)
        last_t, last_q = self._last_snap
        self._last_snap = (now, t.queries)
        q = max(t.queries, 1)
        out = {
            "queries": float(t.queries),
            "batches": float(t.batches),
            "qps": t.queries / elapsed,
            "qps_interval": (t.queries - last_q)
            / max(now - last_t, 1e-9),
            "batch_occupancy": (t.queries / t.padded_rows
                                if t.padded_rows else 0.0),
            "model_pos_rate": t.model_pos / q,
            "fixup_hit_rate": t.fixup_pos / q,
            "positive_rate": t.final_pos / q,
            "tenants_served": float(len(self.per_tenant)),
            "overlapped_batches": float(t.overlapped),
            "grouped_batches": float(t.grouped),
            "reloads": float(t.reloads),
            "arena_tenants_int8": float(self.arena_tenants_int8),
            "arena_tenants_fp32": float(self.arena_tenants_fp32),
            "arena_tenants_int4": float(self.arena_tenants_int4),
            # reliability counters + the live degraded gauge
            "shed_rows": float(t.shed_rows),
            "deadline_expired": float(t.deadline_expired),
            "hydration_retries": float(t.hydration_retries),
            "checksum_failures": float(t.checksum_failures),
            "degraded_tenants": float(self.degraded_tenants),
            "max_drift_score": max(
                (ts.drift_score for ts in self.tenants.values()),
                default=0.0),
        }
        for state, n in self.lifecycle.items():
            out[f"lifecycle_{state.value}"] = float(n)
        out.update(self.batch_latency.summary("batch_"))
        out.update(self.request_latency.summary("request_"))
        out.update(self.reload_latency.summary("reload_"))
        out.update(self.queue_time.summary("queue_", scale=1e3))
        return out

    def log_to(self, logger: MetricsLogger, step: int = 0) -> Dict:
        return logger.log(step, **self.snapshot())
