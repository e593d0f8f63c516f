"""Micro-batching scheduler: admission queue, padding buckets, dispatch.

Requests (a tenant id + a block of raw-id rows) enter per-tenant FIFO
queues; each ``step()`` coalesces one tenant's waiting rows into one
dispatch, padded up to a fixed bucket size (padding rows are
all-wildcard and sliced off before answers are scattered back). Tenants
take dispatches round-robin, so sustained load from one tenant cannot
starve late arrivals. Rows beyond the largest bucket stay queued for the
next step (bounded per-dispatch latency).

``step()`` is split into a host half (**prepare**: pick the tenant, pop
row spans, pad into a bucket-sized batch) and a device half
(**dispatch**: copy the batch to the tenant's device and run its
executor). Dispatch is synchronous in this slice: each batch retires —
the host blocks on its answers and scatters them — before the next is
prepared. The async double buffer (``DispatchConfig.async_dispatch``)
and group-aware megabatch coalescing are not ported yet.

Completion is a futures surface: :class:`QueryFuture` (``result``,
``exception``, bulk :func:`wait_all`); ``result()`` drives ``step()``
until THAT request retires. Admission is lifecycle-gated (SERVING or
DEGRADED tenants only). Reliability, as in the reference: per-request
queue-wait deadlines (:class:`DeadlineExceeded`), ``max_queued_rows``
backpressure (:class:`Overloaded`), a dispatch watchdog
(``runtime.fault.StepTimer`` + ``dispatch_timeout_s``), and
dispatch-site fault injection that requeues the prepared spans.
Observability: one tracer span per stage (``prepare`` / ``dispatch`` /
``device_block`` / ``scatter_retire``) plus a ``device_compute`` span on
a synthetic ``device`` track.
"""
from __future__ import annotations

import collections
import dataclasses
import itertools
import time
from typing import Deque, Dict, Iterable, List, Optional, Sequence, Set, \
    Tuple

import numpy as np
import torch

from repro_torch.runtime.fault import StepTimer
from repro_torch.runtime.trace import NULL_TRACER, Tracer
from repro_torch.serve_filter import executors
from repro_torch.serve_filter.config import DEFAULT_BUCKETS, TenantState
from repro_torch.serve_filter.faults import (NULL_INJECTOR, DeadlineExceeded,
                                             FaultInjector, FilterServeError,
                                             InjectedFault, Overloaded,
                                             ReliabilityConfig)
from repro_torch.serve_filter.plan import not_ported
from repro_torch.serve_filter.registry import FilterEntry, FilterRegistry
from repro_torch.serve_filter.stats import ServeStats


def bucket_for(n: int, buckets: Sequence[int]) -> int:
    """Smallest bucket >= n (n must not exceed the largest bucket)."""
    for b in buckets:
        if n <= b:
            return b
    raise ValueError(f"batch of {n} exceeds largest bucket {buckets[-1]}")


@dataclasses.dataclass(slots=True)
class QueryRequest:
    """One admitted query block. The result arrays (``answers``,
    ``model_yes``, ``backup_yes``) are owned by the scheduler and must
    be treated as READ-ONLY: single-span requests receive zero-copy
    views of the batch output (non-writeable), multi-span requests a
    private buffer — copy before mutating."""
    rid: int
    tenant: str
    ids: np.ndarray                       # (n, n_cols) int32 raw ids
    t_submit: float
    t_first_dispatch: Optional[float] = None  # queue time endpoint
    answers: Optional[np.ndarray] = None  # (n,) bool when done
    model_yes: Optional[np.ndarray] = None
    backup_yes: Optional[np.ndarray] = None
    t_done: Optional[float] = None
    error: Optional[str] = None           # set when failed (e.g. eviction)
    error_cls: Optional[type] = None      # typed failure (DeadlineExceeded)
    t_deadline: Optional[float] = None    # absolute budget (clock domain)
    future: Optional["QueryFuture"] = None  # resolved at retire time

    @property
    def done(self) -> bool:
        """Fully answered (or failed) — NOT merely partially scattered:
        a multi-dispatch request stays pending until its last rows land.
        """
        return self.t_done is not None

    def _complete(self, t_done: float, error: Optional[str] = None,
                  error_cls: Optional[type] = None) -> None:
        """Mark done (once) and resolve the attached future, if any."""
        if self.t_done is None:
            if error is not None:
                self.error = error
                self.error_cls = error_cls
            self.t_done = t_done
        if self.future is not None:
            self.future._resolve()

    def _raise_type(self) -> type:
        return self.error_cls or FilterServeError


class QueryFuture:
    """Completion handle for one submitted query block.

    Serving is single-threaded, so the future is also the pump:
    ``result()``/``exception()`` drive ``scheduler.step()`` until THIS
    request retires — batches ahead of it in ring order get dispatched,
    but every other queued request stays queued. ``done`` is a METHOD
    (``concurrent.futures`` idiom). After resolution ``answers`` /
    ``model_yes`` / ``backup_yes`` expose the scheduler-owned result
    arrays (read-only — see ``QueryRequest``).
    """

    def __init__(self, request: QueryRequest, scheduler: "QueryScheduler"):
        self._request = request
        self._scheduler = scheduler
        self._resolved = request.done       # zero-row fast path
        request.future = self

    def _resolve(self) -> None:
        """Called by the scheduler the instant the request retires (or
        fails) — the ONLY thing that completes a future: ``done()`` and
        the waiters observe this flag, not the request's fields."""
        self._resolved = True

    # ------------------------------------------------------------- state
    @property
    def tenant(self) -> str:
        return self._request.tenant

    @property
    def request(self) -> QueryRequest:
        """The underlying request (scheduler-internal surface)."""
        return self._request

    def done(self) -> bool:
        return self._resolved

    @property
    def error(self) -> Optional[str]:
        return self._request.error

    @property
    def answers(self) -> Optional[np.ndarray]:
        return self._request.answers

    @property
    def model_yes(self) -> Optional[np.ndarray]:
        return self._request.model_yes

    @property
    def backup_yes(self) -> Optional[np.ndarray]:
        return self._request.backup_yes

    # -------------------------------------------------------- completion
    def _wait(self, deadline: Optional[float]) -> None:
        while not self._resolved:
            if deadline is not None and time.monotonic() >= deadline:
                raise TimeoutError(
                    f"request {self._request.rid} (tenant "
                    f"{self._request.tenant!r}) not retired in time")
            try:
                progressed = self._scheduler.step()
            except InjectedFault:
                # a chaos-injected dispatch fault escaped the pump
                # (non-transient classification): with no timeout we
                # re-raise — the waiter must not spin forever — but a
                # bounded wait keeps driving; the spans were requeued
                if deadline is None:
                    raise
                continue
            if self._resolved:
                # the step that resolved THIS future (e.g. by expiring
                # its deadline) may also be the drained step — check
                # resolution before judging progress
                break
            if not progressed:
                # nothing queued, nothing in flight, yet unresolved:
                # the rows were lost upstream — fail loudly
                raise FilterServeError(
                    "scheduler drained without resolving this future")

    def result(self, timeout: Optional[float] = None) -> np.ndarray:
        """Block (driving the scheduler) until this request retires;
        return its (n,) bool answers or raise its failure (typed:
        ``DeadlineExceeded`` for an expired request, ``FilterServeError``
        otherwise). ``timeout`` bounds the drive loop itself — a wedged
        scheduler surfaces as ``TimeoutError`` instead of a hang."""
        self._wait(None if timeout is None
                   else time.monotonic() + timeout)
        if self._request.error is not None:
            raise self._request._raise_type()(self._request.error)
        return self._request.answers

    def exception(self, timeout: Optional[float] = None
                  ) -> Optional[Exception]:
        """Like :meth:`result`, but return the failure (or None)."""
        self._wait(None if timeout is None
                   else time.monotonic() + timeout)
        if self._request.error is not None:
            return self._request._raise_type()(self._request.error)
        return None


def wait_all(futures: Iterable[QueryFuture],
             timeout: Optional[float] = None) -> List[QueryFuture]:
    """Drive the scheduler until every future is resolved (one shared
    ``timeout`` across the batch); returns the futures for chaining.
    Failures surface when each future's ``result()`` is read — a failed
    request does not abort the rest of the batch here."""
    futures = list(futures)
    deadline = None if timeout is None else time.monotonic() + timeout
    for fut in futures:
        fut._wait(deadline)
    return futures


@dataclasses.dataclass(slots=True)
class _Prepared:
    """Host half of one dispatch: padded batch + scatter plan."""
    tenant: str
    entry: FilterEntry
    take: List[Tuple[QueryRequest, int, int]]   # (request, row offset, rows)
    span_pos: List[int]                         # per-span batch position
    batch: np.ndarray                           # (bucket, n_cols) padded
    bucket: int
    n_total: int                                # valid rows
    seq: int = 0                                # batch sequence (tracing)


class QueryScheduler:
    def __init__(self, registry: FilterRegistry,
                 buckets: Sequence[int] = DEFAULT_BUCKETS,
                 stats: Optional[ServeStats] = None,
                 clock=time.perf_counter, *,
                 async_dispatch: bool = False,
                 tracer: Optional[Tracer] = None,
                 injector: FaultInjector = NULL_INJECTOR,
                 reliability: ReliabilityConfig = ReliabilityConfig()):
        if async_dispatch:
            raise not_ported("async double-buffered dispatch",
                             "1 item 5 (CUDA streams and events)")
        self.registry = registry
        self.buckets = tuple(sorted(int(b) for b in buckets))
        self.stats = stats or ServeStats()
        self.tracer = tracer if tracer is not None else NULL_TRACER
        self._clock = clock
        self._rid = itertools.count()
        self._seq = itertools.count()       # batch sequence, for traces
        self.injector = injector
        self.max_queued_rows = reliability.max_queued_rows
        self.dispatch_timeout_s = reliability.dispatch_timeout_s
        # dispatch watchdog: relative stragglers (trailing-median) plus
        # the absolute dispatch_timeout_s bound counted in stuck_batches
        self.watchdog = StepTimer()
        self.stuck_batches = 0
        self.dispatch_faults = 0            # injected dispatch faults seen
        self._has_deadlines = False
        # per-tenant FIFO of (request, first row not yet taken)
        self._queues: Dict[str, Deque[Tuple[QueryRequest, int]]] = \
            collections.defaultdict(collections.deque)
        self._order: Deque[str] = collections.deque()   # round-robin ring
        self._order_set: Set[str] = set()               # O(1) membership

    # ------------------------------------------------------------ intake
    def submit(self, tenant: str, ids: np.ndarray,
               deadline_ms: Optional[float] = None) -> QueryRequest:
        """Admit one request; rows may exceed the largest bucket (they
        are answered across several dispatches). ``deadline_ms`` bounds
        how long the rows may wait QUEUED."""
        return self.submit_many(((tenant, ids),),
                                deadline_ms=deadline_ms)[0]

    def submit_many(self, items,
                    deadline_ms: Optional[float] = None
                    ) -> List[QueryRequest]:
        """Bulk admission: ``[(tenant, ids), ...]`` -> requests, in
        order. Every item is validated before any is queued; with
        ``max_queued_rows`` set, a call that would exceed it is rejected
        whole with :class:`Overloaded`."""
        registry = self.registry
        checked = []
        new_rows = 0
        for tenant, ids in items:
            entry = registry.peek(tenant)
            if entry is None:
                raise KeyError(f"unknown tenant {tenant!r}")
            if entry.state not in (TenantState.SERVING,
                                   TenantState.DEGRADED):
                raise FilterServeError(
                    f"tenant {tenant!r} is {entry.state.value}, not "
                    "serving — submissions rejected")
            ids = np.asarray(ids, np.int32)
            if ids.ndim == 1:
                ids = ids[None, :]
            if ids.shape[-1] != entry.n_cols:
                raise ValueError(
                    f"tenant {tenant!r} expects {entry.n_cols} columns, "
                    f"got {ids.shape[-1]}")
            checked.append((tenant, entry, ids))
            new_rows += ids.shape[0]
        if (self.max_queued_rows is not None and new_rows
                and self.pending_rows + new_rows > self.max_queued_rows):
            self.stats.record_shed(new_rows)
            raise Overloaded(
                f"queue full: {self.pending_rows} rows queued, admitting "
                f"{new_rows} would exceed max_queued_rows="
                f"{self.max_queued_rows}")
        t_deadline = (None if deadline_ms is None
                      else self._clock() + float(deadline_ms) / 1e3)
        if t_deadline is not None:
            self._has_deadlines = True
        out: List[QueryRequest] = []
        for tenant, entry, ids in checked:
            # LRU touch: a tenant with queued work must not be the next
            # budget-eviction victim
            entry.last_used = registry.tick()
            req = QueryRequest(rid=next(self._rid), tenant=tenant, ids=ids,
                               t_submit=self._clock(),
                               t_deadline=t_deadline)
            if ids.shape[0] == 0:
                req.answers = np.zeros(0, bool)
                req.model_yes = np.zeros(0, bool)
                req.backup_yes = np.zeros(0, bool)
                req.t_done = req.t_submit
            else:
                self._queues[tenant].append((req, 0))
                if tenant not in self._order_set:
                    self._order.append(tenant)
                    self._order_set.add(tenant)
            out.append(req)
        return out

    @property
    def pending_rows(self) -> int:
        """Rows admitted but not yet taken into a dispatch."""
        return sum(req.ids.shape[0] - off
                   for q in self._queues.values() for req, off in q)

    def pending_rows_for(self, tenant: str) -> int:
        """Rows queued (not yet dispatched) for ONE tenant."""
        return sum(req.ids.shape[0] - off
                   for req, off in self._queues.get(tenant, ()))

    def cancel_tenant(self, tenant: str, reason: str) -> None:
        """Fail a tenant's QUEUED requests now (the force-retire path)."""
        self._fail_tenant(tenant, reason)

    # ---------------------------------------------------------- dispatch
    def step(self) -> bool:
        """Prepare, dispatch and retire one batch. Returns False only
        when nothing is queued (expiring a deadline counts as progress)."""
        expired = 0
        if self._has_deadlines:
            expired = self._expire_deadlines()
        with self.tracer.span("prepare") as sp:
            prep = self._prepare()
            if sp and prep is not None:
                sp.args.update(seq=prep.seq, tenant=prep.tenant,
                               bucket=prep.bucket, rows=prep.n_total)
        if prep is None:
            return expired > 0
        try:
            outputs, t_dispatch = self._dispatch(prep)
        except InjectedFault:
            # a chaos-injected transient dispatch fault: the spans go
            # back to the queue heads and the step counts as progress
            self._requeue(prep)
            self.dispatch_faults += 1
            return True
        except Exception:
            # dispatch never completed: keep the rows answerable
            self._requeue(prep)
            raise
        self._retire(prep, outputs, t_dispatch)
        return True

    def _expire_deadlines(self) -> int:
        """Retire still-QUEUED requests whose deadline passed (their
        futures raise :class:`DeadlineExceeded`); requests with rows
        already dispatched are exempt. Returns how many expired."""
        now = self._clock()
        live_deadlines = False
        n_expired = 0
        for tenant in list(self._queues):
            kept: Deque[Tuple[QueryRequest, int]] = collections.deque()
            for req, off in self._queues[tenant]:
                if (req.t_deadline is not None
                        and req.t_first_dispatch is None
                        and now >= req.t_deadline):
                    req._complete(
                        now, error=(
                            f"deadline exceeded: request {req.rid} "
                            f"(tenant {tenant!r}) waited "
                            f"{(now - req.t_submit) * 1e3:.1f}ms queued"),
                        error_cls=DeadlineExceeded)
                    self.stats.record_deadline_expired()
                    n_expired += 1
                else:
                    if req.t_deadline is not None:
                        live_deadlines = True
                    kept.append((req, off))
            if kept:
                self._queues[tenant] = kept
            else:
                del self._queues[tenant]
        self._has_deadlines = live_deadlines
        return n_expired

    def _prepare(self) -> Optional[_Prepared]:
        """Host half: pop up to one largest-bucket of the next tenant's
        rows (maybe splitting a request) and pad them into a batch."""
        tenant = self._next_tenant()
        if tenant is None:
            return None
        entry = self.registry.get(tenant)
        queue = self._queues[tenant]
        cap = self.buckets[-1]
        take: List[Tuple[QueryRequest, int, int]] = []
        span_pos: List[int] = []
        pos = 0
        while queue and pos < cap:
            req, off = queue[0]
            n = min(req.ids.shape[0] - off, cap - pos)
            if off + n < req.ids.shape[0]:
                queue[0] = (req, off + n)     # budget hit mid-request
            else:
                queue.popleft()
            take.append((req, off, n))
            span_pos.append(pos)
            pos += n
        if not queue:
            self._queues.pop(tenant, None)
        bucket = bucket_for(pos, self.buckets)
        batch = np.zeros((bucket, entry.n_cols), np.int32)  # pad = wildcard
        batch[:pos] = np.concatenate(
            [req.ids[off:off + n] for req, off, n in take])
        return _Prepared(tenant=tenant, entry=entry, take=take,
                         span_pos=span_pos, batch=batch, bucket=bucket,
                         n_total=pos, seq=next(self._seq))

    def _dispatch(self, prep: _Prepared):
        """Device half: copy the batch to the tenant's device and launch
        its program (the returned tensors are not synchronized). Records
        each request's queue time the first time any of its rows goes
        out."""
        self.injector.check("dispatch", prep.tenant)
        with self.tracer.span("dispatch", seq=prep.seq,
                              bucket=prep.bucket) as sp:
            compiles_before = executors.compile_count()
            ids = torch.from_numpy(prep.batch).to(prep.entry.device)
            outputs = prep.entry.run(ids)
            if sp and executors.compile_count() > compiles_before:
                sp.args["compiled"] = True
        t = self._clock()
        for req, _, _ in prep.take:
            if req.t_first_dispatch is None:
                req.t_first_dispatch = t
                self.stats.record_queue_time(t - req.t_submit)
        return outputs, t

    def _requeue(self, prep: _Prepared) -> None:
        """Restore a prepared-but-never-dispatched batch's spans to the
        front of the tenant's queue, in their original order."""
        queue = self._queues.setdefault(prep.tenant, collections.deque())
        for req, off, n in reversed(prep.take):
            if queue and queue[0][0] is req:    # cap-split head entry
                queue[0] = (req, off)
            else:
                queue.appendleft((req, off))
        if prep.tenant not in self._order_set:
            self._order.append(prep.tenant)
            self._order_set.add(prep.tenant)

    def _retire(self, prep: _Prepared, outputs, t_dispatch: float) -> None:
        """Block on a dispatched batch, scatter answers back, complete
        fully-answered requests, record stats."""
        tracer = self.tracer
        try:
            with tracer.span("device_block", seq=prep.seq), \
                    self.watchdog:
                # one device-to-host copy for the three stage vectors
                full = torch.stack(outputs).cpu().numpy()
        except Exception as e:
            # the computation itself failed: the rows are gone from the
            # queue, so fail their requests rather than hang their owners
            t = self._clock()
            for req, _, _ in prep.take:
                req._complete(t, error=f"dispatch failed: {e!r}")
            raise
        full_ans, full_model, full_backup = full
        if (self.dispatch_timeout_s is not None and self.watchdog.times
                and self.watchdog.times[-1] > self.dispatch_timeout_s):
            self.stuck_batches += 1
        t_block_end = self._clock()
        latency = t_block_end - t_dispatch
        tracer.add("device_compute", t_dispatch, t_block_end,
                   track="device", cat="device",
                   args={"seq": prep.seq, "bucket": prep.bucket})
        with tracer.span("scatter_retire", seq=prep.seq):
            t_done = self._clock()
            for p, (req, off, n) in zip(prep.span_pos, prep.take):
                if off == 0 and n == req.ids.shape[0]:
                    # whole request in this span: zero-copy views
                    req.answers = full_ans[p:p + n]
                    req.model_yes = full_model[p:p + n]
                    req.backup_yes = full_backup[p:p + n]
                else:
                    if req.answers is None:
                        m = req.ids.shape[0]
                        req.answers = np.zeros(m, bool)
                        req.model_yes = np.zeros(m, bool)
                        req.backup_yes = np.zeros(m, bool)
                    req.answers[off:off + n] = full_ans[p:p + n]
                    req.model_yes[off:off + n] = full_model[p:p + n]
                    req.backup_yes[off:off + n] = full_backup[p:p + n]
                if off + n >= req.ids.shape[0]:  # last span: req done
                    req._complete(t_done)
                    self.stats.record_request(t_done - req.t_submit)
            n = prep.n_total
            self.stats.record_batch(
                prep.tenant, n, prep.bucket, latency, full_ans[:n],
                full_model[:n], full_backup[:n])

    def _next_tenant(self) -> Optional[str]:
        while self._order:
            tenant = self._order[0]
            if not self._queues.get(tenant):
                self._order.popleft()
                self._order_set.discard(tenant)
                continue
            if tenant not in self.registry:
                self._fail_tenant(tenant, f"tenant {tenant!r} evicted "
                                  "with requests queued")
                self._order.popleft()
                self._order_set.discard(tenant)
                continue
            # rotate so tenants with sustained load share dispatches
            self._order.rotate(-1)
            return tenant
        return None

    def _fail_tenant(self, tenant: str, reason: str) -> None:
        """Retire a tenant's queued requests with an error."""
        t = self._clock()
        for req, _ in self._queues.pop(tenant, ()):
            req._complete(t, error=reason)

    def run_until_drained(self, max_steps: int = 100_000) -> int:
        """Steps until the queues are empty. Returns the step count."""
        steps = 0
        while steps < max_steps and self.step():
            steps += 1
        return steps
