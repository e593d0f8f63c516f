"""Executors: the query program for one :class:`QueryPlan`.

This slice ports the grouping-OFF x local-placement leg of the JAX
package's executor core (``LocalExecutor``): one tenant's arrays on one
device, the pipeline body ``existence.query_stages``, and — when the
plan's probe flavor is ``PROBE_KERNEL`` — the fixup probe routed to the
hand-written CUDA kernel of ``kernels/bloom_query``. Grouped and
sharded executors wait for their slices (ROADMAP Queue 1 items 6, 9).

PyTorch runs eagerly, so there is no traced program to cache; an
executor still records each (plan, bucket) shape it first runs as one
"program", with that first call's wall time as its compile cost — it
carries the lazy ``nvcc`` build of the CUDA kernel and the libraries'
warm-up. Executors are cached per plan and ref-counted by the tenants
that use them, as in the reference, and are stateless with respect to
tenant arrays: every dispatch binds the :class:`PlacedFilter` it is
handed, which is what lets a reload swap arrays under live traffic.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Callable, Dict, Set, Tuple

import torch

from repro_torch.core import bloom, existence
from repro_torch.kernels.bloom_query import ops as bloom_ops
from repro_torch.serve_filter.plan import PROBE_KERNEL, QueryPlan

# ================================================================ telemetry
# Process-global (like the executor cache itself): first-call events per
# (plan label, bucket) and cache hit/miss counters.

_COMPILES: Dict[Tuple[str, int], list] = {}   # (label, bucket) -> [n, sec]
_CACHE_HITS = 0
_CACHE_MISSES = 0

# compile-site fault hook, installed process-globally by a chaos-
# configured server (the executor cache is shared across servers)
_FAULT_INJECTOR = None


def set_fault_injector(injector) -> None:
    """Install (or with ``None`` uninstall) the compile-site injector."""
    global _FAULT_INJECTOR
    _FAULT_INJECTOR = injector


def _record_compile(label: str, bucket: int, seconds: float) -> None:
    ev = _COMPILES.setdefault((label, int(bucket)), [0, 0.0])
    ev[0] += 1
    ev[1] += seconds


def compile_count() -> int:
    return sum(v[0] for v in _COMPILES.values())


def compile_time_total() -> float:
    return sum(v[1] for v in _COMPILES.values())


def cache_stats() -> Tuple[int, int]:
    """(executor-cache hits, misses)."""
    return _CACHE_HITS, _CACHE_MISSES


@dataclasses.dataclass
class PlacedFilter:
    """One tenant's device-resident arrays: the params tree and the
    packed fixup bitset (int32 words) on the plan's device."""
    params: Dict
    bits: torch.Tensor


class Executor:
    """Interface: the query path for one :class:`QueryPlan`."""

    plan: QueryPlan
    fn: Callable                # (params, bits, tau, raw_ids) -> 3-tuple

    def __init__(self):
        self._shapes: Set[int] = set()

    def place(self, index: existence.ExistenceIndex) -> PlacedFilter:
        raise NotImplementedError

    def __call__(self, placed: PlacedFilter, tau, raw_ids: torch.Tensor):
        bucket = int(raw_ids.shape[0])
        first = bucket not in self._shapes
        t0 = time.perf_counter()
        out = self.fn(placed.params, placed.bits, tau, raw_ids)
        if first:
            self._shapes.add(bucket)
            _record_compile(self.plan.describe(), bucket,
                            time.perf_counter() - t0)
            if _FAULT_INJECTOR is not None:
                _FAULT_INJECTOR.check("compile", self.plan.describe())
        return out

    def program_count(self) -> int:
        """(plan x bucket) shapes this executor has run."""
        return len(self._shapes)


class LocalExecutor(Executor):
    """Grouping OFF x local placement: one tenant's arrays on the
    plan's device."""

    def __init__(self, plan: QueryPlan):
        super().__init__()
        self.plan = plan
        self.device = torch.device(plan.placement.device)
        cfg, fp = plan.cfg, plan.fixup_params

        if plan.probe == PROBE_KERNEL:
            def probe(bits, ids):
                return bloom_ops.bloom_query(ids, bits, fp)
        else:
            probe = None

        def fused(params, bits, tau, raw_ids):
            return existence.query_stages(params, cfg, tau, bits, fp,
                                          raw_ids, probe_fn=probe)

        self.fn = fused

    def place(self, index: existence.ExistenceIndex) -> PlacedFilter:
        dev = self.device
        params = {g: {k: t.to(dev) for k, t in leaves.items()}
                  for g, leaves in index.params.items()}
        return PlacedFilter(params=params,
                            bits=bloom.bits_tensor(index.fixup_filter.bits,
                                                   dev))


# --------------------------------------------------------------- registry
# of executors: plan -> Executor, ref-counted by the tenants using it, so
# one registry evicting its last tenant on a plan cannot drop an entry
# another registry still serves.

_EXECUTORS: Dict[QueryPlan, Executor] = {}
_REFS: Dict[QueryPlan, int] = {}


def executor_for(plan: QueryPlan) -> Executor:
    """Build-or-fetch the executor for a plan (cached, no ref taken)."""
    global _CACHE_HITS, _CACHE_MISSES
    ex = _EXECUTORS.get(plan)
    if ex is None:
        _CACHE_MISSES += 1
        ex = _EXECUTORS[plan] = LocalExecutor(plan)
    else:
        _CACHE_HITS += 1
    return ex


def acquire_executor(plan: QueryPlan) -> Executor:
    """:func:`executor_for` + take one reference on the cache entry."""
    ex = executor_for(plan)
    _REFS[plan] = _REFS.get(plan, 0) + 1
    return ex


def release_executor(plan: QueryPlan) -> bool:
    """Drop one reference; the last one forgets the cached executor.
    Returns True when dropped."""
    n = _REFS.get(plan, 0) - 1
    if n > 0:
        _REFS[plan] = n
        return False
    _REFS.pop(plan, None)
    return _EXECUTORS.pop(plan, None) is not None


def compiled_program_count() -> int:
    """(plan x bucket) shapes across cached executors."""
    return sum(ex.program_count() for ex in _EXECUTORS.values())


def clear_executors() -> None:
    """Drop every cached executor (tests / tenant-churn hygiene)."""
    _EXECUTORS.clear()
    _REFS.clear()
