"""Fault injection + reliability vocabulary for the serving tier.

Production serving must survive what training's ``runtime/fault.py``
already guards against — slow or corrupted checkpoints, failed
hydrations, stuck dispatches, overload — and the only way to *test*
those paths is to make faults first-class and deterministic. This
module is the vocabulary:

* typed errors (:class:`FilterServeError` and its request-level
  subclasses :class:`DeadlineExceeded` / :class:`Overloaded`, plus the
  transient :class:`InjectedFault` and :class:`CheckpointCorruption`
  re-exported from ``repro_torch.checkpoint``);
* :class:`FaultConfig` — a frozen, seeded description of WHICH named
  sites fail and at WHAT rate;
* :class:`FaultInjector` — the deterministic roller threaded through
  registry / arena / executors / scheduler. Disabled servers share the
  :data:`NULL_INJECTOR` no-op instance (same pattern as
  ``runtime.trace.NULL_TRACER``), so the hot path costs one attribute
  call;
* :class:`ReliabilityConfig` + :func:`backoff_delays` — retry budget
  and the capped-exponential-with-jitter schedule, PURE and seeded so
  tests can pin it.

Determinism contract
====================

Every injection decision is a pure function of ``(seed, site, key,
per-site call count)`` hashed through blake2b — independent of wall
clock, thread timing, and dict order. Two runs with the same config and
the same sequence of ``check()`` calls per site inject the exact same
faults; the chaos suite and the ``--chaos`` bench leg rely on this.
"""
from __future__ import annotations

import dataclasses
import hashlib
import struct
from typing import Dict, Optional, Tuple

from repro_torch.checkpoint.manager import CheckpointCorruption

__all__ = [
    "SITES", "FilterServeError", "DeadlineExceeded", "Overloaded",
    "InjectedFault", "CheckpointCorruption", "FaultConfig",
    "ReliabilityConfig", "FaultInjector", "NULL_INJECTOR",
    "backoff_delays",
]

# The named injection sites threaded through the serving stack.
#   checkpoint_read  registry hydration reading a tenant checkpoint
#   hydrate          index -> arena/executor state build (incl. quant)
#   device_put       arena device materialization / executor placement
#   dispatch         scheduler handing a prepared batch to the device
#   compile          first-call program compilation in the executors
SITES = ("checkpoint_read", "hydrate", "device_put", "dispatch",
         "compile")


class FilterServeError(RuntimeError):
    """Base error for the serving tier (scheduler/registry surfaces)."""


class DeadlineExceeded(FilterServeError):
    """The request's ``deadline_ms`` budget expired before dispatch."""


class Overloaded(FilterServeError):
    """Queue admission refused: ``max_queued_rows`` would be exceeded."""


class InjectedFault(FilterServeError):
    """A transient fault raised by :class:`FaultInjector` at a site."""

    def __init__(self, site: str, key: str, count: int):
        super().__init__(f"injected fault at {site!r} (key={key!r}, "
                         f"call #{count})")
        self.site = site
        self.key = key
        self.count = count


def _validate_rates(rates) -> Tuple[Tuple[str, float], ...]:
    out = []
    for site, rate in sorted(dict(rates).items()):
        if site not in SITES:
            raise ValueError(f"unknown fault site {site!r}; "
                             f"expected one of {SITES}")
        if not 0.0 <= float(rate) <= 1.0:
            raise ValueError(f"fault rate for {site!r} must be in "
                             f"[0, 1], got {rate}")
        out.append((site, float(rate)))
    return tuple(out)


@dataclasses.dataclass(frozen=True)
class FaultConfig:
    """Seeded fault-injection policy (disabled by default).

    ``rates`` maps site name -> probability that one ``check()`` call at
    that site raises :class:`InjectedFault`; accepts a dict or tuple of
    pairs and normalizes to a sorted tuple (keeps the config hashable).
    ``max_faults`` optionally bounds the TOTAL number of injected
    faults, so chaos runs always quiesce.
    """
    enabled: bool = False
    seed: int = 0
    rates: Tuple[Tuple[str, float], ...] = ()
    max_faults: Optional[int] = None

    def __post_init__(self):
        object.__setattr__(self, "rates", _validate_rates(self.rates))
        if self.max_faults is not None and self.max_faults < 0:
            raise ValueError("max_faults must be >= 0")


def _unit_roll(seed: int, *parts) -> float:
    """Deterministic uniform in [0, 1) from blake2b(seed, *parts)."""
    h = hashlib.blake2b(digest_size=8)
    h.update(struct.pack("<q", seed))
    for p in parts:
        h.update(str(p).encode())
        h.update(b"\x00")
    return int.from_bytes(h.digest(), "little") / 2.0 ** 64


class FaultInjector:
    """Deterministic seeded fault roller for the named ``SITES``.

    ``check(site, key)`` either returns quietly or raises
    :class:`InjectedFault`. The decision hashes ``(seed, site, key,
    n)`` where ``n`` is the per-(site, key) call count — stable across
    interleavings of other tenants/sites. ``suspend()``/``resume()``
    gate a chaos storm off for post-chaos verification.
    """

    def __init__(self, config: FaultConfig):
        self.config = config
        self._rates: Dict[str, float] = dict(config.rates)
        self._counts: Dict[Tuple[str, str], int] = {}
        self._suspended = not config.enabled
        self.injected = 0
        self.by_site: Dict[str, int] = {s: 0 for s in SITES}

    @property
    def enabled(self) -> bool:
        return self.config.enabled

    def suspend(self):
        """Stop injecting (post-chaos recovery/verification phases)."""
        self._suspended = True

    def resume(self):
        if self.config.enabled:
            self._suspended = False

    def check(self, site: str, key: str = ""):
        """Roll for ``site``; raise :class:`InjectedFault` on a hit."""
        rate = self._rates.get(site, 0.0)
        if rate <= 0.0:
            return
        ck = (site, key)
        n = self._counts.get(ck, 0)
        self._counts[ck] = n + 1
        if self._suspended:
            return
        cfg = self.config
        if cfg.max_faults is not None and self.injected >= cfg.max_faults:
            return
        if _unit_roll(cfg.seed, site, key, n) < rate:
            self.injected += 1
            self.by_site[site] += 1
            raise InjectedFault(site, key, n)


class _NullInjector(FaultInjector):
    """Shared no-op injector for disabled servers (one instance)."""

    def __init__(self):
        super().__init__(FaultConfig())

    def check(self, site: str, key: str = ""):  # pragma: no cover
        return


NULL_INJECTOR = _NullInjector()


@dataclasses.dataclass(frozen=True)
class ReliabilityConfig:
    """Hydration retry + request deadline/backpressure policy.

    Defaults preserve pre-reliability behavior exactly: no retries, no
    degraded mode, unbounded queue, no dispatch watchdog.

    ``retries``            extra hydration attempts after the first
                           failure (0 = fail fast, the old behavior).
    ``backoff_base_s``     first retry delay.
    ``backoff_mult``       exponential multiplier per attempt.
    ``backoff_cap_s``      delay ceiling (capped exponential).
    ``jitter``             +-fraction of deterministic jitter applied
                           to each delay (seeded, not wall-clock).
    ``attempt_timeout_s``  per-attempt budget: if a FAILED attempt
                           already consumed this much wall time the
                           failure is classified slow-not-transient and
                           retries stop early.
    ``degraded``           exhausted tenants enter ``DEGRADED`` (serve
                           last-good epoch, or backup-Bloom-only when
                           never hydrated) instead of being retired.
    ``max_queued_rows``    scheduler backpressure bound; ``submit``
                           raises :class:`Overloaded` when admission
                           would exceed it (None = unbounded).
    ``dispatch_timeout_s`` dispatch watchdog threshold: a device wait
                           exceeding this is counted as a stuck batch
                           (None = off).
    """
    retries: int = 0
    backoff_base_s: float = 0.05
    backoff_mult: float = 2.0
    backoff_cap_s: float = 2.0
    jitter: float = 0.1
    attempt_timeout_s: Optional[float] = None
    degraded: bool = False
    max_queued_rows: Optional[int] = None
    dispatch_timeout_s: Optional[float] = None

    def __post_init__(self):
        if self.retries < 0:
            raise ValueError("retries must be >= 0")
        if self.backoff_base_s < 0 or self.backoff_cap_s < 0:
            raise ValueError("backoff delays must be >= 0")
        if self.backoff_mult < 1.0:
            raise ValueError("backoff_mult must be >= 1")
        if not 0.0 <= self.jitter <= 1.0:
            raise ValueError("jitter must be in [0, 1]")
        if self.max_queued_rows is not None and self.max_queued_rows <= 0:
            raise ValueError("max_queued_rows must be positive")


def backoff_delays(rel: ReliabilityConfig, seed: int,
                   key: str) -> Tuple[float, ...]:
    """The full deterministic retry schedule for ``(seed, key)``.

    ``delays[i]`` is the sleep before retry ``i``:
    ``min(cap, base * mult**i)`` scaled by ``1 + jitter * (2u - 1)``
    with ``u`` drawn from blake2b — pure, so the hypothesis property
    can assert determinism and the cap without running a server.
    """
    out = []
    for i in range(rel.retries):
        raw = min(rel.backoff_cap_s,
                  rel.backoff_base_s * rel.backoff_mult ** i)
        u = _unit_roll(seed, "backoff", key, i)
        out.append(raw * (1.0 + rel.jitter * (2.0 * u - 1.0)))
    return tuple(out)
