"""Query planning: a frozen, hashable description of HOW a filter runs.

* :class:`Placement` — where a tenant's arrays live. This slice of the
  port has local placement only (one device); mesh-sharded placement is
  ROADMAP Queue 1 item 9.
* :class:`ProbeConfig` — how the fixup Bloom filter is probed: plain
  PyTorch (default) or the hand-written CUDA kernel of
  ``kernels/bloom_query`` (``use_kernel=True``).
* :class:`QueryPlan` — placement + probe flavor + plan shape. Frozen
  and hashable: it IS the executor-cache key.
* :func:`plan_query` — the planner.
"""
from __future__ import annotations

import dataclasses

from repro_torch.core import bloom, lmbf

PROBE_TORCH = "torch"      # core.bloom query (plain PyTorch)
PROBE_KERNEL = "kernel"    # kernels/bloom_query CUDA probe


def not_ported(what: str, item: str) -> NotImplementedError:
    """The error an option of the JAX package raises in this slice."""
    return NotImplementedError(
        f"{what} is not ported to repro_torch yet: ROADMAP Queue {item}")


@dataclasses.dataclass(frozen=True)
class ProbeConfig:
    """How the fixup Bloom filter is probed: plain PyTorch (default) or
    the ``kernels/bloom_query`` CUDA kernel (``use_kernel=True``; on CPU
    tensors the kernel's wrapper runs its plain version)."""
    use_kernel: bool = False


@dataclasses.dataclass(frozen=True)
class Placement:
    """Where a tenant's arrays live: one device (``"cuda:0"``, ``"cpu"``)."""
    device: str = "cuda:0"


@dataclasses.dataclass(frozen=True)
class QueryPlan:
    """Frozen executor-cache key: plan shape, probe flavor, placement."""
    cfg: lmbf.LMBFConfig
    fixup_params: bloom.BloomParams
    probe: str = PROBE_TORCH
    placement: Placement = Placement()

    def __post_init__(self):
        if self.probe not in (PROBE_TORCH, PROBE_KERNEL):
            raise ValueError(f"unknown probe flavor {self.probe!r}")

    @property
    def n_cols(self) -> int:
        return self.cfg.plan.n_columns

    def describe(self) -> str:
        """Short human label for telemetry (compile events, traces)."""
        return (f"{self.probe}/{self.n_cols}c/"
                f"m{self.fixup_params.m_bits}k{self.fixup_params.n_hashes}/"
                f"local[{self.placement.device}]")


def plan_query(cfg: lmbf.LMBFConfig, fixup_params: bloom.BloomParams, *,
               device: str, probe: ProbeConfig = ProbeConfig()) -> QueryPlan:
    """Resolve config + fixup params + target device into a QueryPlan."""
    return QueryPlan(cfg=cfg, fixup_params=fixup_params,
                     probe=PROBE_KERNEL if probe.use_kernel else PROBE_TORCH,
                     placement=Placement(device=str(device)))
