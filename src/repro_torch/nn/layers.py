"""Functional layer ops (the part of ``repro.nn.layers`` the filter
model uses)."""
from __future__ import annotations

import torch


def take_embedding(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Gather rows with ``jnp.take``'s default semantics: ids in
    ``[-rows, 0)`` wrap pythonically, ids outside ``[-rows, rows)`` give
    NaN rows (torch indexing would raise instead)."""
    rows = table.shape[0]
    wrapped = torch.where(ids < 0, ids + rows, ids)
    valid = (wrapped >= 0) & (wrapped < rows)
    g = table[wrapped.clamp(0, rows - 1)]
    return torch.where(valid[..., None], g,
                       torch.full((), float("nan"), dtype=table.dtype,
                                  device=table.device))


def one_hot(ids: torch.Tensor, rows: int, dtype) -> torch.Tensor:
    """``jax.nn.one_hot`` semantics: out-of-range (incl. negative) ids
    give all-zero rows (``F.one_hot`` would raise instead)."""
    cls = torch.arange(rows, device=ids.device)
    return (ids[..., None] == cls).to(dtype)
