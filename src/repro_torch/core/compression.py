"""Lossless input compression for (multidimensional) learned Bloom filters.

The paper's contribution (§3.2): a column with ``v`` distinct values is split
into ``ns`` subcolumns by repeated integer division. With divisor
``sv_d = ceil(v ** (1/ns))`` a value ``x`` becomes ``(x // sv_d, x % sv_d)``;
for ``ns > 2`` the quotient is split again with ``max_vid = max_sv_q``.
The map is bijective on ``[0, v)`` — *lossless* — and the total input
dimensionality drops from ``O(v)`` to ``O(ns * v**(1/ns))``.

Accounting conventions (reverse-engineered to EXACTLY reproduce the paper's
Table 1 "Input dim" column, verified for all five airplane/DMV thetas):

* an uncompressed column contributes ``v`` input dims;
* each subcolumn of a compressed column contributes ``card + 1`` dims — the
  ``+1`` is a dedicated wildcard slot (wildcards of uncompressed columns
  reuse id 0 of the original ``v`` slots);
* subcolumn cardinalities for ``ns = 2``: quotient ``ceil(v / sv_d)``,
  remainder ``sv_d``.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence, Tuple

import numpy as np
import torch

WILDCARD = 0  # id 0 of every *original* column doubles as the wildcard value


@dataclasses.dataclass(frozen=True)
class ColumnPlan:
    """Compression plan for one column."""

    v: int                      # original cardinality (incl. the wildcard id)
    ns: int                     # number of subcolumns; 1 = uncompressed
    divisors: Tuple[int, ...]   # applied low-to-high; empty when ns == 1
    sub_cards: Tuple[int, ...]  # cardinality per subcolumn, quotient-first

    @property
    def compressed(self) -> bool:
        return self.ns > 1

    @property
    def table_rows(self) -> Tuple[int, ...]:
        """Embedding-table rows per subcolumn (+1 wildcard slot if split)."""
        if not self.compressed:
            return (self.v,)
        return tuple(c + 1 for c in self.sub_cards)

    @property
    def input_dims(self) -> int:
        return int(sum(self.table_rows))

    @property
    def wildcard_ids(self) -> Tuple[int, ...]:
        """Wildcard id per subcolumn (the extra slot / id 0 if unsplit)."""
        if not self.compressed:
            return (WILDCARD,)
        return tuple(self.sub_cards)  # the +1 slot sits at index ``card``


def plan_column(v: int, theta: int, ns: int) -> ColumnPlan:
    """Paper §3.2: split iff v > theta; divisor = ceil(cur ** (1/remaining))."""
    if ns < 2 or v <= theta:
        return ColumnPlan(v=v, ns=1, divisors=(), sub_cards=())
    divisors = []
    rem_cards = []
    cur = v
    remaining = ns
    while remaining > 1:
        d = int(math.ceil(cur ** (1.0 / remaining)))
        d = max(d, 2)
        divisors.append(d)
        rem_cards.append(d)                   # remainder subcolumn
        cur = int(math.ceil(cur / d))         # quotient becomes new column
        remaining -= 1
    sub_cards = tuple([cur] + rem_cards[::-1])  # quotient-first ordering
    return ColumnPlan(v=v, ns=ns, divisors=tuple(divisors),
                      sub_cards=sub_cards)


@dataclasses.dataclass(frozen=True)
class CompressionPlan:
    """Whole-relation plan: one ColumnPlan per column."""

    columns: Tuple[ColumnPlan, ...]
    theta: int
    ns: int

    @property
    def n_columns(self) -> int:
        return len(self.columns)

    @property
    def n_subcolumns(self) -> int:
        return sum(max(c.ns, 1) for c in self.columns)

    @property
    def input_dim(self) -> int:
        """The paper's Table 1 'Input dim' column — exact."""
        return int(sum(c.input_dims for c in self.columns))

    @property
    def table_rows(self) -> Tuple[int, ...]:
        rows: list = []
        for c in self.columns:
            rows.extend(c.table_rows)
        return tuple(rows)

    @property
    def n_compressed(self) -> int:
        return sum(1 for c in self.columns if c.compressed)


def make_plan(cardinalities: Sequence[int], theta: int,
              ns: int = 2) -> CompressionPlan:
    return CompressionPlan(
        columns=tuple(plan_column(int(v), theta, ns) for v in cardinalities),
        theta=int(theta), ns=int(ns))


# ------------------------------------------------------------------ codec

def _encode_column(x, plan: ColumnPlan, where):
    """x: (...,) int ids of one column -> list of ns subvalue arrays.

    Wildcards (id 0) map to every subcolumn's dedicated wildcard slot.
    ``where`` is ``torch.where`` or ``np.where``; ``%`` and ``//`` floor
    in both, as in the reference.
    """
    if not plan.compressed:
        return [x]
    is_wild = x == WILDCARD
    subs = []
    cur = x
    for d in plan.divisors:
        subs.append(where(is_wild, plan.sub_cards[len(plan.divisors) -
                                                  len(subs)],
                          cur % d))
        cur = cur // d
    subs.append(where(is_wild, plan.sub_cards[0], cur))
    return subs[::-1]  # quotient-first, matching sub_cards ordering


def _decode_column(subs, plan: ColumnPlan):
    if not plan.compressed:
        return subs[0]
    # quotient-first: x = ((q * d_{k-1} + r_{k-1}) * d_{k-2} + ...)
    cur = subs[0]
    is_wild = subs[0] == plan.sub_cards[0]
    for sub, d in zip(subs[1:], plan.divisors[::-1]):
        cur = cur * d + sub
    return torch.where(is_wild, WILDCARD, cur)


def encode(ids, plan: CompressionPlan) -> torch.Tensor:
    """ids: (..., n_columns) int32 -> (..., n_subcolumns) int32 (lossless)."""
    ids = torch.as_tensor(ids)
    outs = []
    for i, col in enumerate(plan.columns):
        outs.extend(_encode_column(ids[..., i], col, torch.where))
    return torch.stack(outs, dim=-1).to(torch.int32)


def decode(subs, plan: CompressionPlan) -> torch.Tensor:
    """Inverse of :func:`encode` — proves losslessness."""
    subs = torch.as_tensor(subs)
    outs = []
    k = 0
    for col in plan.columns:
        n = max(col.ns, 1)
        outs.append(_decode_column([subs[..., k + j] for j in range(n)], col))
        k += n
    return torch.stack(outs, dim=-1).to(torch.int32)


def encode_np(ids: np.ndarray, plan: CompressionPlan) -> np.ndarray:
    """NumPy twin of :func:`encode` for the host-side data pipeline."""
    outs = []
    for i, col in enumerate(plan.columns):
        outs.extend(_encode_column(ids[..., i], col, np.where))
    return np.stack(outs, axis=-1).astype(np.int32)
