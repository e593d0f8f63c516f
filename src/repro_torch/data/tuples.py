"""Synthetic multidimensional relations + positive/negative samplers.

The paper's datasets (airplane, DMV) are not redistributable; what the
technique's memory behaviour depends on is the *per-column cardinality
profile*, which the paper publishes. We generate relations with exactly
those profiles (Zipf-ish skew, deterministic seed) and follow the paper's
§4 sampling protocol:

* positives: random records, optionally with values replaced by wildcards;
* negatives: random non-co-occurring value combinations (rejection-sampled
  against the record set), optionally with a wildcard.

Wildcard id is 0 in every original column (see core/compression.py).
"""
from __future__ import annotations

import dataclasses
from typing import Optional, Sequence, Tuple

import numpy as np

from repro_torch.core import compression as comp


@dataclasses.dataclass
class TupleDataset:
    cards: Tuple[int, ...]
    records: np.ndarray            # (n_records, n_cols) int32, ids in [1, v)
    _key_set: Optional[set] = None

    @property
    def n_cols(self) -> int:
        return len(self.cards)

    def key_set(self) -> set:
        if self._key_set is None:
            self._key_set = {tuple(r) for r in self.records.tolist()}
        return self._key_set

    def contains(self, rows: np.ndarray) -> np.ndarray:
        ks = self.key_set()
        return np.array([tuple(r) in ks for r in rows.tolist()], dtype=bool)


def synthesize(cards: Sequence[int], n_records: int, seed: int = 0,
               zipf_a: float = 1.3, noise: float = 0.35) -> TupleDataset:
    """Zipf-distributed ids per column, correlated across columns.

    ids are in [1, v): id 0 is reserved for the wildcard. Cross-column
    correlation (records share a latent "entity" rank) makes membership
    learnable, mirroring real relations. ``noise`` sets how much a
    column deviates from the shared latent — the benchmark calibrates it
    so the uncompressed LMBF reproduces the paper's accuracy band on the
    real datasets (the real data is not redistributable; DESIGN.md §1).
    """
    rng = np.random.default_rng(seed)
    n_cols = len(cards)
    # latent entity rank in [0,1), shared across columns with noise
    latent = rng.random(n_records)
    cols = []
    for ci, v in enumerate(cards):
        usable = max(int(v) - 1, 1)
        col_noise = rng.random(n_records) * noise
        rank = np.clip(latent * (1.0 - noise) + col_noise, 0, 1 - 1e-9)
        # map rank through a Zipf-ish CDF onto [1, v)
        idx = np.floor((rank ** zipf_a) * usable).astype(np.int64)
        cols.append((idx % usable) + 1)
    recs = np.stack(cols, axis=-1).astype(np.int32)
    return TupleDataset(cards=tuple(int(c) for c in cards), records=recs)


def sample_positives(ds: TupleDataset, n: int, seed: int,
                     wildcard_prob: float = 0.2) -> np.ndarray:
    rng = np.random.default_rng(seed)
    rows = ds.records[rng.integers(0, len(ds.records), size=n)].copy()
    if wildcard_prob > 0:
        mask = rng.random(rows.shape) < wildcard_prob
        # never wildcard out an entire row
        keep = rng.integers(0, ds.n_cols, size=n)
        mask[np.arange(n), keep] = False
        rows[mask] = comp.WILDCARD
    return rows


def sample_negatives(ds: TupleDataset, n: int, seed: int,
                     wildcard_prob: float = 0.1,
                     max_tries: int = 20) -> np.ndarray:
    """Random non-co-occurring combinations (rejection sampled)."""
    rng = np.random.default_rng(seed)
    ks = ds.key_set()
    out = np.zeros((n, ds.n_cols), dtype=np.int32)
    filled = 0
    for _ in range(max_tries):
        if filled >= n:
            break
        m = n - filled
        cand = np.stack(
            [rng.integers(1, max(v, 2), size=m) for v in ds.cards],
            axis=-1).astype(np.int32)
        fresh = np.array([tuple(r) not in ks for r in cand.tolist()])
        take = cand[fresh]
        out[filled:filled + len(take)] = take[:n - filled]
        filled += min(len(take), n - filled)
    if wildcard_prob > 0 and filled:
        mask = rng.random(out.shape) < wildcard_prob
        keep = rng.integers(0, ds.n_cols, size=n)
        mask[np.arange(n), keep] = False
        out[mask] = comp.WILDCARD
    return out[:filled] if filled < n else out


def make_training_set(ds: TupleDataset, n_pos: int, n_neg: int, seed: int,
                      wildcard_prob: float = 0.2):
    """-> (ids (n,cols) int32, labels (n,) float32), shuffled."""
    pos = sample_positives(ds, n_pos, seed, wildcard_prob)
    neg = sample_negatives(ds, n_neg, seed + 1, wildcard_prob * 0.5)
    ids = np.concatenate([pos, neg], axis=0)
    labels = np.concatenate([np.ones(len(pos), np.float32),
                             np.zeros(len(neg), np.float32)])
    rng = np.random.default_rng(seed + 2)
    perm = rng.permutation(len(ids))
    return ids[perm], labels[perm]
