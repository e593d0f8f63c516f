"""Fixup (backup) Bloom filter — restores the zero-false-negative contract.

After training, every positive key the model scores below the decision
threshold ``tau`` is inserted into a classic Bloom filter; queries falling
below ``tau`` consult it. Composite FPR ~= model FPR + (1-model FPR)*BF FPR.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import bloom


@dataclasses.dataclass
class FixupFilter:
    params: bloom.BloomParams
    bits: np.ndarray                # host uint32 words
    n_false_negatives: int

    @property
    def size_mb(self) -> float:
        return self.params.size_mb

    def query(self, ids, device=None) -> torch.Tensor:
        """Plain probe of the host bitset, on ``device`` (default: the
        device of ``ids``)."""
        return bloom.query(self.bits, ids, self.params, device=device)


def build(positive_ids: np.ndarray, scores: np.ndarray, tau: float,
          fpr: float = 0.01, min_keys: int = 16) -> FixupFilter:
    """positive_ids: (n, n_cols) raw (uncompressed) ids; scores: model
    probs (host numpy, float32)."""
    fn_mask = np.asarray(scores) < tau
    fns = positive_ids[fn_mask]
    n = max(len(fns), min_keys)
    params = bloom.params_for(n, fpr)
    bits = bloom.empty(params)
    if len(fns):
        bloom.add(bits, fns, params)
    return FixupFilter(params=params, bits=bits,
                       n_false_negatives=int(fn_mask.sum()))
