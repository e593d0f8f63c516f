"""Plain PyTorch version of the Bloom probe kernel: the
``core/bloom.py`` query path (int64 arithmetic masked to 32 bits)."""
from __future__ import annotations

import torch

from repro_torch.core import bloom


def bloom_query_ref(ids: torch.Tensor, bits: torch.Tensor, *,
                    n_hashes: int, m_bits: int) -> torch.Tensor:
    """ids: (N, n_cols) int; bits: (n_words,) 32-bit words -> (N,) bool,
    on the device of ``ids``."""
    params = bloom.BloomParams(m_bits=m_bits, n_hashes=n_hashes)
    return bloom.query(bits, ids, params)
