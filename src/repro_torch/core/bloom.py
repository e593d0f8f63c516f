"""Classic Bloom filter over multidimensional tuples, in PyTorch.

The bit array is packed 32-bit words; hashing is murmur3-style 32-bit
mixing with double hashing (Kirsch–Mitzenmacher) for the ``h`` probe
positions — the same hash family as ``repro.core.bloom``, bit for bit.

PyTorch's ``uint32`` lacks ``>>``, ``<<``, ``+`` and ``%`` on the CPU,
so every 32-bit quantity here lives in an ``int64`` tensor holding its
unsigned value in ``[0, 2**32)``, and every step masks with
``& 0xFFFFFFFF``. Multiplications by 32-bit constants are split into
two 16-bit halves so no intermediate leaves int64's range. Bitsets are
stored as ``int32`` tensors (the same bits as the reference's uint32
words) so they can be indexed and handed to the CUDA probe kernel.

Insertion happens host-side (``np.bitwise_or.at``, a build-time
operation); querying is the hot path. ``kernels/bloom_query`` holds the
hand-written CUDA probe; :func:`query` here is its plain version.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Optional, Tuple

import numpy as np
import torch

M32 = 0xFFFFFFFF
_C1 = 0xCC9E2D51
_C2 = 0x1B873593
_GOLDEN = 0x9E3779B9
SEED_H1 = 0x0000A5A5
SEED_H2 = 0x00005EED


def _mul32(x: torch.Tensor, c: int) -> torch.Tensor:
    """``(x * c) mod 2**32`` for x in [0, 2**32) and a 32-bit constant,
    without leaving int64's range."""
    lo = x * (c & 0xFFFF)
    hi = ((x * (c >> 16)) & 0xFFFF) << 16
    return (lo + hi) & M32


def _rotl32(x: torch.Tensor, r: int) -> torch.Tensor:
    return ((x << r) & M32) | (x >> (32 - r))


def fmix32(h: torch.Tensor) -> torch.Tensor:
    h = h ^ (h >> 16)
    h = _mul32(h, 0x85EBCA6B)
    h = h ^ (h >> 13)
    h = _mul32(h, 0xC2B2AE35)
    h = h ^ (h >> 16)
    return h


def as_u32(ids) -> torch.Tensor:
    """Any integer ids -> int64 holding their two's-complement uint32
    value (what ``.astype(uint32)`` gives in the reference)."""
    return torch.as_tensor(ids).to(torch.int64) & M32


def hash_tuples(ids, seed: int) -> torch.Tensor:
    """ids: (..., n_cols) int -> (...,) int64 in [0, 2**32): the
    murmur3-style tuple hash."""
    ids = as_u32(ids)
    n = ids.shape[-1]
    h = torch.full(ids.shape[:-1], seed & M32, dtype=torch.int64,
                   device=ids.device)
    for i in range(n):
        k = ids[..., i] ^ (((i + 1) * _GOLDEN) & M32)
        k = _mul32(k, _C1)
        k = _rotl32(k, 15)
        k = _mul32(k, _C2)
        h = h ^ k
        h = _rotl32(h, 13)
        h = (h * 5 + 0xE6546B64) & M32
    return fmix32(h ^ n)


@dataclasses.dataclass(frozen=True)
class BloomParams:
    m_bits: int
    n_hashes: int

    @property
    def n_words(self) -> int:
        return (self.m_bits + 31) // 32

    @property
    def size_bytes(self) -> int:
        return self.n_words * 4

    @property
    def size_mb(self) -> float:
        return self.size_bytes / (1024.0 * 1024.0)


def params_for(n_keys: int, fpr: float) -> BloomParams:
    """Optimal sizing: m = -n ln p / ln2^2 ; h = (m/n) ln 2."""
    m = int(math.ceil(-n_keys * math.log(fpr) / (math.log(2) ** 2)))
    m = max(m, 64)
    h = max(1, int(round((m / max(n_keys, 1)) * math.log(2))))
    return BloomParams(m_bits=m, n_hashes=h)


def empty(params: BloomParams) -> np.ndarray:
    return np.zeros(params.n_words, dtype=np.uint32)


def bits_tensor(bits, device=None) -> torch.Tensor:
    """Host uint32 words (or a tensor of them) -> contiguous ``int32``
    tensor with the same bits, on ``device``."""
    if isinstance(bits, torch.Tensor):
        t = bits if bits.dtype == torch.int32 else bits.view(torch.int32)
    else:
        t = torch.from_numpy(
            np.ascontiguousarray(bits, dtype=np.uint32).view(np.int32))
    return t.to(device).contiguous() if device is not None \
        else t.contiguous()


def probe_positions(ids, params: BloomParams) -> torch.Tensor:
    """(..., n_cols) -> (..., h) int64 bit positions (double hashing)."""
    h1 = hash_tuples(ids, SEED_H1)
    h2 = hash_tuples(ids, SEED_H2) | 1
    ks = torch.arange(params.n_hashes, dtype=torch.int64, device=h1.device)
    return ((h1[..., None] + ks * h2[..., None]) & M32) % params.m_bits


def probe_words(ids, params: BloomParams
                ) -> Tuple[torch.Tensor, torch.Tensor]:
    """(..., n_cols) -> ((..., h) int64 word index, (..., h) int64 bit
    index within the word): probe ``k`` tests bit ``bit[k]`` of
    ``bits[word[k]]``."""
    pos = probe_positions(ids, params)
    return pos >> 5, pos & 31


def add(bits: np.ndarray, ids, params: BloomParams) -> np.ndarray:
    """Host-side insertion (build-time). Returns the mutated array."""
    pos = probe_positions(torch.as_tensor(np.asarray(ids)).cpu(),
                          params).reshape(-1).numpy()
    words = pos >> 5
    masks = (np.uint32(1) << (pos & 31).astype(np.uint32))
    np.bitwise_or.at(bits, words, masks)
    return bits


def query(bits, ids, params: BloomParams,
          device: Optional[torch.device] = None) -> torch.Tensor:
    """(..., n_cols) -> (...,) bool: the plain PyTorch probe, on the
    device of ``ids`` (or ``device``)."""
    ids = torch.as_tensor(ids)
    if device is not None:
        ids = ids.to(device)
    words, shift = probe_words(ids, params)
    w = bits_tensor(bits, ids.device)[words].to(torch.int64) & M32
    return ((w >> shift) & 1).bool().all(dim=-1)


def fpr_estimate(params: BloomParams, n_keys: int) -> float:
    """Theoretical FPR after inserting n_keys."""
    return (1.0 - math.exp(-params.n_hashes * n_keys / params.m_bits)
            ) ** params.n_hashes
