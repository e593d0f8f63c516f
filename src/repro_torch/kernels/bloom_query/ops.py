"""Wrapper for the CUDA Bloom probe kernel (``csrc/bloom_query.cu``).

:func:`bloom_query` checks its inputs, then launches the hand-written
``sm_90a`` kernel for CUDA tensors, or runs the plain PyTorch version
(:mod:`.ref`) for CPU tensors. A CUDA tensor never takes the plain
path: the kernel launches or the call raises.

``LAUNCHES`` counts kernel launches (not plain-version calls), so a run
can show that its serving path went through the kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path
from typing import Optional

import torch

from repro_torch.core import bloom
from repro_torch.kernels import _build
from repro_torch.kernels.bloom_query.ref import bloom_query_ref

LIBRARY = _build.KernelLibrary(
    "bloom_query", (Path(__file__).parent / "csrc" / "bloom_query.cu",))
LAUNCHES = 0
_LIB: Optional[ctypes.CDLL] = None


def _lib() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = _build.load(LIBRARY)
        fn = lib.bloom_query_launch
        fn.argtypes = [ctypes.c_void_p, ctypes.c_void_p, ctypes.c_void_p,
                       ctypes.c_int, ctypes.c_int, ctypes.c_int,
                       ctypes.c_uint32, ctypes.c_void_p]
        fn.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _check(ids: torch.Tensor, bits: torch.Tensor,
           params: bloom.BloomParams, device: torch.device) -> None:
    if not isinstance(ids, torch.Tensor) or not isinstance(bits,
                                                            torch.Tensor):
        raise TypeError("ids and bits must be torch tensors")
    if ids.device != device or bits.device != device:
        raise ValueError(f"ids on {ids.device} and bits on {bits.device}; "
                         f"expected both on {device}")
    if ids.dtype != torch.int32:
        raise TypeError(f"ids must be int32, got {ids.dtype}")
    if bits.dtype not in (torch.int32, torch.uint32):
        raise TypeError(f"bits must be 32-bit words, got {bits.dtype}")
    if ids.dim() != 2 or ids.shape[1] < 1:
        raise ValueError(f"ids must be (N, n_cols), got {tuple(ids.shape)}")
    if bits.dim() != 1 or bits.shape[0] < params.n_words:
        raise ValueError(f"bits must hold {params.n_words} words, got "
                         f"shape {tuple(bits.shape)}")
    if not (ids.is_contiguous() and bits.is_contiguous()):
        raise ValueError("ids and bits must be contiguous")
    if not 0 < params.m_bits < 2 ** 32 or params.n_hashes < 1:
        raise ValueError(f"bad Bloom geometry {params}")


def bloom_query(ids: torch.Tensor, bits: torch.Tensor,
                params: bloom.BloomParams, *,
                device: Optional[torch.device] = None) -> torch.Tensor:
    """Batched membership probe: (N, n_cols) int32 ids against a packed
    bitset -> (N,) bool. Runs on ``device`` (default: the device of
    ``ids``); inputs elsewhere raise."""
    global LAUNCHES
    dev = ids.device if device is None else torch.device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    _check(ids, bits, params, dev)
    if dev.type == "cpu":
        return bloom_query_ref(ids, bits, n_hashes=params.n_hashes,
                               m_bits=params.m_bits)
    if dev.type != "cuda":
        raise ValueError(f"bloom_query runs on cpu or cuda, not {dev}")
    n, n_cols = ids.shape
    out = torch.empty(n, dtype=torch.bool, device=dev)
    if n == 0:
        return out
    fn = _lib().bloom_query_launch
    stream = torch.cuda.current_stream(dev).cuda_stream
    err = fn(ids.data_ptr(), bits.data_ptr(), out.data_ptr(), n, n_cols,
             params.n_hashes, params.m_bits, stream)
    if err != 0:
        raise RuntimeError(f"bloom_query kernel launch failed: CUDA error "
                           f"{err}")
    LAUNCHES += 1
    return out
