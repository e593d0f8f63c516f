"""Initializers for ParamSpec leaves, drawn from an explicit
``torch.Generator`` on the target device."""
from __future__ import annotations

import numpy as np
import torch


def _fan_in(spec) -> int:
    if spec.fan_in_dims is not None:
        dims = spec.fan_in_dims
    else:
        # default: all but the last dim count as fan-in, skipping a
        # leading "layers" stack axis
        start = 1 if (spec.axes and spec.axes[0] == "layers") else 0
        dims = tuple(range(start, max(start, len(spec.shape) - 1)))
    f = 1
    for d in dims:
        f *= int(spec.shape[d])
    return max(f, 1)


def _normal(gen, spec, device):
    return torch.randn(tuple(spec.shape), generator=gen, dtype=spec.dtype,
                       device=device)


def scaled_normal(gen, spec, device):
    """LeCun-style 1/sqrt(fan_in) normal — default for dense kernels."""
    std = float(spec.init_scale / np.sqrt(_fan_in(spec)))
    return std * _normal(gen, spec, device)


def embedding(gen, spec, device):
    return spec.init_scale * _normal(gen, spec, device)


def zeros(gen, spec, device):
    return torch.zeros(tuple(spec.shape), dtype=spec.dtype, device=device)


_REGISTRY = {
    "scaled_normal": scaled_normal,
    "embedding": embedding,
    "zeros": zeros,
}


def get(name: str):
    return _REGISTRY[name]
