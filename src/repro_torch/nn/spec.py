"""Parameter specs: shape, dtype, initializer and logical axes per leaf.

A model declares its parameters as a nested dict of :class:`ParamSpec`
leaves (as in ``repro.nn.spec``); :func:`build_params` materializes it
into tensors on a device from a seed.
"""
from __future__ import annotations

import dataclasses
import zlib
from typing import Optional

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.nn import init as init_lib


@dataclasses.dataclass(frozen=True)
class ParamSpec:
    """One parameter: shape, dtype, initializer and logical axes."""

    shape: tuple
    dtype: torch.dtype = torch.float32
    init: str = "scaled_normal"   # name into repro_torch.nn.init registry
    axes: tuple = ()              # logical axis name (or None) per dim
    init_scale: float = 1.0
    fan_in_dims: Optional[tuple] = None  # dims counted as fan-in

    def __post_init__(self):
        if self.axes and len(self.axes) != len(self.shape):
            raise ValueError(
                f"axes {self.axes} rank != shape {self.shape} rank")


def build_params(spec_tree, seed: int, device) -> dict:
    """Materialize a spec tree into tensors on ``device``.

    Each leaf draws from its own ``torch.Generator`` seeded from
    ``seed`` and the CRC32 of the leaf's path, so adding or removing a
    parameter does not reshuffle the others' init streams. The numbers
    differ from the JAX package's (``jax.random`` is another generator).
    """
    dev = torch.device(device)

    def one(path: str, spec: ParamSpec):
        gen = torch.Generator(device=dev)
        gen.manual_seed((int(seed) * 0x9E3779B1
                         + zlib.crc32(path.encode())) & 0x7FFFFFFFFFFFFFFF)
        return init_lib.get(spec.init)(gen, spec, dev)

    return tree_lib.map_with_paths(one, spec_tree)


def count_params(spec_tree) -> int:
    return int(sum(int(np.prod(s.shape))
                   for _, s in tree_lib.leaves_with_paths(spec_tree)))
