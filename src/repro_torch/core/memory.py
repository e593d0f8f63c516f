"""Exact memory/parameter accounting reproducing the paper's Table 1.

Verified against the published numbers (tests/test_table1_accounting.py):

* "Input dim"  — exact for ALL eight published rows (airplane theta in
  {3000, 5500, 8000} + LMBF; DMV theta in {100, 1000, 2000} + LMBF).
* "NN params"  — exact for all four airplane rows; DMV rows carry a
  constant +134 offset vs our formula (0.1%-2.5%), unexplained by the
  published per-column cardinalities (documented in EXPERIMENTS.md).
* "Memory MB"  — the paper stores Keras models: weights + Adam moments
  (3x f32 params = 12 bytes/param) plus a 0.1-0.3 MB serialization
  constant. We report weights-only, Keras-equivalent, and measured-exact
  variants.
"""
from __future__ import annotations

import dataclasses
from typing import Tuple

from repro_torch.core import bloom, compression as comp, lmbf

KERAS_OVERHEAD_BYTES = 150 * 1024   # observed serialization constant


@dataclasses.dataclass(frozen=True)
class ModelMemory:
    input_dim: int
    nn_params: int
    weights_mb: float          # f32 weights only
    keras_equiv_mb: float      # weights + Adam moments + serialization


def accounting(cfg: lmbf.LMBFConfig) -> ModelMemory:
    params = lmbf.count_params(cfg)
    return ModelMemory(
        input_dim=cfg.plan.input_dim,
        nn_params=params,
        weights_mb=params * 4 / 2**20,
        keras_equiv_mb=(params * 12 + KERAS_OVERHEAD_BYTES) / 2**20,
    )


def bloom_mb(n_keys: int, fpr: float) -> float:
    return bloom.params_for(n_keys, fpr).size_mb


def table1_row(cards, theta: int, ns: int = 2,
               hidden: Tuple[int, ...] = (64,)) -> ModelMemory:
    plan = comp.make_plan(cards, theta=theta, ns=ns)
    return accounting(lmbf.LMBFConfig(plan=plan, hidden=hidden))


# Published per-column cardinalities (paper §4).
AIRPLANE_CARDS = (6887, 8021, 8046, 6537, 2557, 5017, 1663)
DMV_CARDS = (5, 10001, 27, 1627, 27, 1570, 64, 107, 694, 40, 8, 1509, 346,
             966, 794, 102, 3, 3, 2)

# Published Table 1 rows: theta -> (accuracy, memory_mb, nn_params, input_dim)
PAPER_TABLE1 = {
    "airplane": {
        3000: (0.95, 0.53, 33_006, 5060),
        5500: (0.97, 1.01, 73_110, 9933),
        8000: (0.98, 2.35, 186_713, 23025),
        None: (0.98, 4.06, 330_608, 38728),     # LMBF (no compression)
    },
    "dmv": {
        100: (0.98, 0.36, 5_447, 892),
        1000: (0.98, 0.47, 19_564, 3636),
        2000: (0.98, 0.78, 47_694, 8097),
        None: (0.98, 1.97, 147_351, 17895),     # LMBF
    },
}


def no_compression_theta(cards) -> int:
    return max(cards) + 1
