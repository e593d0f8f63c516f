"""Learned (multidimensional) Bloom filter models: LMBF and C-LMBF (fp32).

Architecture (Macke et al. [9], as used by the paper): per-(sub)column
embedding -> concat -> dense hidden layer(s) (ReLU) -> sigmoid logit.

* LMBF   = plan with no compression (theta = inf).
* C-LMBF = plan from ``repro_torch.core.compression`` (theta, ns);
  inputs are the losslessly-compressed subcolumn ids; subcolumn tables
  carry a ``+1`` wildcard row.

Embedding dims follow ``floor(rows ** 0.25)`` (min 1); columns whose
table has at most ``onehot_max`` rows use one-hot encoding instead.

Batch invariance. The filter's zero-false-negative contract needs a
row's score at serving time to be bit-identical to the score the fixup
filter was built from, whatever batch the row rides in. Plain PyTorch
does not give that: on the GPU the library GEMM behind ``x @ w`` picks
its algorithm by the number of rows and sums in another order (the
last ulps differ between batches of 1-64 rows and of 1024 or more,
measured by ``chip_smoke.py``); on the CPU the GEMM differs at one row
and the vectorized ``sigmoid`` computes a tensor's SIMD tail on a
scalar path that differs in the last ulp. :func:`mlp_head` and
:func:`predict` therefore run on blocks of exactly :data:`ROW_CHUNK`
rows, zero-padding the last block: every row meets the same kernels at
the same shapes and never sits in a vector tail, so its score does not
depend on its batch.

The quantized storage modes of the JAX package (int8, packed int4/NF4)
are not ported yet (ROADMAP Queue 1 item 7).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Dict, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.core import compression as comp
from repro_torch.nn import ParamSpec, build_params
from repro_torch.nn import layers as L

# rows per block of the batch-invariant MLP head (the largest serving
# bucket, so a full bucket runs unpadded)
ROW_CHUNK = 4096

_DTYPES = {"float32": torch.float32}


def dtype_name(dtype: torch.dtype) -> str:
    """``torch.float32`` -> ``"float32"`` (the checkpoint meta's form)."""
    return str(dtype).removeprefix("torch.")


def dtype_from_name(name: str) -> torch.dtype:
    if name not in _DTYPES:
        raise NotImplementedError(
            f"dtype {name!r}: only float32 models are ported (ROADMAP "
            "Queue 1 item 7 brings the compressed storage modes)")
    return _DTYPES[name]


def embed_dim_for(rows: int) -> int:
    """The paper's (reverse-engineered) embedding-size heuristic."""
    return max(1, int(math.floor(rows ** 0.25)))


@dataclasses.dataclass(frozen=True)
class LMBFConfig:
    plan: comp.CompressionPlan
    hidden: Tuple[int, ...] = (64,)      # paper Table 1: one layer of 64
    onehot_max: int = 0                  # 0 disables the one-hot path
    dtype: torch.dtype = torch.float32

    def __post_init__(self):
        if isinstance(self.dtype, str):
            object.__setattr__(self, "dtype", dtype_from_name(self.dtype))
        object.__setattr__(self, "hidden", tuple(int(h) for h in self.hidden))

    @property
    def column_encodings(self):
        """[(rows, embed_dim_or_None)] per subcolumn; None = one-hot."""
        out = []
        for rows in self.plan.table_rows:
            if rows <= self.onehot_max:
                out.append((rows, None))
            else:
                out.append((rows, embed_dim_for(rows)))
        return out

    @property
    def concat_dim(self) -> int:
        return sum(e if e is not None else r
                   for r, e in self.column_encodings)


def params_spec(cfg: LMBFConfig):
    spec = {"embed": {}, "dense": {}}
    for i, (rows, e) in enumerate(cfg.column_encodings):
        if e is not None:
            spec["embed"][f"col{i}"] = ParamSpec(
                (rows, e), cfg.dtype, init="embedding",
                axes=("vocab", "embed"), init_scale=0.05)
    prev = cfg.concat_dim
    for li, width in enumerate(cfg.hidden):
        spec["dense"][f"w{li}"] = ParamSpec(
            (prev, width), cfg.dtype, init="scaled_normal",
            axes=("embed", "mlp"))
        spec["dense"][f"b{li}"] = ParamSpec((width,), cfg.dtype, init="zeros",
                                            axes=(None,))
        prev = width
    spec["dense"]["w_out"] = ParamSpec((prev, 1), cfg.dtype,
                                       init="scaled_normal",
                                       axes=("embed", None))
    spec["dense"]["b_out"] = ParamSpec((1,), cfg.dtype, init="zeros",
                                       axes=(None,))
    return spec


def init(cfg: LMBFConfig, seed: int, device) -> Dict:
    """Random init from seeded ``torch.Generator``\\ s on ``device``."""
    return build_params(params_spec(cfg), seed, device)


def params_from_numpy(tree, *, device) -> Dict:
    """The JAX package's parameter tree (nested dicts of arrays, layout
    unchanged) -> the port's tree of tensors on ``device``."""
    return tree_lib.map_leaves(
        lambda a: torch.from_numpy(np.array(a, copy=True)).to(device), tree)


def params_to_numpy(params) -> Dict:
    """Inverse of :func:`params_from_numpy`: host numpy arrays."""
    return tree_lib.map_leaves(lambda t: t.detach().cpu().numpy(), params)


def features(params, cfg: LMBFConfig, encoded_ids) -> torch.Tensor:
    """encoded_ids: (..., n_subcolumns) int -> (..., concat_dim) input
    features (per-subcolumn embedding gathers / one-hots, concatenated).
    Out-of-range ids give NaN gathers and all-zero one-hots, as in the
    reference."""
    encoded_ids = encoded_ids.to(torch.int64)
    feats = []
    for i, (rows, e) in enumerate(cfg.column_encodings):
        ids = encoded_ids[..., i]
        if e is None:
            feats.append(L.one_hot(ids, rows, cfg.dtype))
        else:
            feats.append(L.take_embedding(params["embed"][f"col{i}"], ids))
    return torch.cat(feats, dim=-1)


def _head_block(dense, n_hidden: int, x: torch.Tensor) -> torch.Tensor:
    for li in range(n_hidden):
        x = torch.relu(x @ dense[f"w{li}"] + dense[f"b{li}"])
    # multiply + last-axis reduce (not a GEMV), as in the reference
    return (x * dense["w_out"][:, 0]).sum(dim=-1) + dense["b_out"][0]


def _by_blocks(fn, x: torch.Tensor) -> torch.Tensor:
    """``fn`` over zero-padded blocks of exactly ``ROW_CHUNK`` rows of
    ``x`` (..., d) -> (...,): every row meets the same kernels at the
    same shapes, at a position that is never a vector tail."""
    lead = x.shape[:-1]
    flat = x.reshape(-1, x.shape[-1])
    n = flat.shape[0]
    out = flat.new_empty((n,))
    for s in range(0, n, ROW_CHUNK):
        m = min(ROW_CHUNK, n - s)
        blk = flat.new_zeros((ROW_CHUNK, flat.shape[1]))
        blk[:m] = flat[s:s + m]
        out[s:s + m] = fn(blk)[:m]
    return out.reshape(lead)


def mlp_head(params, cfg: LMBFConfig, x: torch.Tensor) -> torch.Tensor:
    """(..., concat_dim) features -> (...,) logits (hidden ReLU stack),
    computed block by block (see the module note on batch invariance)."""
    return _by_blocks(
        lambda b: _head_block(params["dense"], len(cfg.hidden), b), x)


def apply(params, cfg: LMBFConfig, encoded_ids) -> torch.Tensor:
    """encoded_ids: (..., n_subcolumns) int -> (...,) logits."""
    return mlp_head(params, cfg, features(params, cfg, encoded_ids))


def predict(params, cfg: LMBFConfig, encoded_ids) -> torch.Tensor:
    """Scores in (0, 1); the sigmoid runs inside the same fixed blocks
    as the head."""
    return _by_blocks(
        lambda b: torch.sigmoid(
            _head_block(params["dense"], len(cfg.hidden), b)),
        features(params, cfg, encoded_ids))


def count_params(cfg: LMBFConfig) -> int:
    """NN parameter count matching the paper's Table 1 accounting."""
    total = 0
    for rows, e in cfg.column_encodings:
        if e is not None:
            total += rows * e
    prev = cfg.concat_dim
    for width in cfg.hidden:
        total += prev * width + width
        prev = width
    total += prev * 1 + 1
    return total
