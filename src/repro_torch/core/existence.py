"""End-to-end existence index: C-LMBF/LMBF model + fixup filter.

An :class:`ExistenceIndex` answers membership queries with the Bloom
filter contract: **no false negatives** on the indexed positives. The
query pipeline is the function :func:`query_stages` —
``encode -> embed -> MLP -> tau threshold -> fixup Bloom probe`` — which
the serving subsystem (``repro_torch.serve_filter``) runs per batch.
An index round-trips through ``checkpoint.manager`` via
:func:`save_index` / :func:`load_index` in the JAX package's format
(kinds ``existence_index_v1`` and ``_v2``), so an index fitted by
``repro.core.existence.fit`` serves here and the reverse.

Training (``fit``) is not ported yet (ROADMAP Queue 1 item 3);
:func:`index_from_params` is its tail — the fixup filter built from
every indexed positive the model rejects — and builds a servable index
from any parameters, e.g. a fresh :func:`lmbf.init`.
"""
from __future__ import annotations

import dataclasses
import warnings
from typing import Dict, Optional, Tuple

import numpy as np
import torch

from repro_torch import tree as tree_lib
from repro_torch.checkpoint import manager as ckpt
from repro_torch.core import bloom, compression as comp, fixup, lmbf, memory
from repro_torch.data import tuples as tuples_lib
from repro_torch.runtime import device as device_lib


@dataclasses.dataclass
class TrainSettings:
    steps: int = 600
    batch_size: int = 512
    learning_rate: float = 1e-2
    tau: float = 0.5
    fixup_fpr: float = 0.01
    seed: int = 0
    wildcard_prob: float = 0.2
    n_pos: int = 20_000
    n_neg: int = 20_000


def ids_tensor(raw_ids, device) -> torch.Tensor:
    """Raw ids (numpy, list or tensor) -> int32 tensor on ``device``."""
    if not isinstance(raw_ids, torch.Tensor):
        raw_ids = torch.from_numpy(np.asarray(raw_ids, np.int32))
    return raw_ids.to(device=device, dtype=torch.int32)


def query_stages(params, cfg: lmbf.LMBFConfig, tau, fixup_bits,
                 fixup_params: Optional[bloom.BloomParams], raw_ids, *,
                 probe_fn=None, predict_fn=None):
    """The whole query pipeline: ``compression.encode -> embedding
    gather -> MLP -> tau threshold -> fixup Bloom probe``, on the device
    of ``raw_ids`` (an int32 tensor) with no host round-trips.

    ``probe_fn(bits, ids)`` overrides the fixup probe (the serving
    subsystem injects the CUDA kernel of ``kernels/bloom_query`` here);
    ``predict_fn(params, cfg, enc)`` overrides the model score.

    Returns ``(answers, model_yes, backup_yes)`` bool tensors — the
    per-stage booleans feed the serving subsystem's stage counters.
    """
    enc = comp.encode(raw_ids, cfg.plan)
    s = (predict_fn or lmbf.predict)(params, cfg, enc)
    model_yes = s >= tau
    if probe_fn is None:
        backup_yes = bloom.query(fixup_bits, raw_ids, fixup_params)
    else:
        backup_yes = probe_fn(fixup_bits, raw_ids)
    return model_yes | backup_yes, model_yes, backup_yes


@dataclasses.dataclass
class ExistenceIndex:
    cfg: lmbf.LMBFConfig
    params: Dict                       # tree of tensors, all on one device
    fixup_filter: fixup.FixupFilter    # host bitset
    tau: float
    train_log: dict

    @property
    def device(self) -> torch.device:
        return self.params["dense"]["w_out"].device

    def scores(self, raw_ids) -> torch.Tensor:
        enc = comp.encode(ids_tensor(raw_ids, self.device), self.cfg.plan)
        return lmbf.predict(self.params, self.cfg, enc)

    def query(self, raw_ids) -> torch.Tensor:
        """(n, n_cols) raw ids -> (n,) bool membership answers."""
        ids = ids_tensor(raw_ids, self.device)
        ans, _, _ = query_stages(
            self.params, self.cfg, self.tau,
            bloom.bits_tensor(self.fixup_filter.bits, self.device),
            self.fixup_filter.params, ids)
        return ans

    @property
    def memory(self) -> memory.ModelMemory:
        return memory.accounting(self.cfg)

    @property
    def total_mb(self) -> float:
        return self.memory.weights_mb + self.fixup_filter.size_mb


def score_np(params, cfg: lmbf.LMBFConfig, raw_ids: np.ndarray,
             device) -> np.ndarray:
    """Model probabilities for host raw ids, computed on ``device``."""
    enc = torch.from_numpy(comp.encode_np(raw_ids, cfg.plan)).to(device)
    return lmbf.predict(params, cfg, enc).cpu().numpy()


def index_from_params(ds: tuples_lib.TupleDataset, cfg: lmbf.LMBFConfig,
                      params: Dict,
                      settings: Optional[TrainSettings] = None,
                      train_log: Optional[dict] = None) -> ExistenceIndex:
    """Build the fixup filter for ``params`` exactly as the tail of
    ``repro.core.existence.fit`` does: score ALL indexed positives (the
    records plus the sampled wildcard positives of the training set
    drawn with ``settings``) on the params' device, insert every one
    scored below tau, and measure held-out accuracy."""
    st = settings or TrainSettings()
    device = params["dense"]["w_out"].device
    ids, labels = tuples_lib.make_training_set(
        ds, st.n_pos, st.n_neg, st.seed, st.wildcard_prob)
    all_pos = np.unique(np.concatenate([ds.records, ids[labels > 0.5]],
                                       axis=0), axis=0)
    fx = fixup.build(all_pos, score_np(params, cfg, all_pos, device),
                     st.tau, st.fixup_fpr)
    test_ids, test_labels = tuples_lib.make_training_set(
        ds, 4096, 4096, st.seed + 1000, st.wildcard_prob)
    test_scores = score_np(params, cfg, test_ids, device)
    acc = float(np.mean((test_scores >= st.tau) == (test_labels > 0.5)))
    log = dict(train_log or {"losses": [], "train_seconds": 0.0,
                             "steps": 0})
    log.update(accuracy=acc, fn_count=fx.n_false_negatives)
    return ExistenceIndex(cfg=cfg, params=params, fixup_filter=fx,
                          tau=st.tau, train_log=log)


# ------------------------------------------------------- (de)serialization

def _plan_to_json(plan: comp.CompressionPlan) -> Dict:
    return {
        "theta": plan.theta, "ns": plan.ns,
        "columns": [{"v": c.v, "ns": c.ns,
                     "divisors": list(c.divisors),
                     "sub_cards": list(c.sub_cards)}
                    for c in plan.columns],
    }


def _plan_from_json(d: Dict) -> comp.CompressionPlan:
    cols = tuple(comp.ColumnPlan(
        v=int(c["v"]), ns=int(c["ns"]),
        divisors=tuple(int(x) for x in c["divisors"]),
        sub_cards=tuple(int(x) for x in c["sub_cards"]))
        for c in d["columns"])
    return comp.CompressionPlan(columns=cols, theta=int(d["theta"]),
                                ns=int(d["ns"]))


# Checkpoint kinds this module can hydrate. v1 indexes were fit when the
# reference's output layer was a (prev, 1) GEMV; scores under the
# current multiply+reduce head differ in the last ulps, so v1 rows
# borderline at tau can flip and loading v1 warns. v3 (v2 plus a
# quantized payload) waits for the compressed storage modes.
_INDEX_KINDS = ("existence_index_v2", "existence_index_v1")
_V3 = "existence_index_v3"
_FIXUP_KEY = "['fixup_bits']"   # keystr path of the saved bitset leaf


def index_meta(idx: ExistenceIndex, kind: str = "existence_index_v2") -> Dict:
    """JSON-safe description of everything but the arrays."""
    return {
        "kind": kind,
        "plan": _plan_to_json(idx.cfg.plan),
        "hidden": list(idx.cfg.hidden),
        "onehot_max": idx.cfg.onehot_max,
        "dtype": lmbf.dtype_name(idx.cfg.dtype),
        "tau": float(idx.tau),
        "fixup": {"m_bits": idx.fixup_filter.params.m_bits,
                  "n_hashes": idx.fixup_filter.params.n_hashes,
                  "n_false_negatives": idx.fixup_filter.n_false_negatives},
        "train_log": idx.train_log,
    }


def config_from_meta(meta: Dict) -> lmbf.LMBFConfig:
    return lmbf.LMBFConfig(
        plan=_plan_from_json(meta["plan"]),
        hidden=tuple(int(h) for h in meta["hidden"]),
        onehot_max=int(meta["onehot_max"]),
        dtype=lmbf.dtype_from_name(meta["dtype"]))


def save_index(directory: str, idx: ExistenceIndex, *, step: int = 0,
               keep: int = 3, quant: Optional[Dict] = None) -> None:
    """Persist an index through the checkpoint manager (atomic, keep-N)
    as ``existence_index_v2``: params + fixup bitset in the payload,
    plan/config/tau in the JSON meta."""
    if quant is not None:
        raise NotImplementedError(
            "existence_index_v3 (quantized payload) checkpoints are not "
            "ported yet: ROADMAP Queue 1 item 7")
    tree = {"params": idx.params,
            "fixup_bits": np.asarray(idx.fixup_filter.bits, np.uint32)}
    ckpt.save(directory, step, tree, extra=index_meta(idx), keep=keep)


def _read_index_meta(directory: str, step: Optional[int]
                     ) -> Tuple[int, Dict]:
    if step is None:
        step = ckpt.latest_step(directory)
        if step is None:
            raise FileNotFoundError(f"no committed checkpoint in {directory}")
    meta = ckpt.read_meta(directory, step)["extra"]
    kind = meta.get("kind")
    if kind == _V3:
        raise NotImplementedError(
            f"{directory} step {step} is an existence_index_v3 "
            "(quantized) checkpoint: not ported yet, ROADMAP Queue 1 "
            "item 7")
    if kind not in _INDEX_KINDS:
        raise ValueError(f"{directory} step {step} is not an existence "
                         f"index checkpoint: {kind!r}")
    return step, meta


def _fixup_from(meta: Dict, bits: np.ndarray) -> fixup.FixupFilter:
    bp = bloom.BloomParams(m_bits=int(meta["fixup"]["m_bits"]),
                           n_hashes=int(meta["fixup"]["n_hashes"]))
    if bits.shape != (bp.n_words,):
        raise ckpt.CheckpointCorruption(
            f"fixup bitset has shape {bits.shape}, meta says "
            f"({bp.n_words},)")
    return fixup.FixupFilter(
        params=bp, bits=np.ascontiguousarray(bits.astype(np.uint32)),
        n_false_negatives=int(meta["fixup"]["n_false_negatives"]))


def load_index(directory: str, step: Optional[int] = None, *,
               device=None) -> ExistenceIndex:
    """Rebuild an :class:`ExistenceIndex` written by either package's
    ``save_index``, with its params on ``device`` (default ``cuda``)."""
    dev = device_lib.resolve(device)
    step, meta = _read_index_meta(directory, step)
    if meta["kind"] == "existence_index_v1":
        warnings.warn(
            f"{directory} step {step} was fit under the pre-grouped MLP "
            "head (existence_index_v1); its scores differ in the last "
            "ulps under the current head, so rows borderline at tau may "
            "flip and the no-false-negative guarantee is not assured — "
            "refit and re-save to upgrade", UserWarning, stacklevel=2)
    cfg = config_from_meta(meta)
    host = ckpt.restore_arrays(directory, step)

    def leaf(path: str, spec):
        key = "['params']" + path
        if key not in host:
            raise KeyError(f"checkpoint missing array {key}")
        arr = host[key]
        if tuple(arr.shape) != tuple(spec.shape):
            raise ckpt.CheckpointCorruption(
                f"array {key} has shape {arr.shape}, config says "
                f"{tuple(spec.shape)}")
        return torch.from_numpy(np.ascontiguousarray(arr)).to(
            device=dev, dtype=spec.dtype)

    params = tree_lib.map_with_paths(leaf, lmbf.params_spec(cfg))
    if _FIXUP_KEY not in host:
        raise KeyError(f"checkpoint missing array {_FIXUP_KEY}")
    return ExistenceIndex(cfg=cfg, params=params,
                          fixup_filter=_fixup_from(meta, host[_FIXUP_KEY]),
                          tau=float(meta["tau"]),
                          train_log=meta["train_log"])


def load_fixup_only(directory: str, step: Optional[int] = None
                    ) -> Tuple[lmbf.LMBFConfig, fixup.FixupFilter]:
    """Load ONLY the fixup/backup Bloom structure of a saved index — a
    selective, CRC-verified read of the one ``fixup_bits`` array, for
    the degraded serving path whose model arrays are unreadable."""
    step, meta = _read_index_meta(directory, step)
    host = ckpt.restore_arrays(directory, step, only=(_FIXUP_KEY,))
    return config_from_meta(meta), _fixup_from(meta, host[_FIXUP_KEY])
