"""Chip smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Drives the port's main path once, at the full width of the paper's
Table 1 row "airplane theta=5500" (7 columns, 11 subcolumns, hidden
(64,), 73,110 parameters, 100,000 records): it builds an index on the
card, admits it to a ``FilterServer`` whose fixup probe runs in the
hand-written CUDA kernel, serves requests of mixed sizes and checks the
answers. Phases, each of which fails the run:

1. device — the card's name and power limit (exits non-zero, printing
   no result, when CUDA is not available);
2. build — every CUDA kernel of the path, one ``nvcc`` each, started
   together, with ``-Xptxas -v``'s registers and spills;
3. kernels — each kernel against its plain PyTorch version on the card,
   bit for bit, at the path's shapes and at edge shapes; times from
   CUDA events over warm launches, beside the plain version's time and
   the least time the card could take (``bound_ms``);
4. slice — the index built as ``repro.core.existence.fit`` builds it
   with zero training steps (random weights from a seeded generator on
   the card; training is not ported yet), the batch-invariance check of
   the model's scores, then serving through ``FilterServer``: zero false
   negatives, answers bit-identical to ``ExistenceIndex.query``, and the
   kernel's launch counter above 0 for the serving run;
5. report — one JSON line listing every kernel, then the last line
   ``{"ok": true, "device": {...}}``.

It imports nothing of JAX or of the JAX package (``src/repro``).
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np
import torch

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)),
                                "src"))

from repro_torch.core import bloom, compression as comp, existence, lmbf  # noqa: E402
from repro_torch.core import memory  # noqa: E402
from repro_torch.data import tuples  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels.bloom_query import ops as bloom_ops  # noqa: E402
from repro_torch.kernels.bloom_query.ref import bloom_query_ref  # noqa: E402
from repro_torch.serve_filter import (FilterServer,  # noqa: E402
                                      PlacementConfig, ProbeConfig,
                                      ServeConfig, TenantSpec)

# H100 SXM peaks (NVIDIA data sheet, at the 700 W limit): HBM bandwidth,
# and the non-tensor 32-bit rate (the fp32 CUDA-core rate; the integer
# rate is no higher, so a bound computed with it stays a lower bound)
HBM_BYTES_PER_S = 3.35e12
SCALAR_OPS_PER_S = 67e12

THETA, NS, HIDDEN, N_RECORDS = 5500, 2, (64,), 100_000
SEED = 0
TAU, FIXUP_FPR = 0.5, 0.01
N_NEGATIVES = 20_000
REQUEST_SIZES = (1, 37, 1_000, 20_000)
BATCH_SIZES = (1, 64, 1024, 4096)           # plus the full set
SERVE_BUCKET = 4096                          # largest serving bucket
KERNELS = [bloom_ops.LIBRARY]


def log(*args) -> None:
    print(*args, flush=True)


# ----------------------------------------------------------------- timing

def time_ms(fn, *, warmup: int = 10, iters: int = 200) -> float:
    """Mean milliseconds per call from CUDA events over ``iters`` warm
    calls (host launch overhead included: the calls are back to back)."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_ms(fn, *, iters: int = 100) -> float:
    """Mean device milliseconds per call, the calls replayed from one
    CUDA graph (no host launch gaps between them)."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(3):
            fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(iters):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


# ------------------------------------------------------- phase 1: device

def phase_device() -> dict:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: torch.cuda.is_available() is False — "
                         "this script runs on a CUDA card")
    torch.backends.cuda.matmul.allow_tf32 = False   # fp32 GEMMs in fp32
    torch.backends.cudnn.allow_tf32 = False
    kind = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True).stdout.strip().splitlines()[0]
    log(f"[device] {kind}; torch {torch.__version__} cuda "
        f"{torch.version.cuda}; python {sys.version.split()[0]}")
    log(smi)
    return {"kind": kind, "count": torch.cuda.device_count(), "smi": smi}


# -------------------------------------------------------- phase 2: build

def phase_build() -> None:
    t0 = time.perf_counter()
    _build.build(KERNELS)
    log(f"[build] {len(KERNELS)} kernel libraries in "
        f"{time.perf_counter() - t0:.1f}s (sm_90a)")
    for lib in KERNELS:
        for line in lib.log_path.read_text().splitlines():
            if "registers" in line or "spill" in line:
                log(f"[build] {lib.name}: {line.strip()}")


# ------------------------------------------------------ phase 3: kernels

def _random_bloom(rng, n_keys: int, fpr: float, n_cols: int,
                  m_bits: int = 0):
    params = bloom.params_for(n_keys, fpr)
    if m_bits:
        params = bloom.BloomParams(m_bits=m_bits, n_hashes=params.n_hashes)
    bits = bloom.empty(params)
    keys = rng.integers(-2**31, 2**31 - 1, size=(n_keys, n_cols),
                        dtype=np.int64).astype(np.int32)
    bloom.add(bits, keys, params)
    return params, bits, keys


def bloom_query_work(n: int, n_cols: int, params: bloom.BloomParams):
    """(bytes, ops) the probe must do: ids in, one byte out a row and the
    bitset read once; per row 2 hashes x n_cols mix rounds of 12 integer
    ops, two 9-op finalisers and the |1, and 8 ops per probe (multiply,
    add, modulo, shift, mask, shift, mask, and)."""
    nbytes = n * n_cols * 4 + n + params.n_words * 4
    ops = n * (24 * n_cols + 19 + 8 * params.n_hashes)
    return nbytes, ops


def phase_kernels(slice_params: bloom.BloomParams, slice_bits: np.ndarray,
                  slice_ids: np.ndarray) -> dict:
    """Kernel 1 against its plain version, bit for bit, then timed at
    the serving shape (one full bucket of the slice's rows against the
    slice's fixup bitset)."""
    rng = np.random.default_rng(SEED + 1)
    dev = torch.device("cuda")
    cases = [("slice bucket", slice_params, slice_bits,
              slice_ids[:SERVE_BUCKET]),
             ("slice N=1", slice_params, slice_bits, slice_ids[:1]),
             ("slice N=1001 (ragged)", slice_params, slice_bits,
              slice_ids[:1001])]
    for label, n_cols, m_bits in (("n_cols=1", 1, 0), ("n_cols=19", 19, 0),
                                  ("m_bits=64", 7, 64)):
        params, bits, keys = _random_bloom(rng, 2000, 0.01, n_cols, m_bits)
        fresh = rng.integers(-2**31, 2**31 - 1, size=(777, n_cols),
                             dtype=np.int64).astype(np.int32)
        cases.append((label, params, bits,
                      np.concatenate([keys[:777], fresh])))
    max_err = 0
    for label, params, bits, ids in cases:
        t_ids = torch.from_numpy(np.ascontiguousarray(ids)).to(dev)
        t_bits = bloom.bits_tensor(bits, dev)
        got = bloom_ops.bloom_query(t_ids, t_bits, params)
        want = bloom_query_ref(t_ids, t_bits, n_hashes=params.n_hashes,
                               m_bits=params.m_bits)
        torch.cuda.synchronize()
        err = int((got.to(torch.int32) - want.to(torch.int32))
                  .abs().max().item())
        log(f"[kernel] bloom_query {label}: N={len(ids)} "
            f"n_cols={ids.shape[1]} m_bits={params.m_bits} "
            f"k={params.n_hashes} hits={float(got.float().mean()):.4f} "
            f"max_abs_err={err}")
        if err:
            raise AssertionError(f"bloom_query kernel disagrees with its "
                                 f"plain version ({label})")
        max_err = max(max_err, err)

    t_ids = torch.from_numpy(slice_ids[:SERVE_BUCKET].copy()).to(dev)
    t_bits = bloom.bits_tensor(slice_bits, dev)
    p = slice_params
    ms = time_ms(lambda: bloom_ops.bloom_query(t_ids, t_bits, p))
    dev_ms = graph_ms(lambda: bloom_ops.bloom_query(t_ids, t_bits, p))
    plain_ms = time_ms(lambda: bloom_query_ref(
        t_ids, t_bits, n_hashes=p.n_hashes, m_bits=p.m_bits), iters=50)
    nbytes, ops = bloom_query_work(*t_ids.shape, p)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, ops / SCALAR_OPS_PER_S
    bound_ms = max(t_bytes, t_ops) * 1e3
    log(f"[kernel] bloom_query timing at N={t_ids.shape[0]} "
        f"n_cols={t_ids.shape[1]} m_bits={p.m_bits} k={p.n_hashes}: "
        f"{ms:.5f} ms/launch (events, back-to-back launches), "
        f"{dev_ms:.5f} ms/launch (CUDA graph replay), plain "
        f"{plain_ms:.5f} ms, bound {bound_ms:.6f} ms "
        f"({nbytes} bytes, {ops} int ops); no single PyTorch call "
        f"computes a Bloom probe, so there is no library time")
    return {"name": "bloom_query", "route": "cuda",
            "source": "src/repro_torch/kernels/bloom_query/csrc/"
                      "bloom_query.cu",
            "replaces": "src/repro/kernels/bloom_query/bloom_query.py:282",
            "launches": 0, "max_abs_err": max_err, "bit_exact": True,
            "ms": ms, "graph_ms": dev_ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms,
            "bound_by": "bytes" if t_bytes >= t_ops else "operations",
            "library_ms": None}


# -------------------------------------------------------- phase 4: slice

def build_index(ds: tuples.TupleDataset, device) -> existence.ExistenceIndex:
    """The index ``repro.core.existence.fit`` builds with zero training
    steps: the airplane theta=5500 plan, hidden (64,), random weights
    from a seeded generator on ``device``, and the fixup filter over
    every indexed positive (records + sampled wildcard positives)."""
    plan = comp.make_plan(ds.cards, theta=THETA, ns=NS)
    cfg = lmbf.LMBFConfig(plan=plan, hidden=HIDDEN)
    acct = memory.accounting(cfg)
    if acct.nn_params != 73_110 or plan.input_dim != 9933:
        raise AssertionError(f"not the Table 1 airplane theta=5500 model: "
                             f"{acct}")
    params = lmbf.init(cfg, SEED, device)
    st = existence.TrainSettings(steps=0, seed=SEED, tau=TAU,
                                 fixup_fpr=FIXUP_FPR)
    return existence.index_from_params(ds, cfg, params, st)


def indexed_positives(ds: tuples.TupleDataset) -> np.ndarray:
    st = existence.TrainSettings(seed=SEED)
    ids, labels = tuples.make_training_set(ds, st.n_pos, st.n_neg, st.seed,
                                           st.wildcard_prob)
    return np.unique(np.concatenate([ds.records, ids[labels > 0.5]]),
                     axis=0)


def check_batch_invariance(idx: existence.ExistenceIndex,
                           rows: np.ndarray) -> None:
    """A row's score must not depend on the batch it is scored in: the
    fixup filter was built from one full-set scoring pass, serving pads
    to buckets. Checks the raw hidden GEMM ``x @ w0`` (reported) and the
    port's scores (asserted), at batch sizes 1..4096 and the full set,
    bit for bit, at several offsets."""
    dev = idx.device
    enc = comp.encode(torch.from_numpy(rows).to(dev), idx.cfg.plan)
    x = lmbf.features(idx.params, idx.cfg, enc)
    w0 = idx.params["dense"]["w0"]
    raw_full = x @ w0
    full = lmbf.predict(idx.params, idx.cfg, enc)
    raw_ok, scores_ok = {}, True
    for b in BATCH_SIZES:
        for start in (0, 1, len(rows) // 2):
            sl = slice(start, start + b)
            raw_ok.setdefault(b, True)
            raw_ok[b] &= bool(torch.equal(x[sl] @ w0, raw_full[sl]))
            scores_ok &= bool(torch.equal(
                lmbf.predict(idx.params, idx.cfg, enc[sl]), full[sl]))
    log(f"[slice] batch invariance over {len(rows)} rows: raw x @ w0 "
        f"bit-identical to the full-set product at batch "
        f"{ {b: ok for b, ok in raw_ok.items()} }; port scores (fixed "
        f"{lmbf.ROW_CHUNK}-row blocks) bit-identical at every batch: "
        f"{scores_ok}")
    if not scores_ok:
        raise AssertionError("model scores depend on the batch size")


def setup_index(device):
    """The slice's data and index, built on ``device``."""
    t0 = time.perf_counter()
    ds = tuples.synthesize(memory.AIRPLANE_CARDS, N_RECORDS, seed=SEED)
    idx = build_index(ds, device)
    fx = idx.fixup_filter
    log(f"[slice] index built in {time.perf_counter() - t0:.1f}s: "
        f"{idx.memory.nn_params} params, concat_dim {idx.cfg.concat_dim}, "
        f"{fx.n_false_negatives} fixup keys, m_bits {fx.params.m_bits}, "
        f"k {fx.params.n_hashes}, accuracy {idx.train_log['accuracy']:.4f}")
    return ds, idx, indexed_positives(ds)


def phase_serve(ds: tuples.TupleDataset, idx: existence.ExistenceIndex,
                positives: np.ndarray, device) -> int:
    """Serve every indexed positive and sampled negatives through a
    ``FilterServer`` with the kernel probe; returns the kernel launches
    of the serving run."""
    check_batch_invariance(idx, positives)
    negatives = tuples.sample_negatives(ds, N_NEGATIVES, seed=SEED + 99)
    corpus = np.concatenate([positives, negatives])
    n_pos = len(positives)

    server = FilterServer(ServeConfig(
        placement=PlacementConfig(device=str(device)),
        probe=ProbeConfig(use_kernel=True)))
    handle = server.admit(TenantSpec("airplane", index=idx))
    # warm-up request (first-call costs), outside the measured run
    handle.submit(corpus[:SERVE_BUCKET]).result()

    bloom_ops.LAUNCHES = 0
    t0 = time.perf_counter()
    futures, start, i = [], 0, 0
    while start < len(corpus):
        n = REQUEST_SIZES[i % len(REQUEST_SIZES)]
        futures.append(handle.submit(corpus[start:start + n]))
        start += n
        i += 1
    served = np.concatenate([f.result() for f in futures])
    wall = time.perf_counter() - t0
    launches = bloom_ops.LAUNCHES

    direct = idx.query(corpus).cpu().numpy()
    fn = int((~served[:n_pos]).sum())
    log(f"[slice] served {len(corpus)} rows in {len(futures)} requests "
        f"({n_pos} indexed positives + {len(negatives)} negatives): "
        f"{len(corpus) / wall:.0f} q/s over {wall:.3f}s; false negatives "
        f"{fn}; bloom_query launches {launches}")
    if fn:
        raise AssertionError(f"{fn} false negatives on indexed positives")
    if not np.array_equal(served, direct):
        raise AssertionError("served answers differ from "
                             "ExistenceIndex.query")
    snap = server.stats_snapshot()
    log("[slice] stats " + json.dumps(
        {k: snap[k] for k in ("queries", "batches", "batch_occupancy",
                              "model_pos_rate", "fixup_hit_rate",
                              "positive_rate", "batch_p50_ms",
                              "batch_p99_ms", "request_p50_ms",
                              "request_p99_ms", "compile_count",
                              "compile_ms_total")}))
    log(f"[slice] negatives: positive rate "
        f"{float(served[n_pos:].mean()):.4f}")
    server.close()
    return launches


def main() -> int:
    dev_info = phase_device()
    phase_build()
    dev = torch.device("cuda")
    torch.cuda.reset_peak_memory_stats()
    ds, idx, positives = setup_index(dev)
    kernel = phase_kernels(idx.fixup_filter.params, idx.fixup_filter.bits,
                           positives)
    kernel["launches"] = phase_serve(ds, idx, positives, dev)
    if kernel["launches"] < 1:
        raise AssertionError("the serving run never launched bloom_query")
    log(f"[slice] max_memory_allocated {torch.cuda.max_memory_allocated()} "
        f"bytes")
    print(json.dumps({"kernels": [kernel]}), flush=True)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": dev_info["kind"],
        "count": dev_info["count"]}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
