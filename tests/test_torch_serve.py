"""Port parity: single-tenant filter serving (admit -> submit -> result).

Served answers must be bit-identical to the port's own
``ExistenceIndex.query`` whatever the bucket or request split, equal to a
JAX ``FilterServer`` on the same checkpoint and queries (on every row
whose JAX score is farther than 1e-6 from tau; there are none nearer at
this seed), and keep zero false negatives. Serving on the card is
tested in ``tests/test_torch_gpu.py``.
"""
import json
import os

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import existence as jex  # noqa: E402
from repro.data import tuples as jtuples  # noqa: E402
from repro.serve_filter import FilterServer as JaxServer  # noqa: E402
from repro.serve_filter import ServeConfig as JaxConfig  # noqa: E402
from repro.serve_filter import TenantSpec as JaxSpec  # noqa: E402
from repro_torch.core import existence  # noqa: E402
from repro_torch.kernels.bloom_query import ops  # noqa: E402
from repro_torch.serve_filter import (DeadlineExceeded, FilterServer,  # noqa: E402
                                      FilterServeError, Overloaded,
                                      ReliabilityConfig, ServeConfig,
                                      PlacementConfig, TenantSpec,
                                      TenantState)

NEAR_TAU = 1e-6
SIZES = (1, 37, 64, 65, 255, 1000, 4095, 4097, 9000)


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    ds = jtuples.synthesize([300, 200, 80], n_records=3000, seed=3)
    idx = jex.fit(ds, theta=100, settings=jex.TrainSettings(
        steps=25, n_pos=1200, n_neg=1200))
    root = str(tmp_path_factory.mktemp("ckpt"))
    jex.save_index(os.path.join(root, "a"), idx)
    rng = np.random.default_rng(11)
    neg = np.stack([rng.integers(0, v, 20_000) for v in ds.cards], -1)
    corpus = np.concatenate([ds.records, neg]).astype(np.int32)
    return ds, idx, root, corpus


def _serve(server, handle, corpus, sizes=SIZES):
    futures, start, i = [], 0, 0
    while start < len(corpus):
        n = sizes[i % len(sizes)]
        futures.append(handle.submit(corpus[start:start + n]))
        start += n
        i += 1
    return np.concatenate([f.result() for f in futures])


def test_served_equals_own_query_across_buckets(fitted):
    ds, _, root, corpus = fitted
    server = FilterServer(device="cpu", use_kernel=True)
    handle = server.admit(TenantSpec("a", checkpoint=root))
    launches = ops.LAUNCHES
    served = _serve(server, handle, corpus)
    assert ops.LAUNCHES == launches       # CPU tensors: the plain probe
    idx = existence.load_index(os.path.join(root, "a"), device="cpu")
    np.testing.assert_array_equal(served, idx.query(corpus).numpy())
    assert served[:len(ds.records)].all()             # zero false negatives
    snap = server.stats_snapshot()
    assert snap["queries"] == len(corpus)
    assert snap["batches"] >= len(corpus) // 4096
    assert 0.0 < snap["batch_occupancy"] <= 1.0


def test_served_equals_jax_server(fitted):
    _, idx, root, corpus = fitted
    port = FilterServer(device="cpu", use_kernel=True)
    port_ans = port.admit(TenantSpec("a", checkpoint=root)) \
        .submit(corpus).result()
    jax_server = JaxServer(JaxConfig.from_kwargs(use_kernel=True))
    jax_ans = jax_server.admit(JaxSpec("a", checkpoint=root)) \
        .submit(corpus).result()
    js = np.asarray(idx.scores(corpus))
    far = np.abs(js - idx.tau) > NEAR_TAU
    assert int((~far).sum()) == 0
    np.testing.assert_array_equal(port_ans[far], jax_ans[far])
    # the pinned snapshot key set is the JAX server's
    assert set(port.stats_snapshot()) == set(jax_server.stats_snapshot())
    assert all(isinstance(v, float) for v in port.stats_snapshot().values())


@pytest.mark.parametrize("kwargs,item", [
    ({"grouped": True}, "item 6"),
    ({"quantized": True}, "item 7"),
    ({"mesh": object()}, "item 9"),
    ({"async_dispatch": True}, "item 5"),
])
def test_unported_options_raise(kwargs, item):
    with pytest.raises(NotImplementedError, match=item):
        FilterServer(device="cpu", **kwargs)


def test_v3_checkpoint_is_not_served(fitted, tmp_path):
    _, idx, _, _ = fitted
    jex.save_index(str(tmp_path / "q"), idx,
                   quant={"bits": 8, "grid": "linear", "row_group": 32,
                          "calib_samples": 64, "margin_safety": 2.0,
                          "margin_floor": 1e-3})
    server = FilterServer(device="cpu")
    with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
        server.admit(TenantSpec("q", checkpoint=str(tmp_path)))
    assert server.registry.state_of("q") is TenantState.RETIRED


def test_cuda_default_without_cuda_raises(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        FilterServer()
    with pytest.raises(RuntimeError):
        FilterServer(ServeConfig(placement=PlacementConfig(device="cuda")))


def test_lifecycle_reload_retire(fitted):
    ds, _, root, corpus = fitted
    server = FilterServer(device="cpu")
    handle = server.admit(TenantSpec("a", checkpoint=root))
    assert handle.state is TenantState.SERVING and handle.epoch == 0
    before = handle.query(corpus[:500])
    handle.reload(checkpoint=root)
    assert handle.epoch == 1
    np.testing.assert_array_equal(handle.query(corpus[:500]), before)
    handle.retire()
    assert handle.state is TenantState.RETIRED
    with pytest.raises(KeyError):
        server.submit("a", corpus[:3])
    snap = server.stats_snapshot()
    assert snap["reloads"] == 1.0 and snap["lifecycle_retired"] == 1.0


def test_deadline_backpressure_and_save(fitted, tmp_path):
    _, _, root, corpus = fitted
    server = FilterServer(ServeConfig(
        placement=PlacementConfig(device="cpu"),
        reliability=ReliabilityConfig(max_queued_rows=5000)))
    handle = server.admit(TenantSpec("a", checkpoint=root))
    fut = handle.submit(corpus[:10], deadline_ms=0.0)
    with pytest.raises(DeadlineExceeded):
        fut.result()
    with pytest.raises(Overloaded):
        handle.submit(corpus[:6000])
    assert server.stats_snapshot()["shed_rows"] == 6000.0
    path = handle.save(str(tmp_path))
    back = jex.load_index(path)
    np.testing.assert_array_equal(np.asarray(back.query(corpus[:800])),
                                  handle.query(corpus[:800]))


def test_degraded_backup_only_keeps_zero_false_negatives(fitted, tmp_path):
    """A fresh tenant whose model arrays fail their CRC serves from its
    backup bitset alone: all positive, never a false negative."""
    ds, idx, _, corpus = fitted
    d = tmp_path / "b"
    jex.save_index(str(d), idx)
    meta_path = d / "step_0" / "meta.json"
    meta = json.loads(meta_path.read_text())
    meta["arrays"]["['params']['dense']['w0']"]["crc32"] ^= 1
    meta_path.write_text(json.dumps(meta))
    server = FilterServer(ServeConfig(
        placement=PlacementConfig(device="cpu"),
        reliability=ReliabilityConfig(degraded=True)))
    handle = server.admit(TenantSpec("b", checkpoint=str(tmp_path)))
    assert handle.state is TenantState.DEGRADED
    ans = handle.query(corpus[:2000])
    assert ans.all()
    server.registry.begin_drain("b")
    with pytest.raises(FilterServeError, match="draining"):
        server.submit("b", corpus[:1])
    handle.retire()
    assert handle.state is TenantState.RETIRED


def test_budget_lru_metrics_and_trace(fitted, tmp_path):
    _, _, root, corpus = fitted
    idx = existence.load_index(os.path.join(root, "a"), device="cpu")
    server = FilterServer(device="cpu", budget_mb=2.5 * idx.total_mb,
                          metrics_path=str(tmp_path / "m.jsonl"),
                          trace_path=str(tmp_path / "t.json"))
    for tenant in ("t1", "t2"):
        server.admit(TenantSpec(tenant, index=idx))
    server.registry.get("t1")                 # t2 is now least recent
    server.admit(TenantSpec("t3", index=idx))
    assert set(server.registry.tenants) == {"t1", "t3"}
    assert server.registry.evictions == ["t2"]
    server.scheduler.submit("t1", corpus[:100])
    assert server.run_until_drained() == 1
    server.close()
    rec = json.loads((tmp_path / "m.jsonl").read_text().splitlines()[-1])
    assert rec["queries"] == 100.0 and rec["lifecycle_retired"] == 1.0
    names = {e["name"] for e in
             json.loads((tmp_path / "t.json").read_text())["traceEvents"]}
    assert {"admit", "prepare", "dispatch", "device_block",
            "scatter_retire", "device_compute"} <= names
