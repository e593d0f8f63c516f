"""The port on the card: the CUDA kernel against its plain version, and
serving through it. Every test here needs a CUDA card (marker ``gpu``)
and skips without one; run them on the card with
``PYTHONPATH=src python -m pytest -m gpu tests/test_torch_gpu.py``.

The machine with the card has no JAX, so this file imports only
``torch`` and the port: the kernel is held bit for bit against the
port's plain version, which ``tests/test_torch_bloom.py`` holds against
the JAX package on the CPU.
"""
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.core import bloom, compression as comp  # noqa: E402
from repro_torch.core import existence, lmbf  # noqa: E402
from repro_torch.data import tuples  # noqa: E402
from repro_torch.kernels.bloom_query import ops  # noqa: E402
from repro_torch.serve_filter import FilterServer, TenantSpec  # noqa: E402

pytestmark = pytest.mark.gpu


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _ids(rng, n, n_cols):
    return rng.integers(-2**31, 2**31, size=(n, n_cols),
                        dtype=np.int64).astype(np.int32)


@pytest.mark.parametrize("n_keys,n_cols,n_query,m_bits", [
    (50_000, 7, 4096, 0), (50_000, 7, 1, 0), (2_000, 7, 1001, 0),
    (2_000, 1, 777, 0), (2_000, 19, 777, 0), (500, 7, 777, 64),
])
def test_kernel_matches_plain_on_card(rng, cuda, n_keys, n_cols, n_query,
                                      m_bits):
    p = bloom.params_for(n_keys, 0.01)
    if m_bits:
        p = bloom.BloomParams(m_bits=m_bits, n_hashes=p.n_hashes)
    bits = bloom.empty(p)
    keys = _ids(rng, n_keys, n_cols)
    bloom.add(bits, keys, p)
    q = np.concatenate([keys[:n_query // 2],
                        _ids(rng, n_query - n_query // 2, n_cols)])
    tq = torch.from_numpy(q).to(cuda)
    tb = bloom.bits_tensor(bits, cuda)
    before = ops.LAUNCHES
    got = ops.bloom_query(tq, tb, p)
    torch.cuda.synchronize()
    assert ops.LAUNCHES == before + 1
    assert torch.equal(got, bloom.query(tb, tq, p))
    assert got[:n_query // 2].all()


def test_kernel_rejects_mixed_devices(cuda):
    p = bloom.params_for(100, 0.01)
    ids = torch.zeros((4, 3), dtype=torch.int32, device=cuda)
    with pytest.raises(ValueError):
        ops.bloom_query(ids, bloom.bits_tensor(bloom.empty(p)), p)


@pytest.fixture
def card_index(cuda):
    ds = tuples.synthesize([300, 200, 80], n_records=3000, seed=3)
    cfg = lmbf.LMBFConfig(plan=comp.make_plan(ds.cards, theta=100, ns=2))
    params = lmbf.init(cfg, seed=0, device=cuda)
    return ds, existence.index_from_params(
        ds, cfg, params, existence.TrainSettings(n_pos=1200, n_neg=1200))


def test_scores_do_not_depend_on_the_batch_on_card(card_index):
    ds, idx = card_index
    enc = comp.encode(torch.from_numpy(ds.records).to(idx.device),
                      idx.cfg.plan)
    full = lmbf.predict(idx.params, idx.cfg, enc)
    for start, size in [(0, 1), (7, 1), (3, 64), (100, 1000), (0, 2999)]:
        sl = slice(start, start + size)
        assert torch.equal(lmbf.predict(idx.params, idx.cfg, enc[sl]),
                           full[sl])


def test_served_on_card_through_kernel(card_index):
    ds, idx = card_index
    rng = np.random.default_rng(5)
    neg = np.stack([rng.integers(0, v, 5000) for v in ds.cards], -1)
    corpus = np.concatenate([ds.records, neg]).astype(np.int32)
    server = FilterServer(use_kernel=True)          # default device: cuda
    handle = server.admit(TenantSpec("a", index=idx))
    before = ops.LAUNCHES
    futures = [handle.submit(corpus[s:s + n]) for s, n in
               [(0, 1), (1, 37), (38, 1000), (1038, len(corpus))]]
    served = np.concatenate([f.result() for f in futures])
    assert ops.LAUNCHES > before
    np.testing.assert_array_equal(served, idx.query(corpus).cpu().numpy())
    assert served[:len(ds.records)].all()            # no false negatives
