"""Port parity: Bloom hashing/probes and the bloom_query kernel wrapper.

The JAX package pins no golden hash values, so every check compares the
port's function with the JAX function directly, on the same numpy
inputs, bit for bit. The CUDA kernel itself is held against this plain
version on the card by ``tests/test_torch_gpu.py`` and ``chip_smoke.py``.
"""
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import bloom as jbloom  # noqa: E402
from repro.kernels.bloom_query.bloom_query import bloom_query_call  # noqa: E402
from repro_torch.core import bloom  # noqa: E402
from repro_torch.kernels.bloom_query import ops  # noqa: E402


def _ids(rng, n, n_cols):
    ids = rng.integers(-2**31, 2**31, size=(n, n_cols),
                       dtype=np.int64).astype(np.int32)
    specials = np.array([0, 1, 2**31 - 1, -1, -2**31, 12345], np.int32)
    ids[:len(specials)] = specials[:, None]
    return ids


def _params(p):
    return bloom.BloomParams(m_bits=p.m_bits, n_hashes=p.n_hashes)


@pytest.mark.parametrize("n_cols", list(range(1, 20)))
def test_hash_tuples_bit_equal(rng, n_cols):
    ids = _ids(rng, 257, n_cols)
    for seed in (bloom.SEED_H1, bloom.SEED_H2, 0, 0xFFFFFFFF):
        want = np.asarray(jbloom.hash_tuples(jnp.asarray(ids), seed))
        got = bloom.hash_tuples(torch.from_numpy(ids), seed).numpy()
        np.testing.assert_array_equal(got, want.astype(np.int64))


def test_fmix32_bit_equal(rng):
    h = rng.integers(0, 2**32, size=1000, dtype=np.uint64).astype(np.uint32)
    want = np.asarray(jbloom.fmix32(jnp.asarray(h)))
    got = bloom.fmix32(torch.from_numpy(h.astype(np.int64))).numpy()
    np.testing.assert_array_equal(got, want.astype(np.int64))


@pytest.mark.parametrize("n_keys,fpr,n_cols", [(100, 0.05, 1), (3000, 0.01, 7),
                                               (500, 0.1, 19)])
def test_params_positions_words_add_query(rng, n_keys, fpr, n_cols):
    jp = jbloom.params_for(n_keys, fpr)
    p = bloom.params_for(n_keys, fpr)
    assert (p.m_bits, p.n_hashes, p.n_words) == (jp.m_bits, jp.n_hashes,
                                                 jp.n_words)
    keys = _ids(rng, n_keys, n_cols)
    np.testing.assert_array_equal(
        bloom.probe_positions(torch.from_numpy(keys), p).numpy(),
        np.asarray(jbloom.probe_positions(jnp.asarray(keys), jp)))
    jw, jm = jbloom.probe_words(jnp.asarray(keys), jp)
    w, sh = bloom.probe_words(torch.from_numpy(keys), p)
    np.testing.assert_array_equal(w.numpy(), np.asarray(jw))
    np.testing.assert_array_equal(
        (np.uint32(1) << sh.numpy().astype(np.uint32)), np.asarray(jm))
    jbits = jbloom.add(jbloom.empty(jp), keys, jp)
    bits = bloom.add(bloom.empty(p), keys, p)
    np.testing.assert_array_equal(bits, jbits)
    queries = np.concatenate([keys[:200], _ids(rng, 800, n_cols)])
    np.testing.assert_array_equal(
        bloom.query(bits, torch.from_numpy(queries), p).numpy(),
        np.asarray(jbloom.query(jbits, jnp.asarray(queries), jp)))
    assert bloom.fpr_estimate(p, n_keys) == jbloom.fpr_estimate(jp, n_keys)


# the three shapes of tests/test_kernels.py::test_bloom_query_bit_exact,
# plus a ragged N that is no multiple of any block size
@pytest.mark.parametrize("n_keys,fpr,n_cols,n_query", [
    (5_000, 0.1, 3, 1000), (50_000, 0.01, 7, 1000), (100, 0.05, 1, 600),
    (2_000, 0.01, 5, 1237),
])
def test_ops_cpu_matches_pallas_interpret(rng, n_keys, fpr, n_cols,
                                          n_query):
    jp = jbloom.params_for(n_keys, fpr)
    jbits = jbloom.empty(jp)
    keys = rng.integers(0, 10_000, size=(n_keys, n_cols)).astype(np.int32)
    jbloom.add(jbits, keys, jp)
    n_pos = min(n_query // 2, n_keys)
    queries = np.concatenate(
        [keys[:n_pos], rng.integers(0, 10_000, size=(n_query - n_pos, n_cols))
         .astype(np.int32)])
    want = np.asarray(bloom_query_call(
        jnp.asarray(queries), jnp.asarray(jbits), n_hashes=jp.n_hashes,
        m_bits=jp.m_bits, interpret=True))
    before = ops.LAUNCHES
    got = ops.bloom_query(torch.from_numpy(queries), bloom.bits_tensor(jbits),
                          _params(jp))
    assert ops.LAUNCHES == before          # CPU tensors: no kernel launch
    assert got.dtype == torch.bool and got.shape == (n_query,)
    np.testing.assert_array_equal(got.numpy(), want)
    assert got[:n_pos].all()


def test_ops_rejects_bad_inputs():
    p = bloom.params_for(100, 0.01)
    bits = bloom.bits_tensor(bloom.empty(p))
    ids = torch.zeros((4, 3), dtype=torch.int32)
    with pytest.raises(TypeError):
        ops.bloom_query(ids.to(torch.int64), bits, p)
    with pytest.raises(TypeError):
        ops.bloom_query(ids, bits.to(torch.int64), p)
    with pytest.raises(ValueError):
        ops.bloom_query(ids[0], bits, p)                     # not 2-D
    with pytest.raises(ValueError):
        ops.bloom_query(ids, bits[:1], p)                    # too few words
    with pytest.raises(ValueError):
        ops.bloom_query(torch.zeros((3, 4), dtype=torch.int32).t(), bits, p)
    with pytest.raises(ValueError):
        ops.bloom_query(ids, bits, p, device="meta")         # wrong device


def test_bits_tensor_keeps_the_bits(rng):
    words = rng.integers(0, 2**32, size=77, dtype=np.uint64).astype(np.uint32)
    t = bloom.bits_tensor(words)
    assert t.dtype == torch.int32
    np.testing.assert_array_equal(t.numpy().view(np.uint32), words)
