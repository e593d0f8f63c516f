"""Port parity: the fp32 C-LMBF model, parameter init and Table 1 accounting.

Logits are compared with a tolerance: both packages sum the hidden
layer's fp32 products, but XLA and PyTorch (MKL/oneDNN here, cuBLAS on
the card) accumulate them in different orders, so the last ulps differ.
With ``concat_dim`` 45 products of magnitude < 1, the accumulated error
is a few fp32 ulps of the logit; ``atol = rtol = 1e-5`` bounds that with
margin. Gathers, one-hots and concatenation are exact and are compared
bit for bit.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.configs.clmbf import TABLE1  # noqa: E402
from repro.core import compression as jcomp, existence as jex  # noqa: E402
from repro.core import lmbf as jlmbf, memory as jmemory  # noqa: E402
from repro.data import tuples as jtuples  # noqa: E402
from repro_torch.core import compression as comp, lmbf, memory  # noqa: E402
from repro_torch.nn import layers  # noqa: E402

TOL = dict(rtol=1e-5, atol=1e-5)


@pytest.fixture(scope="module")
def fitted():
    """A small JAX-fitted index with one-hot columns (onehot_max=8) and
    its params carried into the port on the CPU."""
    ds = jtuples.synthesize([300, 200, 80, 6], n_records=1500, seed=3)
    idx = jex.fit(ds, theta=100, onehot_max=8,
                  settings=jex.TrainSettings(steps=25, n_pos=1200,
                                             n_neg=1200))
    host = jax.tree_util.tree_map(np.asarray, idx.params)
    cfg = lmbf.LMBFConfig(
        plan=comp.make_plan(ds.cards, theta=100, ns=2), hidden=(64,),
        onehot_max=8)
    return ds, idx, cfg, lmbf.params_from_numpy(host, device="cpu")


def _queries(ds, rng, n=600):
    pos = ds.records[rng.integers(0, len(ds.records), n // 2)]
    neg = np.stack([rng.integers(0, v, n - n // 2) for v in ds.cards], -1)
    return np.concatenate([pos, neg]).astype(np.int32)


def test_config_and_counts_match(fitted):
    _, idx, cfg, _ = fitted
    assert cfg.column_encodings == idx.cfg.column_encodings
    assert any(e is None for _, e in cfg.column_encodings)   # one-hot used
    assert cfg.concat_dim == idx.cfg.concat_dim
    assert lmbf.count_params(cfg) == jlmbf.count_params(idx.cfg)


def test_features_apply_predict_match(fitted, rng):
    ds, idx, cfg, params = fitted
    raw = _queries(ds, rng)
    jenc = jcomp.encode(jnp.asarray(raw), idx.cfg.plan)
    enc = comp.encode(torch.from_numpy(raw), cfg.plan)
    np.testing.assert_array_equal(
        lmbf.features(params, cfg, enc).numpy(),
        np.asarray(jlmbf.features(idx.params, idx.cfg, jenc)))
    np.testing.assert_allclose(lmbf.apply(params, cfg, enc).numpy(),
                               np.asarray(jlmbf.apply(idx.params, idx.cfg,
                                                      jenc)), **TOL)
    np.testing.assert_allclose(lmbf.predict(params, cfg, enc).numpy(),
                               np.asarray(jlmbf.predict(idx.params, idx.cfg,
                                                        jenc)), **TOL)


def test_out_of_range_ids_match_jax_semantics(rng):
    table = rng.standard_normal((11, 3)).astype(np.float32)
    ids = np.arange(-14, 15, dtype=np.int32)
    np.testing.assert_array_equal(
        layers.take_embedding(torch.from_numpy(table),
                              torch.from_numpy(ids)).numpy(),
        np.asarray(jnp.take(jnp.asarray(table), jnp.asarray(ids), axis=0)))
    np.testing.assert_array_equal(
        layers.one_hot(torch.from_numpy(ids), 11, torch.float32).numpy(),
        np.asarray(jax.nn.one_hot(jnp.asarray(ids), 11, dtype=jnp.float32)))


def test_out_of_range_encoded_ids_through_model(fitted, rng):
    """Bad encoded ids (beyond every table, negative) degrade exactly as
    in the reference: NaN gathers, all-zero one-hots, NaN scores."""
    _, idx, cfg, params = fitted
    rows = np.array(cfg.plan.table_rows)
    enc = np.stack([rows + 5, -rows - 1, rows - 1, -np.ones_like(rows)]) \
        .astype(np.int32)
    got = lmbf.features(params, cfg, torch.from_numpy(enc)).numpy()
    want = np.asarray(jlmbf.features(idx.params, idx.cfg, jnp.asarray(enc)))
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(
        np.isnan(lmbf.predict(params, cfg, torch.from_numpy(enc)).numpy()),
        np.isnan(np.asarray(jlmbf.predict(idx.params, idx.cfg,
                                          jnp.asarray(enc)))))


@pytest.mark.parametrize("exp", TABLE1, ids=lambda e: f"{e.dataset}-{e.theta}")
def test_table1_accounting_matches(exp):
    want = jmemory.table1_row(exp.cards, exp.effective_theta, exp.ns,
                              exp.hidden)
    got = memory.table1_row(exp.cards, exp.effective_theta, exp.ns,
                            exp.hidden)
    assert got == memory.ModelMemory(*vars(want).values())


def test_scores_do_not_depend_on_the_batch(fitted, rng):
    """The head runs on fixed ROW_CHUNK-row blocks, so a row's score is
    bit-identical whatever batch (size or offset) it is scored in."""
    ds, _, cfg, params = fitted
    raw = _queries(ds, rng, n=lmbf.ROW_CHUNK + 300)
    enc = comp.encode(torch.from_numpy(raw), cfg.plan)
    full = lmbf.predict(params, cfg, enc)
    for start, size in [(0, 1), (5, 1), (3, 64), (100, 1000),
                        (0, lmbf.ROW_CHUNK + 1), (250, 50)]:
        sl = slice(start, start + size)
        assert torch.equal(lmbf.predict(params, cfg, enc[sl]), full[sl])


def test_params_numpy_round_trip_and_init(fitted):
    _, idx, cfg, params = fitted
    back = lmbf.params_to_numpy(params)
    for group in ("embed", "dense"):
        for k, v in idx.params[group].items():
            np.testing.assert_array_equal(back[group][k], np.asarray(v))
    a = lmbf.init(cfg, seed=3, device="cpu")
    b = lmbf.init(cfg, seed=3, device="cpu")
    c = lmbf.init(cfg, seed=4, device="cpu")
    for group, leaves in lmbf.params_spec(cfg).items():
        for k, spec in leaves.items():
            assert tuple(a[group][k].shape) == tuple(spec.shape)
            assert torch.equal(a[group][k], b[group][k])
    assert not torch.equal(a["dense"]["w0"], c["dense"]["w0"])
    assert not a["dense"]["b0"].any()
    emb = torch.cat([t.flatten() for t in a["embed"].values()])
    assert 0.04 < float(emb.std()) < 0.06          # init_scale 0.05
    w0 = a["dense"]["w0"]
    assert abs(float(w0.std()) * cfg.concat_dim ** 0.5 - 1.0) < 0.1
