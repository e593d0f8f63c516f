"""Port parity: the existence index, its checkpoints across the two
packages, the data generators, and the query pipeline."""
import json
import os
import warnings

import jax
import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import existence as jex  # noqa: E402
from repro.data import tuples as jtuples  # noqa: E402
from repro_torch.checkpoint import manager as ckpt  # noqa: E402
from repro_torch.core import bloom, existence, lmbf  # noqa: E402
from repro_torch.data import tuples  # noqa: E402

NEAR_TAU = 1e-6


@pytest.fixture(scope="module")
def fitted(tmp_path_factory):
    ds = jtuples.synthesize([300, 200, 80], n_records=1500, seed=3)
    idx = jex.fit(ds, theta=100, settings=jex.TrainSettings(
        steps=25, n_pos=1200, n_neg=1200))
    d = str(tmp_path_factory.mktemp("jax_index"))
    jex.save_index(d, idx)
    return ds, idx, d


def _corpus(ds, seed, n=2000):
    rng = np.random.default_rng(seed)
    neg = np.stack([rng.integers(0, v, n) for v in ds.cards], -1)
    return np.concatenate([ds.records, neg]).astype(np.int32)


def test_tuples_identical_arrays():
    cards = [300, 200, 80, 9]
    a, b = jtuples.synthesize(cards, 2000, seed=5), \
        tuples.synthesize(cards, 2000, seed=5)
    np.testing.assert_array_equal(a.records, b.records)
    for fn, args in [("sample_positives", (300, 7)),
                     ("sample_negatives", (300, 8))]:
        np.testing.assert_array_equal(getattr(jtuples, fn)(a, *args),
                                      getattr(tuples, fn)(b, *args))
    ji, jl = jtuples.make_training_set(a, 500, 400, seed=9)
    ti, tl = tuples.make_training_set(b, 500, 400, seed=9)
    np.testing.assert_array_equal(ji, ti)
    np.testing.assert_array_equal(jl, tl)


def test_jax_checkpoint_loads_bit_equal(fitted):
    _, idx, d = fitted
    pi = existence.load_index(d, device="cpu")
    host = jax.tree_util.tree_map(np.asarray, idx.params)
    back = lmbf.params_to_numpy(pi.params)
    for group in host:
        for k in host[group]:
            np.testing.assert_array_equal(back[group][k], host[group][k])
    np.testing.assert_array_equal(pi.fixup_filter.bits, idx.fixup_filter.bits)
    assert pi.fixup_filter.bits.dtype == np.uint32
    assert pi.tau == idx.tau
    assert pi.cfg.column_encodings == idx.cfg.column_encodings
    assert pi.cfg.hidden == idx.cfg.hidden
    assert existence._plan_to_json(pi.cfg.plan) == \
        jex._plan_to_json(idx.cfg.plan)
    assert (pi.fixup_filter.params.m_bits, pi.fixup_filter.params.n_hashes,
            pi.fixup_filter.n_false_negatives) == (
        idx.fixup_filter.params.m_bits, idx.fixup_filter.params.n_hashes,
        idx.fixup_filter.n_false_negatives)
    assert pi.train_log == json.loads(json.dumps(idx.train_log))


def test_port_checkpoint_loads_in_jax(fitted, tmp_path):
    ds, idx, d = fitted
    pi = existence.load_index(d, device="cpu")
    out = str(tmp_path / "port_index")
    existence.save_index(out, pi)
    back = jex.load_index(out)
    q = _corpus(ds, 1)
    np.testing.assert_array_equal(np.asarray(back.query(q)),
                                  np.asarray(idx.query(q)))
    assert existence.index_meta(pi) == jex.index_meta(back) | {
        "train_log": json.loads(json.dumps(idx.train_log))}


def test_flipped_byte_raises_corruption(fitted, tmp_path):
    _, idx, _ = fitted
    d = str(tmp_path / "corrupt")
    jex.save_index(d, idx)
    path = os.path.join(d, "step_0", "arrays.npz")
    data = bytearray(open(path, "rb").read())
    meta = ckpt.read_meta(d, 0)
    # flip a byte inside the fixup bitset's stored payload
    raw = np.asarray(idx.fixup_filter.bits).tobytes()
    at = data.find(raw[:64])
    assert at > 0
    data[at + 3] ^= 0xFF
    open(path, "wb").write(bytes(data))
    assert "['fixup_bits']" in meta["arrays"]
    with pytest.raises(ckpt.CheckpointCorruption):
        existence.load_index(d, device="cpu")
    with pytest.raises(ckpt.CheckpointCorruption):
        existence.load_fixup_only(d)


def test_load_fixup_only_and_kinds(fitted, tmp_path):
    _, idx, d = fitted
    cfg, fx = existence.load_fixup_only(d)
    np.testing.assert_array_equal(fx.bits, idx.fixup_filter.bits)
    assert cfg.concat_dim == idx.cfg.concat_dim
    # v1 loads with the reference's warning; v3 is not ported yet
    for kind, expect in [("existence_index_v1", UserWarning),
                         ("existence_index_v3", NotImplementedError)]:
        out = str(tmp_path / kind)
        meta = jex.index_meta(idx, kind=kind)
        from repro.checkpoint import manager as jckpt
        jckpt.save(out, 0, {"params": idx.params,
                            "fixup_bits": np.asarray(idx.fixup_filter.bits)},
                   extra=meta)
        if expect is UserWarning:
            with pytest.warns(UserWarning, match="existence_index_v1"):
                existence.load_index(out, device="cpu")
        else:
            with pytest.raises(NotImplementedError, match="Queue 1 item 7"):
                existence.load_index(out, device="cpu")
    with pytest.raises(NotImplementedError):
        existence.save_index(str(tmp_path / "q"), existence.load_index(
            d, device="cpu"), quant={"bits": 8})


def test_query_stages_match_jax(fitted):
    """Answers equal the reference's on every row whose JAX score is
    farther than 1e-6 from tau; the rows nearer than that are counted,
    and there are none at this seed."""
    ds, idx, d = fitted
    pi = existence.load_index(d, device="cpu")
    q = _corpus(ds, 2)
    jans, jmodel, jbackup = existence_stages_jax(idx, q)
    ans, model, backup = existence.query_stages(
        pi.params, pi.cfg, pi.tau,
        bloom.bits_tensor(pi.fixup_filter.bits), pi.fixup_filter.params,
        torch.from_numpy(q))
    js = np.asarray(idx.scores(q))
    far = np.abs(js - idx.tau) > NEAR_TAU
    assert int((~far).sum()) == 0
    np.testing.assert_array_equal(ans.numpy()[far], jans[far])
    np.testing.assert_array_equal(model.numpy()[far], jmodel[far])
    np.testing.assert_array_equal(backup.numpy(), jbackup)
    assert ans.numpy()[:len(ds.records)].all()      # no false negatives
    np.testing.assert_array_equal(pi.query(q).numpy(), ans.numpy())


def existence_stages_jax(idx, q):
    out = jex.query_stages(idx.params, idx.cfg, idx.tau,
                           jnp.asarray(idx.fixup_filter.bits),
                           idx.fixup_filter.params, q)
    return tuple(np.asarray(o) for o in out)


def test_index_from_params_matches_fit_tail(fitted):
    """The fixup filter the port builds for given params equals the one
    ``jex.fit`` built for the same params (scores agree away from tau,
    and no row of this seed is near it)."""
    ds, idx, d = fitted
    pi = existence.load_index(d, device="cpu")
    st = existence.TrainSettings(steps=25, n_pos=1200, n_neg=1200)
    built = existence.index_from_params(ds, pi.cfg, pi.params, st)
    assert built.fixup_filter.params == pi.fixup_filter.params
    np.testing.assert_array_equal(built.fixup_filter.bits,
                                  idx.fixup_filter.bits)
    assert built.fixup_filter.n_false_negatives == \
        idx.fixup_filter.n_false_negatives
    assert built.train_log["accuracy"] == pytest.approx(
        idx.train_log["accuracy"], abs=1e-3)
    assert built.query(ds.records).all()


def test_load_index_never_falls_back_to_cpu(fitted, monkeypatch):
    _, _, d = fitted
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        existence.load_index(d)               # default device is cuda
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        existence.load_index(d, device="cpu")
