"""Port parity: lossless input compression (plans, encode, decode)."""
import dataclasses
import itertools

import jax.numpy as jnp
import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro.core import compression as jcomp  # noqa: E402
from repro_torch.core import compression as comp  # noqa: E402

PLANS = [
    # (cardinalities, theta, ns)
    ((7, 30, 5), 6, 2),
    ((50, 3, 17), 10, 3),
    ((12, 9), 100, 2),               # nothing compressed
    ((64,), 4, 4),
]


@pytest.mark.parametrize("cards,theta,ns", PLANS)
def test_plans_equal(cards, theta, ns):
    p = comp.make_plan(cards, theta, ns)
    jp = jcomp.make_plan(cards, theta, ns)
    assert dataclasses.asdict(p) == dataclasses.asdict(jp)
    assert (p.input_dim, p.table_rows, p.n_subcolumns) == \
        (jp.input_dim, jp.table_rows, jp.n_subcolumns)


@pytest.mark.parametrize("cards,theta,ns", PLANS)
def test_encode_decode_exhaustive(cards, theta, ns):
    """Every tuple of the (small) domain, wildcard id 0 included, plus
    out-of-domain and negative ids: encode, encode_np and decode equal
    the reference bit for bit."""
    plan = comp.make_plan(cards, theta, ns)
    jplan = jcomp.make_plan(cards, theta, ns)
    domain = np.array(list(itertools.product(*[range(v) for v in cards])),
                      np.int32)
    odd = np.array([[-1] * len(cards), [v + 3 for v in cards],
                    [-v for v in cards]], np.int32)
    ids = np.concatenate([domain, odd])
    want = np.asarray(jcomp.encode(jnp.asarray(ids), jplan))
    got = comp.encode(torch.from_numpy(ids), plan)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(comp.encode_np(ids, plan),
                                  jcomp.encode_np(ids, jplan))
    np.testing.assert_array_equal(
        comp.decode(got, plan).numpy(),
        np.asarray(jcomp.decode(jnp.asarray(want), jplan)))
    # lossless on the domain
    np.testing.assert_array_equal(
        comp.decode(comp.encode(torch.from_numpy(domain), plan),
                    plan).numpy(), domain)


def test_wildcard_maps_to_dedicated_slot():
    plan = comp.make_plan((40, 5), theta=10, ns=2)
    enc = comp.encode(torch.tensor([[0, 0]], dtype=torch.int32), plan)
    col = plan.columns[0]
    assert enc[0, :2].tolist() == list(col.wildcard_ids)
    assert enc[0, 2].item() == comp.WILDCARD
