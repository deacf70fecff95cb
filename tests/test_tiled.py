"""Tiled-domain API (round 3, VERDICT round-2 item 3).

Chained four-step pipelines may stay on the rank-3 (B, n1, n2) layout;
everything here pins bit-exact equivalence with the flat API.
"""

import numpy as np
import pytest

from agilex_ntt import Ring


@pytest.fixture(
    scope="module",
    params=["xla", "pallas-full-fuse", "pallas-composed"],
)
def tring(request):
    # the plain path, and the kernel (interpreter) at a square and at a
    # larger split
    if request.param == "xla":
        return Ring(16384, method="fourstep")
    if request.param == "pallas-full-fuse":
        return Ring(16384, method="fourstep", interpret=True)
    return Ring(1 << 18, method="fourstep", interpret=True)


def _batch(rng, ring, shape):
    return rng.integers(0, ring.q, size=shape + (ring.n,), dtype=np.uint32)


def test_tiled_roundtrip_layout(tring, rng):
    x = _batch(rng, tring, (3,))
    xt = tring.to_tiled(x)
    assert xt.shape == (3,) + tring.tile_shape
    assert (np.asarray(tring.from_tiled(xt)) == x).all()


def test_ntt_tiled_matches_flat(tring, rng):
    x = _batch(rng, tring, (2,))
    want = np.asarray(tring.ntt(x))
    got = np.asarray(tring.from_tiled(tring.ntt_tiled(tring.to_tiled(x))))
    assert (got == want).all()


def test_intt_tiled_matches_flat(tring, rng):
    x = _batch(rng, tring, (2,))
    y = tring.ntt_tiled(tring.to_tiled(x))
    back = np.asarray(tring.from_tiled(tring.intt_tiled(y)))
    assert (back == x).all()


def test_polymul_tiled_matches_flat(tring, rng):
    a = _batch(rng, tring, (2,))
    b = _batch(rng, tring, (2,))
    want = np.asarray(tring.polymul(a, b))
    got = np.asarray(tring.from_tiled(
        tring.polymul_tiled(tring.to_tiled(a), tring.to_tiled(b))
    ))
    assert (got == want).all()


def test_chained_pipeline_stays_tiled(tring, rng):
    """(a*b) + (c*d) entirely in the tiled domain, one ingress/egress."""
    a, b, c, d = (_batch(rng, tring, ()) for _ in range(4))
    at, bt, ct, dt = (tring.to_tiled(v) for v in (a, b, c, d))
    res_t = tring.add(tring.polymul_tiled(at, bt),
                      tring.polymul_tiled(ct, dt))
    want = np.asarray(tring.add(tring.polymul(a, b), tring.polymul(c, d)))
    assert (np.asarray(tring.from_tiled(res_t)) == want).all()


def test_elementwise_accept_tiled(tring, rng):
    a = tring.to_tiled(_batch(rng, tring, (2,)))
    b = tring.to_tiled(_batch(rng, tring, (2,)))
    q = tring.q
    s = np.asarray(tring.add(a, b))
    assert (s == (np.asarray(a).astype(np.uint64)
                  + np.asarray(b)) % q).all()
    pw = np.asarray(tring.pointwise_mul(a, b))
    assert (pw == np.asarray(a).astype(np.uint64)
            * np.asarray(b) % q).all()


def test_tiled_batch_shapes(tring, rng):
    # no leading dims and nested leading dims both work
    x0 = _batch(rng, tring, ())
    y0 = np.asarray(tring.ntt_tiled(tring.to_tiled(x0)))
    assert y0.shape == tring.tile_shape
    x2 = _batch(rng, tring, (2, 3))
    y2 = np.asarray(tring.ntt_tiled(tring.to_tiled(x2)))
    assert y2.shape == (2, 3) + tring.tile_shape
    flat = np.asarray(tring.ntt(x2))
    assert (y2.reshape(2, 3, tring.n) == flat).all()


def test_tiled_requires_fourstep():
    r = Ring(256)
    with pytest.raises(ValueError, match="four-step"):
        r.to_tiled(np.zeros((1, 256), dtype=np.uint32))
    with pytest.raises(ValueError, match="four-step"):
        _ = r.tile_shape


def test_tiled_shape_validation(tring):
    bad = np.zeros((2, 7, 5), dtype=np.uint32)
    with pytest.raises(ValueError, match="n1, n2"):
        tring.ntt_tiled(bad)
    with pytest.raises(ValueError, match="last dim"):
        tring.to_tiled(np.zeros((2, 7), dtype=np.uint32))
