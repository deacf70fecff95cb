"""Ring-level RLWE tensor product: bit-exact vs the composed polymul form.

Ring.tensor computes the degree-2 product in the evaluation domain (4
forward + 3 inverse transforms, one dispatch); these tests pin it
coefficient-exact against three public polymul calls for every kernel
configuration the scheme layer dispatches to.
"""

import numpy as np
import pytest

from agilex_ntt import Ring, RNSRing


def composed(r, a0, a1, b0, b1):
    d0 = np.asarray(r.polymul(a0, b0))
    d2 = np.asarray(r.polymul(a1, b1))
    cross = np.asarray(r.polymul(r.add(a0, a1), r.add(b0, b1)))
    q = getattr(r, "q", None)
    if q is not None:
        d1 = (cross.astype(np.int64) - d0 - d2) % q
    else:  # RNSRing: per-channel moduli
        qs = np.array(r.qs, dtype=np.int64).reshape((-1,) + (1,) * (d0.ndim - 1))
        d1 = (cross.astype(np.int64) - d0 - d2) % qs
    return d0, d1.astype(np.uint32), d2


@pytest.mark.parametrize("n,kwargs", [
    (256, {}),
    (1024, {}),
    (65536, {"method": "fourstep"}),
])
def test_ring_tensor_matches_composed(n, kwargs):
    r = Ring(n, **kwargs)
    rng = np.random.default_rng(3)
    a0, a1, b0, b1 = (
        rng.integers(0, r.q, size=(2, n), dtype=np.uint32) for _ in range(4)
    )
    g0, g1, g2 = (np.asarray(v) for v in r.tensor(a0, a1, b0, b1))
    w0, w1, w2 = composed(r, a0, a1, b0, b1)
    np.testing.assert_array_equal(g0, w0)
    np.testing.assert_array_equal(g1, w1)
    np.testing.assert_array_equal(g2, w2)


def test_ring_tensor_square_matches_tensor():
    r = Ring(512)
    rng = np.random.default_rng(4)
    a0, a1 = (rng.integers(0, r.q, size=(3, 512), dtype=np.uint32)
              for _ in range(2))
    g = [np.asarray(v) for v in r.tensor_square(a0, a1)]
    w = [np.asarray(v) for v in r.tensor(a0, a1, a0, a1)]
    for gi, wi in zip(g, w):
        np.testing.assert_array_equal(gi, wi)


def test_rns_tensor_matches_composed():
    r = RNSRing(512, num_primes=3)
    rng = np.random.default_rng(5)
    mx = min(r.qs)
    a0, a1, b0, b1 = (
        rng.integers(0, mx, size=(3, 4, 512), dtype=np.uint32)
        for _ in range(4)
    )
    g = [np.asarray(v) for v in r.tensor(a0, a1, b0, b1)]
    w = composed(r, a0, a1, b0, b1)
    for gi, wi in zip(g, w):
        np.testing.assert_array_equal(gi, wi)


def test_rns_tensor_square_matches_tensor():
    r = RNSRing(256, num_primes=2)
    rng = np.random.default_rng(6)
    mx = min(r.qs)
    a0, a1 = (rng.integers(0, mx, size=(2, 2, 256), dtype=np.uint32)
              for _ in range(2))
    g = [np.asarray(v) for v in r.tensor_square(a0, a1)]
    w = [np.asarray(v) for v in r.tensor(a0, a1, a0, a1)]
    for gi, wi in zip(g, w):
        np.testing.assert_array_equal(gi, wi)


def test_rns_polydot_multi_matches_per_output_polydot():
    # out[j] = polydot(a, w_j): the fused multi-output form transforms the
    # bundle once; must be bit-exact vs g separate polydot calls
    r = RNSRing(256, num_primes=3)
    rng = np.random.default_rng(7)
    L, B, k, g, n = r.L, 2, 4, 3, 256
    mx = min(r.qs)
    a = rng.integers(0, mx, size=(L, B, k, n), dtype=np.uint32)
    ws = rng.integers(0, mx, size=(L, g, k, n), dtype=np.uint32)
    ws_ntt = np.asarray(r.ntt(ws))
    got = np.asarray(r.polydot_multi(a, ws_ntt))  # (g, L, B, n)
    for j in range(g):
        wj = np.broadcast_to(ws[:, j][:, None], a.shape)
        want = np.asarray(r.polydot(a, wj))
        np.testing.assert_array_equal(got[j], want)
