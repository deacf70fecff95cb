"""Galois automorphisms and the cyclic ring — beyond-reference ring ops."""

import numpy as np
import pytest

from agilex_ntt import CyclicRing, Ring


@pytest.fixture(scope="module")
def ring():
    return Ring(256)


def _naive_auto(a, k, q):
    """tau_k by direct exponent bookkeeping over X^n = -1."""
    n = len(a)
    out = np.zeros(n, dtype=np.uint32)
    for j in range(n):
        e = j * k % (2 * n)
        if e < n:
            out[e] = (int(out[e]) + int(a[j])) % q
        else:
            out[e - n] = (int(out[e - n]) - int(a[j])) % q
    return out


@pytest.mark.parametrize("k", [3, 5, 2 * 256 - 1])
def test_automorphism_coeff_matches_naive(ring, rng, k):
    a = rng.integers(0, ring.q, size=(256,), dtype=np.uint32)
    got = np.asarray(ring.automorphism(a, k))
    assert (got == _naive_auto(a, k, ring.q)).all()


def test_automorphism_ntt_domain_commutes(ring, rng):
    """NTT(tau_k(a)) == slot-permutation of NTT(a)."""
    a = rng.integers(0, ring.q, size=(4, 256), dtype=np.uint32)
    for k in (3, 7, 9):
        lhs = np.asarray(ring.ntt(ring.automorphism(a, k)))
        rhs = np.asarray(ring.automorphism(ring.ntt(a), k, domain="ntt"))
        assert (lhs == rhs).all(), k


def test_automorphism_composition(ring, rng):
    a = rng.integers(0, ring.q, size=(256,), dtype=np.uint32)
    k1, k2 = 3, 5
    lhs = np.asarray(ring.automorphism(ring.automorphism(a, k1), k2))
    rhs = np.asarray(ring.automorphism(a, k1 * k2))
    assert (lhs == rhs).all()


def test_automorphism_identity_and_validation(ring, rng):
    a = rng.integers(0, ring.q, size=(256,), dtype=np.uint32)
    assert (np.asarray(ring.automorphism(a, 1)) == a).all()
    with pytest.raises(ValueError, match="odd"):
        ring.automorphism(a, 2)
    with pytest.raises(ValueError, match="domain"):
        ring.automorphism(a, 3, domain="spectral")


def test_automorphism_respects_polymul(ring, rng):
    """tau_k is a ring homomorphism: tau(a*b) == tau(a)*tau(b)."""
    a = rng.integers(0, ring.q, size=(256,), dtype=np.uint32)
    b = rng.integers(0, ring.q, size=(256,), dtype=np.uint32)
    k = 5
    lhs = np.asarray(ring.automorphism(ring.polymul(a, b), k))
    rhs = np.asarray(ring.polymul(ring.automorphism(a, k), ring.automorphism(b, k)))
    assert (lhs == rhs).all()


# -- cyclic ring --------------------------------------------------------------


def test_cyclic_roundtrip(rng):
    r = CyclicRing(512)
    x = rng.integers(0, r.q, size=(4, 512), dtype=np.uint32)
    assert (np.asarray(r.intt(r.ntt(x))) == x).all()


def test_cyclic_polymul_matches_naive(rng):
    r = CyclicRing(128)
    a = rng.integers(0, r.q, size=(128,), dtype=np.uint32)
    b = np.zeros(128, dtype=np.uint32)
    b[0], b[1], b[5] = 2, 7, 11
    got = np.asarray(r.polymul(a, b))
    acc = np.zeros(128, dtype=object)
    for j in (0, 1, 5):
        for i in range(128):
            acc[(i + j) % 128] = (acc[(i + j) % 128] + int(a[i]) * int(b[j])) % r.q
    assert (got == acc.astype(np.uint32)).all()


def test_cyclic_wraparound_differs_from_negacyclic(rng):
    """x^(n-1) * x = x^n: +1 cyclically, -1 negacyclically."""
    n = 128
    cr = CyclicRing(n)
    nr = Ring(n, cr.q)
    a = np.zeros(n, dtype=np.uint32); a[n - 1] = 1
    b = np.zeros(n, dtype=np.uint32); b[1] = 1
    cyc = np.asarray(cr.polymul(a, b))
    neg = np.asarray(nr.polymul(a, b))
    assert cyc[0] == 1 and neg[0] == nr.q - 1


def test_cyclic_large_n_fourstep(rng):
    """Beyond the single-pass wall the cyclic ring uses the all-cyclic
    four-step plan; roundtrip + the pure-rotation convolution property."""
    r = CyclicRing(1 << 16)
    assert r.method == "fourstep"
    x = rng.integers(0, r.q, size=(2, r.n), dtype=np.uint32)
    assert (np.asarray(r.intt(r.ntt(x))) == x).all()
    xp = np.zeros(r.n, dtype=np.uint32)
    xp[1] = 1
    got = np.asarray(r.polymul(x[0], xp))
    assert (got == np.roll(x[0], 1)).all()
    with pytest.raises(ValueError):
        CyclicRing(1 << 16, method="radix2")


def test_cyclic_fourstep_matches_radix2(rng):
    n = 4096
    r2 = CyclicRing(n)
    r4 = CyclicRing(n, r2.q, omega=r2.omega, method="fourstep")
    x = rng.integers(0, r2.q, size=(3, n), dtype=np.uint32)
    assert (np.asarray(r2.ntt(x)) == np.asarray(r4.ntt(x))).all()
    y = r2.ntt(x)
    assert (np.asarray(r2.intt(y)) == np.asarray(r4.intt(y))).all()


def test_polydot_matches_sum_of_polymuls(ring, rng):
    k = 4
    a = rng.integers(0, ring.q, size=(k, 256), dtype=np.uint32)
    b = rng.integers(0, ring.q, size=(k, 256), dtype=np.uint32)
    got = np.asarray(ring.polydot(a, b))
    want = np.zeros(256, dtype=np.uint64)
    for i in range(k):
        want = (want + np.asarray(ring.polymul(a[i], b[i])).astype(np.uint64)) % np.uint64(ring.q)
    assert (got.astype(np.uint64) == want).all()


def test_polydot_batched_and_validated(ring, rng):
    a = rng.integers(0, ring.q, size=(2, 3, 256), dtype=np.uint32)
    b = rng.integers(0, ring.q, size=(2, 3, 256), dtype=np.uint32)
    got = np.asarray(ring.polydot(a, b))
    assert got.shape == (2, 256)
    for j in range(2):
        want = np.asarray(ring.polydot(a[j], b[j]))
        assert (got[j] == want).all()
    with pytest.raises(ValueError, match="matching"):
        ring.polydot(a, b[:1])


def test_rotate_matches_polymul_by_monomial(ring, rng):
    a = rng.integers(0, ring.q, size=(256,), dtype=np.uint32)
    for k in (1, 5, 255, 256, 300, -3):
        xk = np.zeros(256, dtype=np.uint32)
        kk = k % 512
        if kk < 256:
            xk[kk] = 1
        else:
            xk[kk - 256] = ring.q - 1
        want = np.asarray(ring.polymul(a, xk))
        got = np.asarray(ring.rotate(a, k))
        assert (got == want).all(), k


def test_rns_polydot_and_rotate(rng):
    from agilex_ntt import RNSRing

    rns = RNSRing(256, num_primes=2)
    k = 2
    a = np.stack([rng.integers(0, q, size=(k, 256), dtype=np.uint32) for q in rns.qs])
    b = np.stack([rng.integers(0, q, size=(k, 256), dtype=np.uint32) for q in rns.qs])
    got = np.asarray(rns.polydot(a, b))
    for i, r in enumerate(rns.rings):
        assert (got[i] == np.asarray(r.polydot(a[i], b[i]))).all()
    x = a[:, 0]
    rot = np.asarray(rns.rotate(x, 5))
    for i, r in enumerate(rns.rings):
        assert (rot[i] == np.asarray(r.rotate(x[i], 5))).all()
    au = np.asarray(rns.automorphism(x, 3))
    for i, r in enumerate(rns.rings):
        assert (au[i] == np.asarray(r.automorphism(x[i], 3))).all()


def test_polymul_broadcast_shapes(ring, rng):
    """(B, n) x (n,) broadcasts identically on every backend (regression:
    the fused-Pallas path used to zero-pad the operands independently)."""
    a = rng.integers(0, ring.q, size=(4, 256), dtype=np.uint32)
    b = rng.integers(0, ring.q, size=(256,), dtype=np.uint32)
    got = np.asarray(ring.polymul(a, b))
    for j in range(4):
        assert (got[j] == np.asarray(ring.polymul(a[j], b))).all(), j


def test_polymul_broadcast_shapes_fused_interpret(rng):
    """Same regression through the kernel (interpreter)."""
    r = Ring(256, interpret=True)
    a = rng.integers(0, r.q, size=(4, 256), dtype=np.uint32)
    b = rng.integers(0, r.q, size=(256,), dtype=np.uint32)
    got = np.asarray(r.polymul(a, b))
    rx = Ring(256, r.q)
    want = np.asarray(rx.polymul(a, b))
    assert (got == want).all()


def test_rns_fused_polymul_broadcasts_lead_dims(rng):
    """(L, k, n) x (L, 1, n) broadcasts through the fused multi-prime
    kernel path exactly like the stacked per-ring path (regression, round
    4: scheme keygen multiplies the (K, dnum, n) noise block against the
    (K, 1, n) secret — a channel-batched branch that reshaped without
    broadcasting once crashed keygen for every scheme)."""
    from agilex_ntt import RNSRing

    n = 256
    rp = RNSRing(n, num_primes=3, interpret=True)
    rx = RNSRing(n, num_primes=3)
    assert rp._radix2() and rx._radix2()
    a = np.stack([
        rng.integers(0, r.q, size=(4, n), dtype=np.uint32)
        for r in rp.rings
    ])
    s = np.stack([
        rng.integers(0, r.q, size=(1, n), dtype=np.uint32)
        for r in rp.rings
    ])
    got = np.asarray(rp.polymul(a, s))
    want = np.asarray(rx.polymul(a, s))
    assert got.shape == (3, 4, n)
    assert (got == want).all()


def test_rns_fused_polymul_broadcasts_missing_lead_dims(rng):
    """(L, n) x (L, B, n) — RANK-mismatched operands — broadcast through
    the fused kernel path like the stacked path (regression, round 4:
    trailing-aligned broadcast_to collided the channel axis with the batch
    axis, so CKKS encrypt of a batched plaintext against the unbatched
    public key crashed)."""
    from agilex_ntt import RNSRing

    n = 256
    rp = RNSRing(n, num_primes=3, interpret=True)
    rx = RNSRing(n, num_primes=3)
    pk = np.stack([
        rng.integers(0, r.q, size=(n,), dtype=np.uint32) for r in rp.rings
    ])
    v = np.stack([
        rng.integers(0, r.q, size=(5, n), dtype=np.uint32)
        for r in rp.rings
    ])
    for x, y in ((pk, v), (v, pk)):
        got = np.asarray(rp.polymul(x, y))
        want = np.asarray(rx.polymul(x, y))
        assert got.shape == (3, 5, n)
        assert (got == want).all()


def test_cyclic_rejects_oversized_and_composite_q():
    with pytest.raises(ValueError, match="2\\*\\*30"):
        CyclicRing(256, q=2147483137)  # 31-bit prime, q % n == 1
    with pytest.raises(ValueError, match="not prime"):
        CyclicRing(256, q=257 * 769)  # composite, ≡ 1 (mod 256), < 2**30


def test_cyclic_polymul_fused_interpret(rng):
    """CyclicRing.polymul through the kernel with cyclic tables
    (interpreter) vs the plain composition."""
    from agilex_ntt import CyclicRing

    n = 256
    rp = CyclicRing(n, interpret=True)
    rx = CyclicRing(n)
    a = rng.integers(0, rp.q, size=(5, n), dtype=np.uint32)
    b = rng.integers(0, rp.q, size=(5, n), dtype=np.uint32)
    got = np.asarray(rp.polymul(a, b))
    want = np.asarray(rx.polymul(a, b))
    assert (got == want).all()
