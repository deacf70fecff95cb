"""Property-based tests (hypothesis) — SURVEY.md §4 item (4).

Algebraic laws of the negacyclic ring, checked over randomized sizes,
primes, and inputs: NTT∘INTT = id, linearity, convolution theorem,
psi-independence of the roundtrip, and the Montgomery pointwise algebra.
"""

import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from agilex_ntt import Ring
from agilex_ntt.params import find_primes

_SIZES = [16, 64, 256, 512]


def _ring(n, prime_idx=0):
    q = find_primes(n, prime_idx + 1)[prime_idx]
    return Ring(n, q)


@st.composite
def ring_and_polys(draw, num_polys=2):
    n = draw(st.sampled_from(_SIZES))
    prime_idx = draw(st.integers(0, 1))
    seed = draw(st.integers(0, 2**31 - 1))
    r = _ring(n, prime_idx)
    rng = np.random.default_rng(seed)
    polys = [
        rng.integers(0, r.q, size=(n,), dtype=np.uint32)
        for _ in range(num_polys)
    ]
    return r, polys


@settings(max_examples=12, deadline=None)
@given(ring_and_polys(1))
def test_roundtrip_identity(rp):
    r, (a,) = rp
    assert (np.asarray(r.intt(r.ntt(a))) == a).all()


@settings(max_examples=10, deadline=None)
@given(ring_and_polys(2))
def test_ntt_linearity(rp):
    r, (a, b) = rp
    lhs = np.asarray(r.ntt(r.add(a, b)))
    rhs = np.asarray(r.add(r.ntt(a), r.ntt(b)))
    assert (lhs == rhs).all()


@settings(max_examples=8, deadline=None)
@given(ring_and_polys(2))
def test_convolution_theorem(rp):
    """polymul == schoolbook negacyclic convolution (big-int reference)."""
    r, (a, b) = rp
    got = np.asarray(r.polymul(a, b))
    n, q = r.n, r.q
    acc = [0] * n
    bi = [int(v) for v in b]
    ai = [int(v) for v in a]
    for i in range(n):
        if ai[i] == 0:
            continue
        for j in range(n):
            k = i + j
            if k < n:
                acc[k] = (acc[k] + ai[i] * bi[j]) % q
            else:
                acc[k - n] = (acc[k - n] - ai[i] * bi[j]) % q
    assert got.tolist() == acc


@settings(max_examples=8, deadline=None)
@given(ring_and_polys(2))
def test_polymul_commutative(rp):
    r, (a, b) = rp
    assert (np.asarray(r.polymul(a, b)) == np.asarray(r.polymul(b, a))).all()


@settings(max_examples=8, deadline=None)
@given(ring_and_polys(3))
def test_polymul_distributes_over_add(rp):
    r, (a, b, c) = rp
    lhs = np.asarray(r.polymul(a, r.add(b, c)))
    rhs = np.asarray(r.add(r.polymul(a, b), r.polymul(a, c)))
    assert (lhs == rhs).all()


@settings(max_examples=10, deadline=None)
@given(ring_and_polys(1))
def test_mul_by_one(rp):
    r, (a,) = rp
    one = np.zeros(r.n, dtype=np.uint32)
    one[0] = 1
    assert (np.asarray(r.polymul(a, one)) == a).all()


@settings(max_examples=10, deadline=None)
@given(ring_and_polys(1))
def test_mul_by_x_rotates_negacyclically(rp):
    """a * X == shift with sign flip at the wraparound (X^n = -1)."""
    r, (a,) = rp
    x_poly = np.zeros(r.n, dtype=np.uint32)
    x_poly[1] = 1
    got = np.asarray(r.polymul(a, x_poly))
    want = np.empty_like(a)
    want[1:] = a[:-1]
    want[0] = (r.q - a[-1]) % r.q
    assert (got == want).all()


def test_check_flags_out_of_range():
    r = _ring(64)
    good = np.zeros(64, dtype=np.uint32)
    r.check(good)
    bad = good.copy()
    bad[3] = r.q
    with pytest.raises(ValueError, match="outside"):
        r.check(bad)
    r.check(bad, bound=4 * r.q)  # lazy bound accepts it


# -- RNS layer properties (round 3: basechange / gadget / keyswitch) --------

from agilex_ntt import RNSRing  # noqa: E402
from agilex_ntt.ops import gadget as _gadget  # noqa: E402
from agilex_ntt.utils.crt import crt_compose  # noqa: E402


@st.composite
def rns_case(draw):
    n = draw(st.sampled_from([16, 64, 256]))
    L = draw(st.integers(2, 5))
    extra = draw(st.integers(1, 2))
    seed = draw(st.integers(0, 2**31 - 1))
    qs = find_primes(n, L + extra)
    src = RNSRing(n, qs=qs[:L])
    rng = np.random.default_rng(seed)
    res = np.stack([
        rng.integers(0, q, size=(2, n), dtype=np.uint32) for q in src.qs
    ])
    return src, tuple(qs), res


@settings(max_examples=10, deadline=None)
@given(rns_case())
def test_base_convert_float_exact_property(case):
    """HPS conversion reproduces x mod p for random L, basis, and shapes."""
    src, qs_all, res = case
    dst = qs_all[src.L:]
    x = crt_compose(res, src.qs)
    out = np.asarray(src.base_convert(res, dst, correction="float"))
    for j, p in enumerate(dst):
        assert (out[j] == (x % p).astype(np.uint32)).all()


@settings(max_examples=10, deadline=None)
@given(rns_case(), st.integers(1, 5))
def test_gadget_digits_reconstruct_property(case, dnum_raw):
    """sum_d t_d * Qhat_d * [Qhat_d^-1]_{Q_d} == x mod Q for every legal
    dnum (digits read back from the device output channels)."""
    src, qs_all, res = case
    alpha = -(-src.L // dnum_raw)
    dnum = -(-src.L // alpha)  # snap to a legal digit count
    out = np.asarray(src.gadget_decompose(res, qs_all, dnum))
    groups = _gadget.gadget_groups(src.L, dnum)
    Q = src.modulus
    x = crt_compose(res, src.qs)
    acc = np.zeros(x.shape, dtype=object)
    for d, (lo, hi) in enumerate(groups):
        sub = tuple(src.qs[lo:hi])
        # recover t_d from the digit's residues on the source-group channels
        t = crt_compose(out[d, lo:hi], sub)
        Qd = 1
        for q in sub:
            Qd *= q
        qhat = Q // Qd
        acc = acc + t * qhat * pow(qhat % Qd, -1, Qd)
    assert ((acc - x) % Q == 0).all()


@settings(max_examples=8, deadline=None)
@given(rns_case())
def test_mod_down_property(case):
    """mod_down(count) == iterated centered divide-and-round (big-int)."""
    src, _, res = case
    count = src.L - 1
    x = crt_compose(res, src.qs)
    out = np.asarray(src.mod_down(res, count))
    y = x
    for i in range(count):
        p = src.qs[src.L - 1 - i]
        s = y % p
        s = np.where(s > p // 2, s - p, s)
        y = (y - s) // p
    q0 = src.qs[0]
    assert (out[0] == (y % q0).astype(np.uint32)).all()


@settings(max_examples=6, deadline=None)
@given(rns_case(), st.integers(0, 2**31 - 1))
def test_keyswitch_matches_composition_property(case, kseed):
    """The fused one-call keyswitch equals the public composition
    gadget_decompose -> polydot -> mod_down (each piece independently
    oracle-tested) over random n, L, basis, and key material."""
    src, qs_all, res = case
    dnum = src.L
    ext = qs_all
    K = len(ext)
    rng = np.random.default_rng(kseed)
    ksk = np.stack([
        np.stack([rng.integers(0, p, size=src.n, dtype=np.uint32)
                  for p in ext])
        for _ in range(dnum)
    ])
    got = np.asarray(src.keyswitch(res, ksk, ext, dnum))
    assert got.shape == res.shape
    # pin against the public composition (each piece oracle-tested)
    import jax.numpy as jnp

    dig = jnp.moveaxis(
        jnp.asarray(src.gadget_decompose(res, ext, dnum)), 0, -2
    )
    kb = jnp.broadcast_to(
        jnp.moveaxis(jnp.asarray(ksk), 0, -2)[:, None], dig.shape
    )
    ext_ring = src._ext_rings[tuple(int(q) for q in ext)]
    want = np.asarray(
        ext_ring.mod_down(ext_ring.polydot(dig, kb), count=K - src.L)
    )
    assert (got == want).all()
