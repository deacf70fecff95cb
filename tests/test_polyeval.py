"""Homomorphic polynomial evaluation (BSGS Paterson-Stockmeyer).

`poly_eval` is the workhorse for non-linear functions under FHE
(activation polynomials, bootstrapping's EvalMod); the reference stops at
the forward transform it dispatches (`/root/reference/src/kernel/
ntt.cpp:86-506`).  CKKS results are approximate and checked against
numpy polyval on the slots; BGV results are EXACT mod t
(assert_array_equal).  The recursion's exact-Fraction scale dictation is
pinned directly: the returned scale must equal Delta^2 (CKKS) / the
dictated correction factor algebra (BGV), with no float drift.
"""

from fractions import Fraction

import numpy as np
import pytest

from agilex_ntt.schemes import CKKSContext
from agilex_ntt.schemes.bgv import BGVContext

N = 256
SLOTS = N // 2


@pytest.fixture(scope="module")
def ctx():
    return CKKSContext(N, num_primes=6, rng=np.random.default_rng(11))


@pytest.fixture(scope="module")
def keys(ctx):
    return ctx.keygen()


@pytest.fixture(scope="module")
def bctx():
    return BGVContext(N, num_primes=6, rng=np.random.default_rng(5))


@pytest.fixture(scope="module")
def bkeys(bctx):
    return bctx.keygen()


@pytest.fixture()
def rng():
    return np.random.default_rng(3)


def slots(rng, lo=-0.9, hi=0.9, shape=(SLOTS,)):
    return rng.uniform(lo, hi, shape) + 1j * rng.uniform(lo, hi, shape)


def ref_poly(coeffs, z):
    out = np.zeros_like(z)
    for c in reversed(coeffs):
        out = out * z + c
    return out


def dec(ctx, keys, ct):
    return ctx.decode(ctx.decrypt(ct, keys))


# -- CKKS ---------------------------------------------------------------------


def test_linear_no_multiplies(ctx, keys, rng):
    z = slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    coeffs = [0.25 - 0.5j, 1.5]
    out = ctx.poly_eval(ct, coeffs, keys)
    assert out.level == ctx.L  # depth 0: no level consumed
    assert out.scale == Fraction(ctx.delta) ** 2
    np.testing.assert_allclose(dec(ctx, keys, out), ref_poly(coeffs, z),
                               atol=1e-3)


def test_cubic(ctx, keys, rng):
    z = slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    coeffs = [0.5, -1.0, 0.25, 0.75]
    out = ctx.poly_eval(ct, coeffs, keys)
    assert out.scale == Fraction(ctx.delta) ** 2
    np.testing.assert_allclose(dec(ctx, keys, out), ref_poly(coeffs, z),
                               atol=5e-3)


def test_degree8_complex_coeffs(ctx, keys, rng):
    z = slots(rng, -0.8, 0.8)
    ct = ctx.encrypt(ctx.encode(z), keys)
    coeffs = [0.1 + 0.2j, -0.4, 0.3j, 0.2, -0.15,
              0.1 - 0.1j, 0.05, -0.08, 0.06]
    out = ctx.poly_eval(ct, coeffs, keys)
    assert out.scale == Fraction(ctx.delta) ** 2
    np.testing.assert_allclose(dec(ctx, keys, out), ref_poly(coeffs, z),
                               atol=5e-2)


def test_sparse_gaps(ctx, keys, rng):
    # x^5 + 0.5: zero coefficients skip work but not correctness
    z = slots(rng, -0.8, 0.8)
    ct = ctx.encrypt(ctx.encode(z), keys)
    coeffs = [0.5, 0, 0, 0, 0, 0.8]
    out = ctx.poly_eval(ct, coeffs, keys)
    np.testing.assert_allclose(dec(ctx, keys, out), ref_poly(coeffs, z),
                               atol=2e-2)


def test_rescale_composes(ctx, keys, rng):
    # the Delta^2 product convention composes with one rescale, like
    # multiply()
    z = slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    coeffs = [0.0, 0.5, 0.5]
    out = ctx.rescale(ctx.poly_eval(ct, coeffs, keys))
    np.testing.assert_allclose(dec(ctx, keys, out), ref_poly(coeffs, z),
                               atol=5e-3)


def test_batched(ctx, keys, rng):
    z = slots(rng, shape=(3, SLOTS))
    ct = ctx.encrypt(ctx.encode(z), keys)
    coeffs = [0.2, -0.3, 0.4]
    out = ctx.poly_eval(ct, coeffs, keys)
    np.testing.assert_allclose(dec(ctx, keys, out), ref_poly(coeffs, z),
                               atol=5e-3)


def test_constant_polynomial(ctx, keys, rng):
    z = slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    out = ctx.poly_eval(ct, [0.75 + 0.25j], keys)
    np.testing.assert_allclose(dec(ctx, keys, out),
                               np.full(SLOTS, 0.75 + 0.25j), atol=1e-3)


def test_chain_too_short_raises_before_any_work(rng):
    short = CKKSContext(N, num_primes=3, rng=np.random.default_rng(2))
    kk = short.keygen()
    z = slots(rng)
    ct = short.encrypt(short.encode(z), kk)
    with pytest.raises(ValueError, match="prime level"):
        short.poly_eval(ct, [0.1] * 9, kk)  # degree 8 needs ~5 levels


def test_result_level_must_hold_delta_squared(rng):
    # a cubic on a 3-prime chain would land at level 1, where the
    # Delta^2 output scale wraps mod Q_1 and decodes to garbage — the
    # plan must refuse, not silently return a wrong answer
    short = CKKSContext(N, num_primes=3, rng=np.random.default_rng(2))
    kk = short.keygen()
    ct = short.encrypt(short.encode(slots(rng)), kk)
    with pytest.raises(ValueError, match="level >= 2"):
        short.poly_eval(ct, [0.5, -1.0, 0.25, 0.75], kk)


def test_degree4_constant_quotient(ctx, keys, rng):
    # deg == k*2^j: the quotient is the single constant c_4, so the
    # giant term is a PLAINTEXT multiply — no relinearization and no
    # level consumed (result one level higher than the full-node form)
    z = slots(rng, -0.8, 0.8)
    ct = ctx.encrypt(ctx.encode(z), keys)
    coeffs = [0.1, -0.4, 0.3, 0.2, -0.15]
    out = ctx.poly_eval(ct, coeffs, keys)
    assert out.level == ctx.L - 2  # x^2/x^3 depth only
    np.testing.assert_allclose(dec(ctx, keys, out), ref_poly(coeffs, z),
                               atol=2e-2)


def test_empty_coeffs_raises(ctx, keys, rng):
    ct = ctx.encrypt(ctx.encode(slots(rng)), keys)
    with pytest.raises(ValueError, match="non-empty"):
        ctx.poly_eval(ct, [], keys)


# -- BGV: exact mod t ---------------------------------------------------------


def bgv_ref(coeffs, m, t):
    out = np.zeros_like(m)
    for c in reversed(coeffs):
        out = (out * m + int(c)) % t
    return out


def test_bgv_cubic_exact(bctx, bkeys, rng):
    m = rng.integers(0, bctx.t, size=(2, SLOTS))
    ct = bctx.encrypt(bctx.encode(m), bkeys)
    coeffs = [3, 7, 1, 5]
    out = bctx.poly_eval(ct, coeffs, bkeys)
    np.testing.assert_array_equal(
        dec(bctx, bkeys, out) % bctx.t, bgv_ref(coeffs, m, bctx.t)
    )


def test_bgv_degree8_exact(bctx, bkeys, rng):
    m = rng.integers(0, bctx.t, size=(2, SLOTS))
    ct = bctx.encrypt(bctx.encode(m), bkeys)
    coeffs = [2, 0, 11, 0, 5, 1, 0, 9, 4]
    out = bctx.poly_eval(ct, coeffs, bkeys)
    np.testing.assert_array_equal(
        dec(bctx, bkeys, out) % bctx.t, bgv_ref(coeffs, m, bctx.t)
    )


def test_bgv_float_coeff_raises(bctx, bkeys, rng):
    # the exact scheme must refuse silently-truncating coefficients
    m = rng.integers(0, bctx.t, size=(2, SLOTS))
    ct = bctx.encrypt(bctx.encode(m), bkeys)
    with pytest.raises(ValueError, match="integers mod t"):
        bctx.poly_eval(ct, [0.5, 2], bkeys)


# -- Chebyshev basis ----------------------------------------------------------


def cheb_slots(rng, shape=(SLOTS,)):
    # REAL values inside the Chebyshev domain [-1, 1]: outside it
    # |T_i(z)| grows like cosh(i*arccosh|z|) and overflows the modulus
    # (complex slots of radius sqrt(2)*0.9 sent T_12 past 500)
    return rng.uniform(-0.95, 0.95, shape) + 0j


def test_chebyshev_deg6(ctx, keys, rng):
    # exercises the odd-baby path (T_3 = 2 T_2 T_1 - T_1 with the
    # plaintext-ratio alignment) and a full giant node
    z = cheb_slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    coeffs = [0.2, -0.5, 0.3, 0.15, -0.1, 0.05, 0.1]
    out = ctx.poly_eval(ct, coeffs, keys, basis="chebyshev")
    want = np.polynomial.chebyshev.chebval(z, coeffs)
    np.testing.assert_allclose(dec(ctx, keys, out), want, atol=5e-2)


def test_chebyshev_deg12(ctx, keys, rng):
    # two giants (T_4, T_8), a constant-quotient inner node, nested
    # remainders — the EvalMod-shaped tree
    z = cheb_slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    coeffs = [0.1, -0.2, 0.15, 0.1, -0.08, 0.06, -0.05, 0.04,
              -0.03, 0.02, -0.02, 0.01, 0.01]
    out = ctx.poly_eval(ct, coeffs, keys, basis="chebyshev")
    want = np.polynomial.chebyshev.chebval(z, coeffs)
    np.testing.assert_allclose(dec(ctx, keys, out), want, atol=5e-2)


def test_chebyshev_matches_power_composition(ctx, keys, rng):
    # T-basis coefficients converted to the power basis must evaluate to
    # the same function (small degree: the conversion is exact in floats)
    z = cheb_slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    tcoeffs = [0.3, -0.4, 0.25, 0.2]
    pcoeffs = list(np.polynomial.chebyshev.cheb2poly(tcoeffs))
    a = ctx.poly_eval(ct, tcoeffs, keys, basis="chebyshev")
    b = ctx.poly_eval(ct, pcoeffs, keys)
    np.testing.assert_allclose(dec(ctx, keys, a), dec(ctx, keys, b),
                               atol=2e-2)


def test_bad_basis_raises(ctx, keys, rng):
    ct = ctx.encrypt(ctx.encode(slots(rng)), keys)
    with pytest.raises(ValueError, match="basis"):
        ctx.poly_eval(ct, [1, 2], keys, basis="legendre")


def bgv_cheb_ref(coeffs, m, t):
    tm1 = np.ones_like(m)          # T_0
    tc = m % t                     # T_1
    out = (coeffs[0] * tm1) % t
    if len(coeffs) > 1:
        out = (out + coeffs[1] * tc) % t
    for c in coeffs[2:]:
        tm1, tc = tc, (2 * m * tc - tm1) % t
        out = (out + c * tc) % t
    return out % t


def test_bgv_chebyshev_exact(bctx, bkeys, rng):
    # the Chebyshev division and the odd-baby alignment are exact mod t
    m = rng.integers(0, bctx.t, size=(2, SLOTS))
    ct = bctx.encrypt(bctx.encode(m), bkeys)
    coeffs = [3, 1, 7, 2, 5, 0, 4]
    out = bctx.poly_eval(ct, coeffs, bkeys, basis="chebyshev")
    np.testing.assert_array_equal(
        dec(bctx, bkeys, out) % bctx.t, bgv_cheb_ref(coeffs, m, bctx.t)
    )
