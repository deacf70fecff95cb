"""Scheme-layer tests: RNS-CKKS end to end against slotwise numpy oracles.

The reference stops at the forward transform (`/root/reference/src/kernel/
ntt.cpp`); these tests pin the evaluator built on top of it — encoder
roundtrip and homomorphism, encryption (both flavors), every evaluator op,
key reuse across levels, batching, and the fused BSGS linear transform —
each against the corresponding exact slotwise computation.
"""

import numpy as np
import pytest

from agilex_ntt.schemes import CKKSContext
from agilex_ntt.schemes.ckks import decode_coeffs, encode_coeffs

N = 256
SLOTS = N // 2
TOL = 1e-3


@pytest.fixture(scope="module")
def ctx():
    return CKKSContext(N, num_primes=3, rng=np.random.default_rng(7))


@pytest.fixture(scope="module")
def keys(ctx):
    return ctx.keygen(galois_steps=(0, 1, -1, 3, 5))


@pytest.fixture()
def rng():
    return np.random.default_rng(42)


def slots(rng, shape=(SLOTS,), lo=-1.0, hi=1.0):
    return rng.uniform(lo, hi, shape) + 1j * rng.uniform(lo, hi, shape)


def dec(ctx, keys, ct):
    return ctx.decode(ctx.decrypt(ct, keys))


# -- encoder -----------------------------------------------------------------


def test_encoder_roundtrip(rng):
    z = slots(rng)
    m = encode_coeffs(z, N, 1 << 29)
    back = decode_coeffs(m, N, 1 << 29)
    np.testing.assert_allclose(back, z, atol=1e-6)


def test_encoder_coeffs_are_real_integers(rng):
    m = encode_coeffs(slots(rng), N, 1 << 29)
    assert m.dtype == np.int64
    assert np.abs(m).max() < (1 << 31)


def test_encoder_is_ring_homomorphism(rng):
    # negacyclic product of encodings decodes to the slotwise product
    z1, z2 = slots(rng), slots(rng)
    m1 = encode_coeffs(z1, N, 1 << 20).astype(object)
    m2 = encode_coeffs(z2, N, 1 << 20).astype(object)
    conv = np.convolve(m1, m2)
    prod = conv[:N].copy()
    prod[: N - 1] -= conv[N:]
    got = decode_coeffs(prod.astype(np.float64), N, (1 << 20) ** 2)
    # error floor is the encode rounding (0.5/coeff) amplified by the
    # n-term convolution: ~ n * 0.5 / 2^20 ≈ 1e-4
    np.testing.assert_allclose(got, z1 * z2, atol=1e-3)


def test_encoder_batch(rng):
    z = slots(rng, (3, 2, SLOTS))
    m = encode_coeffs(z, N, 1 << 29)
    assert m.shape == (3, 2, N)
    np.testing.assert_allclose(decode_coeffs(m, N, 1 << 29), z, atol=1e-6)


# -- encrypt / decrypt ---------------------------------------------------------


def test_public_key_roundtrip(ctx, keys, rng):
    z = slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    np.testing.assert_allclose(dec(ctx, keys, ct), z, atol=TOL)


def test_symmetric_roundtrip(ctx, keys, rng):
    z = slots(rng)
    ct = ctx.encrypt_symmetric(ctx.encode(z), keys)
    np.testing.assert_allclose(dec(ctx, keys, ct), z, atol=TOL)


def test_batched_ciphertext(ctx, keys, rng):
    z = slots(rng, (4, SLOTS))
    ct = ctx.encrypt(ctx.encode(z), keys)
    assert ct.c0.shape == (ctx.L, 4, N)
    np.testing.assert_allclose(dec(ctx, keys, ct), z, atol=TOL)


# -- linear ops ----------------------------------------------------------------


def test_add_sub_negate(ctx, keys, rng):
    z1, z2 = slots(rng), slots(rng)
    c1 = ctx.encrypt(ctx.encode(z1), keys)
    c2 = ctx.encrypt(ctx.encode(z2), keys)
    np.testing.assert_allclose(
        dec(ctx, keys, ctx.add(c1, c2)), z1 + z2, atol=TOL
    )
    np.testing.assert_allclose(
        dec(ctx, keys, ctx.sub(c1, c2)), z1 - z2, atol=TOL
    )
    np.testing.assert_allclose(
        dec(ctx, keys, ctx.negate(c1)), -z1, atol=TOL
    )


def test_add_plain(ctx, keys, rng):
    z1, z2 = slots(rng), slots(rng)
    ct = ctx.encrypt(ctx.encode(z1), keys)
    out = ctx.add_plain(ct, ctx.encode(z2))
    np.testing.assert_allclose(dec(ctx, keys, out), z1 + z2, atol=TOL)


def test_mul_plain_rescale(ctx, keys, rng):
    z1, z2 = slots(rng), slots(rng)
    ct = ctx.encrypt(ctx.encode(z1), keys)
    out = ctx.rescale(ctx.mul_plain(ct, ctx.encode(z2)))
    assert out.level == ctx.L - 1
    np.testing.assert_allclose(dec(ctx, keys, out), z1 * z2, atol=TOL)


# -- multiply / relinearize / levels -------------------------------------------


def test_multiply_relinearize(ctx, keys, rng):
    z1, z2 = slots(rng), slots(rng)
    c1 = ctx.encrypt(ctx.encode(z1), keys)
    c2 = ctx.encrypt(ctx.encode(z2), keys)
    out = ctx.rescale(ctx.multiply(c1, c2, keys))
    np.testing.assert_allclose(dec(ctx, keys, out), z1 * z2, atol=TOL)


def test_square(ctx, keys, rng):
    z = slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    out = ctx.rescale(ctx.square(ct, keys))
    np.testing.assert_allclose(dec(ctx, keys, out), z * z, atol=TOL)


def test_multiply_at_lower_level_reuses_keys(ctx, keys, rng):
    # x^4 via two squarings: the second multiply runs at level L-1 with the
    # SAME key arrays (sliced rows/channels) — pins the g_d ≡ g_d^(l)
    # congruence argument the level slicing relies on
    z = slots(rng, lo=-0.8, hi=0.8)
    ct = ctx.encrypt(ctx.encode(z), keys)
    sq = ctx.rescale(ctx.square(ct, keys))
    assert sq.level == ctx.L - 1
    quad = ctx.rescale(ctx.square(sq, keys))
    assert quad.level == ctx.L - 2
    np.testing.assert_allclose(dec(ctx, keys, quad), z ** 4, atol=5 * TOL)


def test_mod_down_to(ctx, keys, rng):
    z = slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    low = ctx.mod_down_to(ct, 1)
    assert low.level == 1
    np.testing.assert_allclose(dec(ctx, keys, low), z, atol=TOL)


def test_level_scale_mismatch_raises(ctx, keys, rng):
    z = slots(rng)
    c1 = ctx.encrypt(ctx.encode(z), keys)
    c2 = ctx.mod_down_to(ctx.encrypt(ctx.encode(z), keys), ctx.L - 1)
    with pytest.raises(ValueError, match="level mismatch"):
        ctx.add(c1, c2)


# -- rotations -----------------------------------------------------------------


@pytest.mark.parametrize("t", [1, -1, 3, 5])
def test_rotate(ctx, keys, rng, t):
    z = slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    out = ctx.rotate(ct, t, keys)
    np.testing.assert_allclose(dec(ctx, keys, out), np.roll(z, -t), atol=TOL)


def test_conjugate(ctx, keys, rng):
    z = slots(rng)
    ct = ctx.encrypt(ctx.encode(z), keys)
    out = ctx.conjugate(ct, keys)
    np.testing.assert_allclose(dec(ctx, keys, out), np.conj(z), atol=TOL)


def test_rotate_at_lower_level(ctx, keys, rng):
    z = slots(rng)
    ct = ctx.mod_down_to(ctx.encrypt(ctx.encode(z), keys), ctx.L - 1)
    out = ctx.rotate(ct, 1, keys)
    np.testing.assert_allclose(dec(ctx, keys, out), np.roll(z, -1), atol=TOL)


def test_missing_rotation_key_raises(ctx, keys, rng):
    ct = ctx.encrypt(ctx.encode(slots(rng)), keys)
    with pytest.raises(KeyError, match="no rotation key"):
        ctx.rotate(ct, 7, keys)


# -- fused BSGS linear transform -------------------------------------------------


def test_linear_op_matches_composed(ctx, keys, rng):
    z = slots(rng)
    steps = (0, 1, -1)
    ws = [slots(rng) for _ in steps]
    op = ctx.make_linear_op(list(zip(steps, ws)), keys, ctx.L)
    ct = ctx.encrypt(ctx.encode(z), keys)
    got = dec(ctx, keys, ctx.rescale(ctx.apply_linear(ct, op)))
    want = sum(w * np.roll(z, -t) for t, w in zip(steps, ws))
    np.testing.assert_allclose(got, want, atol=5 * TOL)


def test_linear_op_identity_term_only(ctx, keys, rng):
    # the t=0 term goes through the same fused path via the g=1 key
    z, w = slots(rng), slots(rng)
    op = ctx.make_linear_op([(0, w)], keys, ctx.L)
    ct = ctx.encrypt(ctx.encode(z), keys)
    got = dec(ctx, keys, ctx.rescale(ctx.apply_linear(ct, op)))
    np.testing.assert_allclose(got, w * z, atol=5 * TOL)


def test_linear_op_batched(ctx, keys, rng):
    z = slots(rng, (3, SLOTS))
    steps = (1, 3)
    ws = [slots(rng) for _ in steps]
    op = ctx.make_linear_op(list(zip(steps, ws)), keys, ctx.L)
    ct = ctx.encrypt(ctx.encode(z), keys)
    got = dec(ctx, keys, ctx.rescale(ctx.apply_linear(ct, op)))
    want = sum(w[None] * np.roll(z, -t, axis=-1) for t, w in zip(steps, ws))
    np.testing.assert_allclose(got, want, atol=5 * TOL)


# -- two-level BSGS matrix-vector product ----------------------------------------


# matvec tests run on a smaller ring: the baked op's baby-step hoisted
# keyswitch is the largest jit graph in the suite, and at N=256 its XLA
# CPU compile has (flakily) segfaulted inside backend_compile on the
# 1-CPU CI box; N=128 halves the graph and the coverage is identical
MN = 128
MSLOTS = MN // 2


@pytest.fixture(scope="module")
def mv_ctx():
    return CKKSContext(MN, num_primes=3, rng=np.random.default_rng(7))


@pytest.fixture(scope="module")
def mv_keys(mv_ctx):
    steps = set(mv_ctx.bsgs_steps()) | set(
        mv_ctx.bsgs_steps(bsgs=(16, MSLOTS // 16))
    )
    return mv_ctx.keygen(galois_steps=sorted(steps))


def mslots(rng, shape=(MSLOTS,)):
    return rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)


def test_matvec_full_matrix(mv_ctx, mv_keys, rng):
    ctx = mv_ctx
    z = mslots(rng)
    M = (rng.uniform(-1, 1, (MSLOTS, MSLOTS))
         + 1j * rng.uniform(-1, 1, (MSLOTS, MSLOTS))) / MSLOTS
    op = ctx.make_matvec(M, mv_keys, ctx.L)
    ct = ctx.encrypt(ctx.encode(z), mv_keys)
    got = dec(ctx, mv_keys, ctx.rescale(ctx.apply_matvec(ct, op)))
    np.testing.assert_allclose(got, M @ z, atol=5 * TOL)


def test_matvec_explicit_bsgs_split(mv_ctx, mv_keys, rng):
    # a split that differs from the default — the zero-padded tail
    # diagonals must not contribute
    ctx = mv_ctx
    z = mslots(rng)
    M = np.diag(rng.uniform(-1, 1, MSLOTS)) + 0j
    b, g = 16, MSLOTS // 16
    op = ctx.make_matvec(M, mv_keys, ctx.L, bsgs=(b, g))
    assert op.b == b and op.g == g
    ct = ctx.encrypt(ctx.encode(z), mv_keys)
    got = dec(ctx, mv_keys, ctx.rescale(ctx.apply_matvec(ct, op)))
    np.testing.assert_allclose(got, M @ z, atol=5 * TOL)


def test_matvec_at_lower_level(mv_ctx, mv_keys, rng):
    ctx = mv_ctx
    z = mslots(rng)
    M = np.eye(MSLOTS, k=1) + np.eye(MSLOTS, k=-(MSLOTS - 1)) + 0j
    op = ctx.make_matvec(M, mv_keys, ctx.L - 1)
    ct = ctx.mod_down_to(ctx.encrypt(ctx.encode(z), mv_keys), ctx.L - 1)
    got = dec(ctx, mv_keys, ctx.rescale(ctx.apply_matvec(ct, op)))
    np.testing.assert_allclose(got, np.roll(z, -1), atol=5 * TOL)


def test_matvec_missing_key_raises(ctx, keys, rng):
    M = np.eye(SLOTS) + 0j
    with pytest.raises(KeyError, match="rotation key"):
        ctx.make_matvec(M, keys, ctx.L)
