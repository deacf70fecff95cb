"""BGV scheme tests: exact integer arithmetic, slotwise numpy oracles.

Everything must be EXACT (assert_array_equal, not allclose): BGV noise is
a t-multiple by construction and the t-correcting ModDown/rescale keep it
one, so decryption recovers the message mod t with no approximation.
"""

import numpy as np
import pytest

from conftest import require_devices

from agilex_ntt.schemes.bgv import BGVContext

N = 256
SLOTS = N // 2


@pytest.fixture(scope="module")
def ctx():
    return BGVContext(N, num_primes=3, rng=np.random.default_rng(13))


@pytest.fixture(scope="module")
def keys(ctx):
    return ctx.keygen(galois_steps=(1, -1, 3))


@pytest.fixture()
def rng():
    return np.random.default_rng(21)


def mat(ctx, rng, shape=()):
    return rng.integers(0, ctx.t, size=shape + (2, SLOTS))


def dec(ctx, keys, ct):
    return ctx.decode(ctx.decrypt(ct, keys))


def test_t_structure(ctx):
    assert (ctx.t - 1) % (2 * N) == 0
    assert ctx.t not in ctx.qs and ctx.t != ctx.p


def test_encoder_roundtrip(ctx, rng):
    m = mat(ctx, rng)
    np.testing.assert_array_equal(ctx.decode(ctx.encode(m)), m)


def test_encoder_batch(ctx, rng):
    m = mat(ctx, rng, (3,))
    pt = ctx.encode(m)
    assert pt.rns.shape == (ctx.L, 3, N)
    np.testing.assert_array_equal(ctx.decode(pt), m)


def test_encrypt_roundtrip_exact(ctx, keys, rng):
    m = mat(ctx, rng)
    ct = ctx.encrypt(ctx.encode(m), keys)
    np.testing.assert_array_equal(dec(ctx, keys, ct), m)
    cts = ctx.encrypt_symmetric(ctx.encode(m), keys)
    np.testing.assert_array_equal(dec(ctx, keys, cts), m)


def test_add_sub_plain_ops(ctx, keys, rng):
    m1, m2 = mat(ctx, rng), mat(ctx, rng)
    c1 = ctx.encrypt(ctx.encode(m1), keys)
    c2 = ctx.encrypt(ctx.encode(m2), keys)
    np.testing.assert_array_equal(
        dec(ctx, keys, ctx.add(c1, c2)), (m1 + m2) % ctx.t
    )
    np.testing.assert_array_equal(
        dec(ctx, keys, ctx.sub(c1, c2)), (m1 - m2) % ctx.t
    )
    np.testing.assert_array_equal(
        dec(ctx, keys, ctx.add_plain(c1, ctx.encode(m2))), (m1 + m2) % ctx.t
    )
    np.testing.assert_array_equal(
        dec(ctx, keys, ctx.mul_plain(c1, ctx.encode(m2))), (m1 * m2) % ctx.t
    )


def test_multiply_relinearize_exact(ctx, keys, rng):
    m1, m2 = mat(ctx, rng), mat(ctx, rng)
    c1 = ctx.encrypt(ctx.encode(m1), keys)
    c2 = ctx.encrypt(ctx.encode(m2), keys)
    out = ctx.multiply(c1, c2, keys)
    np.testing.assert_array_equal(dec(ctx, keys, out), (m1 * m2) % ctx.t)


def test_modulus_switch_exact(ctx, keys, rng):
    # rescale divides the noise and multiplies the message by q_L^-1;
    # the tracked correction factor undoes it exactly at decode time
    m = mat(ctx, rng)
    ct = ctx.encrypt(ctx.encode(m), keys)
    low = ctx.rescale(ct)
    assert low.level == ctx.L - 1
    np.testing.assert_array_equal(dec(ctx, keys, low), m)


def test_multiply_then_switch_then_multiply(ctx, keys, rng):
    # the leveled pipeline: mult -> modswitch -> mult, key slices reused
    m1, m2, m3 = mat(ctx, rng), mat(ctx, rng), mat(ctx, rng)
    c1 = ctx.encrypt(ctx.encode(m1), keys)
    c2 = ctx.encrypt(ctx.encode(m2), keys)
    prod = ctx.rescale(ctx.multiply(c1, c2, keys))
    c3 = ctx.mod_down_to(ctx.encrypt(ctx.encode(m3), keys), prod.level)
    # factors differ (prod picked up q_L): align c3 by encoding at
    # prod.scale is not needed for multiply (factors multiply through)
    out = ctx.multiply(prod, c3, keys)
    np.testing.assert_array_equal(
        dec(ctx, keys, out), (m1 * m2 * m3) % ctx.t
    )


def test_rotate_rows_and_swap(ctx, keys, rng):
    m = mat(ctx, rng)
    ct = ctx.encrypt(ctx.encode(m), keys)
    got = dec(ctx, keys, ctx.rotate(ct, 1, keys))
    np.testing.assert_array_equal(got, np.roll(m, -1, axis=-1))
    got3 = dec(ctx, keys, ctx.rotate(ct, 3, keys))
    np.testing.assert_array_equal(got3, np.roll(m, -3, axis=-1))
    swapped = dec(ctx, keys, ctx.conjugate(ct, keys))
    np.testing.assert_array_equal(swapped, m[..., ::-1, :])


def test_batched_pipeline(ctx, keys, rng):
    m1, m2 = mat(ctx, rng, (4,)), mat(ctx, rng, (4,))
    c1 = ctx.encrypt(ctx.encode(m1), keys)
    c2 = ctx.encrypt(ctx.encode(m2), keys)
    out = ctx.rescale(ctx.multiply(c1, c2, keys))
    np.testing.assert_array_equal(dec(ctx, keys, out), (m1 * m2) % ctx.t)


def test_mesh_sharded_matches_single_chip(ctx, keys, rng):
    # every evaluator op through ShardedRNSRing with the t-correcting
    # ModDown: byte-equal to the single-chip path, still exact
    from agilex_ntt.parallel import make_mesh

    require_devices(4)
    mctx = BGVContext(N, num_primes=3, mesh=make_mesh(dp=4))
    m1, m2 = mat(ctx, rng, (4,)), mat(ctx, rng, (4,))
    c1 = ctx.encrypt(ctx.encode(m1), keys)
    c2 = ctx.encrypt(ctx.encode(m2), keys)
    want = ctx.rescale(ctx.multiply(c1, c2, keys))
    got = mctx.rescale(
        mctx.multiply(mctx.place(c1), mctx.place(c2), keys)
    )
    np.testing.assert_array_equal(np.asarray(got.c0), np.asarray(want.c0))
    np.testing.assert_array_equal(np.asarray(got.c1), np.asarray(want.c1))
    assert got.scale == want.scale
    np.testing.assert_array_equal(dec(ctx, keys, got), (m1 * m2) % ctx.t)
    rot_w = ctx.rotate(c1, 1, keys)
    rot_g = mctx.rotate(mctx.place(c1), 1, keys)
    np.testing.assert_array_equal(
        np.asarray(rot_g.c0), np.asarray(rot_w.c0)
    )
    ws = [mat(ctx, rng) for _ in (0, 1)]
    terms = list(zip((0, 1), ws))
    opm = mctx.make_linear_op(terms, keys, ctx.L)
    op0 = ctx.make_linear_op(terms, keys, ctx.L)
    lw = ctx.apply_linear(c1, op0)
    lg = mctx.apply_linear(mctx.place(c1), opm)
    np.testing.assert_array_equal(np.asarray(lg.c0), np.asarray(lw.c0))
    np.testing.assert_array_equal(np.asarray(lg.c1), np.asarray(lw.c1))


def test_fused_linear_op_exact(ctx, keys, rng):
    # sum_j w_j (*) rot_j(ct) through the t-correcting hoisted_linear_sum,
    # exact vs the slotwise oracle
    m = mat(ctx, rng)
    steps = (0, 1, -1)
    ws = [mat(ctx, rng) for _ in steps]
    op = ctx.make_linear_op(list(zip(steps, ws)), keys, ctx.L)
    ct = ctx.encrypt(ctx.encode(m), keys)
    got = dec(ctx, keys, ctx.apply_linear(ct, op))
    want = sum(
        w * np.roll(m, -t, axis=-1) for t, w in zip(steps, ws)
    ) % ctx.t
    np.testing.assert_array_equal(got, want)
