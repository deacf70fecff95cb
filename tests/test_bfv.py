"""BFV scheme tests: scale-invariant exact integer arithmetic.

Like BGV, everything decrypts EXACTLY (assert_array_equal) — the message
sits at Δ = floor(Q/t) and every pipeline keeps noise << Δ/2.  What's
specifically BFV under test: the Δ-scaled encoder, the HPS big-base
multiply (lift -> tensor -> scale_round -> Shenoy-Kumaresan return), and
scale-invariant modulus switching (no tracked correction factor).
"""

import numpy as np
import pytest

from agilex_ntt.schemes.bfv import BFVContext

N = 256
SLOTS = N // 2


@pytest.fixture(scope="module")
def ctx():
    return BFVContext(N, num_primes=3, rng=np.random.default_rng(17))


@pytest.fixture(scope="module")
def keys(ctx):
    return ctx.keygen(galois_steps=(1, -1, 3))


@pytest.fixture()
def rng():
    return np.random.default_rng(23)


def mat(ctx, rng, shape=()):
    return rng.integers(0, ctx.t, size=shape + (2, SLOTS))


def dec(ctx, keys, ct):
    return ctx.decode(ctx.decrypt(ct, keys))


def test_scale_invariant_hooks(ctx):
    # the BGV noise/keyswitch hooks must be undone
    assert ctx._noise_mul == 1 and ctx._ks_plain_mod is None
    assert ctx.delta_at(ctx.L) == ctx.q_at(ctx.L) // ctx.t


def test_encoder_roundtrip(ctx, rng):
    m = mat(ctx, rng)
    pt = ctx.encode(m)
    np.testing.assert_array_equal(ctx.decode(pt), m)
    # raw (mul) encodings hold small residues, not Δ-scaled ones
    raw = ctx.encode_mul(m)
    assert int(np.asarray(raw.rns).max()) < ctx.t


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
    # mul_plain takes the RAW encoding (Δ·m times w stays at one Δ)
    np.testing.assert_array_equal(
        dec(ctx, keys, ctx.mul_plain(c1, ctx.encode_mul(m2))),
        (m1 * m2) % ctx.t,
    )


def test_multiply_relinearize_exact(ctx, keys, rng):
    m1, m2 = mat(ctx, rng), mat(ctx, rng)
    c1 = ctx.encrypt(ctx.encode(m1), keys)
    c2 = ctx.encrypt(ctx.encode(m2), keys)
    prod = ctx.multiply(c1, c2, keys)
    assert prod.level == c1.level and prod.scale == 1
    np.testing.assert_array_equal(dec(ctx, keys, prod), (m1 * m2) % ctx.t)
    sq = ctx.square(c1, keys)
    np.testing.assert_array_equal(dec(ctx, keys, sq), (m1 * m1) % ctx.t)


def test_modulus_switch_exact(ctx, keys, rng):
    m = mat(ctx, rng)
    ct = ctx.encrypt(ctx.encode(m), keys)
    low = ctx.rescale(ct)
    assert low.level == ct.level - 1 and low.scale == ct.scale == 1
    np.testing.assert_array_equal(dec(ctx, keys, low), m)
    np.testing.assert_array_equal(
        dec(ctx, keys, ctx.mod_down_to(ct, 1)), m
    )


def test_multiply_chain_across_levels(ctx, keys, rng):
    """Depth-2: multiply at L, switch down, multiply again — the scale-
    invariant core (no correction factors anywhere)."""
    ms = [mat(ctx, rng) for _ in range(3)]
    cs = [ctx.encrypt(ctx.encode(m), keys) for m in ms]
    prod = ctx.multiply(cs[0], cs[1], keys)
    prod = ctx.rescale(prod)
    c2 = ctx.mod_down_to(cs[2], prod.level)
    out = ctx.multiply(prod, c2, keys)
    np.testing.assert_array_equal(
        dec(ctx, keys, out), (ms[0] * ms[1] * ms[2]) % ctx.t
    )


def test_rotate_rows_and_swap(ctx, keys, rng):
    m = mat(ctx, rng)
    ct = ctx.encrypt(ctx.encode(m), keys)
    np.testing.assert_array_equal(
        dec(ctx, keys, ctx.rotate(ct, 1, keys)), np.roll(m, -1, axis=-1)
    )
    np.testing.assert_array_equal(
        dec(ctx, keys, ctx.rotate(ct, -1, keys)), np.roll(m, 1, axis=-1)
    )
    np.testing.assert_array_equal(
        dec(ctx, keys, ctx.conjugate(ct, keys)), m[..., ::-1, :]
    )


def test_batched_pipeline(ctx, keys, rng):
    m1, m2 = mat(ctx, rng, (3,)), mat(ctx, rng, (3,))
    c1 = ctx.encrypt(ctx.encode(m1), keys)
    c2 = ctx.encrypt(ctx.encode(m2), keys)
    out = ctx.rescale(ctx.multiply(c1, c2, keys))
    np.testing.assert_array_equal(dec(ctx, keys, out), (m1 * m2) % ctx.t)


def test_fused_linear_op_exact(ctx, keys, rng):
    m = mat(ctx, rng)
    ws = [mat(ctx, rng) for _ in range(3)]
    steps = (0, 1, -1)
    op = ctx.make_linear_op(
        [(t, w) for t, w in zip(steps, ws)], keys, ctx.L
    )
    ct = ctx.encrypt(ctx.encode(m), keys)
    out = ctx.apply_linear(ct, op)
    want = sum(
        w * np.roll(m, -t, axis=-1) for t, w in zip(steps, ws)
    ) % ctx.t
    np.testing.assert_array_equal(dec(ctx, keys, out), want)


def test_bsgs_matvec_exact(rng):
    """Row-wise homomorphic y_r = M @ z_r via the inherited two-level
    BSGS pipeline (hoisted babies, fused polydot giants)."""
    n = 64
    S = n // 2
    ctx = BFVContext(n, num_primes=3, rng=np.random.default_rng(29))
    keys = ctx.keygen(galois_steps=ctx.bsgs_steps(S))
    M = rng.integers(0, ctx.t, size=(S, S))
    z = rng.integers(0, ctx.t, size=(2, S))
    op = ctx.make_matvec(M, keys, ctx.L)
    ct = ctx.encrypt(ctx.encode(z), keys)
    out = ctx.apply_matvec(ct, op)
    want = (z.astype(object) @ M.T.astype(object)) % ctx.t
    np.testing.assert_array_equal(
        ctx.decode(ctx.decrypt(out, keys)), want.astype(np.int64)
    )


def test_bfv_guards(ctx, keys, rng):
    m = mat(ctx, rng)
    with pytest.raises(ValueError):
        ctx.encode(m, scale=2)
    ct = ctx.encrypt(ctx.encode(m), keys)
    low_pt = ctx.encode(m, level=ctx.L - 1)
    with pytest.raises(ValueError):
        ctx.add_plain(ct, low_pt)  # Δ-encodings are level-specific
