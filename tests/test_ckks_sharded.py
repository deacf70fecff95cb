"""Mesh-sharded CKKS evaluator: bit-identical to the single-chip path.

A CKKSContext with a mesh dispatches every evaluator op through
ShardedRNSRing (batch over dp).  The sharded ring ops are documented
bit-identical to RNSRing, so the whole scheme must be too: the same keys
and ciphertexts produce byte-equal results either way.  (The reference
never spans work across compute units for one frame — SURVEY.md §2; this
is the beyond-reference distributed serving path.)
"""

import numpy as np
import pytest

from conftest import require_devices

from agilex_ntt.parallel import make_mesh
from agilex_ntt.schemes import CKKSContext

N = 256
SLOTS = N // 2
B = 8  # batch; dp=4 divides it


@pytest.fixture(scope="module")
def base():
    ctx = CKKSContext(N, num_primes=3, rng=np.random.default_rng(3))
    keys = ctx.keygen(galois_steps=(0, 1, -1))
    rng = np.random.default_rng(9)
    z = rng.uniform(-1, 1, (B, SLOTS)) + 1j * rng.uniform(-1, 1, (B, SLOTS))
    w = rng.uniform(-1, 1, (B, SLOTS)) + 1j * rng.uniform(-1, 1, (B, SLOTS))
    ct1 = ctx.encrypt(ctx.encode(z), keys)
    ct2 = ctx.encrypt(ctx.encode(w), keys)
    return ctx, keys, z, w, ct1, ct2


@pytest.fixture(scope="module")
def mctx():
    require_devices(4)
    mesh = make_mesh(dp=4)
    return CKKSContext(N, num_primes=3, mesh=mesh)


def same(a, b):
    np.testing.assert_array_equal(np.asarray(a.c0), np.asarray(b.c0))
    np.testing.assert_array_equal(np.asarray(a.c1), np.asarray(b.c1))
    assert a.level == b.level and a.scale == b.scale


def test_add_mul_plain_match(base, mctx):
    ctx, keys, z, w, ct1, ct2 = base
    m1, m2 = mctx.place(ct1), mctx.place(ct2)
    same(mctx.add(m1, m2), ctx.add(ct1, ct2))
    pt = ctx.encode(w)
    same(mctx.mul_plain(m1, pt), ctx.mul_plain(ct1, pt))
    same(mctx.add_plain(m1, pt), ctx.add_plain(ct1, pt))


def test_multiply_relin_matches(base, mctx):
    ctx, keys, z, w, ct1, ct2 = base
    want = ctx.rescale(ctx.multiply(ct1, ct2, keys))
    got = mctx.rescale(
        mctx.multiply(mctx.place(ct1), mctx.place(ct2), keys)
    )
    same(got, want)
    np.testing.assert_allclose(
        ctx.decode(ctx.decrypt(got, keys)), z * w, atol=1e-3
    )


def test_rotate_matches(base, mctx):
    ctx, keys, z, w, ct1, ct2 = base
    same(mctx.rotate(mctx.place(ct1), 1, keys), ctx.rotate(ct1, 1, keys))
    same(mctx.conjugate(mctx.place(ct1), keys), ctx.conjugate(ct1, keys))


def test_lower_level_multiply_matches(base, mctx):
    ctx, keys, z, w, ct1, ct2 = base
    lo1, lo2 = (ctx.mod_down_to(c, ctx.L - 1) for c in (ct1, ct2))
    want = ctx.multiply(lo1, lo2, keys)
    got = mctx.multiply(
        mctx.mod_down_to(mctx.place(ct1), ctx.L - 1),
        mctx.mod_down_to(mctx.place(ct2), ctx.L - 1),
        keys,
    )
    same(got, want)


def test_linear_op_matches(base, mctx):
    ctx, keys, z, w, ct1, ct2 = base
    rng = np.random.default_rng(4)
    steps = (0, 1, -1)
    ws = [rng.uniform(-1, 1, SLOTS) + 0j for _ in steps]
    terms = list(zip(steps, ws))
    op0 = ctx.make_linear_op(terms, keys, ctx.L)
    opm = mctx.make_linear_op(terms, keys, ctx.L)
    assert op0.domain == "ntt" and opm.domain == "coeff"
    want = ctx.apply_linear(ct1, op0)
    got = mctx.apply_linear(mctx.place(ct1), opm)
    same(got, want)
    dec = ctx.decode(ctx.decrypt(ctx.rescale(want), keys))
    oracle = sum(
        wv[None] * np.roll(z, -t, axis=-1) for t, wv in zip(steps, ws)
    )
    np.testing.assert_allclose(dec, oracle, atol=5e-3)


def test_domain_mismatch_raises(base, mctx):
    ctx, keys, z, w, ct1, ct2 = base
    op0 = ctx.make_linear_op([(1, np.ones(SLOTS) + 0j)], keys, ctx.L)
    with pytest.raises(ValueError, match="baked for domain"):
        mctx.apply_linear(mctx.place(ct1), op0)


def test_matvec_matches(base, mctx):
    ctx, keys, z, w, ct1, ct2 = base
    bsgs = (16, SLOTS // 16)
    mv_keys = ctx.keygen(galois_steps=ctx.bsgs_steps(bsgs=bsgs))
    rng = np.random.default_rng(11)
    M = (rng.uniform(-1, 1, (SLOTS, SLOTS)) + 0j) / SLOTS
    ct = ctx.encrypt(ctx.encode(z), mv_keys)
    op0 = ctx.make_matvec(M, mv_keys, ctx.L, bsgs=bsgs)
    opm = mctx.make_matvec(M, mv_keys, ctx.L, bsgs=bsgs)
    want = ctx.apply_matvec(ct, op0)
    got = mctx.apply_matvec(mctx.place(ct), opm)
    same(got, want)
    dec = ctx.decode(ctx.decrypt(ctx.rescale(want), mv_keys))
    np.testing.assert_allclose(dec, (M @ z.T).T, atol=5e-3)


def test_poly_eval_matches(base, mctx):
    # the BSGS Paterson-Stockmeyer recursion composes only mesh-tested
    # ops (multiply/rescale/mod_down/mul_plain/add_plain/add), so the
    # sharded result must be byte-equal, dictated Fraction scale included
    # (degree 2: the deepest shape the 3-prime fixture chain supports at
    # the Delta^2 output convention's min level 2)
    ctx, keys, z, w, ct1, ct2 = base
    coeffs = [0.3, -0.7, 0.2]
    want = ctx.poly_eval(ct1, coeffs, keys)
    assert want.level == 2
    got = mctx.poly_eval(mctx.place(ct1), coeffs, keys)
    same(got, want)


def test_poly_eval_chebyshev_matches(base, mctx):
    # the Chebyshev-only op sequences — _cheb_double's add_plain
    # alignment, the odd-baby plaintext-ratio alignment (T_3), a giant
    # node — must also be byte-equal under mesh dispatch; needs its own
    # 5-prime pair (degree 6 lands at level 2, the Delta^2 minimum)
    require_devices(4)
    ctx5 = CKKSContext(N, num_primes=5, rng=np.random.default_rng(17))
    k5 = ctx5.keygen()
    rng = np.random.default_rng(23)
    z = rng.uniform(-0.95, 0.95, (B, SLOTS)) + 0j
    ct = ctx5.encrypt(ctx5.encode(z), k5)
    mctx5 = CKKSContext(N, num_primes=5, mesh=make_mesh(dp=4))
    coeffs = [0.2, -0.5, 0.3, 0.15, -0.1, 0.05, 0.1]
    want = ctx5.poly_eval(ct, coeffs, k5, basis="chebyshev")
    got = mctx5.poly_eval(mctx5.place(ct), coeffs, k5, basis="chebyshev")
    same(got, want)
    dec = ctx5.decode(ctx5.decrypt(want, k5))
    ref = np.polynomial.chebyshev.chebval(z, coeffs)
    np.testing.assert_allclose(dec, ref, atol=5e-2)
