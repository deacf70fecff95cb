"""Mesh-sharded BFV evaluator: bit-identical to the single-chip path.

A BFVContext with a mesh dispatches the HPS multiply pipeline through
ShardedRNSRing — the float-corrected big-base lift, Karatsuba tensor in
the union basis, HPS t/Q scale + Shenoy-Kumaresan exact return
(``ShardedRNSRing.hps_scale_sk``), and hoisted relinearization, all dp/sp
sharded.  Closes VERDICT round-3 task 5 (the round-3
``NotImplementedError`` mesh guards).  The reference never spans work
across compute units for one frame (SURVEY.md §2); this is the
beyond-reference distributed serving path for the exact scheme.
"""

import numpy as np
import pytest

from conftest import require_devices

from agilex_ntt.parallel import make_mesh
from agilex_ntt.schemes.bfv import BFVContext

N = 256
SLOTS = N // 2
B = 8  # batch; dp=4 divides it


@pytest.fixture(scope="module")
def base():
    ctx = BFVContext(N, num_primes=3, rng=np.random.default_rng(17))
    keys = ctx.keygen(galois_steps=(1, -1))
    rng = np.random.default_rng(23)
    m1 = rng.integers(0, ctx.t, size=(B, 2, SLOTS))
    m2 = rng.integers(0, ctx.t, size=(B, 2, SLOTS))
    ct1 = ctx.encrypt(ctx.encode(m1), keys)
    ct2 = ctx.encrypt(ctx.encode(m2), keys)
    return ctx, keys, m1, m2, ct1, ct2


@pytest.fixture(scope="module")
def mctx():
    require_devices(4)
    mesh = make_mesh(dp=4)
    return BFVContext(N, num_primes=3, mesh=mesh)


def same(a, b):
    np.testing.assert_array_equal(np.asarray(a.c0), np.asarray(b.c0))
    np.testing.assert_array_equal(np.asarray(a.c1), np.asarray(b.c1))
    assert a.level == b.level and a.scale == b.scale


def test_multiply_matches_and_exact(base, mctx):
    ctx, keys, m1, m2, ct1, ct2 = base
    want = ctx.multiply(ct1, ct2, keys)
    got = mctx.multiply(mctx.place(ct1), mctx.place(ct2), keys)
    same(got, want)
    np.testing.assert_array_equal(
        mctx.decode(mctx.decrypt(got, keys)), (m1 * m2) % ctx.t
    )


def test_square_matches_and_exact(base, mctx):
    ctx, keys, m1, m2, ct1, ct2 = base
    same(mctx.square(mctx.place(ct1), keys), ctx.square(ct1, keys))


def test_mod_switch_then_multiply_matches(base, mctx):
    ctx, keys, m1, m2, ct1, ct2 = base
    lo1 = ctx.mod_down_to(ct1, ctx.L - 1)
    lo2 = ctx.mod_down_to(ct2, ctx.L - 1)
    want = ctx.multiply(lo1, lo2, keys)
    got = mctx.multiply(
        mctx.mod_down_to(mctx.place(ct1), ctx.L - 1),
        mctx.mod_down_to(mctx.place(ct2), ctx.L - 1),
        keys,
    )
    same(got, want)
    np.testing.assert_array_equal(
        mctx.decode(mctx.decrypt(got, keys)), (m1 * m2) % ctx.t
    )


def test_rotate_matches(base, mctx):
    ctx, keys, m1, m2, ct1, ct2 = base
    same(mctx.rotate(mctx.place(ct1), 1, keys), ctx.rotate(ct1, 1, keys))
