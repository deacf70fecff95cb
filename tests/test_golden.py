"""Golden-model tests: the u64 model (mirror of the reference arithmetic),
the u32 model (what the device transforms compute), and the independent big-int oracle
must all agree; roundtrip and convolution properties must hold.

This is the test pyramid level the reference aspires to but lacks
(SURVEY.md §4: empty include/test.h, dummy driver data in main.cpp:49-55).
"""

import numpy as np
import pytest

from agilex_ntt import golden as G
from agilex_ntt.params import make_params

from conftest import params_for


@pytest.mark.parametrize("n", [32, 256, 1024])
def test_fwd_u64_matches_naive_oracle(n, rng):
    pp = params_for(n)
    x = rng.integers(0, pp.q, size=n, dtype=np.uint64)
    got = G.fwd_ntt_u64(x, pp)
    want = G.naive_negacyclic_ntt([int(v) for v in x], pp)
    assert [int(v) for v in got] == want


@pytest.mark.parametrize("n", [32, 1024, 4096])
def test_u32_matches_u64(n, rng):
    pp = params_for(n)
    x = rng.integers(0, pp.q, size=(3, n), dtype=np.uint64)
    out64 = G.fwd_ntt_u64(x, pp)
    out32 = G.fwd_ntt_u32(x.astype(np.uint32), pp)
    assert (out64 == out32.astype(np.uint64)).all()
    inv64 = G.inv_ntt_u64(out64, pp)
    inv32 = G.inv_ntt_u32(out32, pp)
    assert (inv64 == inv32.astype(np.uint64)).all()


@pytest.mark.parametrize("n", [32, 1024, 8192, 16384, 32768])
def test_roundtrip_identity(n, rng):
    pp = params_for(n)
    x = rng.integers(0, pp.q, size=(2, n), dtype=np.uint64)
    assert (G.inv_ntt_u64(G.fwd_ntt_u64(x, pp), pp) == x).all()


@pytest.mark.parametrize("n", [32, 256])
def test_pointwise_mul_is_negacyclic_convolution(n, rng):
    pp = params_for(n)
    q = pp.q
    a = rng.integers(0, q, size=n, dtype=np.uint64)
    b = rng.integers(0, q, size=n, dtype=np.uint64)
    fa = G.fwd_ntt_u64(a, pp)
    fb = G.fwd_ntt_u64(b, pp)
    prod = (fa.astype(object) * fb.astype(object)) % q
    got = G.inv_ntt_u64(prod.astype(np.uint64), pp)
    want = G.negacyclic_convolution(a, b, q)
    assert [int(v) for v in got] == want


def test_linearity(rng):
    n = 256
    pp = params_for(n)
    q = pp.q
    a = rng.integers(0, q, size=n, dtype=np.uint64)
    b = rng.integers(0, q, size=n, dtype=np.uint64)
    s = ((a + b) % q).astype(np.uint64)
    fa, fb, fs = (G.fwd_ntt_u64(v, pp) for v in (a, b, s))
    assert (((fa.astype(object) + fb.astype(object)) % q) == fs.astype(object)).all()


def test_outputs_fully_reduced(rng):
    n = 1024
    pp = params_for(n)
    x = rng.integers(0, pp.q, size=n, dtype=np.uint64)
    y = G.fwd_ntt_u64(x, pp)
    assert (y < pp.q).all()
    z = G.inv_ntt_u64(y, pp)
    assert (z < pp.q).all()


def test_second_prime_chain(rng):
    # RNS: two different primes for same n give independent transforms
    n = 1024
    p0 = params_for(n, 0)
    p1 = params_for(n, 1)
    assert p0.q != p1.q
    x = rng.integers(0, min(p0.q, p1.q), size=n, dtype=np.uint64)
    r0 = G.inv_ntt_u64(G.fwd_ntt_u64(x, p0), p0)
    r1 = G.inv_ntt_u64(G.fwd_ntt_u64(x, p1), p1)
    assert (r0 == x).all() and (r1 == x).all()
