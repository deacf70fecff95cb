"""Tests of the GPU transform kernel in the Pallas interpreter, of the plain
XLA path it is checked against, and of the wrapper around both (shapes,
padding, per-channel moduli, choice of block and of transform).

Bit-exactness is checked against the u32 golden model, which is itself checked
against the u64 reference-mirror model and the independent big-int oracle in
test_golden.py — so a pass here chains all the way to the O(n^2) evaluation
definition of the negacyclic NTT.
"""

import numpy as np
import pytest

import jax.numpy as jnp

from agilex_ntt import golden as G
from agilex_ntt.ops import ntt_kernel as K
from agilex_ntt.ops import xla_ntt as X

from conftest import params_for

INTERP = dict(interpret=True)


@pytest.mark.parametrize("n", [128, 1024, 4096])
def test_fwd_matches_golden(n, rng):
    pp = params_for(n)
    x = rng.integers(0, pp.q, size=(16, n), dtype=np.uint32)
    got = np.asarray(K.fwd_ntt(x, pp, **INTERP))
    want = G.fwd_ntt_u32(x, pp)
    assert (got == want).all()


@pytest.mark.parametrize("n", [128, 1024])
def test_inv_matches_golden(n, rng):
    pp = params_for(n)
    y = rng.integers(0, pp.q, size=(16, n), dtype=np.uint32)
    got = np.asarray(K.inv_ntt(y, pp, **INTERP))
    want = G.inv_ntt_u32(y, pp)
    assert (got == want).all()


@pytest.mark.parametrize("logn", range(3, 16))
def test_kernel_every_size_matches_golden(logn, rng):
    """Kernel (interpreter) forward vs golden and its inverse roundtrip at
    every power of two from 8 to 32768 (the radix-2 range)."""
    n = 1 << logn
    pp = params_for(n)
    x = rng.integers(0, pp.q, size=(2, n), dtype=np.uint32)
    y = np.asarray(K.fwd_ntt(x, pp, **INTERP))
    assert (y == G.fwd_ntt_u32(x, pp)).all()
    assert (np.asarray(K.inv_ntt(y, pp, **INTERP)) == x).all()


@pytest.mark.parametrize("logn", range(7, 16))
def test_split_stages_match_golden(logn, rng):
    """The plain split-form chains (the kernel's reference) vs golden,
    forward and inverse, n = 128 ... 32768."""
    n = 1 << logn
    pp = params_for(n)
    x = rng.integers(0, pp.q, size=(3, n), dtype=np.uint32)
    y = np.asarray(X.fwd_ntt_xla(x, pp))
    assert (y == G.fwd_ntt_u32(x, pp)).all()
    assert (np.asarray(X.inv_ntt_xla(y, pp)) == G.inv_ntt_u32(y, pp)).all()


def test_roundtrip(rng):
    n = 1024
    pp = params_for(n)
    x = rng.integers(0, pp.q, size=(8, n), dtype=np.uint32)
    y = K.fwd_ntt(x, pp, **INTERP)
    z = np.asarray(K.inv_ntt(y, pp, **INTERP))
    assert (z == x).all()


def test_fwd_accepts_lazy_input(rng):
    """Forward kernel tolerates inputs in [0, 4q) like the reference's lazy
    pipeline (state invariant at ntt.cpp:331-332, 368-369)."""
    n = 256
    pp = params_for(n)
    x = rng.integers(0, pp.q, size=(8, n), dtype=np.uint32)
    shifted = (x + np.uint32(2 * pp.q)).astype(np.uint32)  # same residues
    a = np.asarray(K.fwd_ntt(x, pp, **INTERP))
    b = np.asarray(K.fwd_ntt(shifted, pp, **INTERP))
    assert (a == b).all()


def test_inv_accepts_lazy_input(rng):
    n = 256
    pp = params_for(n)
    y = rng.integers(0, pp.q, size=(8, n), dtype=np.uint32)
    lazy = (y + np.uint32(pp.q)).astype(np.uint32)
    a = np.asarray(K.inv_ntt(y, pp, **INTERP))
    b = np.asarray(K.inv_ntt(lazy, pp, **INTERP))
    assert (a == b).all()


def test_inv_custom_scale(rng):
    """The scale override (used to fold Montgomery R out of polymul)."""
    n = 256
    pp = params_for(n)
    q = pp.q
    y = rng.integers(0, q, size=(8, n), dtype=np.uint32)
    c = 12345 % q
    scale = pp.n_inv * c % q
    got = np.asarray(K.inv_ntt(y, pp, scale=scale, **INTERP))
    base = G.inv_ntt_u32(y, pp).astype(object)
    assert (got.astype(object) == (base * c) % q).all()


@pytest.mark.parametrize("batch", [64, 37, 1])
def test_block_rows_grid(batch, rng):
    """Several programs per call, and a batch the block does not divide
    (padded, then sliced back), give the golden result."""
    n = 256
    pp = params_for(n)
    x = rng.integers(0, pp.q, size=(batch, n), dtype=np.uint32)
    a = np.asarray(K.fwd_ntt(x, pp, **INTERP))
    assert a.shape == (batch, n)
    assert (a == G.fwd_ntt_u32(x, pp)).all()


def test_pick_block_rows_legal_shapes():
    """Rows per program: a power of two, ~4096 elements per program,
    never more than the batch needs."""
    assert K.block_rows(4096, 8192) == 1
    assert K.block_rows(256, 131072) == 16
    assert K.block_rows(128, 5) == 4
    assert K.block_rows(32768, 3) == 1
    for n in (8, 128, 1024, 32768):
        for batch in (1, 3, 64, 4096):
            r = K.block_rows(n, batch)
            assert r >= 1 and r & (r - 1) == 0
            assert r == 1 or r <= batch
            assert r * n <= max(4096, n)


def test_num_warps_by_size():
    assert [K.num_warps(n) for n in (128, 4096, 8192, 16384, 32768)] == \
        [4, 4, 4, 8, 16]


def test_polymul_fused_kernel_matches_golden(rng):
    """Polymul through the kernel (fwd x2 + Montgomery pointwise + scaled
    inverse, one jitted computation) vs golden."""
    from agilex_ntt import Ring

    n = 256
    ring = Ring(n, **INTERP)
    pp, q = ring.params, ring.q
    a = rng.integers(0, q, size=(8, n), dtype=np.uint32)
    b = rng.integers(0, q, size=(8, n), dtype=np.uint32)
    got = np.asarray(ring.polymul(a, b))
    fa = G.fwd_ntt_u32(a, pp).astype(np.uint64)
    fb = G.fwd_ntt_u32(b, pp).astype(np.uint64)
    prod = ((fa * fb) % np.uint64(q)).astype(np.uint32)
    want = G.inv_ntt_u32(prod, pp)
    assert (got == want).all()


def test_polydot_fused_interpret_bit_exact(rng):
    """Polydot through the kernel vs the plain XLA ring."""
    from agilex_ntt import Ring

    n, k, B = 256, 3, 8
    ring = Ring(n)
    a = rng.integers(0, ring.q, size=(B, k, n), dtype=np.uint32)
    b = rng.integers(0, ring.q, size=(B, k, n), dtype=np.uint32)
    got = np.asarray(Ring(n, ring.q, **INTERP).polydot(a, b))
    want = np.asarray(ring.polydot(a, b))
    assert (got == want).all()


def test_rns_single_kernel_interpret_bit_exact(rng):
    """All channels in one kernel call (channel = grid axis, q and tables
    per-channel operands) vs each channel's golden transform."""
    from agilex_ntt import RNSRing

    n, L, B = 256, 3, 8
    rns = RNSRing(n, num_primes=L)
    params_tuple = tuple(r.params for r in rns.rings)
    x = np.stack(
        [rng.integers(0, r.q, size=(B, n), dtype=np.uint32) for r in rns.rings]
    )
    got = np.asarray(K.rns_ntt(jnp.asarray(x), params_tuple, **INTERP))
    for l, r in enumerate(rns.rings):
        assert (got[l] == G.fwd_ntt_u32(x[l], r.params)).all()
    back = np.asarray(K.rns_intt(jnp.asarray(got), params_tuple, **INTERP))
    assert (back == x).all()
    a = np.stack(
        [rng.integers(0, r.q, size=(B, n), dtype=np.uint32) for r in rns.rings]
    )
    pm = np.asarray(RNSRing(n, num_primes=L, **INTERP).polymul(a, x))
    assert (pm == np.asarray(rns.polymul(a, x))).all()


def test_rns_polydot_single_kernel_interpret(rng):
    """Channel-batched polydot through the kernel vs the plain path."""
    from agilex_ntt import RNSRing

    n, L, kk, B = 256, 3, 2, 8
    rns = RNSRing(n, num_primes=L)
    a = np.stack([
        rng.integers(0, r.q, size=(B, kk, n), dtype=np.uint32)
        for r in rns.rings
    ])
    b = np.stack([
        rng.integers(0, r.q, size=(B, kk, n), dtype=np.uint32)
        for r in rns.rings
    ])
    got = np.asarray(RNSRing(n, num_primes=L, **INTERP).polydot(a, b))
    want = np.asarray(rns.polydot(a, b))
    assert (got == want).all()
    # and the channel-batched plain path against per-channel Ring.polydot
    for l, r in enumerate(rns.rings):
        assert (want[l] == np.asarray(r.polydot(a[l], b[l]))).all()


@pytest.mark.parametrize("interpret", [False, True])
def test_per_channel_moduli_are_operands(interpret, rng):
    """One call, tables and q as traced operands: the same jitted function
    serves two different prime bases (the channel-sharded paths rely on
    this)."""
    import jax

    from agilex_ntt.params import find_primes, make_params

    n = 128
    ps = [make_params(n, q) for q in find_primes(n, 4)]
    fn = jax.jit(lambda v, q, w, wp: K.ntt(v, q, w, wp, interpret=interpret))
    for basis in (ps[:2], ps[2:]):
        q, w, wp = X.stacked_tables(tuple(basis))
        x = np.stack([rng.integers(0, p.q, size=(3, n), dtype=np.uint32)
                      for p in basis])
        got = np.asarray(fn(x, q, w, wp))
        for l, p in enumerate(basis):
            assert (got[l] == G.fwd_ntt_u32(x[l], p)).all()


def test_inv_tables_fold_scale():
    pp = params_for(256)
    w, wp = X.inv_tables(pp, 7)
    q = pp.q
    assert int(w[0]) == 7 and int(w[1]) == 7 * int(pp.inv_roots32[1]) % q
    assert int(wp[0]) == (7 << 32) // q
    assert (w[2:] == pp.inv_roots32[2:]).all()
    w_default, _ = X.inv_tables(pp)
    assert int(w_default[0]) == pp.n_inv
