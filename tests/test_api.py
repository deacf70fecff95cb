"""API-level tests: Ring / RNSRing, polymul vs schoolbook oracle, shapes,
transform dispatch, kernel/XLA agreement.
"""

import numpy as np
import pytest

from agilex_ntt import Ring, RNSRing
from agilex_ntt import golden as G

from conftest import params_for


def _rand(rng, q, shape):
    return rng.integers(0, q, size=shape, dtype=np.uint32)


@pytest.mark.parametrize("n", [32, 128, 1024])
def test_ring_ntt_matches_golden(n, rng):
    ring = Ring(n)
    x = _rand(rng, ring.q, (5, n))
    got = np.asarray(ring.ntt(x))
    assert (got == G.fwd_ntt_u32(x, ring.params)).all()


def test_ring_roundtrip_multidim_batch(rng):
    ring = Ring(256)
    x = _rand(rng, ring.q, (3, 4, 256))  # padding path: 12 rows -> 16
    z = np.asarray(ring.intt(ring.ntt(x)))
    assert z.shape == x.shape
    assert (z == x).all()


def test_ring_single_poly(rng):
    ring = Ring(256)
    x = _rand(rng, ring.q, (256,))
    y = np.asarray(ring.ntt(x))
    assert y.shape == (256,)
    assert (y == G.fwd_ntt_u32(x, ring.params)).all()


@pytest.mark.parametrize("n", [32, 256])
def test_polymul_vs_schoolbook(n, rng):
    ring = Ring(n)
    a = _rand(rng, ring.q, (n,))
    b = _rand(rng, ring.q, (n,))
    got = np.asarray(ring.polymul(a, b))
    want = G.negacyclic_convolution(a, b, ring.q)
    assert [int(v) for v in got] == want


def test_polymul_batched(rng):
    ring = Ring(128)
    a = _rand(rng, ring.q, (4, 128))
    b = _rand(rng, ring.q, (4, 128))
    got = np.asarray(ring.polymul(a, b))
    for i in range(4):
        want = G.negacyclic_convolution(a[i], b[i], ring.q)
        assert [int(v) for v in got[i]] == want


def test_pointwise_mul_exact(rng):
    ring = Ring(128)
    a = _rand(rng, ring.q, (2, 128))
    b = _rand(rng, ring.q, (2, 128))
    got = np.asarray(ring.pointwise_mul(a, b))
    want = (a.astype(np.uint64) * b.astype(np.uint64)) % np.uint64(ring.q)
    assert (got.astype(np.uint64) == want).all()


def test_ring_add_sub_neg(rng):
    ring = Ring(128)
    q = ring.q
    a = _rand(rng, q, (128,))
    b = _rand(rng, q, (128,))
    assert (
        np.asarray(ring.add(a, b)).astype(np.uint64)
        == (a.astype(np.uint64) + b) % q
    ).all()
    assert (
        np.asarray(ring.sub(a, b)).astype(np.int64)
        == (a.astype(np.int64) - b) % q
    ).all()
    assert (
        np.asarray(ring.neg(a)).astype(np.int64) == (-a.astype(np.int64)) % q
    ).all()


def test_rns_polymul_crt(rng):
    """RNS polymul + CRT reconstruction equals big-int negacyclic product."""
    n = 64
    rns = RNSRing(n, num_primes=3)
    M = rns.modulus
    a_int = [int(v) for v in rng.integers(0, 1 << 40, size=n)]
    b_int = [int(v) for v in rng.integers(0, 1 << 10, size=n)]
    a_rns = rns.to_rns(a_int)
    b_rns = rns.to_rns(b_int)
    c_rns = np.asarray(rns.polymul(a_rns, b_rns))
    got = rns.from_rns(c_rns)
    # independent big-int oracle
    want = [0] * n
    for i in range(n):
        for j in range(n):
            k = i + j
            if k < n:
                want[k] += a_int[i] * b_int[j]
            else:
                want[k - n] -= a_int[i] * b_int[j]
    want = [v % M for v in want]
    assert [int(v) for v in got] == want


def test_rns_roundtrip(rng):
    n = 128
    rns = RNSRing(n, num_primes=2)
    x = np.stack([_rand(rng, r.q, (2, n)) for r in rns.rings])
    z = np.asarray(rns.intt(rns.ntt(x)))
    assert (z == x).all()


def test_backend_dispatch(monkeypatch):
    # one transform per platform: the GPU kernel on a GPU (or in the
    # interpreter when asked), the plain XLA chains elsewhere; Ring has no
    # option that picks a backend
    from agilex_ntt.ops import ntt_kernel

    calls = []
    monkeypatch.setattr(
        ntt_kernel, "_call",
        lambda x, *a, inverse, interpret: calls.append(interpret) or x,
    )
    x = np.zeros((1, 2, 128), np.uint32)
    tabs = (np.zeros(1, np.uint32), np.zeros((1, 128), np.uint32),
            np.zeros((1, 128), np.uint32))
    ntt_kernel.ntt(x, *tabs)  # CPU: plain path, kernel not called
    assert calls == []
    ntt_kernel.ntt(x, *tabs, interpret=True)
    assert calls == [True]
    monkeypatch.setattr(ntt_kernel, "on_gpu", lambda: True)
    ntt_kernel.intt(x, *tabs)
    assert calls == [True, False]
    with pytest.raises(TypeError):
        Ring(128, backend="xla")


@pytest.mark.parametrize("n", [32, 64])
def test_small_n_packed_pallas_interpret(n, rng):
    """n < 128 through the lane-packed Pallas kernels (interpret mode),
    bit-exact vs golden — reference parity for its smallest config
    (/root/reference/include/kernel/ntt.h:12)."""
    ring = Ring(n, interpret=True)
    x = _rand(rng, ring.q, (11, n))  # odd batch: exercises pack padding
    got = np.asarray(ring.ntt(x))
    assert (got == G.fwd_ntt_u32(x, ring.params)).all()
    back = np.asarray(ring.intt(ring.ntt(x)))
    assert (back == x).all()
    a = _rand(rng, ring.q, (5, n))
    b = _rand(rng, ring.q, (5, n))
    got_pm = np.asarray(ring.polymul(a, b))
    want_pm = np.asarray(Ring(n).polymul(a, b))
    assert (got_pm == want_pm).all()


def test_bad_shapes():
    ring = Ring(128)
    with pytest.raises(ValueError):
        ring.ntt(np.zeros((4, 64), np.uint32))


def test_check_is_eager_only():
    # round-2 ADVICE fix: under an enclosing trace, check() raises a clear
    # error instead of an opaque TracerConversionError
    import jax
    import jax.numpy as jnp

    ring = Ring(128)
    ring.check(np.zeros((2, 128), np.uint32))  # eager path still works
    with pytest.raises(RuntimeError, match="eager-only"):
        jax.jit(lambda x: ring.check(x))(jnp.zeros((2, 128), jnp.uint32))


def test_rns_fused_paths_cast_signed_inputs(rng):
    """Code-review round 2: the fused RNS paths must apply the same
    truncating uint32 cast as the stacked path (int64 numpy input)."""
    from agilex_ntt import RNSRing

    n, L = 256, 2
    fused = RNSRing(n, num_primes=L, interpret=True)
    oracle = RNSRing(n, num_primes=L)
    x64 = np.stack([
        rng.integers(0, r.q, size=(4, n)).astype(np.int64)
        for r in fused.rings
    ])
    assert (np.asarray(fused.ntt(x64)) == np.asarray(oracle.ntt(x64))).all()
    assert (
        np.asarray(fused.polymul(x64, x64))
        == np.asarray(oracle.polymul(x64, x64))
    ).all()


def test_rns_polydot_validates_shapes():
    from agilex_ntt import RNSRing

    rns = RNSRing(256, num_primes=2, interpret=True)
    a = np.zeros((2, 2, 4, 256), np.uint32)
    b = np.zeros((2, 4, 2, 256), np.uint32)  # same element count, wrong shape
    with pytest.raises(ValueError, match="matching"):
        rns.polydot(a, b)
