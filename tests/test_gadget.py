"""Gadget decomposition vs big-int host oracles.

Oracles are exact Python big-int arithmetic (CRT composition pinned by the
existing RNS tests); no modular code is shared with the device path.
"""

import numpy as np
import pytest

from conftest import require_devices

from agilex_ntt import Ring, RNSRing
from agilex_ntt.ops import gadget
from agilex_ntt.params import find_primes
from agilex_ntt.utils.crt import crt_compose


def _random_bigints(rng, modulus, shape):
    out = np.zeros(shape, dtype=object)
    chunks = (modulus.bit_length() + 29) // 30
    for _ in range(chunks):
        out = out * (1 << 30) + rng.integers(0, 1 << 30, size=shape).astype(object)
    return out % modulus


@pytest.fixture(scope="module")
def ring6():
    return RNSRing(256, num_primes=6)


def _digit_oracle(x, qs_src, groups):
    """t_d = [x]_{Q_d} big-int per digit."""
    ts = []
    for lo, hi in groups:
        res = np.stack(
            [(x % q).astype(np.uint32) for q in qs_src[lo:hi]], axis=0
        )
        ts.append(crt_compose(res, qs_src[lo:hi]))
    return ts


@pytest.mark.parametrize("dnum", [1, 2, 3, 6])
def test_gadget_decompose_digits_exact(ring6, dnum):
    src = ring6
    # destination = source basis + 2 fresh specials (the Q u P shape)
    qs_dst = tuple(src.qs) + tuple(find_primes(src.n, 8)[6:])
    rng = np.random.default_rng(21)
    x = _random_bigints(rng, src.modulus, (3, src.n))
    res = src.to_rns(x)
    out = np.asarray(src.gadget_decompose(res, qs_dst, dnum))
    groups = gadget.gadget_groups(src.L, dnum)
    assert out.shape == (dnum, len(qs_dst), 3, src.n)
    for d, t in enumerate(_digit_oracle(x, src.qs, groups)):
        for j, p in enumerate(qs_dst):
            np.testing.assert_array_equal(out[d, j], (t % p).astype(np.uint32))


def test_gadget_identity(ring6):
    """sum_d t_d * (Q/Q_d) * [(Q/Q_d)^-1]_{Q_d} == x mod Q — the identity
    that lets the evaluation key absorb the gadget factors."""
    src = ring6
    dnum = 3
    rng = np.random.default_rng(22)
    x = _random_bigints(rng, src.modulus, (2, src.n))
    groups = gadget.gadget_groups(src.L, dnum)
    Q = src.modulus
    acc = np.zeros_like(x)
    for (lo, hi), t in zip(groups, _digit_oracle(x, src.qs, groups)):
        Qd = 1
        for q in src.qs[lo:hi]:
            Qd *= q
        Qhat = Q // Qd
        acc = acc + t * Qhat * pow(Qhat % Qd, -1, Qd)
    assert ((acc - x) % Q == 0).all()


def test_gadget_groups_validation():
    assert gadget.gadget_groups(6, 3) == [(0, 2), (2, 4), (4, 6)]
    assert gadget.gadget_groups(5, 2) == [(0, 3), (3, 5)]
    with pytest.raises(ValueError):
        gadget.gadget_groups(6, 0)
    with pytest.raises(ValueError):
        gadget.gadget_groups(6, 7)
    with pytest.raises(ValueError):
        gadget.gadget_groups(5, 4)  # alpha=2 -> digit 3 would be empty


def test_gadget_decompose_validates(ring6):
    res = np.zeros((ring6.L, 2, ring6.n), dtype=np.uint32)
    with pytest.raises(ValueError):
        ring6.gadget_decompose(res, ring6.qs, ring6.L + 1)


@pytest.mark.parametrize("base_bits", [4, 8, 13])
def test_digit_decompose_unsigned_reconstructs(base_bits):
    r = Ring(128)
    rng = np.random.default_rng(23)
    x = rng.integers(0, r.q, size=(5, r.n), dtype=np.uint32)
    d = np.asarray(r.digit_decompose(x, base_bits))
    ndig = gadget.digit_count(r.q, base_bits)
    assert d.shape == (ndig, 5, r.n)
    assert (d < (1 << base_bits)).all()
    acc = np.zeros(x.shape, dtype=object)
    for j in range(ndig):
        acc += d[j].astype(object) << (base_bits * j)
    np.testing.assert_array_equal(acc, x.astype(object))


@pytest.mark.parametrize("base_bits", [4, 8])
def test_digit_decompose_balanced_reconstructs(base_bits):
    r = Ring(128)
    w, half = base_bits, 1 << (base_bits - 1)
    rng = np.random.default_rng(24)
    x = rng.integers(0, r.q, size=(4, r.n), dtype=np.uint32)
    d = np.asarray(r.digit_decompose(x, w, balanced=True)).astype(np.int64)
    ndig = d.shape[0]
    # centered lift: non-top digits are small or wrap just below q
    cent = np.where(d > half, d - r.q, d)
    assert (np.abs(cent[:-1]) <= half).all()
    assert (cent[:-1] > -half).all()
    # top digit is unsigned (absorbs the final carry)
    assert (d[-1] >= 0).all() and (d[-1] <= (1 << w)).all()
    acc = np.zeros(x.shape, dtype=object)
    for j in range(ndig - 1):
        acc += cent[j].astype(object) << (w * j)
    acc += d[-1].astype(object) << (w * (ndig - 1))
    np.testing.assert_array_equal(acc, x.astype(object))


def test_digit_decompose_edge_values():
    r = Ring(128)
    for w in (4, 8):
        for bal in (False, True):
            x = np.array([[0, 1, r.q - 1, r.q // 2]] * 1, dtype=np.uint32)
            x = np.tile(x, (1, r.n // 4))
            d = np.asarray(r.digit_decompose(x, w, balanced=bal))
            half = 1 << (w - 1)
            cent = np.where(
                d.astype(np.int64) > half, d.astype(np.int64) - r.q,
                d.astype(np.int64),
            )
            acc = np.zeros(x.shape, dtype=object)
            for j in range(d.shape[0] - 1):
                acc += (cent if bal else d.astype(np.int64))[j].astype(
                    object
                ) << (w * j)
            top = d[-1].astype(object)
            acc += top << (w * (d.shape[0] - 1))
            np.testing.assert_array_equal(acc, x.astype(object))


def test_sharded_gadget_decompose_matches_single_chip(ring6):
    from agilex_ntt.parallel import ShardedRNSRing, make_mesh

    import jax.numpy as jnp

    src = ring6
    qs_dst = tuple(src.qs) + tuple(find_primes(src.n, 8)[6:])
    require_devices(2)
    mesh = make_mesh(dp=2)
    srns = ShardedRNSRing(src, mesh, dp_axis="dp")
    rng = np.random.default_rng(25)
    x = _random_bigints(rng, src.modulus, (6, src.n))
    res = jnp.asarray(src.to_rns(x))
    single = np.asarray(src.gadget_decompose(res, qs_dst, 3))
    placed = srns.shard(res)
    np.testing.assert_array_equal(
        np.asarray(srns.gadget_decompose(placed, qs_dst, 3)), single
    )
