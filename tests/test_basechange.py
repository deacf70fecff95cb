"""RNS base conversion and rescaling vs big-int host oracles.

The oracle is exact Python big-int arithmetic through RNSRing.to_rns /
from_rns (themselves pinned by the CRT tests), so these tests share no
modular-arithmetic code with the device path under test.
"""

import numpy as np
import pytest

from conftest import require_devices

from agilex_ntt import RNSRing
from agilex_ntt.params import find_primes


def _random_bigints(rng, modulus, shape):
    """Uniform big-ints < modulus as an object array (built from 30-bit
    chunks so numpy's 64-bit RNG bound is never the limit)."""
    out = np.zeros(shape, dtype=object)
    chunks = (modulus.bit_length() + 29) // 30
    for _ in range(chunks):
        out = out * (1 << 30) + rng.integers(0, 1 << 30, size=shape).astype(object)
    return out % modulus


@pytest.fixture(scope="module")
def rings():
    n = 256
    src = RNSRing(n, num_primes=3)
    dst_qs = find_primes(n, 5)[3:]  # disjoint from src's first three
    dst = RNSRing(n, qs=dst_qs)
    return src, dst


def test_base_convert_float_correction_exact(rings):
    src, dst = rings
    rng = np.random.default_rng(11)
    x = _random_bigints(rng, src.modulus, (4, src.n))
    res = src.to_rns(x)
    out = np.asarray(src.base_convert(res, dst, correction="float"))
    for j, p in enumerate(dst.qs):
        np.testing.assert_array_equal(out[j], (x % p).astype(np.uint32))


def test_base_convert_approximate_offset(rings):
    """BEHZ conversion returns x + e*Q for a single e < L shared by all
    target channels (that's what lets pipelines absorb it downstream)."""
    src, dst = rings
    rng = np.random.default_rng(12)
    x = _random_bigints(rng, src.modulus, (2, src.n))
    res = src.to_rns(x)
    out = np.asarray(src.base_convert(res, dst, correction="none"))
    # recover the lifted value S = x + e*Q from the dst residues (dst
    # modulus is ~2^60 > L*Q ~ 2^92? no: compare channel-wise instead)
    for e in range(src.L):
        lifted = x + e * src.modulus
        match = np.ones(x.shape, dtype=bool)
        for j, p in enumerate(dst.qs):
            match &= out[j] == (lifted % p).astype(np.uint32)
        if e == 0:
            agree = match.copy()
        else:
            agree |= match
    assert agree.all(), "some coefficient matched no e in [0, L)"


def test_rescale_is_divide_and_round(rings):
    src, _ = rings
    rng = np.random.default_rng(13)
    x = _random_bigints(rng, src.modulus, (3, src.n))
    res = src.to_rns(x)
    out = np.asarray(src.rescale(res))
    qL = src.qs[-1]
    # centered residue s in (-qL/2, qL/2]; (x - s)/qL = round-to-nearest
    s = x % qL
    s = np.where(s > qL // 2, s - qL, s)
    y = (x - s) // qL
    small = src.drop_prime()
    assert small.qs == src.qs[:-1]
    for l, q in enumerate(small.qs):
        np.testing.assert_array_equal(out[l], (y % q).astype(np.uint32))


def test_rescale_then_convert_roundtrip(rings):
    """Composition smoke: rescale into the smaller basis, then convert to a
    fresh basis — shapes and moduli line up end-to-end."""
    src, dst = rings
    rng = np.random.default_rng(14)
    x = _random_bigints(rng, src.modulus, (2, src.n))
    res = src.to_rns(x)
    down = src.rescale(res)
    small = src.drop_prime()
    out = small.base_convert(down, dst, correction="float")
    assert out.shape == (dst.L, 2, src.n)
    qL = src.qs[-1]
    s = x % qL
    s = np.where(s > qL // 2, s - qL, s)
    y = (x - s) // qL
    for j, p in enumerate(dst.qs):
        np.testing.assert_array_equal(np.asarray(out)[j],
                                      (y % p).astype(np.uint32))


def test_base_convert_validates(rings):
    src, dst = rings
    bad = np.zeros((src.L + 1, 2, src.n), dtype=np.uint32)
    with pytest.raises(ValueError):
        src.base_convert(bad, dst)
    with pytest.raises(ValueError):
        src.base_convert(np.zeros((src.L, 2, src.n), dtype=np.uint32),
                         dst, correction="fancy")


def test_sharded_base_convert_and_rescale_match_single_chip(rings):
    """dp mesh: the channel-mixing ops stay bit-identical to the
    single-chip RNSRing (the dp/sp axes are purely elementwise for these
    ops; under ch sharding the crossings are XLA-inserted gathers — see
    ShardedRNSRing._mixing_op)."""
    import jax.numpy as jnp
    from agilex_ntt.parallel import ShardedRNSRing, make_mesh

    src, dst = rings
    require_devices(2)
    mesh = make_mesh(dp=2)
    srns = ShardedRNSRing(src, mesh, dp_axis="dp")
    rng = np.random.default_rng(15)
    x = _random_bigints(rng, src.modulus, (6, src.n))
    res = jnp.asarray(src.to_rns(x))
    placed = srns.shard(res)
    np.testing.assert_array_equal(
        np.asarray(srns.base_convert(placed, dst, correction="float")),
        np.asarray(src.base_convert(res, dst, correction="float")),
    )
    np.testing.assert_array_equal(
        np.asarray(srns.rescale(placed)), np.asarray(src.rescale(res))
    )


# -- BFV primitives: HPS scale-and-round + Shenoy-Kumaresan exact convert --


@pytest.fixture(scope="module")
def bfv_bases():
    n = 256
    primes = find_primes(n, 8)
    qs = tuple(primes[:3])          # Q
    bs = tuple(primes[3:7])         # auxiliary base B
    m_sk = primes[7]                # redundant modulus
    return n, qs, bs, m_sk


def test_scale_round_matches_bigint_rounding(bfv_bases):
    from agilex_ntt.ops.basechange import scale_round

    n, qs, bs, m_sk = bfv_bases
    t = find_primes(n, 1, bits=16)[0]
    Q = int(np.prod([int(q) for q in qs], dtype=object))
    B = int(np.prod([int(b) for b in bs], dtype=object)) * m_sk
    rng = np.random.default_rng(21)
    # x spans the full union basis range [0, Q*B') like a tensor product
    x = _random_bigints(rng, Q * B, (3, n))
    x_src = np.stack([(x % q).astype(np.uint32) for q in qs])
    dst = bs + (m_sk,)
    x_dst = np.stack([(x % p).astype(np.uint32) for p in dst])
    out = np.asarray(scale_round(x_src, x_dst, qs, dst, t))
    want = (2 * t * x + Q) // (2 * Q)  # round(t*x/Q), exact big-int
    for j, p in enumerate(dst):
        diff = (out[j].astype(object) - want % p) % p
        # the float32 fractional sum may round ±1 in a narrow band — the
        # HPS noise term; anything else is a correctness break
        diff = np.where(diff > p // 2, diff - p, diff)
        assert np.abs(diff).max() <= 1
        # and the offset must be IDENTICAL across channels (one integer)
        if j == 0:
            ref = diff
        else:
            np.testing.assert_array_equal(diff, ref)


def test_base_convert_sk_is_exact(bfv_bases):
    from agilex_ntt.ops.basechange import base_convert_sk

    n, qs, bs, m_sk = bfv_bases
    B = int(np.prod([int(b) for b in bs], dtype=object))
    rng = np.random.default_rng(22)
    y = _random_bigints(rng, B, (3, n))
    # include the small values where the float-corrected convert can fail
    y[0, :8] = np.arange(8)
    y[0, 8:12] = [B - 1 - k for k in range(4)]
    x = np.stack([(y % b).astype(np.uint32) for b in bs])
    x_sk = (y % m_sk).astype(np.uint32)
    out = np.asarray(base_convert_sk(x, x_sk, bs, m_sk, qs))
    for j, q in enumerate(qs):
        np.testing.assert_array_equal(out[j], (y % q).astype(np.uint32))
