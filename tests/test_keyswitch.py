"""mod_down and the one-call hybrid keyswitch vs big-int / golden oracles."""

import numpy as np
import pytest

from conftest import require_devices

import jax.numpy as jnp

from agilex_ntt import RNSRing
from agilex_ntt.golden import negacyclic_convolution
from agilex_ntt.params import find_primes
from agilex_ntt.utils.crt import crt_compose


def _random_bigints(rng, modulus, shape):
    out = np.zeros(shape, dtype=object)
    chunks = (modulus.bit_length() + 29) // 30
    for _ in range(chunks):
        out = out * (1 << 30) + rng.integers(0, 1 << 30, size=shape).astype(object)
    return out % modulus


def _centered_divide(x, p):
    s = x % p
    s = np.where(s > p // 2, s - p, s)
    return (x - s) // p


@pytest.fixture(scope="module")
def ext_pair():
    n = 128
    qs = find_primes(n, 6)
    rq = RNSRing(n, qs=qs[:4])
    ext = RNSRing(n, qs=qs)  # Q + 2 specials
    return rq, ext


def test_mod_down_is_iterated_centered_round(ext_pair):
    _, ext = ext_pair
    rng = np.random.default_rng(31)
    x = _random_bigints(rng, ext.modulus, (3, ext.n))
    res = ext.to_rns(x)
    out = np.asarray(ext.mod_down(res, count=2))
    y = _centered_divide(x, ext.qs[-1])
    y = _centered_divide(y, ext.qs[-2])
    home = ext.drop_prime(2)
    assert home.L == ext.L - 2
    for l, q in enumerate(home.qs):
        np.testing.assert_array_equal(out[l], (y % q).astype(np.uint32))


def test_mod_down_count1_equals_rescale(ext_pair):
    _, ext = ext_pair
    rng = np.random.default_rng(32)
    res = np.stack(
        [rng.integers(0, q, size=(2, ext.n), dtype=np.uint32) for q in ext.qs]
    )
    np.testing.assert_array_equal(
        np.asarray(ext.mod_down(res, 1)), np.asarray(ext.rescale(res))
    )


def test_mod_down_validates(ext_pair):
    _, ext = ext_pair
    res = np.zeros((ext.L, 1, ext.n), dtype=np.uint32)
    with pytest.raises(ValueError):
        ext.mod_down(res, 0)
    with pytest.raises(ValueError):
        ext.mod_down(res, ext.L)


def test_keyswitch_matches_public_composition(ext_pair):
    """keyswitch == gadget_decompose -> polydot -> mod_down assembled from
    the already-oracle-pinned public pieces."""
    rq, ext = ext_pair
    dnum, batch = 2, 4
    rng = np.random.default_rng(33)
    x = np.stack(
        [rng.integers(0, q, size=(batch, rq.n), dtype=np.uint32)
         for q in rq.qs]
    )
    ksk = np.stack(
        [np.stack([rng.integers(0, q, size=rq.n, dtype=np.uint32)
                   for q in ext.qs])
         for _ in range(dnum)]
    )  # (dnum, K, n)
    got = np.asarray(rq.keyswitch(x, ksk, ext, dnum))

    dig = np.asarray(rq.gadget_decompose(x, ext, dnum))  # (dnum, K, B, n)
    dig_k = jnp.moveaxis(jnp.asarray(dig), 0, -2)        # (K, B, dnum, n)
    kb = jnp.broadcast_to(
        jnp.moveaxis(jnp.asarray(ksk), 0, -2)[:, None], dig_k.shape
    )
    want = np.asarray(ext.mod_down(ext.polydot(dig_k, kb), count=2))
    np.testing.assert_array_equal(got, want)
    assert got.shape == (rq.L, batch, rq.n)


def test_keyswitch_bigint_oracle(ext_pair):
    """Fully independent oracle: big-int digits, O(n^2) negacyclic
    convolutions per channel, centered ModDown — no device code shared."""
    rq, ext = ext_pair
    dnum, batch = 2, 2
    rng = np.random.default_rng(34)
    xb = _random_bigints(rng, rq.modulus, (batch, rq.n))
    x = rq.to_rns(xb)
    ksk = np.stack(
        [np.stack([rng.integers(0, q, size=rq.n, dtype=np.uint32)
                   for q in ext.qs])
         for _ in range(dnum)]
    )
    got = np.asarray(rq.keyswitch(x, ksk, ext, dnum))

    # oracle digits t_d = [x]_{Q_d}, groups of 2 primes
    ts = []
    for lo, hi in ((0, 2), (2, 4)):
        ts.append(crt_compose(x[lo:hi], rq.qs[lo:hi]))
    # per extended channel: sum_d negacyclic(t_d mod p, ksk[d, j]) mod p
    prod = np.zeros((ext.L, batch, ext.n), dtype=object)
    for j, p in enumerate(ext.qs):
        for d in range(dnum):
            for b in range(batch):
                conv = negacyclic_convolution(
                    [int(v) for v in (ts[d][b] % p)],
                    [int(v) for v in ksk[d, j]], p,
                )
                prod[j, b] = (prod[j, b] + np.array(conv, dtype=object)) % p
    big = crt_compose(prod.astype(object), ext.qs)
    y = _centered_divide(big, ext.qs[-1])
    y = _centered_divide(y, ext.qs[-2])
    for l, q in enumerate(rq.qs):
        np.testing.assert_array_equal(got[l], (y % q).astype(np.uint32))


def test_keyswitch_batched_ksk_matches_shared(ext_pair):
    rq, ext = ext_pair
    dnum, batch = 2, 3
    rng = np.random.default_rng(35)
    x = np.stack(
        [rng.integers(0, q, size=(batch, rq.n), dtype=np.uint32)
         for q in rq.qs]
    )
    ksk = np.stack(
        [np.stack([rng.integers(0, q, size=rq.n, dtype=np.uint32)
                   for q in ext.qs])
         for _ in range(dnum)]
    )
    full = np.broadcast_to(ksk[:, :, None, :], (dnum, ext.L, batch, rq.n))
    np.testing.assert_array_equal(
        np.asarray(rq.keyswitch(x, ksk, ext, dnum)),
        np.asarray(rq.keyswitch(x, np.ascontiguousarray(full), ext, dnum)),
    )


def test_keyswitch_validates(ext_pair):
    rq, ext = ext_pair
    x = np.zeros((rq.L, 1, rq.n), dtype=np.uint32)
    with pytest.raises(ValueError):
        rq.keyswitch(x, np.zeros((2, ext.L, rq.n), np.uint32),
                     find_primes(rq.n, 6)[2:], 2)  # first-L mismatch
    with pytest.raises(ValueError):
        rq.keyswitch(x, np.zeros((2, ext.L, rq.n), np.uint32), rq.qs, 2)
    with pytest.raises(ValueError):
        rq.keyswitch(x, np.zeros((3, ext.L, rq.n), np.uint32), ext, 2)


def test_sharded_keyswitch_and_mod_down_match_single_chip(ext_pair):
    from agilex_ntt.parallel import ShardedRNSRing, make_mesh

    rq, ext = ext_pair
    dnum, batch = 2, 4
    rng = np.random.default_rng(36)
    x = np.stack(
        [rng.integers(0, q, size=(batch, rq.n), dtype=np.uint32)
         for q in rq.qs]
    )
    ksk = np.stack(
        [np.stack([rng.integers(0, q, size=rq.n, dtype=np.uint32)
                   for q in ext.qs])
         for _ in range(dnum)]
    )
    single_ks = np.asarray(rq.keyswitch(x, ksk, ext, dnum))
    ext_res = np.stack(
        [rng.integers(0, q, size=(batch, ext.n), dtype=np.uint32)
         for q in ext.qs]
    )
    single_md = np.asarray(ext.mod_down(ext_res, 2))

    require_devices(2)
    mesh = make_mesh(dp=2)
    srq = ShardedRNSRing(rq, mesh, dp_axis="dp")
    sext = ShardedRNSRing(ext, mesh, dp_axis="dp")
    np.testing.assert_array_equal(
        np.asarray(srq.keyswitch(srq.shard(jnp.asarray(x)), ksk, ext, dnum)),
        single_ks,
    )
    np.testing.assert_array_equal(
        np.asarray(sext.mod_down(sext.shard(jnp.asarray(ext_res)), 2)),
        single_md,
    )


def test_hoisted_keyswitch_matches_per_step_composition(ext_pair):
    """hoisted_keyswitch == per-step (tau on digits -> polydot -> mod_down)
    assembled from the public pieces.  tau is applied AFTER decomposition on
    both sides (the hoisting identity: tau of the gadget reconstruction),
    and the composition exercises the coeff-domain automorphism while the
    hoisted path permutes NTT slots — equality certifies the eval-domain
    table against the coeff-domain one through the whole pipeline."""
    rq, ext = ext_pair
    dnum, batch = 2, 3
    ks = (3, 2 * rq.n - 1, 9)
    rng = np.random.default_rng(41)
    x = np.stack(
        [rng.integers(0, q, size=(batch, rq.n), dtype=np.uint32)
         for q in rq.qs]
    )
    ksks = np.stack([
        np.stack([
            np.stack([rng.integers(0, q, size=rq.n, dtype=np.uint32)
                      for q in ext.qs])
            for _ in range(dnum)
        ])
        for _ in ks
    ])  # (nk, dnum, K, n)
    got = np.asarray(rq.hoisted_keyswitch(x, ksks, ks, ext, dnum))
    assert got.shape == (len(ks), rq.L, batch, rq.n)

    dig = jnp.asarray(np.asarray(rq.gadget_decompose(x, ext, dnum)))
    dig_ch = jnp.moveaxis(dig, 0, 1)  # (K, dnum, B, n)
    for j, k in enumerate(ks):
        tau = ext.automorphism(dig_ch, k)            # coeff domain, per chan
        dig_k = jnp.moveaxis(tau, 1, -2)             # (K, B, dnum, n)
        kb = jnp.broadcast_to(
            jnp.moveaxis(jnp.asarray(ksks[j]), 0, -2)[:, None], dig_k.shape
        )
        want = np.asarray(ext.mod_down(ext.polydot(dig_k, kb), count=2))
        np.testing.assert_array_equal(got[j], want)


def test_hoisted_keyswitch_single_step_no_batch(ext_pair):
    """ks of length 1 and a batchless (L, n) input both round through."""
    rq, ext = ext_pair
    dnum = rq.L
    rng = np.random.default_rng(43)
    x = np.stack(
        [rng.integers(0, q, size=rq.n, dtype=np.uint32) for q in rq.qs]
    )
    ksks = np.stack([
        np.stack([
            np.stack([rng.integers(0, q, size=rq.n, dtype=np.uint32)
                      for q in ext.qs])
            for _ in range(dnum)
        ])
    ])
    got = np.asarray(rq.hoisted_keyswitch(x, ksks, (5,), ext, dnum))
    assert got.shape == (1, rq.L, rq.n)
    dig = jnp.asarray(np.asarray(rq.gadget_decompose(x, ext, dnum)))
    tau = ext.automorphism(jnp.moveaxis(dig, 0, 1), 5)
    dig_k = jnp.moveaxis(tau, 1, -2)
    kb = jnp.moveaxis(jnp.asarray(ksks[0]), 0, -2)
    want = np.asarray(ext.mod_down(ext.polydot(dig_k, kb), count=2))
    np.testing.assert_array_equal(got[0], want)


def test_hoisted_keyswitch_validates(ext_pair):
    rq, ext = ext_pair
    x = np.zeros((rq.L, rq.n), dtype=np.uint32)
    ksks = np.zeros((1, 2, ext.L, rq.n), dtype=np.uint32)
    with pytest.raises(ValueError, match="odd"):
        rq.hoisted_keyswitch(x, ksks, (4,), ext, 2)
    with pytest.raises(ValueError, match="ksks"):
        rq.hoisted_keyswitch(x, ksks[:, :1], (3,), ext, 2)


def test_sharded_hoisted_keyswitch_matches_single_chip(ext_pair):
    from agilex_ntt.parallel import ShardedRNSRing, make_mesh

    rq, ext = ext_pair
    dnum, batch = 2, 4
    ks = (3, 7)
    rng = np.random.default_rng(47)
    x = np.stack(
        [rng.integers(0, q, size=(batch, rq.n), dtype=np.uint32)
         for q in rq.qs]
    )
    ksks = np.stack([
        np.stack([
            np.stack([rng.integers(0, q, size=rq.n, dtype=np.uint32)
                      for q in ext.qs])
            for _ in range(dnum)
        ])
        for _ in ks
    ])
    single = np.asarray(rq.hoisted_keyswitch(x, ksks, ks, ext, dnum))
    require_devices(2)
    mesh = make_mesh(dp=2)
    srq = ShardedRNSRing(rq, mesh, dp_axis="dp")
    got = np.asarray(
        srq.hoisted_keyswitch(srq.shard(jnp.asarray(x)), ksks, ks, ext, dnum)
    )
    np.testing.assert_array_equal(got, single)


def test_ntt_domain_keys_bit_identical(ext_pair):
    """ksk_to_ntt + ksk_domain='ntt' == the coeff-domain path, bit for bit,
    for both keyswitch and hoisted_keyswitch (the serving configuration:
    keys transformed once at setup, not per call)."""
    rq, ext = ext_pair
    dnum, batch = 2, 3
    ks = (3, 7)
    rng = np.random.default_rng(53)
    x = np.stack(
        [rng.integers(0, q, size=(batch, rq.n), dtype=np.uint32)
         for q in rq.qs]
    )
    ksk = np.stack(
        [np.stack([rng.integers(0, q, size=rq.n, dtype=np.uint32)
                   for q in ext.qs])
         for _ in range(dnum)]
    )
    want = np.asarray(rq.keyswitch(x, ksk, ext, dnum))
    ksk_ntt = rq.ksk_to_ntt(ksk, ext)
    got = np.asarray(rq.keyswitch(x, ksk_ntt, ext, dnum, ksk_domain="ntt"))
    np.testing.assert_array_equal(got, want)

    ksks = np.stack([ksk] * len(ks))
    want_h = np.asarray(rq.hoisted_keyswitch(x, ksks, ks, ext, dnum))
    ksks_ntt = rq.ksk_to_ntt(ksks, ext, ch_axis=2)
    got_h = np.asarray(
        rq.hoisted_keyswitch(x, ksks_ntt, ks, ext, dnum, ksk_domain="ntt")
    )
    np.testing.assert_array_equal(got_h, want_h)

    with pytest.raises(ValueError, match="ksk_domain"):
        rq.keyswitch(x, ksk, ext, dnum, ksk_domain="eval")


def _linear_sum_spec(rq, ext, c0, c1, pts, ksks_b, ksks_a, ks, dnum):
    """The public-op composition hoisted_linear_sum must match bit for bit:
    per step tau-after-decompose -> polydot -> plaintext polymul, products
    accumulated in the EXTENDED basis, ONE deferred mod_down per part."""
    spec = ext.L - rq.L
    dig = jnp.asarray(np.asarray(rq.gadget_decompose(c1, ext, dnum)))
    dig_ch = jnp.moveaxis(dig, 0, 1)  # (K, dnum, ..., n)
    accB = accA = c0sum = None
    for j, k in enumerate(ks):
        tau = ext.automorphism(dig_ch, k)
        dig_k = jnp.moveaxis(tau, 1, -2)  # (K, ..., dnum, n)
        kb = jnp.broadcast_to(
            jnp.moveaxis(jnp.asarray(ksks_b[j]), 0, -2).reshape(
                (ext.L,) + (1,) * (dig_k.ndim - 3) + (dnum, rq.n)
            ),
            dig_k.shape,
        )
        ka = jnp.broadcast_to(
            jnp.moveaxis(jnp.asarray(ksks_a[j]), 0, -2).reshape(
                (ext.L,) + (1,) * (dig_k.ndim - 3) + (dnum, rq.n)
            ),
            dig_k.shape,
        )
        pdb = ext.polydot(dig_k, kb)  # (K, ..., n)
        pda = ext.polydot(dig_k, ka)
        ptj = jnp.broadcast_to(
            jnp.asarray(pts[j]).reshape(
                (ext.L,) + (1,) * (pdb.ndim - 2) + (rq.n,)
            ),
            pdb.shape,
        )
        tb = ext.polymul(ptj, pdb)
        ta = ext.polymul(ptj, pda)
        accB = tb if accB is None else ext.add(accB, tb)
        accA = ta if accA is None else ext.add(accA, ta)
        tau_c0 = rq.automorphism(jnp.asarray(c0), k)
        ptl = jnp.broadcast_to(
            jnp.asarray(pts[j][: rq.L]).reshape(
                (rq.L,) + (1,) * (tau_c0.ndim - 2) + (rq.n,)
            ),
            tau_c0.shape,
        )
        tc = rq.polymul(ptl, tau_c0)
        c0sum = tc if c0sum is None else rq.add(c0sum, tc)
    out0 = rq.add(c0sum, ext.mod_down(accB, count=spec))
    out1 = ext.mod_down(accA, count=spec)
    return np.asarray(out0), np.asarray(out1)


def _linear_sum_inputs(rq, ext, ks, dnum, batch, seed):
    rng = np.random.default_rng(seed)
    shape = (batch, rq.n) if batch else (rq.n,)
    c0 = np.stack(
        [rng.integers(0, q, size=shape, dtype=np.uint32) for q in rq.qs]
    )
    c1 = np.stack(
        [rng.integers(0, q, size=shape, dtype=np.uint32) for q in rq.qs]
    )
    pts = np.stack(
        [np.stack([rng.integers(0, q, size=rq.n, dtype=np.uint32)
                   for q in ext.qs])
         for _ in ks]
    )
    mk = lambda: np.stack([
        np.stack([
            np.stack([rng.integers(0, q, size=rq.n, dtype=np.uint32)
                      for q in ext.qs])
            for _ in range(dnum)
        ])
        for _ in ks
    ])
    return c0, c1, pts, mk(), mk()


def test_hoisted_linear_sum_matches_public_composition(ext_pair):
    rq, ext = ext_pair
    dnum, batch = 2, 2
    ks = (3, 9, 2 * rq.n - 1)
    c0, c1, pts, kb, ka = _linear_sum_inputs(rq, ext, ks, dnum, batch, 61)
    o0, o1 = rq.hoisted_linear_sum(c0, c1, pts, kb, ka, ks, ext, dnum)
    assert o0.shape == c0.shape and o1.shape == c1.shape
    w0, w1 = _linear_sum_spec(rq, ext, c0, c1, pts, kb, ka, ks, dnum)
    np.testing.assert_array_equal(np.asarray(o1), w1)
    np.testing.assert_array_equal(np.asarray(o0), w0)


def test_hoisted_linear_sum_batchless_and_single_step(ext_pair):
    rq, ext = ext_pair
    dnum = rq.L
    ks = (5,)
    c0, c1, pts, kb, ka = _linear_sum_inputs(rq, ext, ks, dnum, 0, 67)
    o0, o1 = rq.hoisted_linear_sum(c0, c1, pts, kb, ka, ks, ext, dnum)
    assert o0.shape == (rq.L, rq.n)
    w0, w1 = _linear_sum_spec(rq, ext, c0, c1, pts, kb, ka, ks, dnum)
    np.testing.assert_array_equal(np.asarray(o0), w0)
    np.testing.assert_array_equal(np.asarray(o1), w1)


def test_hoisted_linear_sum_pre_transformed_material(ext_pair):
    """ksk_domain='ntt' + pt_domain='ntt' (the serving configuration) is
    bit-identical to the coeff-domain path."""
    rq, ext = ext_pair
    dnum, batch = 2, 3
    ks = (3, 7)
    c0, c1, pts, kb, ka = _linear_sum_inputs(rq, ext, ks, dnum, batch, 71)
    w0, w1 = rq.hoisted_linear_sum(c0, c1, pts, kb, ka, ks, ext, dnum)
    kbn = rq.ksk_to_ntt(kb, ext, ch_axis=2)
    kan = rq.ksk_to_ntt(ka, ext, ch_axis=2)
    ptn = rq.ksk_to_ntt(pts, ext, ch_axis=1)
    g0, g1 = rq.hoisted_linear_sum(
        c0, c1, ptn, kbn, kan, ks, ext, dnum,
        ksk_domain="ntt", pt_domain="ntt",
    )
    np.testing.assert_array_equal(np.asarray(g0), np.asarray(w0))
    np.testing.assert_array_equal(np.asarray(g1), np.asarray(w1))


def test_hoisted_linear_sum_validates(ext_pair):
    rq, ext = ext_pair
    c0 = np.zeros((rq.L, rq.n), dtype=np.uint32)
    pts = np.zeros((1, ext.L, rq.n), dtype=np.uint32)
    kk = np.zeros((1, 2, ext.L, rq.n), dtype=np.uint32)
    with pytest.raises(ValueError, match="odd"):
        rq.hoisted_linear_sum(c0, c0, pts, kk, kk, (4,), ext, 2)
    with pytest.raises(ValueError, match="ksks_a"):
        rq.hoisted_linear_sum(c0, c0, pts, kk, kk[:, :1], (3,), ext, 2)
    with pytest.raises(ValueError, match="pts"):
        rq.hoisted_linear_sum(c0, c0, pts[:, :2], kk, kk, (3,), ext, 2)
    with pytest.raises(ValueError, match="pt_domain"):
        rq.hoisted_linear_sum(
            c0, c0, pts, kk, kk, (3,), ext, 2, pt_domain="eval"
        )


def test_sharded_hoisted_linear_sum_matches_single_chip(ext_pair):
    from agilex_ntt.parallel import ShardedRNSRing, make_mesh

    rq, ext = ext_pair
    dnum, batch = 2, 4
    ks = (3, 7)
    c0, c1, pts, kb, ka = _linear_sum_inputs(rq, ext, ks, dnum, batch, 73)
    w0, w1 = rq.hoisted_linear_sum(c0, c1, pts, kb, ka, ks, ext, dnum)

    require_devices(2)
    mesh = make_mesh(dp=2)
    srq = ShardedRNSRing(rq, mesh, dp_axis="dp")
    g0, g1 = srq.hoisted_linear_sum(
        srq.shard(jnp.asarray(c0)), srq.shard(jnp.asarray(c1)),
        pts, kb, ka, ks, ext, dnum,
    )
    np.testing.assert_array_equal(np.asarray(g0), np.asarray(w0))
    np.testing.assert_array_equal(np.asarray(g1), np.asarray(w1))
