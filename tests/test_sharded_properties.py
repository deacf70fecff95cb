"""Randomized sharded-path properties (hypothesis over mesh/size/strategy).

Every combination of sharding strategy, mesh factorization, and transform
size must stay bit-identical to the single-chip golden model.
"""

import jax
import numpy as np
import pytest
from hypothesis import given, settings, strategies as st

from agilex_ntt import Ring
from agilex_ntt import golden as G
from agilex_ntt.parallel import ShardedRing, make_mesh


pytestmark = pytest.mark.skipif(
    len(jax.devices()) < 8, reason="needs 8 (virtual) devices"
)


@settings(max_examples=10, deadline=None)
@given(
    n=st.sampled_from([512, 1024, 4096]),
    sp=st.sampled_from([2, 4]),
    with_dp=st.booleans(),
    method=st.sampled_from(["stage", "fourstep"]),
    seed=st.integers(0, 2**31 - 1),
)
def test_sharded_ntt_always_matches_golden(n, sp, with_dp, method, seed):
    ring = Ring(n)
    dp = 8 // sp if with_dp else None
    mesh = make_mesh(**({"dp": dp, "sp": sp} if dp else {"sp": sp}))
    sr = ShardedRing(
        ring, mesh, dp_axis="dp" if dp else None, sp_axis="sp",
        sp_method=method,
    )
    rng = np.random.default_rng(seed)
    b = 2 * (dp or 1)
    x = rng.integers(0, ring.q, size=(b, n), dtype=np.uint32)
    got = np.asarray(sr.ntt(sr.shard(x)))
    assert (got == G.fwd_ntt_u32(x, ring.params)).all()
    back = np.asarray(sr.intt(sr.ntt(sr.shard(x))))
    assert (back == x).all()


def test_sharded_rns_dp_fused_kernel(rng):
    """Round-2: dp-only ShardedRNSRing runs ONE shard_map over the fused
    multi-prime kernel (interpret mode exercises it on the CPU mesh)."""
    import jax.numpy as jnp

    from agilex_ntt import RNSRing
    from agilex_ntt.parallel import ShardedRNSRing, make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    n, L = 256, 3
    rns_i = RNSRing(n, num_primes=L, interpret=True)
    rns_oracle = RNSRing(n, num_primes=L)
    mesh = make_mesh(dp=8)
    srns = ShardedRNSRing(rns_i, mesh, dp_axis="dp")
    assert srns._use_dp_fused()
    x = np.stack([
        rng.integers(0, r.q, size=(16, n), dtype=np.uint32)
        for r in rns_i.rings
    ])
    got = np.asarray(srns.ntt(srns.shard(jnp.asarray(x))))
    want = np.asarray(rns_oracle.ntt(x))
    assert (got == want).all()
    pm = np.asarray(srns.polymul(srns.shard(jnp.asarray(x)),
                                 srns.shard(jnp.asarray(x))))
    want_pm = np.asarray(rns_oracle.polymul(x, x))
    assert (pm == want_pm).all()
    back = np.asarray(srns.intt(srns.shard(jnp.asarray(got))))
    assert (back == x).all()


def test_sharded_rns_dp_fused_uneven_batch(rng):
    """Code-review round 2: the dp-fused RNS path must support
    remainder-frame batches like the stacked fallback."""
    import jax.numpy as jnp

    from agilex_ntt import RNSRing
    from agilex_ntt.parallel import ShardedRNSRing, make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    n, L = 256, 2
    rns_i = RNSRing(n, num_primes=L, interpret=True)
    oracle = RNSRing(n, num_primes=L)
    srns = ShardedRNSRing(rns_i, make_mesh(dp=8), dp_axis="dp")
    assert srns._use_dp_fused()
    x = np.stack([
        rng.integers(0, r.q, size=(13, n), dtype=np.uint32)
        for r in rns_i.rings
    ])
    got = np.asarray(srns.ntt(jnp.asarray(x)))
    assert got.shape == x.shape
    assert (got == np.asarray(oracle.ntt(x))).all()


@pytest.mark.parametrize("axes", [dict(ch=4, dp=2), dict(ch=2, dp=4)])
def test_sharded_rns_channel_parallel(rng, axes):
    """Round-2 channel parallelism (the RNS analog of expert parallelism):
    prime channels shard over a mesh axis with their tables; bit-exact vs
    the single-host RNSRing, including a remainder-frame batch."""
    import jax.numpy as jnp

    from agilex_ntt import RNSRing
    from agilex_ntt.parallel import ShardedRNSRing, make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    n, L = 256, 4
    rns_i = RNSRing(n, num_primes=L, interpret=True)
    oracle = RNSRing(n, num_primes=L)
    mesh = make_mesh(**axes)
    srns = ShardedRNSRing(rns_i, mesh, dp_axis="dp", ch_axis="ch")
    x = np.stack([
        rng.integers(0, r.q, size=(5, n), dtype=np.uint32)  # 5 % dp != 0 both ways
        for r in rns_i.rings
    ])
    # NOTE: remainder batches are passed unsharded (shard() is an eager
    # device_put and cannot place a non-divisible batch; the jitted ops
    # pad, place, and slice internally)
    got = np.asarray(srns.ntt(jnp.asarray(x)))
    assert (got == np.asarray(oracle.ntt(x))).all()
    back = np.asarray(srns.intt(jnp.asarray(got)))
    assert (back == x).all()
    pm = np.asarray(srns.polymul(jnp.asarray(x), jnp.asarray(x)))
    assert (pm == np.asarray(oracle.polymul(x, x))).all()


@pytest.mark.parametrize(
    "axes,use_ch",
    [(dict(dp=8), False), (dict(ch=2, dp=4), True), (dict(ch=4, dp=2), True)],
)
def test_sharded_rns_polydot(rng, axes, use_ch):
    """Round 3 (VERDICT round-2 item 4): distributed RNS polydot under dp
    (fused multi-prime kernel in one shard_map) and under ch (channels and
    tables sharded together), remainder batch included."""
    import jax.numpy as jnp

    from agilex_ntt import RNSRing
    from agilex_ntt.parallel import ShardedRNSRing, make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    n, L, k = 256, 4, 2
    rns_i = RNSRing(n, num_primes=L, interpret=True)
    oracle = RNSRing(n, num_primes=L)
    mesh = make_mesh(**axes)
    srns = ShardedRNSRing(
        rns_i, mesh, dp_axis="dp", ch_axis="ch" if use_ch else None
    )
    a = np.stack([
        rng.integers(0, r.q, size=(5, k, n), dtype=np.uint32)
        for r in rns_i.rings
    ])
    b = np.stack([
        rng.integers(0, r.q, size=(5, k, n), dtype=np.uint32)
        for r in rns_i.rings
    ])
    got = np.asarray(srns.polydot(jnp.asarray(a), jnp.asarray(b)))
    want = np.asarray(oracle.polydot(a, b))
    assert got.shape == (L, 5, n)
    assert (got == want).all()


def test_sharded_rns_ch_x_sp(rng):
    """Round 3 (VERDICT round-2 item 8): ch_axis composes with sp_axis —
    channels over one mesh axis, coefficients over another (the L x large-n
    production shape), batch over a third.  Bit-exact vs the single-chip
    RNSRing, remainder batch included."""
    import jax.numpy as jnp

    from agilex_ntt import RNSRing
    from agilex_ntt.parallel import ShardedRNSRing, make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    n, L = 16384, 2  # (n1, n2) = (128, 128): smallest ch x sp-eligible size
    rns_i = RNSRing(n, num_primes=L, interpret=True,
                    method="fourstep")
    oracle = RNSRing(n, num_primes=L)
    mesh = make_mesh(ch=2, sp=2, dp=2)
    srns = ShardedRNSRing(rns_i, mesh, dp_axis="dp", sp_axis="sp",
                          ch_axis="ch")
    x = np.stack([
        rng.integers(0, r.q, size=(3, n), dtype=np.uint32)  # 3 % dp != 0
        for r in rns_i.rings
    ])
    got = np.asarray(srns.ntt(jnp.asarray(x)))
    assert (got == np.asarray(oracle.ntt(x))).all()
    back = np.asarray(srns.intt(jnp.asarray(got)))
    assert (back == x).all()
    pm = np.asarray(srns.polymul(jnp.asarray(x), jnp.asarray(x)))
    assert (pm == np.asarray(oracle.polymul(x, x))).all()
    # polydot with k=2 terms
    a = np.stack([
        rng.integers(0, r.q, size=(2, 2, n), dtype=np.uint32)
        for r in rns_i.rings
    ])
    b = np.stack([
        rng.integers(0, r.q, size=(2, 2, n), dtype=np.uint32)
        for r in rns_i.rings
    ])
    pd = np.asarray(srns.polydot(jnp.asarray(a), jnp.asarray(b)))
    assert (pd == np.asarray(oracle.polydot(a, b))).all()


def test_sharded_rns_ch_x_sp_rejects_radix2(rng):
    """radix-2 rings still reject the combination, with a clear message."""
    from agilex_ntt import RNSRing
    from agilex_ntt.parallel import ShardedRNSRing, make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    rns = RNSRing(256, num_primes=2, interpret=True)
    with pytest.raises(ValueError, match="four-step"):
        ShardedRNSRing(rns, make_mesh(ch=2, sp=2, dp=2), dp_axis="dp",
                       sp_axis="sp", ch_axis="ch")


def test_sharded_rns_rotate_automorphism(rng):
    """Round 3: per-channel gather ops on the sharded residues."""
    import jax.numpy as jnp

    from agilex_ntt import RNSRing
    from agilex_ntt.parallel import ShardedRNSRing, make_mesh

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    n, L = 256, 2
    rns = RNSRing(n, num_primes=L)
    srns = ShardedRNSRing(rns, make_mesh(dp=8), dp_axis="dp")
    x = np.stack([
        rng.integers(0, r.q, size=(8, n), dtype=np.uint32)
        for r in rns.rings
    ])
    xs = srns.shard(jnp.asarray(x))
    assert (
        np.asarray(srns.rotate(xs, 7)) == np.asarray(rns.rotate(x, 7))
    ).all()
    for domain in ("coeff", "ntt"):
        got = np.asarray(srns.automorphism(xs, 3, domain=domain))
        want = np.asarray(rns.automorphism(x, 3, domain=domain))
        assert (got == want).all(), domain
