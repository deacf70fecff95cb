"""Distributed four-step NTT on the 8-virtual-device CPU mesh.

The all-to-all transpose variant of the coefficient-sharded transform
(SURVEY.md §5: "local column NTTs -> twiddle scale -> all-to-all transpose
-> local row NTTs").  Everything must stay bit-identical to the single-chip
kernels / golden model, like the ppermute stage-shard path it complements.
"""

import jax
import numpy as np
import pytest

from agilex_ntt import Ring
from agilex_ntt import golden as G
from agilex_ntt.ops.fourstep import make_plan
from agilex_ntt.parallel import (
    ShardedRing,
    fourstep_sharded_fwd,
    fourstep_sharded_inv,
    make_mesh,
)

from conftest import params_for


@pytest.fixture(scope="module")
def devices8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return jax.devices()


@pytest.mark.parametrize("sp", [2, 4, 8])
def test_fourstep_sharded_fwd_matches_golden(devices8, rng, sp):
    n = 1024
    params = params_for(n)
    plan = make_plan(n, params.q, params.psi)
    mesh = make_mesh(sp=sp)
    x = rng.integers(0, params.q, size=(4, n), dtype=np.uint32)
    got = np.asarray(
        fourstep_sharded_fwd(x, plan, mesh, axis="sp")
    )
    want = G.fwd_ntt_u64(x, params).astype(np.uint32)
    assert (got == want).all()


def test_fourstep_sharded_inv_matches_golden(devices8, rng):
    n = 1024
    params = params_for(n)
    plan = make_plan(n, params.q, params.psi)
    mesh = make_mesh(sp=4)
    y = rng.integers(0, params.q, size=(3, n), dtype=np.uint32)
    got = np.asarray(
        fourstep_sharded_inv(y, plan, mesh, axis="sp")
    )
    want = G.inv_ntt_u64(y, params).astype(np.uint32)
    assert (got == want).all()


def test_fourstep_sharded_roundtrip_dp_sp(devices8, rng):
    """Combined dp x sp mesh, forward then inverse."""
    n = 4096
    params = params_for(n)
    plan = make_plan(n, params.q, params.psi)
    mesh = make_mesh(dp=2, sp=4)
    x = rng.integers(0, params.q, size=(4, n), dtype=np.uint32)
    y = fourstep_sharded_fwd(x, plan, mesh, axis="sp", dp_axis="dp")
    back = np.asarray(
        fourstep_sharded_inv(y, plan, mesh, axis="sp", dp_axis="dp")
    )
    assert (back == x).all()


def test_sharded_ring_fourstep_polymul(devices8, rng):
    """ShardedRing with sp_method='fourstep': full polymul vs golden."""
    n = 1024
    ring = Ring(n, method="fourstep")
    mesh = make_mesh(dp=2, sp=4)
    sr = ShardedRing(ring, mesh, dp_axis="dp", sp_axis="sp")
    assert sr.sp_method == "fourstep"
    a = rng.integers(0, ring.q, size=(4, n), dtype=np.uint32)
    b = rng.integers(0, ring.q, size=(4, n), dtype=np.uint32)
    got = np.asarray(sr.polymul(sr.shard(a), sr.shard(b)))
    fa = G.fwd_ntt_u32(a, ring.params)
    fb = G.fwd_ntt_u32(b, ring.params)
    prod = (
        (fa.astype(np.uint64) * fb.astype(np.uint64)) % np.uint64(ring.q)
    ).astype(np.uint32)
    want = G.inv_ntt_u32(prod, ring.params)
    assert (got == want).all()


def test_sharded_ring_sp_method_validation(devices8, rng):
    from agilex_ntt import CyclicRing

    mesh = make_mesh(sp=2)
    # a negacyclic four-step ring has single-pass tables too: the stage
    # method runs on it, bit-identical to the ring
    ring4 = Ring(1024, method="fourstep")
    sr = ShardedRing(ring4, mesh, dp_axis=None, sp_axis="sp",
                     sp_method="stage")
    x = rng.integers(0, ring4.q, size=(2, 1024), dtype=np.uint32)
    assert (np.asarray(sr.ntt(x)) == np.asarray(ring4.ntt(x))).all()
    # a four-step cyclic ring has none; overlap needs the four-step method
    with pytest.raises(ValueError):
        ShardedRing(CyclicRing(1 << 16), mesh, dp_axis=None, sp_axis="sp",
                    sp_method="stage")
    with pytest.raises(ValueError, match="overlap"):
        ShardedRing(Ring(1024), mesh, dp_axis=None, sp_axis="sp",
                    sp_method="stage", sp_comm="overlap")
    ring2 = Ring(1024)
    sr = ShardedRing(ring2, mesh, dp_axis=None, sp_axis="sp", sp_method="fourstep")
    assert sr._plan is not None


def test_fourstep_sharded_rejects_bad_split(devices8):
    n = 256
    params = params_for(n)
    plan = make_plan(n, params.q, params.psi, n1=128)  # n2 = 2, not divisible by P=8
    mesh = make_mesh(sp=8)
    x = np.zeros((2, n), dtype=np.uint32)
    with pytest.raises(ValueError):
        fourstep_sharded_fwd(x, plan, mesh, axis="sp")


def test_sharded_rns_ring(devices8, rng):
    """ShardedRNSRing: L channels, dp x sp mesh, one dispatch per op,
    bit-identical to per-channel single-chip golden."""
    from agilex_ntt import RNSRing
    from agilex_ntt.parallel import ShardedRNSRing

    n = 1024
    rns = RNSRing(n, num_primes=2)
    mesh = make_mesh(dp=2, sp=4)
    srns = ShardedRNSRing(rns, mesh, dp_axis="dp", sp_axis="sp",
                          sp_method="fourstep")
    a = np.stack([rng.integers(0, q, size=(4, n), dtype=np.uint32) for q in rns.qs])
    b = np.stack([rng.integers(0, q, size=(4, n), dtype=np.uint32) for q in rns.qs])
    got = np.asarray(srns.polymul(srns.shard(a), srns.shard(b)))
    for i, r in enumerate(rns.rings):
        fa = G.fwd_ntt_u32(a[i], r.params)
        fb = G.fwd_ntt_u32(b[i], r.params)
        pw = ((fa.astype(np.uint64) * fb.astype(np.uint64)) % np.uint64(r.q)).astype(np.uint32)
        assert (got[i] == G.inv_ntt_u32(pw, r.params)).all(), i
    back = np.asarray(srns.intt(srns.ntt(srns.shard(a))))
    assert (back == a).all()
