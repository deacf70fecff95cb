"""Multi-chip tests on the 8-virtual-device CPU mesh (the analog of testing
multi-CU behavior in the FPGA emulator, SURVEY.md §4).

All sharded paths must be bit-identical to the single-chip golden model.
"""

import jax
import numpy as np
import pytest

from agilex_ntt import Ring
from agilex_ntt import golden as G
from agilex_ntt.parallel import (
    ShardedRing,
    dp_shard_batch,
    make_mesh,
    stage_sharded_fwd,
    stage_sharded_inv,
)

from conftest import params_for


@pytest.fixture(scope="module")
def devices8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return jax.devices()


def test_dp_ntt_matches_golden(devices8, rng):
    ring = Ring(256)
    mesh = make_mesh(dp=8)
    x = rng.integers(0, ring.q, size=(32, 256), dtype=np.uint32)
    xs = dp_shard_batch(x, mesh)
    sr = ShardedRing(ring, mesh, dp_axis="dp")
    got = np.asarray(sr.ntt(xs))
    assert (got == G.fwd_ntt_u32(x, ring.params)).all()
    back = np.asarray(sr.intt(sr.ntt(xs)))
    assert (back == x).all()


@pytest.mark.parametrize("num_sp", [2, 4, 8])
def test_stage_sharded_fwd_bitexact(devices8, rng, num_sp):
    n = 2048
    pp = params_for(n)
    mesh = make_mesh(sp=num_sp)
    x = rng.integers(0, pp.q, size=(8, n), dtype=np.uint32)
    got = np.asarray(stage_sharded_fwd(x, pp, mesh, axis="sp"))
    assert (got == G.fwd_ntt_u32(x, pp)).all()


@pytest.mark.parametrize("num_sp", [2, 8])
def test_stage_sharded_inv_bitexact(devices8, rng, num_sp):
    n = 2048
    pp = params_for(n)
    mesh = make_mesh(sp=num_sp)
    y = rng.integers(0, pp.q, size=(8, n), dtype=np.uint32)
    got = np.asarray(stage_sharded_inv(y, pp, mesh, axis="sp"))
    assert (got == G.inv_ntt_u32(y, pp)).all()


def test_stage_sharded_roundtrip(devices8, rng):
    n = 1024
    pp = params_for(n)
    mesh = make_mesh(sp=4)
    x = rng.integers(0, pp.q, size=(8, n), dtype=np.uint32)
    y = stage_sharded_fwd(x, pp, mesh, axis="sp")
    z = np.asarray(stage_sharded_inv(y, pp, mesh, axis="sp"))
    assert (z == x).all()


def test_dp_plus_sp_2d_mesh(devices8, rng):
    """Combined data + stage parallelism on a (dp=2, sp=4) mesh."""
    n = 1024
    ring = Ring(n)
    mesh = make_mesh(dp=2, sp=4)
    sr = ShardedRing(ring, mesh, dp_axis="dp", sp_axis="sp")
    x = rng.integers(0, ring.q, size=(16, n), dtype=np.uint32)
    xs = sr.shard(x)
    got = np.asarray(sr.ntt(xs))
    assert (got == G.fwd_ntt_u32(x, ring.params)).all()
    z = np.asarray(sr.intt(sr.ntt(xs)))
    assert (z == x).all()


def test_sharded_polymul(devices8, rng):
    n = 512
    ring = Ring(n)
    mesh = make_mesh(dp=2, sp=2)
    sr = ShardedRing(ring, mesh, dp_axis="dp", sp_axis="sp")
    a = rng.integers(0, ring.q, size=(4, n), dtype=np.uint32)
    b = rng.integers(0, ring.q, size=(4, n), dtype=np.uint32)
    got = np.asarray(sr.polymul(sr.shard(a), sr.shard(b)))
    want = np.asarray(ring.polymul(a, b))
    assert (got == want).all()


@pytest.mark.parametrize("P", [2, 4, 8])
def test_stage_sharded_pallas_interpret(P, devices8, rng):
    """Local stages as one kernel call (interpreter) inside shard_map, on
    the per-shard tables, plus the cross-device stages; inverse too."""
    from agilex_ntt.parallel.stage_shard import stage_sharded_inv

    n = 1024
    pp = params_for(n)
    mesh = make_mesh(sp=P)
    x = rng.integers(0, pp.q, size=(8, n), dtype=np.uint32)
    got = np.asarray(
        stage_sharded_fwd(x, pp, mesh, axis="sp", interpret=True)
    )
    assert (got == G.fwd_ntt_u32(x, pp)).all()
    back = np.asarray(
        stage_sharded_inv(got, pp, mesh, axis="sp", interpret=True)
    )
    assert (back == x).all()


def test_sharded_cyclic_ring_dp(devices8, rng):
    """Round-2: ShardedRing now accepts CyclicRing (was a TypeError)."""
    from agilex_ntt import CyclicRing

    ring = CyclicRing(256)
    mesh = make_mesh(dp=8)
    sr = ShardedRing(ring, mesh, dp_axis="dp")
    x = rng.integers(0, ring.q, size=(16, 256), dtype=np.uint32)
    want = np.asarray(ring.ntt(x))
    got = np.asarray(sr.ntt(dp_shard_batch(x, mesh)))
    assert (got == want).all()
    a = rng.integers(0, ring.q, size=(16, 256), dtype=np.uint32)
    b = rng.integers(0, ring.q, size=(16, 256), dtype=np.uint32)
    assert (
        np.asarray(sr.polymul(a, b)) == np.asarray(ring.polymul(a, b))
    ).all()


def test_sharded_polydot_dp_fused(devices8, rng):
    """ShardedRing.polydot under dp with the kernel in the interpreter,
    remainder batch included; bit-exact vs the single-device op."""
    import jax.numpy as jnp

    n, k = 256, 3
    ring_i = Ring(n, interpret=True)
    oracle = Ring(n)
    mesh = make_mesh(dp=8)
    sr = ShardedRing(ring_i, mesh, dp_axis="dp")
    a = rng.integers(0, ring_i.q, size=(13, k, n), dtype=np.uint32)
    b = rng.integers(0, ring_i.q, size=(13, k, n), dtype=np.uint32)
    got = np.asarray(sr.polydot(jnp.asarray(a), jnp.asarray(b)))
    want = np.asarray(oracle.polydot(a, b))
    assert got.shape == (13, n)
    assert (got == want).all()


def test_sharded_polydot_dp_sp_composed(devices8, rng):
    """polydot with coefficient sharding: composed sharded transforms."""
    n, k = 512, 2
    ring = Ring(n)
    mesh = make_mesh(dp=2, sp=4)
    sr = ShardedRing(ring, mesh, dp_axis="dp", sp_axis="sp")
    a = rng.integers(0, ring.q, size=(4, k, n), dtype=np.uint32)
    b = rng.integers(0, ring.q, size=(4, k, n), dtype=np.uint32)
    got = np.asarray(sr.polydot(a, b))
    want = np.asarray(ring.polydot(a, b))
    assert (got == want).all()


def test_sharded_rotate_automorphism(devices8, rng):
    """Round 3: rotate/automorphism on the mesh (dp x sp), both domains."""
    n = 256
    ring = Ring(n)
    mesh = make_mesh(dp=4, sp=2)
    sr = ShardedRing(ring, mesh, dp_axis="dp", sp_axis="sp")
    x = rng.integers(0, ring.q, size=(8, n), dtype=np.uint32)
    xs = sr.shard(x)
    for k in (1, 5, 2 * n - 3):
        assert (
            np.asarray(sr.rotate(xs, k)) == np.asarray(ring.rotate(x, k))
        ).all()
    for k in (3, 5):
        for domain in ("coeff", "ntt"):
            got = np.asarray(sr.automorphism(xs, k, domain=domain))
            want = np.asarray(ring.automorphism(x, k, domain=domain))
            assert (got == want).all(), (k, domain)


@pytest.mark.parametrize("sp_method", ["stage", "fourstep"])
def test_sharded_cyclic_ring_sp(devices8, rng, sp_method):
    from agilex_ntt import CyclicRing

    n = 2048
    ring = CyclicRing(n)
    mesh = make_mesh(dp=2, sp=4)
    sr = ShardedRing(ring, mesh, dp_axis="dp", sp_axis="sp",
                     sp_method=sp_method)
    x = rng.integers(0, ring.q, size=(4, n), dtype=np.uint32)
    want = np.asarray(ring.ntt(x))
    got = np.asarray(sr.ntt(sr.shard(x)))
    assert (got == want).all()
    back = np.asarray(sr.intt(sr.shard(got)))
    assert (back == x).all()


def test_stage_shard_local_tables():
    """Shard d's local table entry m + g is the global twiddle of stage
    P*m, group d*m + g; the inverse's entries 0 and 1 are (1, w[P + d])."""
    from agilex_ntt.parallel.stage_shard import _local_tables

    pp = params_for(256)
    P = 4
    lw, lwp, cw, cwp = _local_tables(pp, P, False)
    assert lw.shape == (P, 64) and cw.shape == (P, 2)
    for d in range(P):
        for m in (1, 2, 32):
            for g in range(m):
                assert lw[d, m + g] == pp.roots32[P * m + d * m + g]
    # cross stage s = 0 (m = 1) has one group; s = 1 (m = 2) two
    assert (cw[:, 0] == pp.roots32[1]).all()
    assert list(cw[:, 1]) == [pp.roots32[2]] * 2 + [pp.roots32[3]] * 2
    ilw, ilwp, _, _ = _local_tables(pp, P, True)
    assert (ilw[:, 0] == 1).all()
    assert list(ilw[:, 1]) == list(pp.inv_roots32[P:2 * P])
    assert (ilwp[:, 0] == (1 << 32) // pp.q).all()


def test_chsp_interpret_matches_single_device(devices8, rng):
    """ch x sp four-step with the kernel in the interpreter inside the
    shard_map body, per-channel tables and moduli as sharded operands."""
    from agilex_ntt import RNSRing
    from agilex_ntt.parallel import ShardedRNSRing

    rns_i = RNSRing(16384, num_primes=2, method="fourstep", interpret=True)
    oracle = RNSRing(16384, num_primes=2)
    mesh = make_mesh(ch=2, sp=2)
    s = ShardedRNSRing(rns_i, mesh, dp_axis=None, sp_axis="sp",
                       ch_axis="ch")
    x = np.stack([rng.integers(0, r.q, size=(2, 16384), dtype=np.uint32)
                  for r in rns_i.rings])
    got = np.asarray(s.ntt(s.shard(x)))
    assert (got == np.asarray(oracle.ntt(x))).all()
    assert (np.asarray(s.intt(s.shard(got))) == x).all()
