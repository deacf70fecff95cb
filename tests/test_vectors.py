"""Known-answer tests: every implementation layer against the committed
SEAL-Embedded-style vector battery (tests/vectors/ntt_kat.npz).

The battery was generated by the native C core and certified against the
independent big-int oracle (tools/gen_vectors.py); these tests close the loop
by checking the numpy golden models, the XLA path, the Pallas kernels, and
(when built) the C core itself against the committed bits.
"""

import os

import numpy as np
import pytest

from agilex_ntt import Ring, golden as G, native
from agilex_ntt.params import make_params

VEC = os.path.join(os.path.dirname(__file__), "vectors", "ntt_kat.npz")
# full reference size menu (include/kernel/ntt.h:11-23) plus n=4096
SIZES = [32, 1024, 4096, 8192, 16384, 32768]
# plus one four-step-range size beyond the reference's wall (round 2)
SIZES_ALL = SIZES + [65536]
# round 3: the remaining four-step sizes the sweep quotes, forward-only
# vectors stored uint32 (see tools/gen_vectors.py gen_large_fourstep)
SIZES_LARGE = [1 << 18, 1 << 20]


@pytest.fixture(scope="module")
def kat():
    return np.load(VEC)


@pytest.mark.parametrize("n", SIZES_ALL)
def test_golden_u64_matches_kat(kat, n):
    q = int(kat[f"n{n}_q"])
    pp = make_params(n, q, int(kat[f"n{n}_psi"]))
    got = G.fwd_ntt_u64(kat[f"n{n}_input"], pp)
    assert (got == kat[f"n{n}_ntt"]).all()


@pytest.mark.parametrize("n", SIZES)
def test_golden_u32_matches_kat(kat, n):
    q = int(kat[f"n{n}_q"])
    pp = make_params(n, q, int(kat[f"n{n}_psi"]))
    got = G.fwd_ntt_u32(kat[f"n{n}_input"].astype(np.uint32), pp)
    assert (got.astype(np.uint64) == kat[f"n{n}_ntt"]).all()


@pytest.mark.parametrize("n", SIZES_ALL)
def test_ring_matches_kat(kat, n):
    """Full API path (plain XLA on the CPU, the kernel on a GPU) against the
    KAT."""
    q = int(kat[f"n{n}_q"])
    ring = Ring(n, q, psi=int(kat[f"n{n}_psi"]))
    x = kat[f"n{n}_input"].astype(np.uint32)
    got = np.asarray(ring.ntt(x)).astype(np.uint64)
    assert (got == kat[f"n{n}_ntt"]).all()
    back = np.asarray(ring.intt(got.astype(np.uint32))).astype(np.uint64)
    assert (back == kat[f"n{n}_input"]).all()


@pytest.mark.parametrize("n", SIZES_ALL)
def test_ring_polymul_matches_kat(kat, n):
    q = int(kat[f"n{n}_q"])
    ring = Ring(n, q, psi=int(kat[f"n{n}_psi"]))
    a = kat[f"n{n}_pm_a"].astype(np.uint32)
    b = kat[f"n{n}_pm_b"].astype(np.uint32)
    got = np.asarray(ring.polymul(a, b)).astype(np.uint64)
    assert (got == kat[f"n{n}_pm_c"]).all()


@pytest.mark.parametrize("n", SIZES)
def test_pallas_interpret_matches_kat(kat, n):
    from agilex_ntt.ops import ntt_kernel as K

    q = int(kat[f"n{n}_q"])
    pp = make_params(n, q, int(kat[f"n{n}_psi"]))
    x = kat[f"n{n}_input"].astype(np.uint32)[None, :].repeat(8, axis=0)
    got = np.asarray(K.fwd_ntt(x, pp, interpret=True))
    assert (got[0].astype(np.uint64) == kat[f"n{n}_ntt"]).all()


@pytest.mark.skipif(not native.available(), reason="native core not built")
@pytest.mark.parametrize("n", SIZES_ALL)
def test_native_matches_kat(kat, n):
    q = int(kat[f"n{n}_q"])
    pp = make_params(n, q, int(kat[f"n{n}_psi"]))
    got = native.fwd_ntt(kat[f"n{n}_input"][None, :], q, pp.roots, pp.precon64)
    assert (got[0] == kat[f"n{n}_ntt"]).all()


def test_small_n_packed_pallas_matches_kat(kat):
    """n=32, the reference's smallest config, through the kernel
    (interpreter), with a batch that fills several programs."""
    from agilex_ntt.ops import ntt_kernel as K

    n = 32
    q = int(kat[f"n{n}_q"])
    pp = make_params(n, q, int(kat[f"n{n}_psi"]))
    x = kat[f"n{n}_input"].astype(np.uint32)[None, :].repeat(16, axis=0)
    got = np.asarray(K.fwd_ntt(x, pp, interpret=True))
    assert (got[0].astype(np.uint64) == kat[f"n{n}_ntt"]).all()


@pytest.mark.parametrize("n", SIZES_LARGE)
def test_ring_large_matches_kat(kat, n):
    """Four-step Ring at 2^18 / 2^20 against the committed certified rows —
    closes VERDICT round-2 item 7 (these sizes were previously pinned only
    by in-process golden comparisons)."""
    q = int(kat[f"n{n}_q"])
    ring = Ring(n, q, psi=int(kat[f"n{n}_psi"]))
    x = kat[f"n{n}_input"]
    got = np.asarray(ring.ntt(x))
    assert (got == kat[f"n{n}_ntt"]).all()
    back = np.asarray(ring.intt(got))
    assert (back == x).all()


@pytest.mark.parametrize("bits", [45, 62])
def test_widering_matches_kat(kat, bits):
    """WideRing (u64 word width, VERDICT round-2 item 5) against C-core
    generated, big-int-spot-certified vectors at wide primes."""
    from agilex_ntt import WideRing

    n = 1024
    q = int(kat[f"w{bits}_q"])
    ring = WideRing(n, q, psi=int(kat[f"w{bits}_psi"]))
    got = ring.ntt(kat[f"w{bits}_input"])
    assert (got == kat[f"w{bits}_ntt"]).all()
    back = ring.intt(got)
    assert (back == kat[f"w{bits}_input"]).all()
    pm = ring.polymul(kat[f"w{bits}_pm_a"], kat[f"w{bits}_pm_b"])
    assert (pm == kat[f"w{bits}_pm_c"]).all()


@pytest.mark.parametrize("n", [32, 1024])
def test_cyclic_ring_matches_kat(kat, n):
    """CyclicRing against the C-core-generated, big-int-certified cyclic
    vectors (round 2: the cyclic surface was previously pinned only by
    in-process golden models)."""
    from agilex_ntt import CyclicRing

    q = int(kat[f"cyc{n}_q"])
    ring = CyclicRing(n, q, omega=int(kat[f"cyc{n}_omega"]))
    x = kat[f"cyc{n}_input"].astype(np.uint32)
    got = np.asarray(ring.ntt(x)).astype(np.uint64)
    assert (got == kat[f"cyc{n}_ntt"]).all()
    back = np.asarray(ring.intt(got.astype(np.uint32))).astype(np.uint64)
    assert (back == kat[f"cyc{n}_input"]).all()


@pytest.mark.parametrize("k", [3, 5, 2047])
def test_automorphism_matches_kat(kat, k):
    """tau_k in both domains against big-int substitution vectors."""
    n = 1024
    q = int(kat["auto_q"])
    ring = Ring(n, q, psi=int(kat["auto_psi"]))
    x = kat["auto_input"].astype(np.uint32)
    got_c = np.asarray(ring.automorphism(x, k)).astype(np.uint64)
    assert (got_c == kat[f"auto_k{k}_coeff"]).all()
    y = kat["auto_ntt"].astype(np.uint32)
    got_n = np.asarray(ring.automorphism(y, k, domain="ntt")).astype(np.uint64)
    assert (got_n == kat[f"auto_k{k}_ntt"]).all()


def test_polydot_matches_kat(kat):
    """Ring.polydot against the pure big-int convolution oracle vectors."""
    n = 1024
    q = int(kat["pd_q"])
    ring = Ring(n, q)
    a = kat["pd_a"].astype(np.uint32)
    b = kat["pd_b"].astype(np.uint32)
    got = np.asarray(ring.polydot(a, b)).astype(np.uint64)
    assert (got == kat["pd_c"]).all()


def test_keyswitch_matches_kat(kat):
    """The one-call hybrid key-switch pipeline (gadget digits -> extended-
    basis polydot -> centered ModDown) against the committed big-int-
    certified vector at the production shape n=4096, L=4+2, dnum=2
    (round 4, VERDICT round-3 item 8 — the FHE core primitive gets the
    same certified-battery status as the transforms)."""
    from agilex_ntt import RNSRing

    ext_qs = tuple(int(q) for q in kat["ks_qs"])
    L, dnum = int(kat["ks_L"]), int(kat["ks_dnum"])
    rq = RNSRing(4096, qs=ext_qs[:L])
    got = np.asarray(rq.keyswitch(kat["ks_x"], kat["ks_ksk"], ext_qs, dnum))
    assert (got == kat["ks_out"]).all()
