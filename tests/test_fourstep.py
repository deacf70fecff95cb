"""Four-step large-N transform: bit-exactness, roundtrip, API integration.

The four-step path is the capability the reference structurally lacks — its
transform size is capped at n = 32768 by per-compute-unit BLOCK_RAM
(``/root/reference/include/kernel/ntt.h:11-23``, state arrays
``src/kernel/ntt.cpp:90-101``).  Everything here checks that the two-pass
decomposition is *bit-identical* to the single-pass kernels / golden model,
including through the Ring API and the polymul Montgomery-scale folding.
"""

import numpy as np
import pytest
import jax.numpy as jnp

from agilex_ntt import Ring, golden as G
from agilex_ntt.params import (
    find_primes,
    fourstep_split,
    make_cyclic_params,
    make_params,
)
from agilex_ntt.ops import xla_ntt
from agilex_ntt.ops.fourstep import (
    fwd_ntt_fourstep,
    inv_ntt_fourstep,
    make_plan,
)

from conftest import params_for


def _naive_cyclic_dft(x, q, omega):
    """O(n^2) big-int cyclic DFT, output in bit-reversed order."""
    n = len(x)
    logn = n.bit_length() - 1
    from agilex_ntt.params import bit_reverse

    out = [0] * n
    nz = [j for j in range(n) if x[j]]
    for k in range(n):
        wk = pow(omega, k, q)
        acc = 0
        for j in nz:
            acc = (acc + int(x[j]) * pow(wk, j, q)) % q
        out[bit_reverse(k, logn)] = acc
    return np.array(out, dtype=np.uint32)


def test_cyclic_tables_match_naive_dft(rng):
    """The cyclic stage tables drive the shared butterfly code to a true DFT."""
    n, nc = 512, 16
    q = find_primes(n, 1)[0]
    plan = make_plan(n, q)
    cp = plan.row  # size-n2 cyclic params
    # only the first nc coefficients nonzero, keeping the O(n^2) model fast
    x = np.zeros((1, cp.n), dtype=np.uint32)
    x[0, :nc] = rng.integers(0, q, size=nc, dtype=np.uint32)
    got = np.asarray(xla_ntt.fwd_ntt_xla(jnp.asarray(x), cp))
    want = _naive_cyclic_dft(x[0], q, cp.omega)
    assert (got[0] == want).all()


def test_cyclic_roundtrip(rng):
    n = 1024
    q = find_primes(n, 1)[0]
    plan = make_plan(n, q)
    cp = plan.row
    x = rng.integers(0, q, size=(4, cp.n), dtype=np.uint32)
    y = xla_ntt.fwd_ntt_xla(jnp.asarray(x), cp)
    back = np.asarray(xla_ntt.inv_ntt_xla(y, cp))
    assert (back == x).all()


@pytest.mark.parametrize("n", [256, 1024, 4096])
def test_fourstep_fwd_bit_exact_vs_golden(rng, n):
    params = params_for(n)
    plan = make_plan(n, params.q, params.psi)
    x = rng.integers(0, params.q, size=(5, n), dtype=np.uint32)
    got = np.asarray(fwd_ntt_fourstep(jnp.asarray(x), plan))
    want = G.fwd_ntt_u64(x, params).astype(np.uint32)
    assert (got == want).all()


@pytest.mark.parametrize("n", [256, 4096])
def test_fourstep_inv_bit_exact_vs_golden(rng, n):
    params = params_for(n)
    plan = make_plan(n, params.q, params.psi)
    y = rng.integers(0, params.q, size=(3, n), dtype=np.uint32)
    got = np.asarray(inv_ntt_fourstep(jnp.asarray(y), plan))
    want = G.inv_ntt_u64(y, params).astype(np.uint32)
    assert (got == want).all()


def test_fourstep_lazy_input_range(rng):
    """Forward accepts [0, 4q), inverse accepts [0, 2q), like the kernels."""
    n = 1024
    params = params_for(n)
    plan = make_plan(n, params.q, params.psi)
    x = rng.integers(0, 4 * params.q, size=(2, n), dtype=np.uint32)
    got = np.asarray(fwd_ntt_fourstep(jnp.asarray(x), plan))
    want = G.fwd_ntt_u64(x, params).astype(np.uint32)
    assert (got == want).all()


def test_fourstep_unbalanced_split(rng):
    n = 2048  # odd log2: n1=64, n2=32
    n1, n2 = fourstep_split(n)
    assert (n1, n2) == (64, 32) and n1 * n2 == n
    params = params_for(n)
    plan = make_plan(n, params.q, params.psi)
    x = rng.integers(0, params.q, size=(2, n), dtype=np.uint32)
    got = np.asarray(fwd_ntt_fourstep(jnp.asarray(x), plan))
    want = G.fwd_ntt_u64(x, params).astype(np.uint32)
    assert (got == want).all()


def test_fourstep_large_n_vs_golden(rng):
    """n = 65536: twice the reference's maximum size, checked bit-exactly."""
    n = 1 << 16
    q = find_primes(n, 1)[0]
    params = make_params(n, q)
    plan = make_plan(n, q, params.psi)
    x = rng.integers(0, q, size=(2, n), dtype=np.uint32)
    got = np.asarray(fwd_ntt_fourstep(jnp.asarray(x), plan))
    want = G.fwd_ntt_u64(x, params).astype(np.uint32)
    assert (got == want).all()
    back = np.asarray(inv_ntt_fourstep(jnp.asarray(got), plan))
    assert (back == x).all()


def test_fused_col_pass_interpret_bit_exact(rng):
    """Both passes through the GPU kernel in the Pallas interpreter,
    bit-compared to the golden model."""
    n = 65536
    params = params_for(n)
    plan = make_plan(n, params.q, params.psi)
    x = rng.integers(0, params.q, size=(2, n), dtype=np.uint32)
    got = np.asarray(
        fwd_ntt_fourstep(jnp.asarray(x), plan, interpret=True)
    )
    want = G.fwd_ntt_u64(x, params).astype(np.uint32)
    assert (got == want).all()
    back = np.asarray(
        inv_ntt_fourstep(jnp.asarray(got), plan, interpret=True)
    )
    assert (back == x).all()


@pytest.mark.parametrize("n1", [32, 512])
def test_nonsquare_split_interpret_bit_exact(n1, rng):
    """Explicit n1 != n2 splits through the kernel passes (interpreter)."""
    n = 1 << 14
    params = params_for(n, 1)
    plan = make_plan(n, params.q, params.psi, n1=n1)
    x = rng.integers(0, params.q, size=(2, n), dtype=np.uint32)
    got = np.asarray(fwd_ntt_fourstep(jnp.asarray(x), plan, interpret=True))
    assert (got == G.fwd_ntt_u64(x, params).astype(np.uint32)).all()
    back = np.asarray(inv_ntt_fourstep(jnp.asarray(got), plan,
                                       interpret=True))
    assert (back == x).all()


def test_plan_rejects_oversized_and_composite_q():
    from agilex_ntt.ops.fourstep import make_cyclic_plan

    with pytest.raises(ValueError, match="2\\*\\*30"):
        make_plan(256, q=2147483137)
    with pytest.raises(ValueError, match="not prime"):
        make_cyclic_plan(256, q=257 * 769, omega=2)


def test_ring_auto_selects_fourstep(rng):
    r = Ring(1 << 16)
    assert r.method == "fourstep"
    assert r.plan is not None
    with pytest.raises(ValueError):
        Ring(1 << 16, method="radix2")


def test_ring_fourstep_polymul_matches_naive(rng):
    """Negacyclic product through the four-step path (Montgomery fold incl.)."""
    n = 512
    r = Ring(n, method="fourstep")
    a = rng.integers(0, r.q, size=(n,), dtype=np.uint32)
    b = np.zeros(n, dtype=np.uint32)
    b[0], b[1], b[7] = 3, 1, rng.integers(1, r.q)
    got = np.asarray(r.polymul(a, b))
    # naive negacyclic convolution via big ints
    acc = np.zeros(n, dtype=object)
    for j in range(n):
        if b[j] == 0:
            continue
        for i in range(n):
            k = i + j
            s = 1 if k < n else -1
            acc[k % n] = (acc[k % n] + s * int(a[i]) * int(b[j])) % r.q
    assert (got == acc.astype(np.uint32)).all()


def test_ring_fourstep_matches_radix2(rng):
    n = 4096
    r2 = Ring(n, method="radix2")
    r4 = Ring(n, method="fourstep")
    assert r2.q == r4.q
    x = rng.integers(0, r2.q, size=(3, n), dtype=np.uint32)
    assert (np.asarray(r2.ntt(x)) == np.asarray(r4.ntt(x))).all()
    y = r2.ntt(x)
    assert (np.asarray(r2.intt(y)) == np.asarray(r4.intt(y))).all()


def test_fused_polymul_fourstep_interpret_bit_exact(rng):
    """Four-step polymul with kernel passes (interpreter) vs the composed
    plain chain: fwd x2, Montgomery pointwise, scaled inverse."""
    from agilex_ntt.ops.modmul import mont_mul_lazy, mont_qinv_neg

    n = 1 << 16
    q = find_primes(n, 1)[0]
    plan = make_plan(n, q)
    scale = pow(n, q - 2, q) * ((1 << 32) % q) % q
    a = rng.integers(0, q, size=(2, n), dtype=np.uint32)
    b = rng.integers(0, q, size=(2, n), dtype=np.uint32)
    got = np.asarray(Ring(n, q, interpret=True).polymul(a, b))
    fa = fwd_ntt_fourstep(jnp.asarray(a), plan)
    fb = fwd_ntt_fourstep(jnp.asarray(b), plan)
    prod = mont_mul_lazy(fa, fb, q, mont_qinv_neg(q))
    want = np.asarray(
        inv_ntt_fourstep(prod, plan, scale=scale)
    )
    assert (got == want).all()
