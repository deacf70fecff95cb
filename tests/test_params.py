"""Tests for prime/root/twiddle-table generation (agilex_ntt.params)."""

import numpy as np
import pytest

from agilex_ntt import params as P
from agilex_ntt.config import NTTConfig

from conftest import params_for


def test_is_prime_small():
    primes = [2, 3, 5, 7, 11, 13, 65537, (1 << 13) * 12 + 1]
    comps = [1, 4, 9, 15, 65536, (1 << 30) - 1]
    for p in primes:
        if P.is_prime(p):
            pass
    assert P.is_prime(65537)
    assert not P.is_prime(65536)
    assert P.is_prime((1 << 31) - 1)  # Mersenne
    assert not P.is_prime((1 << 29) - 1)


@pytest.mark.parametrize("n", [32, 1024, 4096, 8192, 16384, 32768])
def test_find_primes(n):
    qs = P.find_primes(n, 3)
    assert len(set(qs)) == 3
    for q in qs:
        assert q < (1 << 30)
        assert q % (2 * n) == 1
        assert P.is_prime(q)
    assert qs == sorted(qs, reverse=True)


def test_psi_is_primitive_2n_root():
    n = 1024
    q = P.find_primes(n, 1)[0]
    psi = P.find_psi(n, q)
    assert pow(psi, n, q) == q - 1
    assert pow(psi, 2 * n, q) == 1
    # primitive: psi^(2n/p) != 1 for prime divisors p of 2n (only 2)
    assert pow(psi, n, q) != 1


def test_bit_reverse():
    assert P.bit_reverse(0b001, 3) == 0b100
    assert P.bit_reverse(0b110, 3) == 0b011
    assert [P.bit_reverse(i, 2) for i in range(4)] == [0, 2, 1, 3]


@pytest.mark.parametrize("n", [32, 1024])
def test_tables(n):
    pp = params_for(n)
    q = pp.q
    # roots[i] = psi^bitrev(i)
    for i in [0, 1, 2, 3, n // 2, n - 1]:
        assert int(pp.roots[i]) == pow(pp.psi, P.bit_reverse(i, pp.log_n), q)
    # precon correctness
    for i in [1, 5, n - 2]:
        w = int(pp.roots[i])
        assert int(pp.precon64[i]) == (w << 64) // q
        assert int(pp.precon32[i]) == (w << 32) // q
        assert int(pp.inv_roots[i]) == pow(w, q - 2, q)
    assert (pp.roots32.astype(np.uint64) == pp.roots).all()
    assert pp.n_inv * n % q == 1


def test_config_validation():
    q = P.find_primes(1024, 1)[0]
    NTTConfig(n=1024, q=q)
    with pytest.raises(ValueError):
        NTTConfig(n=1000, q=q)  # not power of two
    with pytest.raises(ValueError):
        NTTConfig(n=1024, q=q + 2)  # not ≡ 1 mod 2n
    with pytest.raises(ValueError):
        NTTConfig(n=1024, q=(1 << 30) + (1 << 30) % (2 * 1024) + 1)  # too wide
