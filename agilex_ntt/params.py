"""Prime / root-of-unity / twiddle-table generation (host side, pure Python).

Replaces the host-side role implied by the reference's twiddle-table streaming
(component C5 in SURVEY.md): the reference consumes two N-entry u64 tables —
``local_roots`` and Shoup precomputations ``local_precons`` — already stored in
HEXL bit-reversed order so the kernel indexes them as ``local_roots[m + i]``
(``/root/reference/src/kernel/ntt.cpp:100-101, 122-141, 298-300``).  The
reference itself never *generates* real tables (its driver feeds dummy data,
``src/main.cpp:49-55``); this module supplies the real thing: SEAL-Embedded
style NTT-friendly primes, primitive 2n-th roots of unity, and the twiddle +
Shoup-precomputation tables in the exact order the kernels consume.

Two precomputation families are produced:
  * 64-bit Shoup precons ``floor(W * 2**64 / q)`` — consumed by the uint64
    golden model, mirroring the reference butterfly (ntt.cpp:346-363).
  * 32-bit Shoup precons ``floor(W * 2**32 / q)`` — consumed by the
    transforms, which keep all values in uint32 words (q < 2**30 so the lazy
    range [0, 4q) fits in 32 bits).

All arithmetic here is arbitrary-precision Python int; nothing touches JAX.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional, Tuple

import numpy as np

from .config import NTTConfig, log2_exact

# ---------------------------------------------------------------------------
# Primality / roots (pure Python, exact)
# ---------------------------------------------------------------------------

_MR_BASES = (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37)


def is_prime(n: int) -> bool:
    """Deterministic Miller-Rabin for n < 3.3e24 (covers all 64-bit ints)."""
    if n < 2:
        return False
    for p in (2, 3, 5, 7, 11, 13, 17, 19, 23, 29, 31, 37):
        if n % p == 0:
            return n == p
    d = n - 1
    r = 0
    while d % 2 == 0:
        d //= 2
        r += 1
    for a in _MR_BASES:
        x = pow(a, d, n)
        if x in (1, n - 1):
            continue
        for _ in range(r - 1):
            x = x * x % n
            if x == n - 1:
                break
        else:
            return False
    return True


def find_primes(n: int, count: int, bits: int = 30) -> List[int]:
    """Find `count` NTT-friendly primes q ≡ 1 (mod 2n), q < 2**bits.

    Searches downward from 2**bits (SEAL-Embedded style prime chains are
    descending).  These are the moduli the reference targets ("SEAL-Embedded
    primes are ≤ 30-bit", README.md:13 + ntt.cpp:346-363 32-bit-limb mulmod).

    bits may go up to 62 — the reference kernel's own Harvey bound at u64
    word size (4q < 2**64, ntt.cpp:32-37) — but primes above 30 bits are
    only accepted by the wide tier (WideRing / golden u64 / native core),
    not by the 32-bit-word transforms.
    """
    if bits > 62:
        raise ValueError("Harvey lazy range needs 4q < 2**64, i.e. bits <= 62")
    m = 2 * n
    q = ((1 << bits) - 1) // m * m + 1
    out: List[int] = []
    while len(out) < count and q > m:
        if is_prime(q):
            out.append(q)
        q -= m
    if len(out) < count:
        raise ValueError(f"could not find {count} primes ≡ 1 mod {m} below 2**{bits}")
    return out


def _pollard_rho(n: int) -> int:
    """A nontrivial factor of composite odd n (Brent's cycle variant).

    Needed because primitive_root factors q - 1: trial division is fine for
    30-bit primes (sqrt ~ 2**15) but prohibitive for the wide tier's 62-bit
    moduli (sqrt ~ 2**31 Python iterations).
    """
    import math

    if n % 2 == 0:
        return 2
    seed = 1
    while True:
        seed += 1
        x = y = 2
        c = seed
        d = 1
        while d == 1:
            x = (x * x + c) % n
            y = (y * y + c) % n
            y = (y * y + c) % n
            d = math.gcd(abs(x - y), n)
        if d != n:
            return d


def _factorize(n: int) -> List[int]:
    """Distinct prime factors.  Small factors by trial division; anything
    left above the trial bound splits recursively via Pollard rho."""
    fs = []
    d = 2
    while d * d <= n and d < 100_000:
        if n % d == 0:
            fs.append(d)
            while n % d == 0:
                n //= d
        d += 1
    if n == 1:
        return fs
    stack = [n]
    found = set()
    while stack:
        m = stack.pop()
        if m == 1:
            continue
        if is_prime(m):
            found.add(m)
            continue
        f = _pollard_rho(m)
        stack.append(f)
        stack.append(m // f)
    return fs + sorted(found)


def primitive_root(q: int) -> int:
    """Smallest generator of Z_q^* (q prime)."""
    phi = q - 1
    factors = _factorize(phi)
    g = 2
    while True:
        if all(pow(g, phi // f, q) != 1 for f in factors):
            return g
        g += 1


def find_psi(n: int, q: int) -> int:
    """A primitive 2n-th root of unity mod q (so psi^n ≡ -1)."""
    g = primitive_root(q)
    psi = pow(g, (q - 1) // (2 * n), q)
    assert pow(psi, n, q) == q - 1, "psi^n must be -1 (negacyclic)"
    return psi


def bit_reverse(x: int, bits: int) -> int:
    r = 0
    for _ in range(bits):
        r = (r << 1) | (x & 1)
        x >>= 1
    return r


# ---------------------------------------------------------------------------
# Twiddle tables
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash; instances
# are interned by make_params's lru_cache so identity == value identity.
class NTTParams:
    """All precomputed constants for one ring Z_q[X]/(X^n + 1).

    Table layout matches the reference kernel's consumption order
    (``local_roots[m + i]``, ntt.cpp:298-300): ``roots[i] = psi^bitrev(i, log n)``
    so that stage m, group i uses index m+i with no runtime bit-reversal —
    verified empirically: the forward transform then satisfies
    ``out[k] = A(psi^(2*bitrev(k) + 1))``.

    Inverse tables are elementwise inverses under the same indexing; the
    inverse transform runs the stages in reverse with Gentleman-Sande
    butterflies, so roundtrip identity holds by construction.
    """

    n: int
    q: int
    psi: int
    # uint64 tables (golden model; mirrors reference data layout)
    roots: np.ndarray          # uint64 [n]  W[i] = psi^br(i)
    precon64: np.ndarray       # uint64 [n]  floor(W * 2^64 / q)
    inv_roots: np.ndarray      # uint64 [n]  W[i]^-1 mod q
    inv_precon64: np.ndarray   # uint64 [n]
    n_inv: int                 # n^-1 mod q
    # uint32 tables (the 32-bit transforms)
    roots32: np.ndarray        # uint32 [n]
    precon32: np.ndarray       # uint32 [n]  floor(W * 2^32 / q)
    inv_roots32: np.ndarray    # uint32 [n]
    inv_precon32: np.ndarray   # uint32 [n]

    @property
    def log_n(self) -> int:
        return log2_exact(self.n)


def make_params(n: int, q: int, psi: Optional[int] = None) -> NTTParams:
    """Generate all tables for (n, q). Cached: table gen is host-side setup,
    the analog of the reference host filling twiddle buffers (main.cpp:42-56,
    done right: real roots instead of the reference's dummy ``i+2`` data).

    psi is resolved BEFORE the cached builder so make_params(n, q) and
    make_params(n, q, found_psi) intern the same NTTParams instead of
    building the O(n)-bignum table set twice.
    """
    if q % (2 * n) != 1:
        raise ValueError(f"q ≡ 1 (mod 2n) required: q={q} n={n}")
    if not is_prime(q):
        raise ValueError(f"q={q} is not prime")
    if psi is None:
        psi = find_psi(n, q)
    elif pow(psi, n, q) != q - 1:
        raise ValueError("provided psi is not a primitive 2n-th root")
    return _make_params_cached(n, q, psi)


@functools.lru_cache(maxsize=64)
def _make_params_cached(n: int, q: int, psi: int) -> NTTParams:
    logn = log2_exact(n)

    roots_py = [pow(psi, bit_reverse(i, logn), q) for i in range(n)]
    inv_roots_py = [pow(w, q - 2, q) for w in roots_py]
    pre64 = [(w << 64) // q for w in roots_py]
    ipre64 = [(w << 64) // q for w in inv_roots_py]
    pre32 = [(w << 32) // q for w in roots_py]
    ipre32 = [(w << 32) // q for w in inv_roots_py]
    if q >> 30:
        # wide-tier modulus: the 32-bit-word tables are meaningless (and
        # numpy rejects the >2**32 values outright) — the wide tier consumes
        # the u64 tables; mask so the dataclass shape stays uniform
        mask32 = (1 << 32) - 1
        roots32_py = [w & mask32 for w in roots_py]
        iroots32_py = [w & mask32 for w in inv_roots_py]
        pre32 = [p & mask32 for p in pre32]
        ipre32 = [p & mask32 for p in ipre32]
    else:
        roots32_py, iroots32_py = roots_py, inv_roots_py

    return NTTParams(
        n=n,
        q=q,
        psi=psi,
        roots=np.array(roots_py, dtype=np.uint64),
        precon64=np.array(pre64, dtype=np.uint64),
        inv_roots=np.array(inv_roots_py, dtype=np.uint64),
        inv_precon64=np.array(ipre64, dtype=np.uint64),
        n_inv=pow(n, q - 2, q),
        roots32=np.array(roots32_py, dtype=np.uint32),
        precon32=np.array(pre32, dtype=np.uint32),
        inv_roots32=np.array(iroots32_py, dtype=np.uint32),
        inv_precon32=np.array(ipre32, dtype=np.uint32),
    )


def default_params(n: int, num_primes: int = 1) -> List[NTTParams]:
    """SEAL-Embedded style default prime chain for size n (descending 30-bit)."""
    return [make_params(n, q) for q in find_primes(n, num_primes)]


# ---------------------------------------------------------------------------
# Cyclic (plain DFT) tables — the row pass of the four-step decomposition
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True, eq=False)  # eq=False: identity hash (interned
# via make_cyclic_params's lru_cache, same as NTTParams)
class CyclicParams:
    """Tables for a size-n *cyclic* NTT (plain DFT mod q, root omega of order n).

    Same stage structure and table layout as the negacyclic transform — the
    iterative Cooley-Tukey stage loop consumes ``roots32[m + i]`` exactly like
    the reference kernel (``/root/reference/src/kernel/ntt.cpp:298-300``) —
    but with cyclic twiddles ``W[m + i] = omega^(bitrev(i, log2 m) * n/(2m))``
    (no psi^(n/(2m)) negacyclic factor), so the same butterfly kernels compute
    ``out[bitrev(k)] = A(omega^k)``.  Used as the row pass of the four-step
    large-N transform (SURVEY.md §5: "local column NTTs -> twiddle scale ->
    all-to-all transpose -> local row NTTs").
    """

    n: int
    q: int
    omega: int
    roots32: np.ndarray        # uint32 [n]
    precon32: np.ndarray       # uint32 [n]  floor(W * 2^32 / q)
    inv_roots32: np.ndarray    # uint32 [n]
    inv_precon32: np.ndarray   # uint32 [n]
    n_inv: int                 # n^-1 mod q

    @property
    def log_n(self) -> int:
        return log2_exact(self.n)


@functools.lru_cache(maxsize=64)
def make_cyclic_params(n: int, q: int, omega: int) -> CyclicParams:
    """Tables for the cyclic size-n NTT with primitive n-th root `omega`."""
    if pow(omega, n, q) != 1:
        raise ValueError("omega^n != 1")
    if n > 1 and pow(omega, n // 2, q) == 1:
        raise ValueError("omega is not a primitive n-th root")
    logn = log2_exact(n)
    roots_py = [1] * n
    for s in range(logn):
        m = 1 << s
        stride = n // (2 * m)
        for i in range(m):
            roots_py[m + i] = pow(omega, bit_reverse(i, s) * stride, q)
    inv_roots_py = [pow(w, q - 2, q) for w in roots_py]
    pre32 = [(w << 32) // q for w in roots_py]
    ipre32 = [(w << 32) // q for w in inv_roots_py]
    return CyclicParams(
        n=n,
        q=q,
        omega=omega,
        roots32=np.array(roots_py, dtype=np.uint32),
        precon32=np.array(pre32, dtype=np.uint32),
        inv_roots32=np.array(inv_roots_py, dtype=np.uint32),
        inv_precon32=np.array(ipre32, dtype=np.uint32),
        n_inv=pow(n, q - 2, q),
    )


def fourstep_split(n: int) -> Tuple[int, int]:
    """Balanced power-of-two factorization n = n1 * n2 with n1 >= n2.

    n1 is the column-transform size (negacyclic), n2 the row size (cyclic);
    both are kept >= 128 when possible so each pass is a full kernel block.
    """
    logn = log2_exact(n)
    l1 = (logn + 1) // 2
    return 1 << l1, 1 << (logn - l1)
