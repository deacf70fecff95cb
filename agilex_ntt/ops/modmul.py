"""Vectorized modular arithmetic over uint32 words (component C2).

The reference synthesizes the high half of a 64x64 product from four 32x32
partial products because the FPGA has no wide multiplier
(``HEXL_FPGA_USE_64BIT_MULT``, ``/root/reference/src/kernel/ntt.cpp:26-35,
346-363``).  With 64-bit types off in JAX a 32x32 multiply returns only the
low word, so we apply the same decomposition one level down: 32x32 -> 64
products are synthesized from four 16x16 partials that each fit a uint32
word.  On an H100 the GPU kernel measured no faster with a ``mul.hi.u32``
instruction in their place (``ntt_kernel.py``).

All moduli are < 2**30 (SEAL-Embedded primes, reference README.md:13), so the
Harvey lazy range [0, 4q) fits in uint32.  These helpers are pure jnp and
work identically inside Pallas kernels and in plain jitted JAX.

Unsigned semantics: multiplies / adds / subtracts / logical shifts on uint32
are bit-identical to the signed int32 hardware ops; comparisons of values that
can exceed 2**31 (the lazy range reaches 4q - 1) rely on jnp.uint32 unsigned
predicates (verified by the bit-exactness tests against the uint64 golden
model).
"""

from __future__ import annotations

import jax.numpy as jnp

U32 = jnp.uint32
_MASK16 = 0xFFFF


def u32(x) -> jnp.ndarray:
    return jnp.asarray(x, dtype=U32)


def split16(x: jnp.ndarray):
    """Split uint32 into (low16, high16) halves (cf. LOW/HIGH macros,
    ntt.cpp:26-30)."""
    return x & U32(_MASK16), x >> U32(16)


def mulhi_u32(a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
    """High 32 bits of the 64-bit product a*b, from four 16x16 partials.

    Mirrors the reference's partial-product ladder (ntt.cpp:346-363) scaled
    to a 32-bit word.  All intermediates fit in uint32:
      mid1 = a1*b0 + (a0*b0 >> 16) <= (2^16-1)^2 + (2^16-1) < 2^32.
    """
    a0, a1 = split16(a)
    b0, b1 = split16(b)
    lo = a0 * b0
    mid1 = a1 * b0 + (lo >> U32(16))
    mid2 = a0 * b1 + (mid1 & U32(_MASK16))
    return a1 * b1 + (mid1 >> U32(16)) + (mid2 >> U32(16))


def cond_sub(x: jnp.ndarray, bound) -> jnp.ndarray:
    """x - bound if x >= bound else x (lazy reduction step, ntt.cpp:331-332)."""
    b = u32(bound)
    return jnp.where(x >= b, x - b, x)


def shoup_mulmod_lazy(a, w, w_precon, q) -> jnp.ndarray:
    """W * a mod q via Shoup's trick, result in [0, 2q).

    Requires w < q and precon = floor(w * 2**32 / q); `a` may be any uint32.
    32-bit analog of the reference's Q = W_op*a - mulhi(a, W_precon)*q
    (ntt.cpp:346-363), with the 2**64 scale replaced by 2**32.
    """
    hi = mulhi_u32(a, w_precon)
    return w * a - hi * u32(q)


def add_mod(a, b, q) -> jnp.ndarray:
    """(a + b) mod q for a, b in [0, q)."""
    s = a + b
    return cond_sub(s, q)


def sub_mod(a, b, q) -> jnp.ndarray:
    """(a - b) mod q for a, b in [0, q)."""
    d = a - b + u32(q)
    return cond_sub(d, q)


def neg_mod(a, q) -> jnp.ndarray:
    """(-a) mod q for a in [0, q)."""
    return jnp.where(a == U32(0), U32(0), u32(q) - a)


# ---------------------------------------------------------------------------
# Montgomery multiplication (for pointwise products of two variable operands)
# ---------------------------------------------------------------------------


def mont_qinv_neg(q: int) -> int:
    """-q^{-1} mod 2**32 (host-side precomputation for mont_mul)."""
    qinv = pow(q, -1, 1 << 32)
    return (-qinv) % (1 << 32)


def mont_mul_lazy(a, b, q, qinv_neg) -> jnp.ndarray:
    """a * b * 2**-32 mod q, result in [0, 2q), for a, b < 2**32 with a*b < 2**32 * q.

    REDC with R = 2**32: m = (a*b mod R) * (-q^-1) mod R;
    result = (a*b + m*q) / R = hi(a*b) + hi(m*q) + carry, where the low words
    cancel exactly (lo(m*q) = -lo(a*b) mod R) so carry = (lo(a*b) != 0).

    The NTT pointwise path uses this for c̃ = ã * b̃ * R^{-1}; the stray R^{-1}
    is folded into the inverse transform's n^{-1} scaling (see api.polymul).
    """
    lo = a * b
    hi = mulhi_u32(a, b)
    m = lo * u32(qinv_neg)
    mq_hi = mulhi_u32(m, u32(q))
    carry = (lo != U32(0)).astype(U32)
    return hi + mq_hi + carry


def mont_mul(a, b, q, qinv_neg) -> jnp.ndarray:
    """a * b * 2**-32 mod q, fully reduced to [0, q)."""
    return cond_sub(mont_mul_lazy(a, b, q, qinv_neg), q)


def pointwise_mulmod(a, b, q, qinv_neg, to_mont_sq) -> jnp.ndarray:
    """Exact a * b mod q for a, b in [0, q), via two Montgomery multiplies.

    to_mont_sq = 2**64 mod q (host-precomputed): mont(mont(a,b), R^2) = a*b mod q.
    Used where a plain (non-NTT-fused) pointwise product is needed.
    """
    t = mont_mul_lazy(a, b, q, qinv_neg)
    return cond_sub(mont_mul_lazy(t, u32(to_mont_sq), q, qinv_neg), q)
