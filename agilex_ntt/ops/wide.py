"""64-bit-word modular arithmetic and NTT stages from uint32 words.

The reference's word size is u64: its Shoup mulmod synthesizes the high 64
bits of a 64x64 product from 32x32 partial products because the FPGA has no
wide multiplier (``HEXL_FPGA_USE_64BIT_MULT``,
``/root/reference/src/kernel/ntt.cpp:26-37, 346-363``), so its kernel
handles any prime up to the Harvey bound 4q < 2**64, i.e. q < 2**62.  The
main transforms in this repo run a 32-bit word scheme (q < 2**30 SEAL-Embedded
primes, the reference's actual deployment target per its README:13) — this
module restores the reference's full word width as an XLA correctness /
compatibility tier:

  * a 64-bit value is a ``(lo, hi)`` pair of uint32 arrays (limb pairs);
  * every 64-bit op is synthesized from 16x16 partial products that fit a
    uint32 word — the same decomposition ``ops/modmul.py`` applies one level
    down, taken one level up;
  * the stage loops mirror ``golden.fwd_ntt_u64`` / ``inv_ntt_u64`` (which
    themselves mirror the reference kernel): Harvey lazy [0, 4q) forward /
    [0, 2q) inverse, conditional -2q reduction, final-stage correction.

Everything here is pure jnp (no Pallas): the wide tier trades speed for the
reference's full modulus generality; production throughput stays with the
32-bit kernels and the RNS decomposition (see PARITY.md "wide moduli").
"""

from __future__ import annotations

from typing import Tuple

import jax.numpy as jnp
import numpy as np

U32 = jnp.uint32
_M16 = 0xFFFF

# A 64-bit value: (low 32 bits, high 32 bits), both uint32 arrays.
Limbs = Tuple[jnp.ndarray, jnp.ndarray]


def u64c(v: int) -> Limbs:
    """A (broadcastable) constant limb pair from a Python int < 2**64."""
    return (U32(v & 0xFFFFFFFF), U32((v >> 32) & 0xFFFFFFFF))


def split_u64_np(x: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """Host-side numpy uint64 -> (lo32, hi32) uint32 arrays."""
    x = np.asarray(x, dtype=np.uint64)
    return (
        (x & np.uint64(0xFFFFFFFF)).astype(np.uint32),
        (x >> np.uint64(32)).astype(np.uint32),
    )


def join_u64_np(lo: np.ndarray, hi: np.ndarray) -> np.ndarray:
    """Host-side (lo32, hi32) -> numpy uint64."""
    return (
        np.asarray(lo, dtype=np.uint64)
        | (np.asarray(hi, dtype=np.uint64) << np.uint64(32))
    )


# ---------------------------------------------------------------------------
# add / sub / compare (mod 2**64 semantics, like the reference's u64 words)
# ---------------------------------------------------------------------------


def add64(a: Limbs, b: Limbs) -> Limbs:
    lo = a[0] + b[0]
    carry = (lo < a[0]).astype(U32)  # unsigned wrap detect
    return lo, a[1] + b[1] + carry


def sub64(a: Limbs, b: Limbs) -> Limbs:
    lo = a[0] - b[0]
    borrow = (a[0] < b[0]).astype(U32)
    return lo, a[1] - b[1] - borrow


def ge64(a: Limbs, b: Limbs) -> jnp.ndarray:
    return (a[1] > b[1]) | ((a[1] == b[1]) & (a[0] >= b[0]))


def select64(cond: jnp.ndarray, a: Limbs, b: Limbs) -> Limbs:
    return jnp.where(cond, a[0], b[0]), jnp.where(cond, a[1], b[1])


def cond_sub64(x: Limbs, bound: Limbs) -> Limbs:
    """x - bound if x >= bound else x (the reference's lazy reduction,
    ntt.cpp:331-332, at full width)."""
    return select64(ge64(x, bound), sub64(x, bound), x)


def eq0_64(a: Limbs) -> jnp.ndarray:
    return (a[0] | a[1]) == U32(0)


# ---------------------------------------------------------------------------
# multiplication (16-bit-limb schoolbook; every partial fits uint32)
# ---------------------------------------------------------------------------


def _limbs4(a: Limbs):
    """Four 16-bit limbs of a 64-bit value, little-endian."""
    lo, hi = a
    m = U32(_M16)
    return lo & m, lo >> U32(16), hi & m, hi >> U32(16)


def mullo64(a: Limbs, b: Limbs) -> Limbs:
    """Low 64 bits of a*b (the reference's wrapping u64 multiply).

    Decomposed at 32-bit granularity: lo32 = a0*b0 (native wrap already
    exact), hi32 = mulhi32(a0, b0) + a0*b1 + a1*b0 (all mod 2**32).
    """
    from .modmul import mulhi_u32

    lo = a[0] * b[0]
    hi = mulhi_u32(a[0], b[0]) + a[0] * b[1] + a[1] * b[0]
    return lo, hi


def mul128(a: Limbs, b: Limbs) -> Tuple[Limbs, Limbs]:
    """Full 128-bit product as (lo64, hi64) limb pairs.

    16 16x16 partials accumulated in 16-bit columns — column sums stay
    below 2**20, far inside uint32, before one carry-propagation sweep.
    This is the reference's partial-product ladder (ntt.cpp:346-363) taken
    down one more level for 32-bit words.
    """
    al = _limbs4(a)
    bl = _limbs4(b)
    m = U32(_M16)
    zero = jnp.zeros(jnp.broadcast_shapes(a[0].shape, b[0].shape), U32)
    cols = [zero] * 8
    for i in range(4):
        for j in range(4):
            p = al[i] * bl[j]
            k = i + j
            cols[k] = cols[k] + (p & m)
            cols[k + 1] = cols[k + 1] + (p >> U32(16))
    r = []
    carry = zero
    for k in range(8):
        s = cols[k] + carry
        r.append(s & m)
        carry = s >> U32(16)
    lo = (r[0] | (r[1] << U32(16)), r[2] | (r[3] << U32(16)))
    hi = (r[4] | (r[5] << U32(16)), r[6] | (r[7] << U32(16)))
    return lo, hi


def mulhi64(a: Limbs, b: Limbs) -> Limbs:
    """High 64 bits of a*b (the reference's mulhi, ntt.cpp:43-45 analog)."""
    return mul128(a, b)[1]


# ---------------------------------------------------------------------------
# Shoup / Montgomery modular multiplication at full width
# ---------------------------------------------------------------------------


def shoup_mulmod_lazy64(a: Limbs, w: Limbs, wp: Limbs, q: Limbs) -> Limbs:
    """W * a mod q via Shoup's trick, result in [0, 2q).

    Exactly the reference butterfly core Q = W*a - mulhi(a, W')*q
    (ntt.cpp:346-363) with W' = floor(W * 2**64 / q); requires w < q and
    a < 4q, q < 2**62.
    """
    hi = mulhi64(a, wp)
    return sub64(mullo64(w, a), mullo64(hi, q))


def mont_qinv_neg64(q: int) -> int:
    """-q^{-1} mod 2**64 (host precomputation for mont_mul_lazy64)."""
    return (-pow(q, -1, 1 << 64)) % (1 << 64)


def mont_mul_lazy64(a: Limbs, b: Limbs, q: Limbs, qinv_neg: Limbs) -> Limbs:
    """a * b * 2**-64 mod q in [0, 2q), for a*b < 2**64 * q.

    REDC with R = 2**64, the widened twin of modmul.mont_mul_lazy: the low
    words of a*b and m*q cancel exactly, so the quotient is
    hi(a*b) + hi(m*q) + (lo(a*b) != 0).
    """
    lo, hi = mul128(a, b)
    m = mullo64(lo, qinv_neg)
    mq_hi = mulhi64(m, q)
    carry = ((lo[0] | lo[1]) != U32(0)).astype(U32)
    return add64(add64(hi, mq_hi), (carry, jnp.zeros_like(carry)))


# ---------------------------------------------------------------------------
# NTT stage chains (mirrors golden.fwd_ntt_u64 / inv_ntt_u64 on limb pairs)
# ---------------------------------------------------------------------------


def _stage_tables(w_lo, w_hi, p_lo, p_hi, m: int):
    """Stage-m twiddle rows [(m, 1) broadcast over t] as limb pairs."""
    sl = lambda t: jnp.asarray(t[m : 2 * m]).reshape(m, 1)
    return (sl(w_lo), sl(w_hi)), (sl(p_lo), sl(p_hi))


def fwd_stages64(x: Limbs, tables, n: int, q: int) -> Limbs:
    """Forward negacyclic Harvey stages on (batch, n) limb pairs.

    tables = (w_lo, w_hi, p_lo, p_hi) numpy uint32 [n] arrays in the
    reference consumption order (roots[m + i], ntt.cpp:298-300).  Values
    stay in [0, 4q); output fully reduced to [0, q) (final-stage
    correction, ntt.cpp:377-394).
    """
    w_lo, w_hi, p_lo, p_hi = tables
    qq = u64c(q)
    two_q = u64c(2 * q)
    lo, hi = x
    lead = lo.shape[:-1]
    t = n // 2
    m = 1
    while m < n:
        last = m == n // 2
        shape = lead + (m, 2, t)
        vlo = lo.reshape(shape)
        vhi = hi.reshape(shape)
        tx = (vlo[..., 0, :], vhi[..., 0, :])
        ay = (vlo[..., 1, :], vhi[..., 1, :])
        W, Wp = _stage_tables(w_lo, w_hi, p_lo, p_hi, m)
        tx = cond_sub64(tx, two_q)
        Q = shoup_mulmod_lazy64(ay, W, Wp, qq)
        u = add64(tx, Q)
        w = add64(sub64(tx, Q), two_q)
        if last:
            u = cond_sub64(cond_sub64(u, two_q), qq)
            w = cond_sub64(cond_sub64(w, two_q), qq)
        lo = jnp.stack([u[0], w[0]], axis=-2).reshape(lead + (n,))
        hi = jnp.stack([u[1], w[1]], axis=-2).reshape(lead + (n,))
        t //= 2
        m *= 2
    return lo, hi


def inv_stages64(x: Limbs, tables, n: int, q: int, scale: int) -> Limbs:
    """Inverse (Gentleman-Sande) stages + Shoup scaling, output [0, q).

    Input may be lazy in [0, 2q); the [0, 2q) invariant holds throughout
    (4q < 2**64).  `scale` is usually n^-1 mod q; polymul folds the
    Montgomery R^-1 in (see WideRing.polymul).
    """
    w_lo, w_hi, p_lo, p_hi = tables
    qq = u64c(q)
    two_q = u64c(2 * q)
    lo, hi = x
    lead = lo.shape[:-1]
    m = n // 2
    t = 1
    while m >= 1:
        shape = lead + (m, 2, t)
        vlo = lo.reshape(shape)
        vhi = hi.reshape(shape)
        xx = (vlo[..., 0, :], vhi[..., 0, :])
        yy = (vlo[..., 1, :], vhi[..., 1, :])
        W, Wp = _stage_tables(w_lo, w_hi, p_lo, p_hi, m)
        s = cond_sub64(add64(xx, yy), two_q)
        d = add64(sub64(xx, yy), two_q)
        Q = shoup_mulmod_lazy64(d, W, Wp, qq)
        lo = jnp.stack([s[0], Q[0]], axis=-2).reshape(lead + (n,))
        hi = jnp.stack([s[1], Q[1]], axis=-2).reshape(lead + (n,))
        m //= 2
        t *= 2
    sc = u64c(scale)
    scp = u64c((scale << 64) // q)
    out = shoup_mulmod_lazy64((lo, hi), sc, scp, qq)
    return cond_sub64(out, qq)
