"""Gadget decomposition — the noise-control half of key-switching.

Key-switching multiplies by key material whose coefficients are as large as
the modulus; applied directly, the noise would scale by ~q.  Gadget
decomposition splits the operand into small "digits" first so each digit
contributes noise proportional to the digit bound, not q.  The reference
framework stops at the single-modulus transform
(``/root/reference/src/kernel/ntt.cpp:64, 143-144``); this module supplies
both standard decompositions on top of it:

RNS (hybrid) decomposition — ``gadget_decompose``:
    partition the L source primes into ``dnum`` contiguous groups
    ("digits"); digit d is the fast base conversion of the group-d residues
    into the full destination basis (typically Q u P, the extended
    key-switch basis).  With exact conversion the digit lifts to
    t_d = [x]_{Q_d} (the unique integer < Q_d = prod of group-d primes
    matching those residues), and the gadget identity

        x  =  sum_d t_d * (Q/Q_d) * [(Q/Q_d)^-1]_{Q_d}   (mod Q)

    holds — the (Q/Q_d)-factors are absorbed into the evaluation key, so
    the runtime primitive is exactly slice + base_convert.  dnum=L is the
    classical per-prime GHS decomposition; dnum=1 is no decomposition.

Base-2^w decomposition — ``digit_decompose``:
    per-channel positional split x = sum_j d_j * 2^(w*j) with unsigned
    digits d_j in [0, 2^w) or balanced digits in [-2^(w-1)+1, 2^(w-1)]
    (represented mod q; the top digit stays unsigned and absorbs the final
    carry rather than extending into an extra digit).
    The external-product primitive for BFV/TFHE-style gadgets; purely
    elementwise arithmetic — shifts, masks, and adds.

Both return a NEW leading digit axis; device code is uint32 math
throughout (no big-int on device).
"""

from __future__ import annotations

from typing import List, Sequence, Tuple

import jax.numpy as jnp

from .basechange import base_convert


def gadget_groups(L: int, dnum: int) -> List[Tuple[int, int]]:
    """Contiguous [start, stop) prime-index ranges for the dnum digits.

    Groups have size alpha = ceil(L / dnum) (the last may be smaller) —
    the standard hybrid-key-switching partition.  Requires 1 <= dnum <= L.
    """
    if not 1 <= dnum <= L:
        raise ValueError(f"dnum must be in [1, L={L}], got {dnum}")
    alpha = -(-L // dnum)
    groups = []
    for d in range(dnum):
        lo = d * alpha
        hi = min(lo + alpha, L)
        if lo >= hi:
            raise ValueError(
                f"dnum={dnum} leaves digit {d} empty for L={L}; "
                f"use dnum <= ceil(L/alpha) groups that all receive primes"
            )
        groups.append((lo, hi))
    return groups


def gadget_decompose(
    x: jnp.ndarray,
    qs_src: Sequence[int],
    qs_dst: Sequence[int],
    dnum: int,
    *,
    correction: str = "float",
) -> jnp.ndarray:
    """Residues (L, ..., n) -> digits (dnum, K, ..., n) in basis qs_dst.

    Digit d = base_convert of the group-d residue slice into qs_dst (which
    may overlap qs_src — destination channels equal to a source prime of
    the group pass the residue through exactly).  correction="float" makes
    each digit the exact residues of t_d = [x]_{Q_d}; "none" allows the
    BEHZ offset t_d + e*Q_d (e < group size) per digit.  Inputs [0, q_l);
    outputs [0, p_j).
    """
    qs_src = tuple(int(q) for q in qs_src)
    qs_dst = tuple(int(q) for q in qs_dst)
    groups = gadget_groups(len(qs_src), dnum)
    digits = [
        base_convert(x[lo:hi], qs_src[lo:hi], qs_dst, correction=correction)
        for lo, hi in groups
    ]
    return jnp.stack(digits, axis=0)


def digit_count(q: int, base_bits: int) -> int:
    """Digits needed to cover [0, q) in base 2^base_bits."""
    if not 1 <= base_bits <= 30:
        raise ValueError(f"base_bits must be in [1, 30], got {base_bits}")
    return -(-int(q).bit_length() // base_bits)


def digit_decompose(
    x: jnp.ndarray,
    q: int,
    base_bits: int,
    *,
    balanced: bool = False,
) -> jnp.ndarray:
    """Positional split (..., n) in [0, q) -> (ndig, ..., n) digits mod q.

    Unsigned (default): d_j = (x >> w*j) & (2^w - 1), so
    sum_j d_j 2^(w*j) == x exactly.  Balanced: digits are centered into
    [-2^(w-1)+1, 2^(w-1)] with ripple carries (represented mod q, i.e.
    negative digits come back as q - |d|); the TOP digit stays unsigned in
    [0, 2^w] — it absorbs the final carry so the identity
    sum_j centered(d_j) 2^(w*j) == x stays exact with the same digit
    count.  Requires q >= 2^w when ndig > 1 (always true: ndig > 1 means
    bitlen(q) > w).
    """
    q = int(q)
    w = int(base_bits)
    ndig = digit_count(q, w)
    x = jnp.asarray(x, dtype=jnp.uint32)
    mask = jnp.uint32((1 << w) - 1)
    if not balanced:
        return jnp.stack(
            [(x >> jnp.uint32(w * j)) & mask for j in range(ndig)], axis=0
        )
    half = jnp.uint32(1 << (w - 1))
    qq = jnp.uint32(q)
    digits = []
    carry = jnp.zeros_like(x)
    for j in range(ndig):
        d = ((x >> jnp.uint32(w * j)) & mask) + carry  # <= 2^w
        if j == ndig - 1:
            up = jnp.zeros_like(d)  # top digit keeps the carry
        else:
            up = (d > half).astype(jnp.uint32)
        # centered digit mod q: d - 2^w when carrying, wrapped via + q
        digits.append(jnp.where(up == 1, d + (qq - (mask + jnp.uint32(1))), d))
        carry = up
    return jnp.stack(digits, axis=0)
