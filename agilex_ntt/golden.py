"""Golden reference models for the negacyclic NTT (host-side, numpy / Python int).

This is the test oracle the reference *claims* but never ships: its README
declares NTL-backed "NTT Tests taken from SEAL Embedded"
(``/root/reference/README.md:10-13``) yet ``include/test.h`` is empty and the
driver feeds dummy data (``src/main.cpp:49-55``).  Here we implement three
independent models:

  1. ``fwd_ntt_u64`` / ``inv_ntt_u64`` — mirrors the reference compute kernel's
     exact arithmetic: Harvey lazy butterflies with values in [0, 4q), 64-bit
     Shoup multiplication synthesized from 32x32 partial products exactly as
     ``HEXL_FPGA_USE_64BIT_MULT`` does (``src/kernel/ntt.cpp:32, 290-395``),
     final reduction to [0, q) on the last stage (``ntt.cpp:377-394``).
  2. ``fwd_ntt_u32`` / ``inv_ntt_u32`` — the 32-bit-word scheme the transforms
     execute (q < 2**30, precon = floor(W*2**32/q)); bit-identical outputs to
     the u64 model after final reduction.
  3. ``naive_negacyclic_ntt`` — O(n^2) pure-Python big-int evaluation
     ``out[k] = A(psi^(2*bitrev(k)+1)) mod q``; fully independent of the
     butterfly data flow (the NTL-golden-model role).

The loop structure below intentionally mirrors the reference stage loop
(``for m = 1; m < N; m <<= 1`` with ``t = N/2 -> 1``, ntt.cpp:146-501) so the
per-stage state can be compared 1:1 when debugging kernels.
"""

from __future__ import annotations

from typing import Sequence

import numpy as np

from .params import NTTParams, bit_reverse

_U64 = np.uint64
_U32 = np.uint32

# numpy integer overflow is intentional (mod 2^64 / 2^32 wrap) throughout.
def _err():
    return np.errstate(over="ignore")


def _mulhi64(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """High 64 bits of a 64x64 product from four 32x32 partials.

    Same synthesis as the reference's HEXL_FPGA_USE_64BIT_MULT path
    (ntt.cpp:26-30 LOW/HIGH macros, ntt.cpp:346-363)."""
    mask = _U64(0xFFFFFFFF)
    a0 = a & mask
    a1 = a >> _U64(32)
    b0 = b & mask
    b1 = b >> _U64(32)
    with _err():
        a0b0 = a0 * b0
        a0b1 = a0 * b1
        a1b0 = a1 * b0
        a1b1 = a1 * b1
        mid = (a0b0 >> _U64(32)) + (a1b0 & mask) + (a0b1 & mask)
        hi = a1b1 + (a1b0 >> _U64(32)) + (a0b1 >> _U64(32)) + (mid >> _U64(32))
    return hi


def _mulhi32(a: np.ndarray, b: np.ndarray) -> np.ndarray:
    """High 32 bits of a 32x32 product (widened on host; the device code
    uses 16-bit limb synthesis instead — see ops/modmul.py)."""
    return ((a.astype(_U64) * b.astype(_U64)) >> _U64(32)).astype(_U32)


# ---------------------------------------------------------------------------
# u64 model (mirror of the reference kernel arithmetic)
# ---------------------------------------------------------------------------


def fwd_ntt_u64(x: np.ndarray, params: NTTParams) -> np.ndarray:
    """Forward negacyclic NTT, uint64 Harvey-lazy, output reduced to [0, q).

    Bit-exact mirror of the reference compute kernel data flow
    (ntt.cpp:146-501): lazy values in [0, 4q); conditional -2q reduction on
    the first operand (ntt.cpp:331-332); Shoup mulmod Q = W*a - mulhi(a, W')*q
    (ntt.cpp:346-363); outputs X'=tx+Q, Xt'=tx+2q-Q (ntt.cpp:368-369); final
    stage corrects to [0, q) (ntt.cpp:377-394).
    """
    a = np.asarray(x, dtype=_U64).copy()
    n = params.n
    assert a.shape[-1] == n
    q = _U64(params.q)
    two_q = _U64(2 * params.q)
    roots = params.roots
    precon = params.precon64

    t = n // 2
    m = 1
    while m < n:
        last = m == n // 2
        # group view: [..., m groups, 2 halves, t elements]
        v = a.reshape(a.shape[:-1] + (m, 2, t))
        tx = v[..., 0, :]
        ay = v[..., 1, :]
        W = roots[m : 2 * m].reshape((m, 1))
        Wp = precon[m : 2 * m].reshape((m, 1))
        tx = np.where(tx >= two_q, tx - two_q, tx)
        hi = _mulhi64(ay, Wp)
        with _err():
            Q = W * ay - hi * q
            u = tx + Q
            w = tx + two_q - Q
        if last:
            for z in (u, w):
                np.subtract(z, two_q, out=z, where=z >= two_q)
                np.subtract(z, q, out=z, where=z >= q)
        v[..., 0, :] = u
        v[..., 1, :] = w
        t //= 2
        m *= 2
    return a


def inv_ntt_u64(x: np.ndarray, params: NTTParams) -> np.ndarray:
    """Inverse negacyclic NTT (Gentleman-Sande, stages reversed), output [0, q).

    Runs the forward stages of fwd_ntt_u64 in reverse with inverse twiddles —
    each stage exactly inverts its forward counterpart, then scales by n^-1.
    Lazy invariant: state stays in [0, 2q) throughout.
    """
    a = np.asarray(x, dtype=_U64).copy()
    n = params.n
    q = _U64(params.q)
    two_q = _U64(2 * params.q)
    iroots = params.inv_roots
    iprecon = params.inv_precon64

    m = n // 2
    t = 1
    while m >= 1:
        v = a.reshape(a.shape[:-1] + (m, 2, t))
        xx = v[..., 0, :].copy()
        yy = v[..., 1, :].copy()
        W = iroots[m : 2 * m].reshape((m, 1))
        Wp = iprecon[m : 2 * m].reshape((m, 1))
        with _err():
            s = xx + yy
        s = np.where(s >= two_q, s - two_q, s)
        with _err():
            d = xx + two_q - yy
            hi = _mulhi64(d, Wp)
            Q = W * d - hi * q
        v[..., 0, :] = s
        v[..., 1, :] = Q
        m //= 2
        t *= 2
    # scale by n^-1 (Shoup), final reduce to [0, q)
    n_inv = _U64(params.n_inv)
    n_inv_precon = _U64((params.n_inv << 64) // params.q)
    hi = _mulhi64(a, np.broadcast_to(n_inv_precon, a.shape))
    with _err():
        a = n_inv * a - hi * q
    a = np.where(a >= q, a - q, a)
    return a


# ---------------------------------------------------------------------------
# u32 model (what the device transforms compute)
# ---------------------------------------------------------------------------


def fwd_ntt_u32(x: np.ndarray, params: NTTParams) -> np.ndarray:
    """Forward NTT in the 32-bit word scheme (q < 2**30, lazy [0, 4q))."""
    a = np.asarray(x, dtype=_U32).copy()
    n = params.n
    q = _U32(params.q)
    two_q = _U32(2 * params.q)
    roots = params.roots32
    precon = params.precon32

    t = n // 2
    m = 1
    while m < n:
        last = m == n // 2
        v = a.reshape(a.shape[:-1] + (m, 2, t))
        tx = v[..., 0, :]
        ay = v[..., 1, :]
        W = roots[m : 2 * m].reshape((m, 1))
        Wp = precon[m : 2 * m].reshape((m, 1))
        tx = np.where(tx >= two_q, tx - two_q, tx)
        hi = _mulhi32(ay, Wp)
        with _err():
            Q = W * ay - hi * q
            u = tx + Q
            w = tx + two_q - Q
        if last:
            for z in (u, w):
                np.subtract(z, two_q, out=z, where=z >= two_q)
                np.subtract(z, q, out=z, where=z >= q)
        v[..., 0, :] = u
        v[..., 1, :] = w
        t //= 2
        m *= 2
    return a


def inv_ntt_u32(x: np.ndarray, params: NTTParams) -> np.ndarray:
    """Inverse NTT in the 32-bit word scheme, output reduced to [0, q)."""
    a = np.asarray(x, dtype=_U32).copy()
    n = params.n
    q = _U32(params.q)
    two_q = _U32(2 * params.q)
    iroots = params.inv_roots32
    iprecon = params.inv_precon32

    m = n // 2
    t = 1
    while m >= 1:
        v = a.reshape(a.shape[:-1] + (m, 2, t))
        xx = v[..., 0, :].copy()
        yy = v[..., 1, :].copy()
        W = iroots[m : 2 * m].reshape((m, 1))
        Wp = iprecon[m : 2 * m].reshape((m, 1))
        with _err():
            s = xx + yy
        s = np.where(s >= two_q, s - two_q, s)
        with _err():
            d = xx + two_q - yy
            hi = _mulhi32(d, Wp)
            Q = W * d - hi * q
        v[..., 0, :] = s
        v[..., 1, :] = Q
        m //= 2
        t *= 2
    n_inv = _U32(params.n_inv)
    n_inv_precon = _U32((params.n_inv << 32) // params.q)
    hi = _mulhi32(a, np.broadcast_to(n_inv_precon, a.shape))
    with _err():
        a = n_inv * a - hi * q
    a = np.where(a >= q, a - q, a)
    return a


# ---------------------------------------------------------------------------
# Fully independent big-int oracle (the NTL role)
# ---------------------------------------------------------------------------


def naive_negacyclic_ntt(coeffs: Sequence[int], params: NTTParams) -> list:
    """O(n^2) evaluation: out[k] = sum_j a_j * psi^((2*bitrev(k)+1) * j) mod q.

    Pure Python big-int; shares no code with the butterfly models.
    """
    n, q, psi = params.n, params.q, params.psi
    logn = params.log_n
    out = []
    for k in range(n):
        e = 2 * bit_reverse(k, logn) + 1
        root = pow(psi, e, q)
        acc = 0
        x = 1
        for c in coeffs:
            acc = (acc + int(c) * x) % q
            x = x * root % q
        out.append(acc)
    return out


def negacyclic_convolution(a: Sequence[int], b: Sequence[int], q: int) -> list:
    """Schoolbook product in Z_q[X]/(X^n + 1) (independent polymul oracle)."""
    n = len(a)
    out = [0] * n
    for i, ai in enumerate(a):
        for j, bj in enumerate(b):
            k = i + j
            if k < n:
                out[k] = (out[k] + int(ai) * int(bj)) % q
            else:
                out[k - n] = (out[k - n] - int(ai) * int(bj)) % q
    return [v % q for v in out]
