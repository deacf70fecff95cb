"""Shared butterfly stage math on compact twiddle tables.

Used by every executor so their arithmetic cannot drift:
  * the GPU kernel (``ntt_kernel.py``) — one Pallas program holds whole
    polynomials and runs every stage on chip;
  * the plain XLA path (``xla_ntt.py``) — the same chains as jitted jnp ops,
    the reference the kernel is checked against;
  * the stage-sharded multi-device path (``parallel/stage_shard.py``) —
    local stages through the chains, cross-device stages through the
    single-stage steps below with the partner shard from ``lax.ppermute``.

Algorithm: Harvey lazy butterflies in HEXL stage order (``for m = 1; m < n;
m <<= 1`` with t = n/2m, mirroring ``/root/reference/src/kernel/ntt.cpp:
146-501`` and ``golden.fwd_ntt_u32``), in the split form: stage m views the
row as m groups of (u half, v half) and computes every butterfly once with
the group's twiddle roots[m + g].  Tables are the n-entry bit-reversed
roots and their Shoup precons floor(w * 2^32 / q) from ``params``.
"""

from __future__ import annotations

import jax.numpy as jnp

from .modmul import U32, cond_sub, mulhi_u32, u32


def _q2(q):
    """(q, 2q) as uint32 values.  q may be a Python int (a compile-time
    constant) or a traced uint32 array (per-channel moduli of an RNS
    basis, broadcast against the stage arrays)."""
    qv = u32(q)
    return qv, qv + qv


def _halves(x, lead, m: int, t: int):
    """lead + (n,) -> the u and v halves of every butterfly group, each
    lead + (m, 1, t)."""
    x4 = x.reshape(lead + (m, 2, t))
    return jnp.split(x4, 2, axis=-2)


def _interleave(u, v, lead, m: int, t: int):
    """Inverse of ``_halves``: lead + (m, 1, t) pair -> lead + (n,).

    Written as a last-axis join plus a transpose, the only interleave the
    Pallas Triton lowering accepts."""
    u = u.reshape(lead + (m, t))
    v = v.reshape(lead + (m, t))
    uv = jnp.swapaxes(jnp.stack([u, v], axis=-1), -1, -2)
    return uv.reshape(lead + (2 * m * t,))


def fwd_chain(x, q, tw):
    """Forward negacyclic (or cyclic) NTT stages in the split form.

    x: lead + (n,) uint32 in [0, 4q).  q broadcasts against lead + (m, 1, t)
    (a Python int, or a traced per-channel value shaped lead + (1, 1, 1)).
    tw(lo, k) -> (w, wp): entries lo..lo+k-1 of the compact twiddle table
    and of its Shoup precons, shaped to broadcast against lead + (k, 1, 1);
    stage m reads tw(m, m).  A row of width n that is one shard of a larger
    transform runs that transform's later stages when ``tw`` maps its local
    groups onto the global table (``parallel/stage_shard.py``).
    Output in [0, q).
    """
    lead, n = x.shape[:-1], x.shape[-1]
    qv, two_q = _q2(q)
    m = 1
    while m < n:
        t = n // (2 * m)
        u, v = _halves(x, lead, m, t)
        w, wp = tw(m, m)
        tx = cond_sub(u, two_q)
        Q = w * v - mulhi_u32(v, wp) * qv
        un = tx + Q
        vn = tx + two_q - Q
        if m == n // 2:  # final correction to [0, q) (ntt.cpp:377-394)
            un = cond_sub(cond_sub(un, two_q), qv)
            vn = cond_sub(cond_sub(vn, two_q), qv)
        x = _interleave(un, vn, lead, m, t)
        m *= 2
    return x


def inv_chain(x, q, tw):
    """Inverse (Gentleman-Sande) stages in the split form.

    x: lead + (n,) uint32 in [0, 2q); ``tw`` as in ``fwd_chain`` but over
    inverse tables (``xla_ntt.inv_tables``).  The m = 1 stage folds the
    final scaling in: table entries 0 and 1 hold (scale, scale * w1), the
    sum is multiplied by the first and the difference by the second, and
    the output is reduced to [0, q).
    """
    lead, n = x.shape[:-1], x.shape[-1]
    qv, two_q = _q2(q)
    m = n // 2
    while m >= 1:
        t = n // (2 * m)
        u, v = _halves(x, lead, m, t)
        d = u + two_q - v
        if m == 1:
            # Shoup's bound holds for any uint32 operand, so the unreduced
            # sum (< 4q) is multiplied as it is
            w, wp = tw(0, 2)
            su, sv = jnp.split(w, 2, axis=-3)
            pu, pv = jnp.split(wp, 2, axis=-3)
            s = u + v
            un = cond_sub(su * s - mulhi_u32(s, pu) * qv, qv)
            vn = cond_sub(sv * d - mulhi_u32(d, pv) * qv, qv)
        else:
            w, wp = tw(m, m)
            un = cond_sub(u + v, two_q)
            vn = w * d - mulhi_u32(d, wp) * qv
        x = _interleave(un, vn, lead, m, t)
        m //= 2
    return x


# ---------------------------------------------------------------------------
# Single stages with the partner from elsewhere (cross-device stages)
# ---------------------------------------------------------------------------


def fwd_stage_step(x, partner, is_u, w, wp, *, q):
    """One forward stage for a whole shard whose butterfly partners arrived
    as ``partner``; ``is_u`` says whether this shard holds the u halves.
    w, wp: the shard's twiddle and precon.  In/out [0, 4q)."""
    qv, two_q = _q2(q)
    tx = cond_sub(jnp.where(is_u, x, partner), two_q)
    v = jnp.where(is_u, partner, x)
    Q = w * v - mulhi_u32(v, wp) * qv
    return jnp.where(is_u, tx + Q, tx + two_q - Q)


def inv_stage_step(x, partner, is_u, w, wp, *, q):
    """One inverse (GS) stage across shards.  In/out [0, 2q)."""
    qv, two_q = _q2(q)
    ssum = cond_sub(x + partner, two_q)
    d = partner - x + two_q  # only read at v shards: u-value minus v-value
    Q = w * d - mulhi_u32(d, wp) * qv
    return jnp.where(is_u, ssum, Q)


def apply_scale(x, *, q: int, scale: int):
    """x * scale mod q for x < 2^32, fully reduced to [0, q)."""
    hi = mulhi_u32(x, U32((scale << 32) // q))
    return cond_sub(U32(scale) * x - hi * U32(q), U32(q))
