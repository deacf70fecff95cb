"""RNS base conversion and rescaling — the between-NTT production primitives.

An RNS FHE pipeline is not just transforms: between polymuls it must move
residues across prime bases (key-switching / modulus-raising) and divide by
a prime (CKKS rescaling / BGV modulus switching).  The reference framework
stops at the single-modulus transform (one q through modulusPipe,
``/root/reference/src/kernel/ntt.cpp:64, 143-144``); this module supplies
the standard RNS tooling on top of the multi-channel rings, all as
elementwise/channel-mixing vector ops (no big-int anywhere on device).

Fast base conversion (HPS/BEHZ): for x given by residues x_l mod q_l,

    y_l   = [x_l * (Q/q_l)^-1]_{q_l}                (one Shoup mulmod)
    S     = sum_l y_l * (Q/q_l)  =  x + e*Q,  e = floor(sum_l y_l / q_l) < L
    out_j = [S]_{p_j} = sum_l y_l * [(Q/q_l)]_{p_j}  - e * [Q]_{p_j}

``correction="float"`` (HPS) estimates e with a float32 sum of y_l / q_l —
exact unless the fractional part lands within ~L * 2^-23 of an integer
(SEAL uses float64 here; JAX x64 is off, so the boundary band is wider —
documented, and the approximate variant is the default for pipelines that
absorb e*Q downstream).  ``correction="none"`` (BEHZ) returns x + e*Q
mod p_j, the classical approximate conversion.

Rescaling (drop the last prime, divide-and-round):

    t_l   = centered [x_L]_{q_L} reduced mod q_l
    out_l = [(x_l - t_l) * q_L^-1]_{q_l}            l < L-1

which equals round(x / q_L) mapped into the smaller basis (centering the
subtracted residue gives round-to-nearest instead of floor).

All tables are built host-side in numpy and cached by prime tuples; device
code is pure uint32 arithmetic (Shoup lazy mulmods + Barrett
reductions), jit-safe (tables convert to jnp inside the traced call).
"""

from __future__ import annotations

import functools
from typing import Sequence, Tuple

import jax.numpy as jnp
import numpy as np

from .modmul import U32, cond_sub, mulhi_u32, shoup_mulmod_lazy, sub_mod


def _shoup_pair(w: int, q: int) -> Tuple[np.uint32, np.uint32]:
    return np.uint32(w), np.uint32((w << 32) // q)


@functools.lru_cache(maxsize=64)
def _convert_tables(qs_src: tuple, qs_dst: tuple):
    """Host tables for qs_src -> qs_dst conversion (all numpy scalars)."""
    L, K = len(qs_src), len(qs_dst)
    Q = 1
    for q in qs_src:
        Q *= q
    qtilde = np.zeros((L, 2), dtype=np.uint32)   # (Q/q_l)^-1 mod q_l + precon
    for l, q in enumerate(qs_src):
        qhat = Q // q
        qtilde[l] = _shoup_pair(pow(qhat % q, q - 2, q), q)
    mat = np.zeros((K, L, 2), dtype=np.uint32)   # [Q/q_l]_{p_j} + precon
    qmodp = np.zeros((K, 2), dtype=np.uint32)    # [Q]_{p_j} + precon
    for j, p in enumerate(qs_dst):
        for l, q in enumerate(qs_src):
            mat[j, l] = _shoup_pair((Q // q) % p, p)
        qmodp[j] = _shoup_pair(Q % p, p)
    inv_q_f32 = np.array([1.0 / q for q in qs_src], dtype=np.float32)
    return qtilde, mat, qmodp, inv_q_f32


def base_convert(
    x: jnp.ndarray,
    qs_src: Sequence[int],
    qs_dst: Sequence[int],
    *,
    correction: str = "none",
) -> jnp.ndarray:
    """Residues (L, ..., n) mod qs_src -> (K, ..., n) mod qs_dst.

    correction="none": classical BEHZ approximate conversion, returns
    x + e*Q mod p_j with 0 <= e < L.  correction="float": HPS float32
    estimate of e is subtracted (see module docstring for the precision
    band).  Inputs in [0, q_l); outputs in [0, p_j).
    """
    if correction not in ("none", "float"):
        raise ValueError(f"correction must be none|float, got {correction!r}")
    qs_src, qs_dst = tuple(int(q) for q in qs_src), tuple(int(q) for q in qs_dst)
    qtilde, mat, qmodp, inv_q = _convert_tables(qs_src, qs_dst)

    ys = []
    for l, q in enumerate(qs_src):
        y = shoup_mulmod_lazy(
            x[l], U32(int(qtilde[l, 0])), U32(int(qtilde[l, 1])), q
        )
        ys.append(cond_sub(y, q))  # [0, q_l)

    if correction == "float":
        v = ys[0].astype(jnp.float32) * inv_q[0]
        for l in range(1, len(qs_src)):
            v = v + ys[l].astype(jnp.float32) * inv_q[l]
        # e = floor(S/Q) exactly; float32 summation noise matters only in a
        # ~L*2^-23-wide band around integer values of v (see module docstring)
        e = jnp.floor(v).astype(jnp.uint32)

    outs = []
    for j, p in enumerate(qs_dst):
        acc = None
        for l in range(len(qs_src)):
            t = shoup_mulmod_lazy(
                ys[l], U32(int(mat[j, l, 0])), U32(int(mat[j, l, 1])), p
            )  # [0, 2p)
            acc = t if acc is None else cond_sub(acc + t, 2 * p)
        acc = cond_sub(cond_sub(acc, 2 * p), p)  # [0, p)
        if correction == "float":
            eq = shoup_mulmod_lazy(
                e, U32(int(qmodp[j, 0])), U32(int(qmodp[j, 1])), p
            )
            acc = sub_mod(acc, cond_sub(eq, p), p)
        outs.append(acc)
    return jnp.stack(outs, axis=0)


@functools.lru_cache(maxsize=64)
def _scale_round_tables(qs_src: tuple, qs_dst: tuple, t: int):
    """Host tables for round(t*x/Q) into qs_dst (HPS scale-and-round).

    Per source channel l: Shoup pair for (Q/q_l)^-1 mod q_l, and float32
    constants t*2^15/q_l, t/q_l (for the hi/lo-split fractional sum).
    Per (dst j, src l): Shoup pair for [t * q_l^-1]_{p_j}.
    Per dst j: Shoup pair for [t * Q^-1]_{p_j} and a Barrett mu for
    reducing the rounded fractional sum v < 2^21 mod p_j.
    """
    L, K = len(qs_src), len(qs_dst)
    Q = 1
    for q in qs_src:
        Q *= q
    qtilde = np.zeros((L, 2), dtype=np.uint32)
    th = np.zeros(L, dtype=np.float32)
    tl = np.zeros(L, dtype=np.float32)
    for l, q in enumerate(qs_src):
        qhat = Q // q
        qtilde[l] = _shoup_pair(pow(qhat % q, q - 2, q), q)
        th[l] = float(t) * float(1 << 15) / float(q)
        tl[l] = float(t) / float(q)
    tq = np.zeros((K, L, 2), dtype=np.uint32)
    tQ = np.zeros((K, 2), dtype=np.uint32)
    mu = np.zeros(K, dtype=np.uint32)
    for j, p in enumerate(qs_dst):
        for l, q in enumerate(qs_src):
            tq[j, l] = _shoup_pair((t * pow(q % p, p - 2, p)) % p, p)
        tQ[j] = _shoup_pair((t * pow(Q % p, p - 2, p)) % p, p)
        mu[j] = (1 << 32) // p
    return qtilde, th, tl, tq, tQ, mu


def scale_round(
    x_src: jnp.ndarray,
    x_dst: jnp.ndarray,
    qs_src: Sequence[int],
    qs_dst: Sequence[int],
    t: int,
) -> jnp.ndarray:
    """round(t * x / Q) mod each p_j — the BFV scale-invariant division.

    ``x`` is one integer in [0, Q*P') held in the union basis
    qs_src (+) qs_dst: ``x_src`` are its residues (L, ..., n) mod the Q
    primes, ``x_dst`` its residues (K, ..., n) mod the target primes.
    Every target prime must be coprime to Q (Q^-1 mod p_j exists), which
    is why the output lands in the auxiliary basis only — convert back to
    Q with :func:`base_convert_sk`.

    HPS folding (u, the base-conversion overflow count, cancels exactly):

        round(t x / Q) = t*(x - [x]_Q)/Q + round(t [x]_Q / Q)
                       ≡ [t Q^-1]_p x_p - sum_l xt_l [t q_l^-1]_p + v  (mod p)
        v = round(sum_l xt_l * t / q_l),   xt_l = [x_l (Q/q_l)^-1]_{q_l}

    v is the only non-integer step: a float32 hi/lo-split sum whose worst-
    case accumulation error (~2^-5 for L<=16, t<2^17) can flip the rounding
    by ±1 in a narrow band — a ±1 additive noise term on the scaled result
    (the HPS rounding-error term), never a correctness break.  The same v
    is used for every target channel, so the outputs stay consistent
    residues of ONE integer (what base_convert_sk needs).
    """
    qs_src = tuple(int(q) for q in qs_src)
    qs_dst = tuple(int(q) for q in qs_dst)
    qtilde, th, tl, tq, tQ, mu = _scale_round_tables(qs_src, qs_dst, int(t))

    xts = []
    v = None
    for l, q in enumerate(qs_src):
        xt = cond_sub(
            shoup_mulmod_lazy(
                x_src[l], U32(int(qtilde[l, 0])), U32(int(qtilde[l, 1])), q
            ),
            q,
        )
        xts.append(xt)
        # fractional sum in float32: split xt into 15-bit halves so both
        # products are exact up to the constants' own 2^-24 rounding
        hi = (xt >> U32(15)).astype(jnp.float32)
        lo = (xt & U32(0x7FFF)).astype(jnp.float32)
        term = hi * th[l] + lo * tl[l]
        v = term if v is None else v + term
    v = jnp.rint(v).astype(jnp.uint32)  # < L * t < 2^21

    outs = []
    for j, p in enumerate(qs_dst):
        acc = None
        for l in range(len(qs_src)):
            s = shoup_mulmod_lazy(
                xts[l], U32(int(tq[j, l, 0])), U32(int(tq[j, l, 1])), p
            )  # [0, 2p)
            acc = s if acc is None else cond_sub(acc + s, 2 * p)
        acc = cond_sub(cond_sub(acc, 2 * p), p)  # [0, p)
        a = cond_sub(
            shoup_mulmod_lazy(
                x_dst[j], U32(int(tQ[j, 0])), U32(int(tQ[j, 1])), p
            ),
            p,
        )
        y = sub_mod(a, acc, p)
        # v mod p via Barrett (v < 2^21 << p*2^2, one step reaches [0, 2p))
        m = mulhi_u32(v, U32(int(mu[j])))
        vr = cond_sub(cond_sub(v - m * U32(p), 2 * p), p)
        outs.append(cond_sub(y + vr, p))
    return jnp.stack(outs, axis=0)


@functools.lru_cache(maxsize=64)
def _sk_tables(qs_src: tuple, m_sk: int, qs_dst: tuple):
    """Host tables for the Shenoy-Kumaresan exact conversion from
    qs_src (+) {m_sk} to qs_dst: per l a Shoup pair for (B/b_l)^-1 mod
    b_l; [(B/b_l)]_{m_sk} pairs and B^-1 mod m_sk; per (j, l)
    [(B/b_l)]_{q_j} pairs and [B]_{q_j} pairs."""
    L = len(qs_src)
    B = 1
    for b in qs_src:
        B *= b
    btilde = np.zeros((L, 2), dtype=np.uint32)
    for l, b in enumerate(qs_src):
        bhat = B // b
        btilde[l] = _shoup_pair(pow(bhat % b, b - 2, b), b)
    sk_mat = np.zeros((L, 2), dtype=np.uint32)
    for l, b in enumerate(qs_src):
        sk_mat[l] = _shoup_pair((B // b) % m_sk, m_sk)
    binv_sk = _shoup_pair(pow(B % m_sk, m_sk - 2, m_sk), m_sk)
    K = len(qs_dst)
    mat = np.zeros((K, L, 2), dtype=np.uint32)
    bmod = np.zeros((K, 2), dtype=np.uint32)
    for j, p in enumerate(qs_dst):
        for l, b in enumerate(qs_src):
            mat[j, l] = _shoup_pair((B // b) % p, p)
        bmod[j] = _shoup_pair(B % p, p)
    return btilde, sk_mat, binv_sk, mat, bmod


def base_convert_sk(
    x: jnp.ndarray,
    x_sk: jnp.ndarray,
    qs_src: Sequence[int],
    m_sk: int,
    qs_dst: Sequence[int],
) -> jnp.ndarray:
    """EXACT base conversion via the Shenoy-Kumaresan redundant modulus.

    ``x`` (L, ..., n) are the residues mod qs_src of an integer y with
    0 <= y < B = prod(qs_src); ``x_sk`` (..., n) is the SAME integer's
    residue mod the redundant prime m_sk (carried alongside through the
    pipeline).  The classical approximate conversion yields y + e*B with
    0 <= e < L; the m_sk channel pins e = [(approx_sk - x_sk) B^-1]_{m_sk}
    exactly (e < L << m_sk), so the output is y mod q_j with NO float
    band — this is how BEHZ closes its final B->Q conversion, and why the
    BFV pipeline tensors over Q (+) B (+) {m_sk}.
    """
    qs_src = tuple(int(q) for q in qs_src)
    qs_dst = tuple(int(q) for q in qs_dst)
    m_sk = int(m_sk)
    btilde, sk_mat, binv_sk, mat, bmod = _sk_tables(qs_src, m_sk, qs_dst)

    yts = []
    for l, b in enumerate(qs_src):
        yt = shoup_mulmod_lazy(
            x[l], U32(int(btilde[l, 0])), U32(int(btilde[l, 1])), b
        )
        yts.append(cond_sub(yt, b))

    # overflow count e from the redundant channel
    acc = None
    for l in range(len(qs_src)):
        s = shoup_mulmod_lazy(
            yts[l], U32(int(sk_mat[l, 0])), U32(int(sk_mat[l, 1])), m_sk
        )
        acc = s if acc is None else cond_sub(acc + s, 2 * m_sk)
    acc = cond_sub(cond_sub(acc, 2 * m_sk), m_sk)
    diff = sub_mod(acc, x_sk, m_sk)
    e = cond_sub(
        shoup_mulmod_lazy(
            diff, U32(int(binv_sk[0])), U32(int(binv_sk[1])), m_sk
        ),
        m_sk,
    )  # the exact small integer e in [0, L)

    outs = []
    for j, p in enumerate(qs_dst):
        acc = None
        for l in range(len(qs_src)):
            s = shoup_mulmod_lazy(
                yts[l], U32(int(mat[j, l, 0])), U32(int(mat[j, l, 1])), p
            )
            acc = s if acc is None else cond_sub(acc + s, 2 * p)
        acc = cond_sub(cond_sub(acc, 2 * p), p)
        eb = cond_sub(
            shoup_mulmod_lazy(
                e, U32(int(bmod[j, 0])), U32(int(bmod[j, 1])), p
            ),
            p,
        )
        outs.append(sub_mod(acc, eb, p))
    return jnp.stack(outs, axis=0)


@functools.lru_cache(maxsize=64)
def _rescale_tables(qs: tuple):
    """Host tables for dropping q_L: per surviving channel l — Barrett mu
    for reducing values < q_L mod q_l, [q_L]_{q_l}, q_L^-1 mod q_l."""
    qL = qs[-1]
    out = []
    for q in qs[:-1]:
        mu = (1 << 32) // q
        out.append((
            np.uint32(mu),
            _shoup_pair(qL % q, q),
            _shoup_pair(pow(qL % q, q - 2, q), q),
        ))
    return out, qL


def mod_down(x: jnp.ndarray, qs: Sequence[int], count: int = 1) -> jnp.ndarray:
    """Iterated divide-and-round: drop the last ``count`` primes one at a
    time (the standard ModDown after a key-switch in an extended basis).
    (L, ..., n) -> (L-count, ..., n); each step is the exact centered
    rounding of ``rescale``."""
    qs = tuple(int(q) for q in qs)
    if not 1 <= count <= len(qs) - 1:
        raise ValueError(
            f"count must be in [1, L-1={len(qs) - 1}], got {count}"
        )
    for i in range(count):
        x = rescale(x, qs[: len(qs) - i])
    return x


@functools.lru_cache(maxsize=64)
def _rescale_bgv_tables(qs: tuple, t: int):
    """Host tables for the t-correcting drop of q_L: Shoup pair for
    t^-1 mod q_L, and per surviving channel — Barrett mu for reducing
    u < q_L, Shoup pairs for [t]_{q_l}, [t*q_L]_{q_l}, q_L^-1 mod q_l."""
    qL = qs[-1]
    tinv = _shoup_pair(pow(t % qL, qL - 2, qL), qL)
    out = []
    for q in qs[:-1]:
        mu = (1 << 32) // q
        out.append((
            np.uint32(mu),
            _shoup_pair(t % q, q),
            _shoup_pair((t * qL) % q, q),
            _shoup_pair(pow(qL % q, q - 2, q), q),
        ))
    return tinv, out, qL


def rescale_bgv(x: jnp.ndarray, qs: Sequence[int], t: int) -> jnp.ndarray:
    """BGV modulus switch: drop q_L via the t-multiple correction.

    out = (x - delta) / q_L with delta = t * centered([x_L * t^-1]_{q_L}),
    so delta ≡ x (mod q_L) — the division is exact — AND delta ≡ 0
    (mod t) — the phase mod t is preserved up to the q_L^-1 factor the
    scheme layer tracks.  |delta| <= t*q_L/2, i.e. the additive noise is
    ~t/2 after division (the BGV analog of rescale's 1/2).
    (L, ..., n) -> (L-1, ..., n); inputs [0, q_l), outputs [0, q_l).
    """
    qs = tuple(int(q) for q in qs)
    t = int(t)
    if len(qs) < 2:
        raise ValueError("rescale_bgv needs at least 2 primes")
    (tw, tp), tabs, qL = _rescale_bgv_tables(qs, t)
    u = cond_sub(
        shoup_mulmod_lazy(x[-1], U32(int(tw)), U32(int(tp)), qL), qL
    )  # [x_L * t^-1]_{q_L} in [0, q_L)
    big = u > jnp.uint32(qL // 2)  # centered lift of u
    outs = []
    for l, (mu, (w_t, p_t), (w_tq, p_tq), (iw, ip)) in enumerate(tabs):
        q = qs[l]
        # Barrett: u mod q_l (u < q_L < 2^30, exact to [0, 2q))
        m = mulhi_u32(u, U32(int(mu)))
        ul = cond_sub(cond_sub(u - m * U32(q), 2 * q), q)
        tu = cond_sub(shoup_mulmod_lazy(ul, U32(w_t), U32(p_t), q), q)
        # centered: t*(u - qL) == t*u - [t*qL]_{q_l}  (mod q_l)
        tu = jnp.where(big, sub_mod(tu, U32(int(w_tq)), q), tu)
        diff = sub_mod(x[l], tu, q)
        y = shoup_mulmod_lazy(diff, U32(int(iw)), U32(int(ip)), q)
        outs.append(cond_sub(y, q))
    return jnp.stack(outs, axis=0)


def mod_down_bgv(
    x: jnp.ndarray, qs: Sequence[int], t: int, count: int = 1
) -> jnp.ndarray:
    """Iterated t-correcting divide: the BGV ModDown after an extended-
    basis key switch (key noise is a t-multiple, the correction keeps the
    output noise one too).  (L, ..., n) -> (L-count, ..., n)."""
    qs = tuple(int(q) for q in qs)
    if not 1 <= count <= len(qs) - 1:
        raise ValueError(
            f"count must be in [1, L-1={len(qs) - 1}], got {count}"
        )
    for i in range(count):
        x = rescale_bgv(x, qs[: len(qs) - i], t)
    return x


def rescale(x: jnp.ndarray, qs: Sequence[int]) -> jnp.ndarray:
    """Divide-and-round by the last prime: (L, ..., n) -> (L-1, ..., n).

    out_l = [(x_l - centered([x_{L-1}]_{q_L})) * q_L^-1]_{q_l}, i.e. the
    residues of round(x / q_L) in the basis qs[:-1].  Inputs [0, q_l);
    outputs [0, q_l).
    """
    qs = tuple(int(q) for q in qs)
    if len(qs) < 2:
        raise ValueError("rescale needs at least 2 primes")
    tabs, qL = _rescale_tables(qs)
    xL = x[-1]
    big = xL > jnp.uint32(qL // 2)  # centered lift: subtract qL when high
    outs = []
    for l, (mu, (rw, rp), (iw, ip)) in enumerate(tabs):
        q = qs[l]
        # Barrett: t = xL mod q_l  (xL < qL < 2^30 < 2^32, exact to [0, 2q))
        m = mulhi_u32(xL, U32(int(mu)))
        t = cond_sub(cond_sub(xL - m * U32(q), 2 * q), q)
        # centered: x_L - qL  ==  t - [qL]_{q_l}  (mod q_l)
        t = jnp.where(big, sub_mod(t, U32(int(rw)), q), t)
        diff = sub_mod(x[l], t, q)
        y = shoup_mulmod_lazy(diff, U32(int(iw)), U32(int(ip)), q)
        outs.append(cond_sub(y, q))
    return jnp.stack(outs, axis=0)
