#!/usr/bin/env python
"""Toy leveled RNS scheme: the full production stack in ~150 lines.

Drives every between-NTT primitive this framework supplies end to end, the
way an RNS-CKKS/BGV evaluator would (the reference implements only the
forward transform of this stack, ``/root/reference/src/kernel/ntt.cpp``):

    keygen      ternary secret in the RNS basis Q; relinearization key in
                the extended basis Q u P via the CRT-idempotent gadget
                (ksk_d encrypts P * g_d * s^2, g_d = 1 mod q_d, 0 mod q_l)
    encrypt     (c0, c1) = (-(a s) + Delta m + e, a)   residues mod Q
    multiply    tensor square (d0, d1, d2) = (c0 c0', c0 c1' + c1 c0', c1 c1')
    relinearize d2's s^2 term folded back to degree 1 with ONE CALL per key
                row: RNSRing.keyswitch (gadget digits -> extended-basis
                polydot -> ModDown by P)
    rescale     divide-and-round by the last prime — drop a level
    decrypt     round(centered(c0 + c1 s) / scale) mod t

THIS IS A PEDAGOGICAL TOY — parameters and noise handling are not a secure
or complete scheme; it exists to prove the primitives compose into a
working leveled evaluator (every step below is checked numerically and
message recovery is exact).

Run: python examples/ckks_rns_toy.py
"""

import math
import os
import sys
from fractions import Fraction

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax


import numpy as np

from agilex_ntt import RNSRing
from agilex_ntt.params import find_primes

N, T = 1024, 64                    # ring degree, plaintext modulus
QS = find_primes(N, 4)             # 3-prime ciphertext basis Q + special P
rq = RNSRing(N, qs=QS[:3])
rqp = RNSRing(N, qs=QS)
P = QS[3]
Q = rq.modulus
DNUM = rq.L                        # per-prime (GHS) digits: t_d < q_d keeps
                                   # the keyswitch noise ~ |e|, not Q_d|e|/P
# tensor products square the scale: Delta^2 * |m1*m2| must stay < Q/2,
# and |negacyclic(m1, m2)| <= N*T^2 = 2^22 here
DELTA = math.isqrt(Q >> 24)
rng = np.random.default_rng(11)


def negmul(a, b):
    """Negacyclic product of big-int coefficient arrays (host oracle)."""
    conv = np.convolve(np.asarray(a, dtype=object), np.asarray(b, dtype=object))
    out = conv[:N].copy()
    out[: N - 1] -= conv[N:]
    return out


def to_rns_centered(v):
    """Signed host ints (N,) -> residues (L, N) in basis Q."""
    return np.stack([(np.asarray(v, dtype=object) % q).astype(np.uint32)
                     for q in rq.qs])


def small(bound):
    return rng.integers(-bound, bound + 1, size=N).astype(object)


def uniform_big():
    out = np.zeros(N, dtype=object)
    for _ in range(4):
        out = out * (1 << 30) + rng.integers(0, 1 << 30, size=N).astype(object)
    return out % Q


def keygen():
    s = small(1)
    s2 = negmul(s, s)
    ksk_b, ksk_a = [], []
    for d in range(DNUM):
        qd = rq.qs[d]
        qhat = Q // qd
        g_d = qhat * pow(qhat % qd, -1, qd)     # CRT idempotent of q_d
        a_d = uniform_big()
        e_d = small(2)
        b_d = -negmul(a_d, s) + e_d + P * g_d * s2
        ksk_b.append(np.stack([(b_d % p).astype(np.uint32) for p in rqp.qs]))
        ksk_a.append(np.stack([(a_d % p).astype(np.uint32) for p in rqp.qs]))
    return s, np.stack(ksk_b), np.stack(ksk_a)


def encrypt(s, m):
    a = uniform_big()
    e = small(2)
    c0 = -negmul(a, s) + DELTA * np.asarray(m, dtype=object) + e
    return to_rns_centered(c0), to_rns_centered(a)


def phase_centered(s, parts, ring):
    """Centered big-int sum_i c_i * s^i from RNS parts in `ring`."""
    total = np.zeros(N, dtype=object)
    spow = np.zeros(N, dtype=object)
    spow[0] = 1
    for c in parts:
        total = total + negmul(ring.from_rns(np.asarray(c)), spow)
        spow = negmul(spow, s)
    total = total % ring.modulus
    return np.where(total > ring.modulus // 2, total - ring.modulus, total)


def decrypt(s, parts, scale, ring=None):
    """Exact big-int round(phase / scale) mod T (phases exceed float64)."""
    ph = phase_centered(s, parts, ring or rq)
    fr = Fraction(scale)
    num, den = fr.numerator, fr.denominator
    return np.array(
        [((2 * int(v) * den + num) // (2 * num)) % T for v in ph],
        dtype=np.int64,
    )


def tau_host(v, k):
    """tau_k on host ints (signed permutation); v object or int64."""
    idx = (np.arange(N) * k) % (2 * N)
    out = np.zeros(N, dtype=object)
    for i in range(N):
        j, wrap = idx[i] % N, idx[i] >= N
        out[j] += -v[i] if wrap else v[i]
    return out


def rot_keys(s, k):
    """Rotation key pair for tau_k: encrypts P * g_d * tau_k(s)."""
    sk_tau = tau_host(s, k)
    rb, ra = [], []
    for d in range(DNUM):
        qd = rq.qs[d]
        qhat = Q // qd
        g_d = qhat * pow(qhat % qd, -1, qd)
        a_d = uniform_big()
        e_d = small(2)
        b_d = -negmul(a_d, s) + e_d + P * g_d * sk_tau
        rb.append(np.stack([(b_d % p).astype(np.uint32) for p in rqp.qs]))
        ra.append(np.stack([(a_d % p).astype(np.uint32) for p in rqp.qs]))
    return np.stack(rb), np.stack(ra)


def main():
    s, ksk_b, ksk_a = keygen()
    m1 = rng.integers(0, T, size=N)
    m2 = np.zeros(N, dtype=np.int64)
    m2[0], m2[1] = 3, 2            # sparse so the product's scale is tame

    ct1 = encrypt(s, m1)
    ct2 = encrypt(s, m2)
    assert (decrypt(s, ct1, DELTA) == m1 % T).all(), "roundtrip failed"
    print("encrypt/decrypt: exact")

    # tensor multiply: degree-2 ciphertext in Q (device polymuls)
    d0 = np.asarray(rq.polymul(ct1[0], ct2[0]))
    d1 = np.asarray(
        rq.add(rq.polymul(ct1[0], ct2[1]), rq.polymul(ct1[1], ct2[0]))
    )
    d2 = np.asarray(rq.polymul(ct1[1], ct2[1]))

    mm = negmul(m1, m2) % T        # plaintext product oracle

    got3 = decrypt(s, [d0, d1, d2], Fraction(DELTA) ** 2)
    assert (got3 == mm).all(), "degree-2 decrypt mismatch"
    print("tensor multiply: degree-2 decrypt exact vs plaintext oracle")

    # relinearize: one keyswitch per key row folds the s^2 term away
    c0 = np.asarray(rq.add(d0, rq.keyswitch(d2, ksk_b, rqp, DNUM)))
    c1 = np.asarray(rq.add(d1, rq.keyswitch(d2, ksk_a, rqp, DNUM)))
    got2 = decrypt(s, [c0, c1], Fraction(DELTA) ** 2)
    assert (got2 == mm).all(), "post-relinearization decrypt mismatch"
    print(f"relinearize (RNSRing.keyswitch, dnum={DNUM}): exact")

    # rescale: drop a level; the scale divides by the dropped prime
    home = rq.drop_prime()
    c0s, c1s = np.asarray(rq.rescale(c0)), np.asarray(rq.rescale(c1))
    got_low = decrypt(
        s, [c0s, c1s], Fraction(DELTA) ** 2 / rq.qs[-1], ring=home
    )
    assert (got_low == mm).all(), "post-rescale decrypt mismatch"
    print(f"rescale: level dropped ({rq.L} -> {home.L} primes), exact")

    # rotation: tau_k(ct) encrypts tau_k(m) under tau_k(s); a rotation key
    # (the same gadget construction, encrypting P * g_d * tau_k(s)) switches
    # it back under s — automorphism + keyswitch compose
    k = 5
    tau = lambda v: np.asarray(rq.automorphism(np.asarray(v), k))
    rot_b, rot_a = rot_keys(s, k)
    r0 = np.asarray(rq.add(tau(ct1[0]),
                           rq.keyswitch(tau(ct1[1]), rot_b, rqp, DNUM)))
    r1 = np.asarray(rq.keyswitch(tau(ct1[1]), rot_a, rqp, DNUM))
    m1_tau = (tau_host(m1.astype(object), k) % T).astype(np.int64)
    got_rot = decrypt(s, [r0, r1], DELTA)
    assert (got_rot == m1_tau % T).all(), "post-rotation decrypt mismatch"
    print(f"rotate (automorphism tau_{k} + keyswitch): exact")

    # hoisted rotation batch: ONE decomposition of c1 + eval-domain keys
    # (transformed once via ksk_to_ntt) serve several steps at once — the
    # Halevi-Shoup BSGS pattern.  The hoisted digits differ from
    # decompose(tau_k(c1)) but satisfy tau_k of the reconstruction
    # identity, so every step still decrypts exactly.
    steps = (3, 9, 2 * N - 1)
    keys = [rot_keys(s, k) for k in steps]
    kb_ntt = rq.ksk_to_ntt(np.stack([b for b, _ in keys]), rqp, ch_axis=2)
    ka_ntt = rq.ksk_to_ntt(np.stack([a for _, a in keys]), rqp, ch_axis=2)
    hb = rq.hoisted_keyswitch(ct1[1], kb_ntt, steps, rqp, DNUM,
                              ksk_domain="ntt")
    ha = rq.hoisted_keyswitch(ct1[1], ka_ntt, steps, rqp, DNUM,
                              ksk_domain="ntt")
    for j, kk in enumerate(steps):
        h0 = np.asarray(rq.add(
            np.asarray(rq.automorphism(np.asarray(ct1[0]), kk)), hb[j]
        ))
        h1 = np.asarray(ha[j])
        want = (tau_host(m1.astype(object), kk) % T).astype(np.int64)
        got_h = decrypt(s, [h0, h1], DELTA)
        assert (got_h == want).all(), f"hoisted rotation tau_{kk} mismatch"
    print(f"hoisted rotations ({len(steps)} steps, one decomposition, "
          f"eval-domain keys): all exact")

    # BSGS linear transform: sum_j pt_j (*) tau_{k_j}(ct) in ONE fused call
    # (hoisted_linear_sum) — the homomorphic matrix-vector inner loop.  All
    # key/plaintext material pre-transformed once; products accumulate in
    # the extended basis with a single deferred ModDown per part.
    wts = [rng.integers(-2, 3, size=N).astype(object) for _ in steps]
    pts = np.stack([
        np.stack([(w % p).astype(np.uint32) for p in rqp.qs]) for w in wts
    ])  # (nk, K, N)
    ptn = rq.ksk_to_ntt(pts, rqp, ch_axis=1)
    o0, o1 = rq.hoisted_linear_sum(
        ct1[0], ct1[1], ptn, kb_ntt, ka_ntt, steps, rqp, DNUM,
        ksk_domain="ntt", pt_domain="ntt",
    )
    want_lin = np.zeros(N, dtype=object)
    for w, kk in zip(wts, steps):
        want_lin = want_lin + negmul(w, tau_host(m1.astype(object), kk))
    got_lin = decrypt(s, [np.asarray(o0), np.asarray(o1)], DELTA)
    assert (got_lin == (want_lin % T).astype(np.int64)).all(), \
        "linear-transform decrypt mismatch"
    print(f"BSGS linear transform (hoisted_linear_sum, {len(steps)} terms, "
          f"one ModDown): exact")
    print("ckks_rns_toy: full leveled pipeline verified")


if __name__ == "__main__":
    main()
