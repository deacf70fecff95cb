#!/usr/bin/env python
"""Baby-step/giant-step homomorphic linear map: n1*n2 Galois terms from
n1 + n2 - 1 rotation keys.

Evaluates  M(m) = sum_{i,j} w_{ij} (*) tau_{g_i * b_j}(m)  on an encrypted
m — the structure of every homomorphic matrix-vector product (CKKS matvec,
CoeffToSlot/SlotToCoeff, bootstrapping linear layers) — using the BSGS
factorization:

    M(ct) = sum_i tau_{g_i}( sum_j tau_{g_i}^{-1}(w_{ij}) (*) tau_{b_j}(ct) )

The inner sums are ONE fused ``RNSRing.hoisted_linear_sum`` call each (one
gadget decomposition + one digit transform shared by all baby steps, the
plaintext multiplies fused in the evaluation domain, one deferred ModDown);
the outer giant steps are plain hoisted rotations.  Key material is
O(n1 + n2) instead of O(n1 * n2) — the reason BSGS is the production shape.

Builds on the toy leveled scheme from ``ckks_rns_toy`` (pedagogical, not
secure); every step is checked exactly against a host big-int oracle.
The reference implements only the forward transform under this stack
(``/root/reference/src/kernel/ntt.cpp``).

Run: python examples/bsgs_matvec.py
"""

import os
import sys

sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import numpy as np

from ckks_rns_toy import (  # noqa: E402
    DELTA, DNUM, N, T, decrypt, encrypt, keygen, negmul, rot_keys, rq, rqp,
    tau_host,
)

rng = np.random.default_rng(17)


def main():
    s, _, _ = keygen()
    m = rng.integers(0, T, size=N)
    c0, c1 = encrypt(s, m)

    # BSGS grid: baby steps b_j, giant steps g_i (all odd exponents; g_0 = 1
    # is the identity giant step and needs no key)
    baby = (3, 5, 9)
    giant = (1, 11, 13)
    n1, n2 = len(baby), len(giant)
    two_n = 2 * N

    # full weight grid w_ij, small-norm so the toy scheme decrypts exactly
    w = [[rng.integers(-2, 3, size=N).astype(object) for _ in baby]
         for _ in giant]

    # key material: n1 baby keys + (n2 - 1) giant keys — NOT n1 * n2
    baby_keys = [rot_keys(s, b) for b in baby]
    giant_keys = {g: rot_keys(s, g) for g in giant if g != 1}
    kb_ntt = rq.ksk_to_ntt(np.stack([b for b, _ in baby_keys]), rqp,
                           ch_axis=2)
    ka_ntt = rq.ksk_to_ntt(np.stack([a for _, a in baby_keys]), rqp,
                           ch_axis=2)
    n_keys = n1 + len(giant_keys)
    print(f"grid: {n1}x{n2} = {n1 * n2} Galois terms, {n_keys} rotation keys")

    out0 = out1 = None
    for i, g in enumerate(giant):
        # counter-rotate row i's weights so the giant step lands them right:
        # tau_g(tau_{g^-1}(w) (*) tau_b(m)) = w (*) tau_{g b}(m)
        ginv = pow(g, -1, two_n)
        pts = np.stack([
            np.stack([(tau_host(w[i][j], ginv) % p).astype(np.uint32)
                      for p in rqp.qs])
            for j in range(n1)
        ])  # (n1, K, N)
        ptn = rq.ksk_to_ntt(pts, rqp, ch_axis=1)
        h0, h1 = rq.hoisted_linear_sum(
            c0, c1, ptn, kb_ntt, ka_ntt, baby, rqp, DNUM,
            ksk_domain="ntt", pt_domain="ntt",
        )
        if g == 1:
            f0, f1 = h0, h1
        else:
            gb, ga = giant_keys[g]
            t0 = rq.automorphism(h0, g)
            t1 = rq.automorphism(h1, g)
            f0 = rq.add(t0, rq.keyswitch(t1, gb, rqp, DNUM))
            f1 = rq.keyswitch(t1, ga, rqp, DNUM)
        out0 = f0 if out0 is None else rq.add(out0, f0)
        out1 = f1 if out1 is None else rq.add(out1, f1)
        print(f"giant step tau_{g}: inner {n1}-term fused sum"
              + (" (identity, no key)" if g == 1 else " + rotation"))

    # host oracle: the full n1*n2-term linear map on the plaintext
    want = np.zeros(N, dtype=object)
    for i, g in enumerate(giant):
        for j, b in enumerate(baby):
            t = g * b % two_n
            want = want + negmul(w[i][j], tau_host(m.astype(object), t))
    got = decrypt(s, [np.asarray(out0), np.asarray(out1)], DELTA)
    assert (got == (want % T).astype(np.int64)).all(), \
        "BSGS matvec decrypt mismatch"
    print(f"BSGS linear map ({n1 * n2} terms, {n_keys} keys): exact")


if __name__ == "__main__":
    main()
