#!/usr/bin/env python
"""Toy symmetric RLWE encryption built entirely on the public ring API.

Demonstrates that the framework supplies every ring operation an
FHE-adjacent workload needs (the reference implements only the forward
transform of this stack).  THIS IS A PEDAGOGICAL TOY — parameters and noise
handling are not a secure or complete scheme.

    sk        <- small ternary polynomial
    ct = (c0, c1) with c0 = -(a*sk) + m*Delta + e,  c1 = a
    decrypt: round((c0 + c1*sk) / Delta) mod t

Homomorphic additions and plaintext multiplications happen on ciphertexts;
everything reduces to ntt/intt/polymul/add/sub under the hood.

Run: python examples/rlwe_toy.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax


import numpy as np

from agilex_ntt import Ring

N, T = 2048, 16  # ring degree, plaintext modulus
ring = Ring(N)
Q = ring.q
DELTA = Q // T
rng = np.random.default_rng(7)


def small_poly(bound=1):
    return (rng.integers(-bound, bound + 1, size=N) % Q).astype(np.uint32)


def encrypt(sk, m):
    a = rng.integers(0, Q, size=N, dtype=np.uint32)
    e = small_poly(2)
    m_scaled = (m.astype(np.uint64) * DELTA % Q).astype(np.uint32)
    c0 = ring.add(ring.sub(m_scaled, ring.polymul(a, sk)), e)
    return np.asarray(c0), a


def decrypt(sk, ct):
    c0, c1 = ct
    phase = np.asarray(ring.add(c0, ring.polymul(c1, sk))).astype(np.int64)
    centered = np.where(phase > Q // 2, phase - Q, phase)
    return (np.round(centered / DELTA).astype(np.int64) % T).astype(np.uint32)


sk = small_poly()
m1 = rng.integers(0, T, size=N, dtype=np.uint32)
m2 = rng.integers(0, T, size=N, dtype=np.uint32)

ct1 = encrypt(sk, m1)
ct2 = encrypt(sk, m2)
assert (decrypt(sk, ct1) == m1).all(), "roundtrip failed"

# homomorphic addition
ct_add = (np.asarray(ring.add(ct1[0], ct2[0])), np.asarray(ring.add(ct1[1], ct2[1])))
assert (decrypt(sk, ct_add) == (m1 + m2) % T).all(), "hom-add failed"

# multiply by a plaintext monomial = negacyclic rotation of the message
ct_rot = (np.asarray(ring.rotate(ct1[0], 3)), np.asarray(ring.rotate(ct1[1], 3)))
m_rot = decrypt(sk, ct_rot)
want = np.empty_like(m1)
want[3:] = m1[:-3]
want[:3] = (-m1[-3:].astype(np.int64)) % T
assert (m_rot == want).all(), "monomial-mul failed"

print(f"RLWE toy ok: n={N}, q={Q}, t={T} — encrypt/decrypt, hom-add, X^3-mul")
