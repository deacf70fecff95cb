#!/usr/bin/env python
"""Tour of the core API: rings, transforms, products, rotations.

Run: python examples/basic_usage.py   (a GPU, or the CPU with JAX_PLATFORMS=cpu)
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax


import numpy as np

from agilex_ntt import CyclicRing, Ring, RNSRing

rng = np.random.default_rng(0)

# --- negacyclic ring: Z_q[X] / (X^4096 + 1), auto-picked 30-bit NTT prime
ring = Ring(4096)
print("ring:", ring)

a = rng.integers(0, ring.q, size=(4096,), dtype=np.uint32)
b = rng.integers(0, ring.q, size=(4096,), dtype=np.uint32)

y = ring.ntt(a)                     # forward negacyclic NTT
assert (np.asarray(ring.intt(y)) == a).all()

c = ring.polymul(a, b)              # a*b mod (X^n + 1, q) — one fused kernel
print("polymul ok, c[0] =", int(np.asarray(c)[0]))

# NTT-domain rotation (FHE-style): tau_5 is a pure slot permutation there
rot = ring.automorphism(y, 5, domain="ntt")
assert (np.asarray(ring.ntt(ring.automorphism(a, 5))) == np.asarray(rot)).all()

# key-switch-style inner product: sum_i a_i * b_i with one inverse transform
k = 3
av = rng.integers(0, ring.q, size=(k, 4096), dtype=np.uint32)
bv = rng.integers(0, ring.q, size=(k, 4096), dtype=np.uint32)
dot = ring.polydot(av, bv)
print("polydot ok, shape", dot.shape)

# --- RNS: 3-prime CRT basis for wide coefficients (up to ~90 bits)
rns = RNSRing(4096, num_primes=3)
big_coeffs = rng.integers(0, 1 << 60, size=(8,), dtype=np.uint64)
poly = np.zeros(4096, dtype=object)
poly[:8] = big_coeffs
residues = rns.to_rns(poly)          # (3, 4096)
back = rns.from_rns(residues)
assert (back[:8] == big_coeffs).all()
print("RNS roundtrip ok; modulus bits:", rns.modulus.bit_length())

# --- plain cyclic convolution (signal-processing style)
cyc = CyclicRing(4096)
conv = cyc.polymul(a, b)            # a*b mod (X^n - 1, q)
print("cyclic convolution ok")

# --- large N: four-step decomposition beyond the 32768 single-pass wall
big = Ring(1 << 17)
xa = rng.integers(0, big.q, size=(2, big.n), dtype=np.uint32)
assert (np.asarray(big.intt(big.ntt(xa))) == xa).all()
print(f"large-N ok: n={big.n}, method={big.method}")
print("all examples passed")
