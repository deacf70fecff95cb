#!/usr/bin/env python
"""Homomorphic activation functions via `poly_eval` (BSGS PS).

Private inference evaluates non-linear activations as polynomial
approximations under encryption.  This example approximates the logistic
sigmoid on [-4, 4] with a least-squares degree-7 polynomial, encrypts a
batch of pre-activations, and applies it with ONE `poly_eval` call —
4 ciphertext multiplies at depth 3 instead of 7 sequential Horner
multiplies at depth 7.  The reference stops at the forward transform
this dispatches (``/root/reference/src/kernel/ntt.cpp:86-506``).

Run: python examples/poly_activation.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax


import numpy as np

from agilex_ntt.schemes import CKKSContext

N = 2048
L = 6
DEG = 7

rng = np.random.default_rng(0)
ctx = CKKSContext(N, num_primes=L, rng=rng)
keys = ctx.keygen()

# least-squares degree-7 fit of sigmoid on [-4, 4] (host-side, one time)
xs = np.linspace(-4, 4, 513)
coeffs = np.polynomial.polynomial.polyfit(xs, 1 / (1 + np.exp(-xs)), DEG)
fit_err = np.abs(
    np.polynomial.polynomial.polyval(xs, coeffs) - 1 / (1 + np.exp(-xs))
).max()
print(f"degree-{DEG} sigmoid fit, max approx error {fit_err:.2e}")

# encrypt a batch of pre-activations (slots = one layer's outputs)
z = rng.uniform(-4, 4, (4, N // 2))
ct = ctx.encrypt(ctx.encode(z + 0j), keys)

# ONE call: baby/giant powers + the dictated-scale recursion
out = ctx.rescale(ctx.poly_eval(ct, list(coeffs), keys))
print(f"result level {out.level} (input {ctx.L}), scale ~2^"
      f"{float(out.scale).hex().split('p')[1]}")

got = ctx.decode(ctx.decrypt(out, keys)).real
want = 1 / (1 + np.exp(-z))
err = np.abs(got - want).max()
print(f"max end-to-end error vs true sigmoid: {err:.2e} "
      f"(approximation {fit_err:.2e} + scheme noise)")
assert err < fit_err + 1e-2
print("OK")
