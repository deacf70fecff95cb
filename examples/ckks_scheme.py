#!/usr/bin/env python
"""First-class RNS-CKKS API: the scheme layer in ~60 lines of user code.

Where ``ckks_rns_toy.py`` builds a scheme by hand from ring primitives (and
checks every step against big-int oracles), this is the packaged product:
``agilex_ntt.schemes.CKKSContext`` — encoder, keygen, encryption, and
the full evaluator (multiply/relinearize/rescale, rotations, fused BSGS
linear transforms), every polynomial op dispatched through the
channel-batched transform (the GPU kernel on a GPU).  The reference stops at the forward transform
(``/root/reference/src/kernel/ntt.cpp``); this is the workload it feeds.

Run: python examples/ckks_scheme.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax


import numpy as np

from agilex_ntt.schemes import CKKSContext

N, SLOTS = 512, 256


def check(tag, got, want, tol=2e-3):
    err = np.abs(got - want).max()
    assert err < tol, f"{tag}: max error {err:.2e} >= {tol}"
    print(f"{tag}: max error {err:.2e}")


def main():
    rng = np.random.default_rng(5)
    ctx = CKKSContext(N, num_primes=3, rng=rng)
    keys = ctx.keygen(galois_steps=(0, 1, -1, 4))
    print(f"CKKS context: n={N}, {SLOTS} slots, L={ctx.L} levels, "
          f"delta=2^{ctx.delta.bit_length() - 1}")

    z1 = rng.uniform(-1, 1, SLOTS) + 1j * rng.uniform(-1, 1, SLOTS)
    z2 = rng.uniform(-1, 1, SLOTS) + 1j * rng.uniform(-1, 1, SLOTS)

    c1 = ctx.encrypt(ctx.encode(z1), keys)            # public-key
    c2 = ctx.encrypt_symmetric(ctx.encode(z2), keys)  # secret-key
    check("encrypt/decrypt", ctx.decode(ctx.decrypt(c1, keys)), z1)

    check("add", ctx.decode(ctx.decrypt(ctx.add(c1, c2), keys)), z1 + z2)

    prod = ctx.rescale(ctx.multiply(c1, c2, keys))
    check("multiply+relin+rescale",
          ctx.decode(ctx.decrypt(prod, keys)), z1 * z2)
    print(f"  level {ctx.L} -> {prod.level}, scale tracked exactly")

    rot = ctx.rotate(c1, 1, keys)
    check("rotate(1)", ctx.decode(ctx.decrypt(rot, keys)), np.roll(z1, -1))
    conj = ctx.conjugate(c1, keys)
    check("conjugate", ctx.decode(ctx.decrypt(conj, keys)), np.conj(z1))

    # fused BSGS linear transform: sum_t diag_t * rot_t(ct) in ONE call
    steps = (0, 1, -1, 4)
    ws = [rng.uniform(-1, 1, SLOTS) + 0j for _ in steps]
    op = ctx.make_linear_op(list(zip(steps, ws)), keys, ctx.L)
    out = ctx.rescale(ctx.apply_linear(c1, op))
    want = sum(w * np.roll(z1, -t) for t, w in zip(steps, ws))
    check(f"linear transform ({len(steps)} terms, one fused call)",
          ctx.decode(ctx.decrypt(out, keys)), want, tol=5e-3)

    # polynomial evaluation: x^4 by repeated squaring across levels — the
    # same key material serves every level (sliced rows/channels)
    ct = ctx.encrypt(ctx.encode(z1 * 0.5), keys)
    sq = ctx.rescale(ctx.square(ct, keys))
    quad = ctx.rescale(ctx.square(sq, keys))
    check("x^4 (two squarings, two levels)",
          ctx.decode(ctx.decrypt(quad, keys)), (z1 * 0.5) ** 4, tol=5e-3)

    print("ckks_scheme: full evaluator verified")


if __name__ == "__main__":
    main()
