#!/usr/bin/env python
"""Exact integer FHE with the BGV scheme layer — everything checks with ==.

Where `ckks_scheme.py` shows approximate arithmetic, this is the
exact-integer sibling: plaintexts are (2, n/2) slot matrices mod a prime t,
packed by the framework's OWN transform (`Ring(n, q=t)` intt/ntt — the
scheme eats its dog food), and every operation decrypts to exactly the
slotwise result mod t.  The reference implements the forward transform this
pipeline dispatches at every step (`/root/reference/src/kernel/ntt.cpp`).

Run: python examples/bgv_exact.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax


import numpy as np

from agilex_ntt.schemes import BGVContext

N = 256


def main():
    rng = np.random.default_rng(17)
    ctx = BGVContext(N, num_primes=3, rng=rng)
    keys = ctx.keygen(galois_steps=(0, 1, -1))
    print(f"BGV context: n={N}, slots=(2, {N // 2}) mod t={ctx.t}, "
          f"L={ctx.L} levels")

    m1 = rng.integers(0, ctx.t, (2, N // 2))
    m2 = rng.integers(0, ctx.t, (2, N // 2))
    c1 = ctx.encrypt(ctx.encode(m1), keys)
    c2 = ctx.encrypt_symmetric(ctx.encode(m2), keys)

    assert (ctx.decode(ctx.decrypt(c1, keys)) == m1).all()
    print("encrypt/decrypt: exact")

    got = ctx.decode(ctx.decrypt(ctx.add(c1, c2), keys))
    assert (got == (m1 + m2) % ctx.t).all()
    print("add: exact")

    prod = ctx.multiply(c1, c2, keys)
    assert (ctx.decode(ctx.decrypt(prod, keys)) == (m1 * m2) % ctx.t).all()
    print("multiply + relinearize: exact")

    low = ctx.rescale(prod)   # modulus switch: noise /= q_L, factor tracked
    assert (ctx.decode(ctx.decrypt(low, keys)) == (m1 * m2) % ctx.t).all()
    print(f"modulus switch (level {prod.level} -> {low.level}, "
          f"t-correcting divide): exact")

    rot = ctx.rotate(c1, 1, keys)
    assert (ctx.decode(ctx.decrypt(rot, keys))
            == np.roll(m1, -1, axis=-1)).all()
    sw = ctx.conjugate(c1, keys)  # tau_{2n-1}: row swap
    assert (ctx.decode(ctx.decrypt(sw, keys)) == m1[::-1]).all()
    print("rotate rows / swap rows: exact")

    # fused BSGS linear transform, exact mod t
    steps = (0, 1, -1)
    ws = [rng.integers(0, ctx.t, (2, N // 2)) for _ in steps]
    op = ctx.make_linear_op(list(zip(steps, ws)), keys, ctx.L)
    out = ctx.apply_linear(c1, op)
    want = sum(w * np.roll(m1, -s, axis=-1) for s, w in zip(steps, ws)) % ctx.t
    assert (ctx.decode(ctx.decrypt(out, keys)) == want).all()
    print(f"fused linear transform ({len(steps)} terms, one ModDown): exact")
    print("bgv_exact: all checks passed with ==")


if __name__ == "__main__":
    main()
