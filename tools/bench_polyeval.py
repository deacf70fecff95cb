#!/usr/bin/env python
"""Measure CKKS poly_eval throughput on the chip (degree-7 BSGS PS).

Standalone (not in bench_suite.py: the L=5 context's keygen is host
bignum work the 2h supervisor step shouldn't repeat).  Timing follows the
suite convention — `utils.profiling.device_time` delta method, min of
trials — with the level-dropping output zero-padded back to the input
shape so the chained timer composes.  Reference scope: the reference is
the forward transform only (`/root/reference/src/kernel/ntt.cpp`); this
measures the highest-level evaluator op built on it.
"""

import sys

sys.path.insert(0, ".")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from agilex_ntt.schemes import CKKSContext  # noqa: E402
from agilex_ntt.schemes.ckks import Ciphertext  # noqa: E402
from agilex_ntt.utils.profiling import device_time  # noqa: E402

N = 4096
L = 5
B = 64
DEG = 7
COEFFS = [0.1, -0.4, 0.3, 0.2, -0.15, 0.1, 0.05, -0.08]

rng = np.random.default_rng(17)
ctx = CKKSContext(N, num_primes=L, rng=rng)
keys = ctx.keygen()
z = rng.uniform(-0.8, 0.8, (B, N // 2)) + 0j
ct = ctx.encrypt(ctx.encode(z), keys)


def fn(v):
    out = ctx.poly_eval(
        Ciphertext(v, ct.c1, ct.level, ct.scale), COEFFS, keys
    )
    pad = jnp.zeros(
        (ctx.L - out.level,) + out.c0.shape[1:], jnp.uint32
    )
    return jnp.concatenate([out.c0.astype(jnp.uint32), pad], axis=0)


# correctness gate before timing (golden slotwise oracle)
got = ctx.decode(ctx.decrypt(ctx.poly_eval(ct, COEFFS, keys), keys))
want = np.zeros_like(z)
for c in reversed(COEFFS):
    want = want * z + c
err = float(np.abs(got - want).max())
assert err < 5e-2, err

t = min(device_time(fn, ct.c0, iters=8) for _ in range(3))
print(
    f"poly_eval deg={DEG} (BSGS PS, 4 ct-mults): n={N}, L={L}, "
    f"batch={B}: {t * 1e3:.3f} ms/call, {B / t:.1f} evals/s "
    f"(max slot err {err:.2e})",
    flush=True,
)
