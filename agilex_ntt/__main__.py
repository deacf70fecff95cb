"""Smoke driver: `python -m agilex_ntt [n] [batch]`.

The runnable analog of the reference host driver (``/root/reference/src/
main.cpp:14-89``) — done right: where the reference feeds dummy twiddles
(``i+2``/``i+3``, modulus 65537; main.cpp:49-55) and prints raw output with
no verification, this driver builds a real ring, runs forward/inverse NTT
and a negacyclic polymul on the detected backend, and checks the results
against the host golden model before printing a summary.
"""

import sys
import time

import numpy as np


def main(argv=None):
    argv = argv if argv is not None else sys.argv[1:]
    n = int(argv[0]) if len(argv) > 0 else 4096
    batch = int(argv[1]) if len(argv) > 1 else 8

    import jax

    from . import Ring, golden as G

    dev = jax.devices()[0]
    ring = Ring(n)
    print(f"device  : {dev.platform} ({dev.device_kind})")
    print(f"ring    : {ring}")

    rng = np.random.default_rng(0)
    a = rng.integers(0, ring.q, size=(batch, n), dtype=np.uint32)
    b = rng.integers(0, ring.q, size=(batch, n), dtype=np.uint32)

    t0 = time.perf_counter()
    ya = np.asarray(ring.ntt(a))
    t_fwd = time.perf_counter() - t0
    back = np.asarray(ring.intt(ya))
    prod = np.asarray(ring.polymul(a, b))

    checks = {"intt(ntt(a)) == a": bool((back == a).all())}
    if n <= 1 << 16:
        want_fwd = G.fwd_ntt_u64(a, ring.params).astype(np.uint32)
        checks["ntt(a) bit-exact vs golden"] = bool((ya == want_fwd).all())
        fa = want_fwd.astype(np.uint64)
        fb = G.fwd_ntt_u64(b, ring.params)
        pw = ((fa * fb) % np.uint64(ring.q)).astype(np.uint32)
        want_prod = G.inv_ntt_u64(pw, ring.params).astype(np.uint32)
        checks["polymul bit-exact vs golden"] = bool((prod == want_prod).all())

    for name, ok in checks.items():
        print(f"check   : {name:32s} {'OK' if ok else 'FAIL'}")
    print(f"timing  : first fwd call (incl. compile) {t_fwd*1e3:.1f} ms")
    if not all(checks.values()):
        sys.exit(1)
    print(f"all checks passed (n={n}, q={ring.q}, batch={batch})")


if __name__ == "__main__":
    main()
