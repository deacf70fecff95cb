#!/usr/bin/env python
"""Throughput sweep across transform sizes (one JSON line per n).

Covers the reference's whole size menu (32...32768, ntt.h:11-23) plus the
beyond-reference four-step sizes. Batch is scaled so each point moves a
comparable amount of data; vs_baseline is the derived FPGA NTT/s for that
size where the comparison is meaningful (single-CU, VEC=8, II=1, ~400 MHz).
"""

import json
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from agilex_ntt import Ring  # noqa: E402
from agilex_ntt.utils.profiling import (  # noqa: E402
    device_time,
    device_time_profiled,
)

TOTAL_ELEMS = 1 << 25  # ~128 MiB of uint32 per point


def main():
    on_gpu = jax.default_backend() == "gpu"
    sizes = [32, 1024, 4096, 8192, 16384, 32768, 1 << 16, 1 << 18, 1 << 20]
    if not on_gpu:
        sizes = [s for s in sizes if s <= 4096]
    key = jax.random.PRNGKey(0)
    for n in sizes:
        b = max(8, (TOTAL_ELEMS if on_gpu else 1 << 16) // n)
        r = Ring(n)
        x = jax.random.randint(key, (b, n), 0, r.q, dtype=jnp.uint32)
        # device time from a profiler trace where available (GPU); the
        # wall-clock delta estimator otherwise
        t = device_time_profiled(lambda v: r.ntt(v), x, iters=6)
        if t is None:
            t = min(
                device_time(lambda v: r.ntt(v), x, iters=10 if on_gpu else 2)
                for _ in range(3)
            )
        logn = n.bit_length() - 1
        fpga = 400e6 / (logn * n / 16) if n <= 32768 else None
        # flush per row: a timeout SIGTERM must not swallow completed rows
        print(json.dumps({
            "metric": f"fwd NTT/s (n={n}, batch={b}, {r.method})",
            "value": round(b / t, 1),
            "unit": "NTT/s",
            "vs_baseline": round(b / t / fpga, 1) if fpga else None,
        }), flush=True)


if __name__ == "__main__":
    main()
