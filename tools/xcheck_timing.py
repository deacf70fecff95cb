#!/usr/bin/env python
"""Profiled-vs-delta timing cross-check on a GPU.

Runs ``utils.profiling.device_time_profiled`` (trace ground truth) and
``utils.profiling.device_time`` (wall-clock delta estimator) on:

  1. a SINGLE-executable path — radix-2 fwd NTT, n=4096, batch=8192 —
     where the round-3 nested-event bug double-counted (module event +
     same-span op event), and
  2. a MULTI-executable path — Ring.fwd at n=2^20 (two kernel passes,
     transposes and the twiddle scale) — where a dominant-name-only
     accounting would undercount.

Prints one JSON line per case with the profiled/delta ratio; PASS means
within 5%.  Reference analog: none — /root/reference has no runtime timing
at all.
"""

import json
import os
import sys

import jax
import jax.numpy as jnp

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

from agilex_ntt.api import Ring  # noqa: E402
from agilex_ntt.params import find_primes  # noqa: E402
from agilex_ntt.utils.profiling import (  # noqa: E402
    device_time,
    device_time_profiled,
)


def case(name, n, batch, iters):
    ring = Ring(n, find_primes(n, 1)[0])
    x = jax.random.randint(
        jax.random.PRNGKey(0), (batch, n), 0, ring.params.q, dtype=jnp.uint32
    )
    step = ring.ntt
    prof = device_time_profiled(step, x, iters=iters)
    # 5 delta trials: the estimator's residual bias is one-sided (a stalled
    # baseline sample deflates it), so more trials tighten it toward truth.
    delta = device_time(step, x, iters=iters, trials=5)
    ratio = None if prof is None else prof / delta
    ok = ratio is not None and abs(ratio - 1.0) <= 0.05
    print(
        json.dumps(
            {
                "case": name,
                "n": n,
                "batch": batch,
                "profiled_ms": None if prof is None else round(prof * 1e3, 4),
                "delta_ms": round(delta * 1e3, 4),
                "ratio": None if ratio is None else round(ratio, 4),
                "ntts_per_s": None if prof is None else round(batch / prof, 1),
                "pass": ok,
            }
        )
    )
    return ok


def main():
    if jax.devices()[0].platform != "gpu":
        print(json.dumps({"error": "not on a GPU; the cross-check needs one"}))
        return 1
    ok1 = case("radix2 fwd (single executable)", 4096, 8192, iters=10)
    ok2 = case("fourstep fwd (multi executable)", 1 << 20, 128, iters=8)
    return 0 if (ok1 and ok2) else 2


if __name__ == "__main__":
    sys.exit(main())
