#!/usr/bin/env python
"""Headline benchmark: forward NTTs/s on one GPU, n=4096, 30-bit prime.

Prints ONE JSON line: {"metric": ..., "value": N, "unit": ..., "vs_baseline":
N, "device": {...}, "card": "<nvidia-smi name, power limit>"}.  Needs an
NVIDIA GPU; anywhere else it exits non-zero without a result.

Baseline derivation (the reference publishes no numbers — BASELINE.md):
the FPGA hot loop retires VEC=8 butterflies/cycle at II=1
(/root/reference/src/kernel/ntt.cpp:14-16,155-158), i.e.
log2(n) * n / (2*VEC) = 12 * 4096 / 16 = 3072 cycles per n=4096 frame; at the
~400 MHz Agilex clock that is ~130,208 NTTs/s per compute unit.

Timing: on-device kernel time from a jax.profiler trace of chained calls
(utils.profiling.device_time_profiled).
"""

import json
import subprocess
import sys

import jax
import jax.numpy as jnp

N = 4096
B = 8192
ITERS = 20
# 400 MHz / (log2(4096) * 4096 / (2*VEC=16)) cycles = 130,208 frames/s per CU
BASELINE_NTTS_PER_SEC = 400e6 / (12 * 4096 / 16)


def main() -> int:
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {dev.platform!r}",
              file=sys.stderr)
        return 2
    card = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()

    from agilex_ntt import Ring
    from agilex_ntt.utils.profiling import device_time_profiled

    ring = Ring(N)
    x = jax.random.randint(jax.random.PRNGKey(0), (B, N), 0, ring.q,
                           dtype=jnp.uint32)
    per_call = device_time_profiled(ring.ntt, x, iters=ITERS)
    if per_call is None:
        print("no device events in the profiler trace", file=sys.stderr)
        return 1
    ntts_per_sec = B / per_call
    print(json.dumps({
        "metric": f"NTTs/sec (n={N}, 30-bit prime, batch={B}, fwd)",
        "value": round(ntts_per_sec, 1),
        "unit": "NTT/s",
        "vs_baseline": round(ntts_per_sec / BASELINE_NTTS_PER_SEC, 2),
        "device": {"platform": dev.platform, "kind": dev.device_kind,
                   "count": len(jax.devices())},
        "card": card,
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
