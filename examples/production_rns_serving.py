"""Production serving shape: RNS polynomial arithmetic over a device mesh.

The deployment pattern this framework targets (an FHE-style workload): L
prime channels of (batch, n) polynomials, with the prime-channel axis
sharded over one mesh axis (channel parallelism — channels are fully
independent, like experts) and the batch over another (data parallelism —
the reference's frame round-robin, /root/reference/src/kernel/ntt.cpp:526-595).

Runs anywhere: on a host with several GPUs the mesh spans the cards; with
JAX_PLATFORMS=cpu it runs on 8 virtual CPU devices (same code, same
shardings — the FPGA-emulator analog).  Run: python examples/production_rns_serving.py
"""

import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))

import jax

# with JAX_PLATFORMS=cpu, emulate an 8-device mesh on the host
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import jax.numpy as jnp

from agilex_ntt import RNSRing
from agilex_ntt.parallel import ShardedRNSRing, make_mesh


def main():
    n, L, batch = 4096, 4, 64

    # the transform runs the GPU kernel on a GPU, the plain XLA chains on
    # the CPU; the oracle checks the sharded ops against one device
    rns = RNSRing(n, num_primes=L)
    oracle = RNSRing(n, num_primes=L)

    if len(jax.devices()) >= 8:
        mesh = make_mesh(ch=4, dp=2)
        srns = ShardedRNSRing(rns, mesh, dp_axis="dp", ch_axis="ch")
        print(f"mesh: ch=4 x dp=2 over {len(jax.devices())} devices")
    else:
        mesh = make_mesh(dp=len(jax.devices()))
        srns = ShardedRNSRing(rns, mesh, dp_axis="dp")
        print(f"mesh: dp={len(jax.devices())}")

    rng = np.random.default_rng(0)
    a = np.stack(
        [rng.integers(0, r.q, size=(batch, n), dtype=np.uint32)
         for r in rns.rings]
    )
    b = np.stack(
        [rng.integers(0, r.q, size=(batch, n), dtype=np.uint32)
         for r in rns.rings]
    )

    # ciphertext-style multiply: one fused kernel per device shard
    c = np.asarray(srns.polymul(srns.shard(jnp.asarray(a)),
                                srns.shard(jnp.asarray(b))))
    want = np.asarray(oracle.polymul(a, b))
    assert (c == want).all(), "sharded RNS polymul mismatch"
    print(f"sharded RNS polymul OK: L={L}, n={n}, batch={batch}, "
          "bit-exact vs single-host")

    # remainder-frame batch (the reference's miniBatchSize+1 capability)
    a_odd = a[:, : batch - 3]
    y = np.asarray(srns.ntt(jnp.asarray(a_odd)))
    assert (y == np.asarray(oracle.ntt(a_odd))).all()
    print(f"remainder batch OK: {batch - 3} frames over the dp axis")


if __name__ == "__main__":
    main()
