"""Key-switch-shaped RNS pipeline: raise -> NTT -> polydot -> lower.

The production FHE serving inner loop this framework targets, end to end:

  1. RAISE    residues from the ciphertext basis Q (L primes) into the
              extended basis Q u P via fast base conversion
              (``RNSRing.base_convert`` — the HPS float-corrected variant),
  2. DOT      a fused polynomial inner product against k key columns in
              the NTT domain on every extended-basis channel
              (``RNSRing.polydot`` — transforms, Montgomery pointwise
              accumulation, and the inverse all in one kernel per channel),
  3. LOWER    divide-and-round by the special prime back into Q
              (``RNSRing.rescale``).

Every step runs identically on a device mesh (channels over ch when the
configuration allows, batch over dp) and on one chip; the mesh result is
checked bit-exact against the single-chip pipeline, and the raise/lower
arithmetic against the big-int oracle.  Run:
python examples/keyswitch_pipeline.py
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
from agilex_ntt.params import find_primes
from agilex_ntt.parallel import ShardedRNSRing, make_mesh


def main():
    n, batch, k = 1024, 16, 3
    qs = find_primes(n, 4)           # ciphertext basis Q (3) + special p (1)
    q_basis, special = qs[:3], qs[3]
    rq = RNSRing(n, qs=q_basis)
    rqp = RNSRing(n, qs=q_basis + [special])

    rng = np.random.default_rng(0)
    ct = np.stack(
        [rng.integers(0, q, size=(batch, k, n), dtype=np.uint32)
         for q in q_basis], axis=0,
    )
    # key material lives in the EXTENDED basis (generated there, never
    # converted), shape (L+1, batch, k, n)
    keys = np.stack(
        [rng.integers(0, q, size=(batch, k, n), dtype=np.uint32)
         for q in rqp.qs], axis=0,
    )

    # -- single-chip reference run -------------------------------------------
    # 1. raise: Q -> Q u P.  The Q channels pass through untouched; only the
    # special channel is genuinely new (and exact under correction='float').
    special_res = rq.base_convert(
        ct.reshape(rq.L, -1, n), [special], correction="float"
    ).reshape(1, batch, k, n)
    ext = jnp.concatenate([jnp.asarray(ct), special_res], axis=0)
    dot = rqp.polydot(ext, jnp.asarray(keys))
    lowered = rqp.rescale(dot)
    print(f"single-chip: ct{ct.shape} -> ext{ext.shape} -> dot{dot.shape} "
          f"-> lowered{lowered.shape}")

    # -- the same pipeline over a mesh ---------------------------------------
    if len(jax.devices()) >= 4:
        mesh = make_mesh(dp=4)
        srq = ShardedRNSRing(rq, mesh, dp_axis="dp")
        srqp = ShardedRNSRing(rqp, mesh, dp_axis="dp")
        m_special = srq.base_convert(
            jnp.asarray(ct).reshape(rq.L, -1, n), [special],
            correction="float",
        ).reshape(1, batch, k, n)
        m_ext = jnp.concatenate([jnp.asarray(ct), m_special], axis=0)
        m_dot = srqp.polydot(srqp.shard(m_ext), srqp.shard(jnp.asarray(keys)))
        m_low = srqp.rescale(m_dot)
        assert (np.asarray(m_low) == np.asarray(lowered)).all(), (
            "mesh pipeline diverged from single-chip"
        )
        print(f"mesh (dp=4): bit-identical end to end")

    # -- hybrid variant: gadget digits feed polydot as the dot axis ----------
    # Real hybrid key-switching decomposes ct into dnum digits FIRST (noise
    # control), raises each digit into Q u P, and dots the digits against
    # per-digit key columns: digits become polydot's k axis directly.
    dnum = 3
    digits = rq.gadget_decompose(
        ct[:, :, 0, :], rqp, dnum, correction="float"
    )  # (dnum, L+1, batch, n)
    dig_k = jnp.transpose(jnp.asarray(digits), (1, 2, 0, 3))  # (L+1,B,dnum,n)
    ksk = np.stack(
        [rng.integers(0, q, size=(batch, dnum, n), dtype=np.uint32)
         for q in rqp.qs], axis=0,
    )
    ks_dot = rqp.polydot(dig_k, jnp.asarray(ksk))
    ks_out = rqp.rescale(ks_dot)
    print(f"hybrid (dnum={dnum}): digits{np.asarray(digits).shape} "
          f"-> dot{ks_dot.shape} -> lowered{ks_out.shape}")

    # ...or as the one-call production op (shared key material, (dnum,K,n)):
    ksk_shared = np.stack(
        [np.stack([rng.integers(0, q, size=n, dtype=np.uint32)
                   for q in rqp.qs]) for _ in range(dnum)]
    )
    one_call = rq.keyswitch(ct[:, :, 0, :], ksk_shared, rqp, dnum)
    print(f"RNSRing.keyswitch: {ct[:, :, 0, :].shape} -> {one_call.shape} "
          f"(digits -> polydot -> mod_down fused in one jit)")

    # -- hoisted rotation batch (Halevi-Shoup) -------------------------------
    # BSGS matrix-vector serving: ONE decomposition + ONE digit transform
    # shared by every Galois step; each step pays only an eval-domain slot
    # permutation + pointwise dot + inverse + ModDown.
    steps = (3, 5, 2 * n - 1)  # three rotation exponents
    ksks = np.stack([ksk_shared] * len(steps))  # per-step keys (same here)
    hoisted = rq.hoisted_keyswitch(ct[:, :, 0, :], ksks, steps, rqp, dnum)
    assert np.asarray(hoisted).shape == (len(steps), rq.L, batch, n)
    # step j must equal keyswitching the tau_j'd digits the slow way
    dig_ch = jnp.moveaxis(jnp.asarray(digits), 0, 1)
    tau = rqp.automorphism(dig_ch, steps[0])
    slow = rqp.mod_down(
        rqp.polydot(
            jnp.moveaxis(tau, 1, -2),
            jnp.broadcast_to(
                jnp.moveaxis(jnp.asarray(ksk_shared), 0, -2)[:, None],
                jnp.moveaxis(tau, 1, -2).shape,
            ),
        ),
        count=1,
    )
    assert (np.asarray(hoisted[0]) == np.asarray(slow)).all(), (
        "hoisted step 0 disagreed with the per-step composition"
    )
    print(f"hoisted_keyswitch: {len(steps)} rotations from one "
          f"decomposition -> {np.asarray(hoisted).shape}, step 0 bit-exact "
          f"vs the per-step composition")

    # -- big-int oracle for the raise/lower arithmetic -----------------------
    # raise is exact (correction='float'): the special-channel residues must
    # equal the CRT-composed ciphertext mod p
    composed = rq.from_rns(ct.reshape(rq.L, -1, n))
    expect = (composed % special).astype(np.uint32)
    assert (np.asarray(special_res).reshape(-1, n) == expect).all(), (
        "raise disagreed with the big-int oracle"
    )
    # lower: rescale(dot) == round(dot / p) in Q (centered subtraction)
    dot_big = rqp.from_rns(np.asarray(dot))
    s = dot_big % special
    s = np.where(s > special // 2, s - special, s)
    y = (dot_big - s) // special
    for l, q in enumerate(q_basis):
        assert (np.asarray(lowered)[l] == (y % q).astype(np.uint32)).all(), (
            f"lower channel {l} disagreed with the big-int oracle"
        )
    print("oracle: raise and lower both exact vs big-int CRT")


if __name__ == "__main__":
    main()
