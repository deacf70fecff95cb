#!/usr/bin/env python
"""Extended benchmark suite: one JSON line per metric (bench.py's shape).

Covers the workloads beyond the headline single-size bench: polymul (the
flagship composite op), large-N four-step transforms, RNS multi-prime, and
the inverse transform.  Baselines, where they exist, are derived from the
reference FPGA's design parameters the same way bench.py derives its
headline (VEC=8 butterflies/cycle at II=1, ~400 MHz:
/root/reference/src/kernel/ntt.cpp:14-16,155-158); ops with no FPGA analog
report vs_baseline null.
"""

import json
import sys
import time

import jax
import jax.numpy as jnp

sys.path.insert(0, ".")

from agilex_ntt import Ring, RNSRing  # noqa: E402
from agilex_ntt.utils.profiling import (  # noqa: E402
    device_time,
    device_time_profiled,
)


def fpga_ntts_per_sec(n: int) -> float:
    logn = n.bit_length() - 1
    return 400e6 / (logn * n / 16)


def best(fn, x, iters, trials=3):
    # device time from a profiler trace where available (GPU); the
    # wall-clock delta estimator otherwise
    t = device_time_profiled(fn, x, iters=min(iters, 8))
    if t is not None:
        return t
    return min(device_time(fn, x, iters=iters) for _ in range(trials))


def hb(msg):
    # stderr heartbeat: locates a hang without polluting the JSON stdout
    # stream
    print(f"# {time.strftime('%H:%M:%S')} {msg}", file=sys.stderr, flush=True)


def line(metric, value, unit, vs=None):
    # flush per row: a timeout SIGTERM must not swallow completed rows
    print(json.dumps({
        "metric": metric, "value": value, "unit": unit, "vs_baseline": vs,
    }), flush=True)


def main():
    on_gpu = jax.default_backend() == "gpu"
    hb("devices up")
    key = jax.random.PRNGKey(0)

    # forward + inverse + polymul at the headline size
    n, B = 4096, 8192 if on_gpu else 64
    iters = 20 if on_gpu else 2
    r = Ring(n)
    x = jax.random.randint(key, (B, n), 0, r.q, dtype=jnp.uint32)
    hb("first measurement starting (fwd n=4096)")
    t = best(lambda v: r.ntt(v), x, iters)
    line(f"fwd NTT/s (n={n}, batch={B})", round(B / t, 1), "NTT/s",
         round(B / t / fpga_ntts_per_sec(n), 2))
    t = best(lambda v: r.intt(v), x, iters)
    line(f"inv NTT/s (n={n}, batch={B})", round(B / t, 1), "NTT/s", None)
    t = best(lambda v: r.polymul(v, v), x, max(4, iters // 2))
    line(f"polymul/s (n={n}, batch={B})", round(B / t, 1), "polymul/s", None)

    hb("headline section done; large-N next")
    # large-N four-step (beyond the reference's 32768 ceiling), flat and
    # tiled-domain (the chained-pipeline rate: no per-op rank-2<->3 relayout)
    for ln, lb in ((16, 512), (20, 32)):
        if not on_gpu and ln > 16:
            continue
        nn, bb = 1 << ln, lb if on_gpu else 4
        rr = Ring(nn)
        xx = jax.random.randint(key, (bb, nn), 0, rr.q, dtype=jnp.uint32)
        t = best(lambda v: rr.ntt(v), xx, 10 if on_gpu else 1)
        line(f"fwd NTT/s (n=2^{ln}, batch={bb}, four-step)",
             round(bb / t, 1), "NTT/s", None)
        xt = rr.to_tiled(xx)
        t = best(lambda v: rr.ntt_tiled(v), xt, 10 if on_gpu else 1)
        line(f"fwd NTT/s (n=2^{ln}, batch={bb}, tiled-domain)",
             round(bb / t, 1), "NTT/s", None)

    hb("keyswitch section next")
    # key-switch-style fused inner product
    kd = 3
    xd = jax.random.randint(key, (B // 8, kd, n), 0, r.q, dtype=jnp.uint32)
    t = best(lambda v: jnp.broadcast_to(
        r.polydot(v, v)[:, None, :], v.shape).astype(jnp.uint32), xd,
        max(4, iters // 2))
    line(f"polydot/s (k={kd}, n={n}, batch={B // 8})",
         round(B // 8 / t, 1), "dot/s", None)

    # one-call hybrid keyswitch (digits -> extended polydot -> ModDown):
    # the FHE serving inner loop, end to end
    import numpy as np

    from agilex_ntt.params import find_primes

    ks_n = 4096 if on_gpu else 256  # CPU XLA compile of the full fused
    ks_b, dnum = (512, 3) if on_gpu else (8, 3)  # graph at 4096 is minutes
    ks_qs = find_primes(ks_n, 4)
    rq = RNSRing(ks_n, qs=ks_qs[:3])
    rqp = RNSRing(ks_n, qs=ks_qs)
    rngk = np.random.default_rng(0)
    ksk = jnp.asarray(np.stack(
        [np.stack([rngk.integers(0, q, size=ks_n, dtype=np.uint32)
                   for q in ks_qs]) for _ in range(dnum)]
    ))
    xk = jax.random.randint(
        key, (3, ks_b, ks_n), 0, min(rq.qs), dtype=jnp.uint32
    )
    t = best(lambda v: rq.keyswitch(v, ksk, rqp, dnum), xk,
             max(4, iters // 2))
    line(f"keyswitch/s (L=3+1, dnum={dnum}, n={ks_n}, batch={ks_b})",
         round(ks_b / t, 1), "keyswitch/s", None)

    # hoisted rotation batch: one decomposition + one digit transform
    # shared by nk Galois steps (the BSGS matvec inner loop); report the
    # per-rotation rate next to nk separate keyswitch calls
    nk = 8 if on_gpu else 2
    hks = (tuple(range(3, 3 + 2 * nk, 2)))
    ksks = jnp.asarray(np.stack([np.asarray(ksk)] * nk))
    hk_b = ks_b // 4 if on_gpu else ks_b
    xh = xk[:, :hk_b]
    t = best(
        lambda v: rq.hoisted_keyswitch(v, ksks, hks, rqp, dnum)[0]
        .astype(jnp.uint32),
        xh, max(4, iters // 4),
    )
    line(f"hoisted rotations/s (nk={nk}, dnum={dnum}, n={ks_n}, "
         f"batch={hk_b})", round(nk * hk_b / t, 1), "rotation/s", None)
    t = best(lambda v: rq.keyswitch(v, ksk, rqp, dnum), xh,
             max(4, iters // 4))
    line(f"unhoisted rotations/s (nk={nk}, dnum={dnum}, n={ks_n}, "
         f"batch={hk_b})", round(hk_b / t, 1), "rotation/s", None)
    # serving configuration: keys pre-transformed once (ksk_to_ntt)
    ksks_ntt = rq.ksk_to_ntt(ksks, rqp, ch_axis=2)
    t = best(
        lambda v: rq.hoisted_keyswitch(
            v, ksks_ntt, hks, rqp, dnum, ksk_domain="ntt"
        )[0].astype(jnp.uint32),
        xh, max(4, iters // 4),
    )
    line(f"hoisted+nttkeys rotations/s (nk={nk}, dnum={dnum}, n={ks_n}, "
         f"batch={hk_b})", round(nk * hk_b / t, 1), "rotation/s", None)

    # fused BSGS linear transform vs its per-step composition: nk-term
    # sum_j pt_j (*) tau_kj(ct) with one decomposition + one deferred
    # ModDown (hoisted_linear_sum) against nk (keyswitch + polymul) calls
    pt = jnp.asarray(np.stack(
        [np.stack([rngk.integers(0, q, size=ks_n, dtype=np.uint32)
                   for q in ks_qs]) for _ in range(nk)]
    ))
    ptn = rq.ksk_to_ntt(pt, rqp, ch_axis=1)
    c0h, c1h = xh[:, : hk_b // 2], xh[:, hk_b // 2:][:, : hk_b // 2]
    lb = c0h.shape[1]
    t = best(
        lambda v: rq.hoisted_linear_sum(
            v, c1h, ptn, ksks_ntt, ksks_ntt, hks, rqp, dnum,
            ksk_domain="ntt", pt_domain="ntt",
        )[0].astype(jnp.uint32),
        c0h, max(4, iters // 4),
    )
    line(f"linear-transform terms/s fused (nk={nk}, dnum={dnum}, n={ks_n}, "
         f"batch={lb})", round(nk * lb / t, 1), "term/s", None)

    def _composed(v):
        acc0 = acc1 = None
        for j, kk in enumerate(hks):
            t1 = rq.automorphism(c1h, kk)
            h0 = rq.add(rq.automorphism(v, kk),
                        rq.keyswitch(t1, ksks_ntt[j], rqp, dnum,
                                     ksk_domain="ntt"))
            h1 = rq.keyswitch(t1, ksks_ntt[j], rqp, dnum, ksk_domain="ntt")
            pl = jnp.broadcast_to(pt[j][:rq.L][:, None], h0.shape)
            t0 = rq.polymul(pl, h0)
            t1m = rq.polymul(pl, h1)
            acc0 = t0 if acc0 is None else rq.add(acc0, t0)
            acc1 = t1m if acc1 is None else rq.add(acc1, t1m)
        return acc0
    t = best(_composed, c0h, max(2, iters // 8))
    line(f"linear-transform terms/s composed (nk={nk}, dnum={dnum}, "
         f"n={ks_n}, batch={lb})", round(nk * lb / t, 1), "term/s", None)

    hb("CKKS section next")
    # CKKS evaluator ops end to end (scheme layer over the fused kernels):
    # ciphertext multiply + hoisted relinearization, and rotation — the
    # serving ops an FHE deployment actually dispatches.  fn must be
    # shape-preserving for the delta timer, so the timed op excludes the
    # level-dropping rescale (cheap next to the keyswitch).
    from agilex_ntt.schemes import CKKSContext, Ciphertext

    ck_n = 4096 if on_gpu else 256
    ck_b = 256 if on_gpu else 2
    ctx = CKKSContext(ck_n, num_primes=3, rng=rngk)
    ckeys = ctx.keygen(galois_steps=(1,))
    zz = rngk.uniform(-1, 1, (ck_b, ck_n // 2)) + 0j
    cta = ctx.encrypt(ctx.encode(zz), ckeys)
    ctb = ctx.encrypt(ctx.encode(zz), ckeys)

    def _ck_mul(v):
        out = ctx.multiply(
            Ciphertext(v, cta.c1, cta.level, cta.scale), ctb, ckeys
        )
        return out.c0.astype(jnp.uint32)

    t = best(_ck_mul, cta.c0, max(4, iters // 4))
    line(f"CKKS multiply+relin/s (n={ck_n}, L=3, batch={ck_b})",
         round(ck_b / t, 1), "mult/s", None)

    def _ck_rot(v):
        out = ctx.rotate(
            Ciphertext(v, cta.c1, cta.level, cta.scale), 1, ckeys
        )
        return out.c0.astype(jnp.uint32)

    t = best(_ck_rot, cta.c0, max(4, iters // 4))
    line(f"CKKS rotate/s (n={ck_n}, L=3, batch={ck_b})",
         round(ck_b / t, 1), "rotation/s", None)

    hb("BSGS matvec next")
    # BSGS homomorphic matvec at a serving shape (VERDICT round-4 item 1):
    # full dense (n/2, n/2) complex matrix, L=3, hoisted baby steps —
    # b+g-2 keyswitches per apply instead of n/2-1
    mv_S = ck_n // 2
    Mx = rngk.uniform(-1, 1, (mv_S, mv_S)) + 1j * rngk.uniform(
        -1, 1, (mv_S, mv_S)
    )
    mv_keys = ctx.keygen(galois_steps=ctx.bsgs_steps())
    mv_op = ctx.make_matvec(Mx, mv_keys, ctx.L)
    mv_b = 32 if on_gpu else 2
    ctv = ctx.encrypt(ctx.encode(zz[:mv_b]), mv_keys)

    def _mv(v):
        out = ctx.apply_matvec(
            Ciphertext(v, ctv.c1, ctv.level, ctv.scale), mv_op
        )
        return out.c0.astype(jnp.uint32)

    t = best(_mv, ctv.c0, max(2, iters // 8))
    line(f"CKKS BSGS matvec/s ({mv_S}x{mv_S} dense M, n={ck_n}, L=3, "
         f"batch={mv_b}, bsgs={mv_op.b}x{mv_op.g})",
         round(mv_b / t, 1), "matvec/s", None)

    hb("RNS section next")
    # RNS: 3-prime channel throughput
    rb = 2048 if on_gpu else 16
    rns = RNSRing(4096, num_primes=3)
    xr = jax.random.randint(key, (3, rb, 4096), 0, min(rns.qs), dtype=jnp.uint32)
    t = best(lambda v: rns.ntt(v), xr, max(4, iters // 2))
    line(f"RNS channel-NTT/s (L=3, n=4096, batch={rb})",
         round(3 * rb / t, 1), "NTT/s", None)


if __name__ == "__main__":
    main()
