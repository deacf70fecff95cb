#!/usr/bin/env python3
"""Bring-up check of the library's main path on NVIDIA GPUs.

Run from the repository root on a machine with a GPU:

    python chip_smoke.py              # one card: every single-card phase
    python chip_smoke.py --cards 4    # only the multi-card phase (4 cards)

Everything runs in one process, phases in order; a failed check raises and
the script exits non-zero.  Each phase drives the public entry points
(``Ring``, ``RNSRing``, ``CKKSContext``, ``ShardedRing``,
``ShardedRNSRing``) at full size with random data from a fixed seed and
compares against the repository's references: the host golden model
(``golden.py``), exact big-int arithmetic, the plain XLA transform
(``ops/xla_ntt.py``), or numpy on CKKS slot vectors; the suite's
card-only tests (``pytest -m gpu``) run last.  The last line of standard
output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import subprocess
import sys
import time

import numpy as np

SEED = 20261016


def log(msg: str) -> None:
    print(msg, flush=True)


def check(ok, what: str) -> None:
    if not bool(ok):
        raise AssertionError(f"check failed: {what}")
    log(f"  ok  {what}")


def card_name_and_power() -> str:
    """`nvidia-smi` name and power limit, read without touching JAX."""
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    ).stdout.strip()
    if not out:
        raise RuntimeError("nvidia-smi reported no GPU")
    return " | ".join(line.strip() for line in out.splitlines())


def timed(fn, *args, reps: int = 5, iters: int = 10) -> float:
    """Best-of-reps mean seconds per call, ended by block_until_ready."""
    fn(*args).block_until_ready()
    best = float("inf")
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(iters):
            out = fn(*args)
        out.block_until_ready()
        best = min(best, (time.perf_counter() - t0) / iters)
    return best


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------


def phase_device(jax, cards: int) -> dict:
    devs = jax.devices()
    d = devs[0]
    if d.platform != "gpu":
        raise SystemExit(
            f"chip_smoke needs a GPU; JAX found platform {d.platform!r}"
        )
    if len(devs) < cards:
        raise SystemExit(f"--cards {cards} needs {cards} GPUs, found "
                         f"{len(devs)}")
    log(f"[device] platform={d.platform} kind={d.device_kind} "
        f"count={len(devs)}")
    log(f"[device] nvidia-smi: {card_name_and_power()}")
    log(f"[device] compile cache: "
        f"{jax.config.jax_compilation_cache_dir or 'none'}")
    return {"platform": d.platform, "kind": d.device_kind,
            "count": len(devs)}


def _golden_polymul(G, a, b, params):
    fa = G.fwd_ntt_u64(a, params)
    fb = G.fwd_ntt_u64(b, params)
    pw = (fa * fb) % np.uint64(params.q)
    return G.inv_ntt_u64(pw, params).astype(np.uint32)


def phase_transform(n: int, batch: int, rows: int = 64) -> None:
    import jax
    import jax.numpy as jnp

    from agilex_ntt import Ring, golden as G

    log(f"[transform] Ring({n}) batch={batch}")
    r = Ring(n)
    ka, kb = jax.random.split(jax.random.PRNGKey(SEED + n))
    a = jax.random.randint(ka, (batch, n), 0, r.q, dtype=jnp.uint32)
    b = jax.random.randint(kb, (batch, n), 0, r.q, dtype=jnp.uint32)
    y = r.ntt(a)
    check(jnp.array_equal(r.intt(y), a), f"intt(ntt(x)) == x, {batch} rows")
    c = r.polymul(a, b)
    idx = np.sort(np.random.default_rng(SEED).choice(batch, rows, False))
    a_h, b_h = np.asarray(a[idx]), np.asarray(b[idx])
    want = G.fwd_ntt_u64(a_h.astype(np.uint64), r.params).astype(np.uint32)
    check(np.array_equal(np.asarray(y[idx]), want),
          f"ntt bit-exact vs golden.fwd_ntt_u64, {rows} rows")
    check(np.array_equal(np.asarray(c[idx]),
                         _golden_polymul(G, a_h.astype(np.uint64),
                                         b_h.astype(np.uint64), r.params)),
          f"polymul bit-exact vs golden fwd/inv, {rows} rows")


def _random_bigints(rng, modulus, shape):
    out = np.zeros(shape, dtype=object)
    for _ in range((modulus.bit_length() + 29) // 30):
        out = out * (1 << 30) + rng.integers(0, 1 << 30, size=shape).astype(
            object)
    return out % modulus


def phase_rns(n: int = 4096, L: int = 3, batch: int = 2048,
              rows: int = 16, ks_batch: int = 16, bc_batch: int = 64) -> None:
    import jax
    import jax.numpy as jnp

    from agilex_ntt import RNSRing, golden as G
    from agilex_ntt.ops import basechange
    from agilex_ntt.params import find_primes

    log(f"[rns] RNSRing({n}, num_primes={L}) batch={batch}")
    rns = RNSRing(n, num_primes=L)
    keys = jax.random.split(jax.random.PRNGKey(SEED + 1), 2 * L)
    a = jnp.stack([jax.random.randint(keys[i], (batch, n), 0, q,
                                      dtype=jnp.uint32)
                   for i, q in enumerate(rns.qs)])
    b = jnp.stack([jax.random.randint(keys[L + i], (batch, n), 0, q,
                                      dtype=jnp.uint32)
                   for i, q in enumerate(rns.qs)])
    y = rns.ntt(a)
    c = rns.polymul(a, b)
    idx = np.sort(np.random.default_rng(SEED).choice(batch, rows, False))
    for l, r in enumerate(rns.rings):
        a_h = np.asarray(a[l, idx]).astype(np.uint64)
        b_h = np.asarray(b[l, idx]).astype(np.uint64)
        check(np.array_equal(np.asarray(y[l, idx]),
                             G.fwd_ntt_u64(a_h, r.params).astype(np.uint32)),
              f"channel {l} ntt bit-exact vs golden, {rows} rows")
        check(np.array_equal(np.asarray(c[l, idx]),
                             _golden_polymul(G, a_h, b_h, r.params)),
              f"channel {l} polymul bit-exact vs golden, {rows} rows")
    check(jnp.array_equal(rns.intt(y), a), "rns intt(ntt(x)) == x")

    # one hybrid keyswitch, L = 3 + 1 special prime, dnum = 3, against the
    # composition of public ops the test-suite pins to big-int oracles
    primes = find_primes(n, L + 3)
    rq, ext = RNSRing(n, qs=primes[:L]), RNSRing(n, qs=primes[:L + 1])
    rng = np.random.default_rng(SEED + 2)
    x = np.stack([rng.integers(0, q, (ks_batch, n), dtype=np.uint32)
                  for q in rq.qs])
    ksk = np.stack([np.stack([rng.integers(0, q, n, dtype=np.uint32)
                              for q in ext.qs]) for _ in range(3)])
    got = rq.keyswitch(x, ksk, ext, 3)
    dig = jnp.moveaxis(rq.gadget_decompose(x, ext, 3), 0, -2)
    kb = jnp.broadcast_to(jnp.moveaxis(jnp.asarray(ksk), 0, -2)[:, None],
                          dig.shape)
    want = ext.mod_down(ext.polydot(dig, kb), count=1)
    check(jnp.array_equal(got, want),
          "keyswitch (L=3+1, dnum=3) == gadget_decompose -> polydot -> "
          "mod_down")

    # the float32 steps: base_convert(correction="float") and BFV
    # scale_round.  Each rounds a float32 estimate of an exact rational, so
    # it is exact wherever that rational is farther from the rounding
    # boundary than the documented float error (ops/basechange.py); the
    # compiler may contract the products into FMAs, which moves the
    # estimate inside that error only.  Checked on the card against exact
    # big-int arithmetic: bit-exact outside the band, and inside it within
    # the documented contract.
    src_qs, dst_qs = tuple(primes[:L]), tuple(primes[L + 1:L + 3])
    Q = 1
    for q in src_qs:
        Q *= q
    xb = _random_bigints(rng, Q, (bc_batch, n))
    res = np.stack([(xb % q).astype(np.uint32) for q in src_qs])
    out = np.asarray(RNSRing(n, qs=src_qs).base_convert(
        res, dst_qs, correction="float"))
    # e = floor(sum_l y_l / q_l) = e_true + x/Q: the floor flips only when
    # x/Q is within ~L^2 2^-23 of 0 or 1
    band = (xb * (1 << 18) < Q) | ((Q - xb) * (1 << 18) <= Q)
    for j, p in enumerate(dst_qs):
        exact = (xb % p).astype(np.uint32)
        check(np.array_equal(out[j][~band], exact[~band]),
              f"base_convert float -> p_{j} == big-int x mod p outside the "
              f"band, {bc_batch}x{n}")
        # inside the band the estimate of e may be off by one
        off_by_one = (((xb - Q) % p).astype(np.uint32) == out[j]) | (
            ((xb + Q) % p).astype(np.uint32) == out[j])
        check(np.all((out[j] == exact) | (band & off_by_one)),
              f"base_convert float -> p_{j}: in-band values are x or x -+ Q")
    log(f"  --  {int(band.sum())} of {xb.size} inputs in the band")

    t = find_primes(n, 1, bits=16)[0]
    aux = tuple(primes[L + 1:L + 3]) + (primes[L],)
    B = 1
    for p in aux:
        B *= p
    xb = _random_bigints(rng, Q * B, (bc_batch, n))
    x_src = np.stack([(xb % q).astype(np.uint32) for q in src_qs])
    x_dst = np.stack([(xb % p).astype(np.uint32) for p in aux])
    out = np.asarray(jax.jit(
        lambda s_, d_: basechange.scale_round(s_, d_, src_qs, aux, t)
    )(x_src, x_dst))
    # v = sum_l xt_l t / q_l = V / Q rounds to nearest; the float32 sum
    # is within 2^-5 of V / Q, so only |frac - 1/2| < 2^-4 can differ
    xts = [(x_src[l].astype(object) * pow(Q // q % q, -1, q)) % q
           for l, q in enumerate(src_qs)]
    V = sum(xts[l] * t * (Q // q) for l, q in enumerate(src_qs))
    band = np.abs(2 * (V % Q) - Q) * 8 < Q
    exact = (2 * t * xb + Q) // (2 * Q)
    offs = []
    for j, p in enumerate(aux):
        want = (exact % p).astype(np.uint32)
        check(np.array_equal(out[j][~band], want[~band]),
              f"scale_round -> p_{j} == big-int round(t*x/Q) outside the "
              f"band, {bc_batch}x{n}")
        off = (out[j].astype(object) - exact) % p
        off = np.where(off > p // 2, off - p, off)
        check(np.all(np.abs(off) <= 1), f"scale_round -> p_{j} within +-1")
        offs.append(off)
    check(all(np.array_equal(o, offs[0]) for o in offs),
          "scale_round offset identical in every channel (one integer)")
    log(f"  --  {int(band.sum())} of {xb.size} inputs in the band")


def phase_fourstep(n: int = 1 << 16, batch: int = 512, rows: int = 8):
    import jax
    import jax.numpy as jnp

    from agilex_ntt import Ring, golden as G

    log(f"[fourstep] Ring({n}) batch={batch}")
    r = Ring(n)
    check(r.method == "fourstep", f"Ring({n}) runs the four-step method")
    x = jax.random.randint(jax.random.PRNGKey(SEED + 3), (batch, n), 0, r.q,
                           dtype=jnp.uint32)
    y = r.ntt(x)
    idx = np.sort(np.random.default_rng(SEED).choice(batch, rows, False))
    want = G.fwd_ntt_u64(np.asarray(x[idx]).astype(np.uint64), r.params)
    check(np.array_equal(np.asarray(y[idx]), want.astype(np.uint32)),
          f"four-step ntt bit-exact vs golden, {rows} rows")
    check(jnp.array_equal(r.intt(y), x), f"intt(ntt(x)) == x, {batch} rows")


def phase_ckks(n: int = 1 << 15, L: int = 8, count: int = 4) -> None:
    """Bound: 1.5e-3 * n / 256.  The test-suite allows 1e-3 at n = 256.
    Every error term of this chain (fresh encryption, rescale rounding,
    the rotation's key switch at scale ~Delta^2 / q) grows linearly in n:
    the canonical embedding adds sqrt(n), a ternary key of weight ~2n/3
    another sqrt(n).  Measured on the CPU with L = 8: max slot error
    5.7e-4 at n = 1024 and 2.5e-3 at n = 4096.  So n = 2^15 should land
    near 2e-2 to 5e-2 against a bound of 0.19, while any real break
    decodes to errors of order 1."""
    bound = 1.5e-3 * n / 256
    from agilex_ntt.schemes import CKKSContext

    log(f"[ckks] CKKSContext({n}, num_primes={L}), {count} ciphertexts")
    ctx = CKKSContext(n, num_primes=L, rng=np.random.default_rng(SEED + 4))
    keys = ctx.keygen(galois_steps=(1,))
    rng = np.random.default_rng(SEED + 5)
    shape = (count, n // 2)
    z1 = rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
    z2 = rng.uniform(-1, 1, shape) + 1j * rng.uniform(-1, 1, shape)
    c1 = ctx.encrypt(ctx.encode(z1), keys)
    c2 = ctx.encrypt(ctx.encode(z2), keys)
    prod = ctx.rescale(ctx.multiply(c1, c2, keys))
    rot = ctx.rotate(prod, 1, keys)
    got = ctx.decode(ctx.decrypt(rot, keys))
    err = float(np.abs(got - np.roll(z1 * z2, -1, axis=-1)).max())
    log(f"  --  max slot error {err:.3e} (bound {bound:g})")
    check(got.shape == shape and np.isfinite(got).all(),
          f"decoded slots finite, shape {shape}")
    check(err < bound, "encrypt -> multiply -> rescale -> rotate(1) -> "
          "decrypt matches numpy")


def _plain_fourstep(x, plan):
    """The four-step transform with plain XLA passes (the A/B reference):
    the same composition as ``ops/fourstep.py`` over ``xla_ntt``."""
    import jax.numpy as jnp

    from agilex_ntt.ops import xla_ntt
    from agilex_ntt.ops.modmul import shoup_mulmod_lazy

    def pass_(v, params):
        qs, w, wp = xla_ntt.stacked_tables((params,))
        return xla_ntt.ntt(v[None], qs, w, wp)[0]

    b, n1, n2 = x.shape[0], plan.n1, plan.n2
    xc = x.reshape(b, n1, n2).transpose(0, 2, 1).reshape(b * n2, n1)
    m1 = pass_(xc, plan.col).reshape(b, n2, n1).transpose(0, 2, 1)
    m2 = shoup_mulmod_lazy(m1, jnp.asarray(plan.tw)[None],
                           jnp.asarray(plan.twp)[None], plan.q)
    return pass_(m2.reshape(b * n1, n2), plan.row).reshape(b, plan.n)


def phase_kernel_ab(card: str) -> None:
    """The radix-2 kernel against what XLA makes of the same stages."""
    import jax
    import jax.numpy as jnp

    from agilex_ntt import Ring
    from agilex_ntt.ops import ntt_kernel, xla_ntt

    log(f"[kernel A/B] card: {card}")
    n, batch = 4096, 8192
    r = Ring(n)
    x = jax.random.randint(jax.random.PRNGKey(SEED + 6), (1, batch, n), 0,
                           r.q, dtype=jnp.uint32)
    fq, fw, fwp = (jnp.asarray(t) for t in
                   xla_ntt.stacked_tables((r.params,)))
    iq, iw, iwp = (jnp.asarray(t) for t in
                   xla_ntt.stacked_tables((r.params,), True))
    check(ntt_kernel.on_gpu(), "the transform dispatches to the kernel")
    kern = {  # on a GPU the public transform is the kernel
        "fwd": jax.jit(lambda v: ntt_kernel.ntt(v, fq, fw, fwp)),
        "inv": jax.jit(lambda v: ntt_kernel.intt(v, iq, iw, iwp)),
    }
    plain = {
        "fwd": jax.jit(lambda v: xla_ntt.ntt(v, fq, fw, fwp)),
        "inv": jax.jit(lambda v: xla_ntt.intt(v, iq, iw, iwp)),
    }
    y = plain["fwd"](x)
    check(jnp.array_equal(kern["fwd"](x), y), "kernel fwd == plain XLA fwd")
    check(jnp.array_equal(kern["inv"](y), plain["inv"](y)),
          "kernel inv == plain XLA inv")
    for d, v in (("fwd", x), ("inv", y)):
        tk, tp = timed(kern[d], v), timed(plain[d], v)
        log(f"  --  n={n} b={batch} {d}: kernel {tk * 1e3:.4f} ms, plain "
            f"XLA {tp * 1e3:.4f} ms ({tp / tk:.2f}x) [{card}]")

    n, batch = 1 << 16, 512
    r = Ring(n)
    x = jax.random.randint(jax.random.PRNGKey(SEED + 7), (batch, n), 0, r.q,
                           dtype=jnp.uint32)
    kern4 = jax.jit(r.ntt)
    plain4 = jax.jit(lambda v: _plain_fourstep(v, r.plan))
    check(jnp.array_equal(kern4(x), plain4(x)),
          "four-step with kernel passes == with plain XLA passes")
    tk, tp = timed(kern4, x), timed(plain4, x)
    log(f"  --  n=2^16 b={batch} four-step fwd: kernel passes "
        f"{tk * 1e3:.4f} ms, plain XLA passes {tp * 1e3:.4f} ms "
        f"({tp / tk:.2f}x) [{card}]")


def phase_trace(out_dir=None) -> None:
    """The trace parser on a small profiler trace of the card (kept in
    ``out_dir`` when given: tests/fixtures/ holds one, reduced to its
    device events)."""
    import jax
    import jax.numpy as jnp

    from agilex_ntt import Ring
    from agilex_ntt.utils.profiling import device_time_profiled

    r = Ring(256)
    x = jax.random.randint(jax.random.PRNGKey(SEED), (64, 256), 0, r.q,
                           dtype=jnp.uint32)
    if out_dir:
        os.makedirs(out_dir, exist_ok=True)
    t = device_time_profiled(r.ntt, x, iters=4, log_dir=out_dir)
    log(f"[trace] Ring(256) ntt, 64 rows: {t} s per call from the device "
        "trace")
    check(t is not None and t > 0, "trace parser finds the device events")


def phase_gpu_tests() -> None:
    """The suite's card-only tests (marker ``gpu``), in this process."""
    import pytest

    class Count:
        passed = 0

        def pytest_runtest_logreport(self, report):
            if report.when == "call" and report.passed:
                Count.passed += 1

    root = os.path.dirname(os.path.abspath(__file__))
    log("[gpu tests] pytest -m gpu tests/test_gpu.py")
    rc = pytest.main(
        ["-q", "--noconftest", "-p", "no:cacheprovider", "-m", "gpu",
         os.path.join(root, "tests", "test_gpu.py")],
        plugins=[Count()],
    )
    check(rc == 0 and Count.passed > 0,
          f"card-only tests: exit {int(rc)}, {Count.passed} passed")


def phase_cards(jax, cards: int, n: int = 4096, batch: int = 8192,
                big_n: int = 1 << 16, big_batch: int = 512,
                rns_batch: int = 2048) -> None:
    """dp, sp (four-step and stage) and ch on `cards` GPUs, each compared
    bit for bit with the same op on one card."""
    import jax.numpy as jnp

    from agilex_ntt import Ring, RNSRing
    from agilex_ntt.params import find_primes
    from agilex_ntt.parallel.mesh import (
        ShardedRing, ShardedRNSRing, make_mesh,
    )

    dev0 = jax.devices()[0]

    def on_one(v):
        return jax.device_put(v, dev0)

    def spread(y, what):
        devs = {s.device for s in y.addressable_shards}
        check(len(devs) == cards, f"{what}: result spread over {len(devs)} "
              f"cards")

    log(f"[cards] dp={cards}: Ring({n}) batch {cards}x{batch}")
    r = Ring(n)
    x = jax.random.randint(jax.random.PRNGKey(SEED + 8), (cards * batch, n),
                           0, r.q, dtype=jnp.uint32)
    sr = ShardedRing(r, make_mesh(dp=cards), dp_axis="dp")
    y = sr.ntt(sr.shard(x))
    spread(y, "dp ntt")
    check(jnp.array_equal(on_one(y), r.ntt(on_one(x))),
          "dp ntt == one-card ntt")
    check(jnp.array_equal(on_one(sr.intt(y)), on_one(x)),
          "dp intt(ntt(x)) == x")

    r = Ring(big_n)
    x = jax.random.randint(jax.random.PRNGKey(SEED + 9), (big_batch, big_n),
                           0, r.q, dtype=jnp.uint32)
    want = r.ntt(on_one(x))
    for method in ("fourstep", "stage"):
        log(f"[cards] sp={cards} {method}: Ring({big_n}) batch "
            f"{big_batch}")
        sr = ShardedRing(r, make_mesh(sp=cards), dp_axis=None, sp_axis="sp",
                         sp_method=method)
        y = sr.ntt(sr.shard(x))
        spread(y, f"sp {method} ntt")
        check(jnp.array_equal(on_one(y), want),
              f"sp {method} ntt == one-card ntt")
        check(jnp.array_equal(on_one(sr.intt(y)), on_one(x)),
              f"sp {method} intt(ntt(x)) == x")

    log(f"[cards] ch={cards}: RNSRing({n}, num_primes={cards}) batch "
        f"{rns_batch}")
    rns = RNSRing(n, num_primes=cards)
    keys = jax.random.split(jax.random.PRNGKey(SEED + 10), 2 * cards)
    a = jnp.stack([jax.random.randint(keys[i], (rns_batch, n), 0, q,
                                      dtype=jnp.uint32)
                   for i, q in enumerate(rns.qs)])
    b = jnp.stack([jax.random.randint(keys[cards + i], (rns_batch, n), 0, q,
                                      dtype=jnp.uint32)
                   for i, q in enumerate(rns.qs)])
    srn = ShardedRNSRing(rns, make_mesh(ch=cards, dp=1), dp_axis="dp",
                         ch_axis="ch")
    y = srn.ntt(srn.shard(a))
    spread(y, "ch ntt")
    check(jnp.array_equal(on_one(y), rns.ntt(on_one(a))),
          "ch ntt == one-card RNS ntt")
    c = srn.polymul(srn.shard(a), srn.shard(b))
    check(jnp.array_equal(on_one(c), rns.polymul(on_one(a), on_one(b))),
          "ch polymul == one-card RNS polymul")
    primes = find_primes(n, cards + 1)
    ext = RNSRing(n, qs=primes)
    rng = np.random.default_rng(SEED + 11)
    ksk = np.stack([np.stack([rng.integers(0, q, n, dtype=np.uint32)
                              for q in ext.qs]) for _ in range(2)])
    xs = a[:, :64]
    got = srn.keyswitch(srn.shard(xs), ksk, ext, 2)
    check(jnp.array_equal(on_one(got), rns.keyswitch(on_one(xs), ksk, ext, 2)),
          f"sharded keyswitch (L={cards}+1, dnum=2) == one-card keyswitch")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--cards", type=int, default=1,
                    help="run only the multi-card phase on this many GPUs")
    args = ap.parse_args(argv)

    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import jax

    device = phase_device(jax, args.cards)
    import agilex_ntt  # noqa: F401  (fails outside the repository)

    t0 = time.perf_counter()
    if args.cards > 1:
        phase_cards(jax, args.cards)
    else:
        card = card_name_and_power()
        phase_transform(4096, 8192)
        phase_transform(8192, 8192)
        phase_rns()
        phase_fourstep()
        phase_ckks()
        phase_kernel_ab(card)
        phase_trace()
        phase_gpu_tests()
    log(f"[done] all phases passed in {time.perf_counter() - t0:.1f} s; "
        f"card: {card_name_and_power()}")
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
