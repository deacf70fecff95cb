#!/usr/bin/env python
"""Generate the SEAL-Embedded-style NTT known-answer-test battery.

The reference claims to "perform the NTT Tests taken from SEAL Embedded"
(/root/reference/README.md:13) but ships no vectors, no NTL harness, and an
empty test header (SURVEY.md §4).  This script actually produces that
battery: for each transform size, a seeded random polynomial, its forward
negacyclic NTT, and a polymul triple — computed by the native C core
(csrc/nttcore.c) and certified at generation time against the fully
independent big-int oracle (golden.naive_negacyclic_ntt, O(n^2) evaluation at
psi^(2*bitrev(k)+1)).

Output: tests/vectors/ntt_kat.npz  (regenerate with `python tools/gen_vectors.py`).
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

from agilex_ntt import golden as G
from agilex_ntt import native
from agilex_ntt.params import (
    bit_reverse,
    find_primes,
    make_params,
    primitive_root,
)

# full reference size menu (include/kernel/ntt.h:11-23) plus n=4096
SIZES = [32, 1024, 4096, 8192, 16384, 32768]
ORACLE_FULL = {32, 1024}   # big-int oracle over every output index
ORACLE_SPOT = 64           # spot indices for larger sizes

OUT = os.path.join(os.path.dirname(os.path.dirname(os.path.abspath(__file__))),
                   "tests", "vectors", "ntt_kat.npz")


def main():
    assert native.available(), "build the native core first: make native"
    rng = np.random.default_rng(0xCAFE)
    blobs = {}
    for n in SIZES:
        q = find_primes(n, 1)[0]
        pp = make_params(n, q)
        x = rng.integers(0, q, size=n, dtype=np.uint64)
        y = native.fwd_ntt(x[None, :], q, pp.roots, pp.precon64)[0]

        # certify against the independent big-int oracle
        if n in ORACLE_FULL:
            oracle = G.naive_negacyclic_ntt([int(v) for v in x], pp)
            assert [int(v) for v in y] == oracle, f"oracle mismatch at n={n}"
        else:
            from agilex_ntt.params import bit_reverse
            idxs = rng.choice(n, size=ORACLE_SPOT, replace=False)
            for k in idxs:
                e = 2 * bit_reverse(int(k), pp.log_n) + 1
                root = pow(pp.psi, e, q)
                acc, p = 0, 1
                for c in x:
                    acc = (acc + int(c) * p) % q
                    p = p * root % q
                assert acc == int(y[k]), f"spot oracle mismatch n={n} k={k}"

        # roundtrip certification
        back = native.inv_ntt(y[None, :], q, pp.inv_roots, pp.inv_precon64)[0]
        assert (back == x).all(), f"roundtrip failed at n={n}"

        # polymul triple (negacyclic convolution), certified for n=32
        a = rng.integers(0, q, size=n, dtype=np.uint64)
        b = rng.integers(0, q, size=n, dtype=np.uint64)
        fa = native.fwd_ntt(a[None, :], q, pp.roots, pp.precon64)
        fb = native.fwd_ntt(b[None, :], q, pp.roots, pp.precon64)
        fc = native.pointwise(fa, fb, q)
        c = native.inv_ntt(fc, q, pp.inv_roots, pp.inv_precon64)[0]
        if n == 32:
            want = G.negacyclic_convolution(a, b, q)
            assert [int(v) for v in c] == want

        blobs[f"n{n}_q"] = np.uint64(q)
        blobs[f"n{n}_psi"] = np.uint64(pp.psi)
        blobs[f"n{n}_input"] = x
        blobs[f"n{n}_ntt"] = y
        blobs[f"n{n}_pm_a"] = a
        blobs[f"n{n}_pm_b"] = b
        blobs[f"n{n}_pm_c"] = c
        print(f"n={n}: q={q} certified")

    # -- round-2 extensions (VERDICT round-1 item 7) --------------------------
    gen_fourstep_size(rng, blobs)
    gen_cyclic(rng, blobs)
    gen_automorphism(rng, blobs)
    gen_polydot(rng, blobs)

    # -- round-3 extensions (VERDICT round-2 items 5 and 7) ------------------
    gen_large_fourstep(rng, blobs)
    gen_wide(rng, blobs)

    # -- round-4 extension (VERDICT round-3 item 8) ---------------------------
    gen_keyswitch(rng, blobs)

    os.makedirs(os.path.dirname(OUT), exist_ok=True)
    np.savez_compressed(OUT, **blobs)
    print("wrote", OUT)


def _spot_oracle_negacyclic(x, y, pp, rng, spots=ORACLE_SPOT):
    """Certify `spots` random output indices of y = fwd(x) big-int."""
    q = pp.q
    idxs = rng.choice(pp.n, size=spots, replace=False)
    for k in idxs:
        e = 2 * bit_reverse(int(k), pp.log_n) + 1
        root = pow(pp.psi, e, q)
        acc, p = 0, 1
        for c in x:
            acc = (acc + int(c) * p) % q
            p = p * root % q
        assert acc == int(y[k]), f"spot oracle mismatch n={pp.n} k={k}"


def gen_fourstep_size(rng, blobs, n=65536):
    """One four-step-range size (beyond the reference's 32768 wall): forward
    vector + polymul triple, C-core generated, big-int spot-certified."""
    q = find_primes(n, 1)[0]
    pp = make_params(n, q)
    x = rng.integers(0, q, size=n, dtype=np.uint64)
    y = native.fwd_ntt(x[None, :], q, pp.roots, pp.precon64)[0]
    _spot_oracle_negacyclic(x, y, pp, rng)
    back = native.inv_ntt(y[None, :], q, pp.inv_roots, pp.inv_precon64)[0]
    assert (back == x).all(), f"roundtrip failed at n={n}"
    a = rng.integers(0, q, size=n, dtype=np.uint64)
    b = rng.integers(0, q, size=n, dtype=np.uint64)
    fa = native.fwd_ntt(a[None, :], q, pp.roots, pp.precon64)
    fb = native.fwd_ntt(b[None, :], q, pp.roots, pp.precon64)
    c = native.inv_ntt(native.pointwise(fa, fb, q), q,
                       pp.inv_roots, pp.inv_precon64)[0]
    blobs[f"n{n}_q"] = np.uint64(q)
    blobs[f"n{n}_psi"] = np.uint64(pp.psi)
    blobs[f"n{n}_input"] = x
    blobs[f"n{n}_ntt"] = y
    blobs[f"n{n}_pm_a"] = a
    blobs[f"n{n}_pm_b"] = b
    blobs[f"n{n}_pm_c"] = c
    print(f"n={n} (four-step range): q={q} certified")


def gen_large_fourstep(rng, blobs, sizes=((1 << 18, 32), (1 << 20, 16))):
    """Forward vectors for the remaining four-step sizes (2^18, 2^20).

    Same pipeline as gen_fourstep_size but forward-only and stored uint32
    (q < 2^30, so the values fit exactly) — the polymul triple would triple
    the committed bytes while the Ring polymul path at these sizes is the
    same fused kernel already KAT-pinned at 65536.  Spot counts shrink with
    size because each big-int spot evaluation is O(n) Python bignum work.
    """
    for n, spots in sizes:
        q = find_primes(n, 1)[0]
        pp = make_params(n, q)
        x = rng.integers(0, q, size=n, dtype=np.uint64)
        y = native.fwd_ntt(x[None, :], q, pp.roots, pp.precon64)[0]
        _spot_oracle_negacyclic(x, y, pp, rng, spots=spots)
        back = native.inv_ntt(y[None, :], q, pp.inv_roots, pp.inv_precon64)[0]
        assert (back == x).all(), f"roundtrip failed at n={n}"
        blobs[f"n{n}_q"] = np.uint64(q)
        blobs[f"n{n}_psi"] = np.uint64(pp.psi)
        blobs[f"n{n}_input"] = x.astype(np.uint32)
        blobs[f"n{n}_ntt"] = y.astype(np.uint32)
        print(f"n={n} (four-step range): q={q} certified ({spots} spots)")


def gen_wide(rng, blobs, n=1024, bits=(45, 62)):
    """Wide-modulus vectors (q up to the Harvey bound 2**62) — the
    reference's u64 word path (ntt.cpp:32-37, 346-363), served here by
    WideRing.  C-core generated, big-int spot-certified, plus a polymul
    triple certified by the big-int convolution."""
    for b in bits:
        q = find_primes(n, 1, bits=b)[0]
        pp = make_params(n, q)
        x = rng.integers(0, q, size=n, dtype=np.uint64)
        y = native.fwd_ntt(x[None, :], q, pp.roots, pp.precon64)[0]
        _spot_oracle_negacyclic(x, y, pp, rng)
        back = native.inv_ntt(y[None, :], q, pp.inv_roots, pp.inv_precon64)[0]
        assert (back == x).all(), f"wide roundtrip failed at q={q}"
        a = rng.integers(0, q, size=n, dtype=np.uint64)
        bb = rng.integers(0, q, size=n, dtype=np.uint64)
        fa = native.fwd_ntt(a[None, :], q, pp.roots, pp.precon64)
        fb = native.fwd_ntt(bb[None, :], q, pp.roots, pp.precon64)
        c = native.inv_ntt(native.pointwise(fa, fb, q), q,
                           pp.inv_roots, pp.inv_precon64)[0]
        # certify 8 coefficients of the product by direct big-int convolution
        for k in rng.choice(n, size=8, replace=False):
            acc = 0
            for i in range(n):
                j = (int(k) - i) % n
                sign = 1 if i + j == int(k) else -1
                acc = (acc + sign * int(a[i]) * int(bb[j])) % q
            assert acc == int(c[k]), f"wide polymul oracle mismatch q={q} k={k}"
        blobs[f"w{b}_q"] = np.uint64(q)
        blobs[f"w{b}_psi"] = np.uint64(pp.psi)
        blobs[f"w{b}_input"] = x
        blobs[f"w{b}_ntt"] = y
        blobs[f"w{b}_pm_a"] = a
        blobs[f"w{b}_pm_b"] = bb
        blobs[f"w{b}_pm_c"] = c
        print(f"wide n={n}: q={q} ({b}-bit) certified")


def gen_keyswitch(rng, blobs, n=4096, L=4, spec=2, dnum=2):
    """Keyswitch-pipeline KAT (round 4, VERDICT round-3 item 8): exact
    expected output of the one-call hybrid key-switch — gadget digits ->
    extended-basis polydot -> centered ModDown — at a production shape
    (n=4096, L=4 + 2 special primes, dnum=2).

    Oracle, fully independent of the JAX pipeline:
      * digits t_d = [x]_{Q_d} by exact big-int CRT over each prime group
        (the mathematical contract of gadget_decompose — the device path's
        float-corrected fast conversion must land on the same residues);
      * per-channel negacyclic convolutions t_d * ksk_d mod p_j through
        the native C core (itself big-int-certified above), with 4 output
        coefficients per channel re-derived by exact O(n) big-int dot;
      * ModDown = two exact centered divides on the big-int CRT composite.
    """
    from agilex_ntt.utils.crt import crt_compose

    qs_all = find_primes(n, L + spec)
    qs, ext_qs = qs_all[:L], qs_all
    Q = 1
    for q in qs:
        Q *= q
    # random big-int polynomial in [0, Q) via 30-bit chunks
    xb = np.zeros(n, dtype=object)
    for _ in range((Q.bit_length() + 29) // 30):
        xb = xb * (1 << 30) + rng.integers(0, 1 << 30, size=n).astype(object)
    xb %= Q
    x = np.stack([(xb % q).astype(np.uint32) for q in qs])
    ksk = np.stack([
        np.stack([rng.integers(0, q, size=n, dtype=np.uint32)
                  for q in ext_qs])
        for _ in range(dnum)
    ])
    # digits: groups of L/dnum primes each
    g = L // dnum
    ts = [crt_compose(x[d * g:(d + 1) * g], qs[d * g:(d + 1) * g])
          for d in range(dnum)]
    prod = np.zeros((len(ext_qs), n), dtype=object)
    spot_idx = rng.choice(n, size=4, replace=False)
    for j, p in enumerate(ext_qs):
        pp = make_params(n, p)
        for d in range(dnum):
            td = (ts[d] % p).astype(np.uint64)
            kd = ksk[d, j].astype(np.uint64)
            ft = native.fwd_ntt(td[None], p, pp.roots, pp.precon64)
            fk = native.fwd_ntt(kd[None], p, pp.roots, pp.precon64)
            conv = native.inv_ntt(
                native.pointwise(ft, fk, p), p, pp.inv_roots, pp.inv_precon64
            )[0]
            if j == 0:
                for k in spot_idx:  # exact big-int negacyclic spot check
                    acc = 0
                    for i in range(n):
                        jj = (int(k) - i) % n
                        sign = 1 if i + jj == int(k) else -1
                        acc = (acc + sign * int(td[i]) * int(kd[jj])) % p
                    assert acc == int(conv[k]), f"ks conv spot {k} p={p}"
            prod[j] = (prod[j] + conv.astype(object)) % p
    big = crt_compose(prod, ext_qs)
    for _ in range(spec):  # centered divide by each special prime
        p = ext_qs[len(ext_qs) - 1 - _]
        s = big % p
        s = np.where(s > p // 2, s - p, s)
        big = (big - s) // p
    out = np.stack([(big % q).astype(np.uint32) for q in qs])
    blobs["ks_qs"] = np.array(ext_qs, dtype=np.uint64)
    blobs["ks_L"] = np.int64(L)
    blobs["ks_dnum"] = np.int64(dnum)
    blobs["ks_x"] = x
    blobs["ks_ksk"] = ksk
    blobs["ks_out"] = out
    print(f"keyswitch n={n} L={L}+{spec} dnum={dnum}: certified")


def _cyclic_tables_u64(n, q, omega):
    """Cyclic stage tables in HEXL layout (make_cyclic_params mirrored at
    u64 width for the C core) + their inverses."""
    logn = n.bit_length() - 1
    roots = [1] * n
    for s in range(logn):
        m = 1 << s
        stride = n // (2 * m)
        for i in range(m):
            roots[m + i] = pow(omega, bit_reverse(i, s) * stride, q)
    iroots = [pow(w, q - 2, q) for w in roots]
    pre = [(w << 64) // q for w in roots]
    ipre = [(w << 64) // q for w in iroots]
    u64 = lambda v: np.array(v, dtype=np.uint64)
    return u64(roots), u64(pre), u64(iroots), u64(ipre)


def gen_cyclic(rng, blobs, sizes=(32, 1024)):
    """Cyclic-ring vectors: out[bitrev(k)] = A(omega^k), C-core generated
    with cyclic twiddle tables, certified against a naive big-int DFT."""
    for n in sizes:
        q = find_primes(n, 1)[0]
        g = primitive_root(q)
        omega = pow(g, (q - 1) // n, q)
        roots, pre, iroots, ipre = _cyclic_tables_u64(n, q, omega)
        x = rng.integers(0, q, size=n, dtype=np.uint64)
        y = native.fwd_ntt(x[None, :], q, roots, pre)[0]
        logn = n.bit_length() - 1
        idxs = range(n) if n <= 64 else rng.choice(n, ORACLE_SPOT, replace=False)
        for p in idxs:
            k = bit_reverse(int(p), logn)
            root = pow(omega, k, q)
            acc, pw = 0, 1
            for c in x:
                acc = (acc + int(c) * pw) % q
                pw = pw * root % q
            assert acc == int(y[p]), f"cyclic oracle mismatch n={n} slot={p}"
        back = native.inv_ntt(y[None, :], q, iroots, ipre)[0]
        assert (back == x).all(), f"cyclic roundtrip failed at n={n}"
        blobs[f"cyc{n}_q"] = np.uint64(q)
        blobs[f"cyc{n}_omega"] = np.uint64(omega)
        blobs[f"cyc{n}_input"] = x
        blobs[f"cyc{n}_ntt"] = y
        print(f"cyclic n={n}: q={q} omega={omega} certified")


def gen_automorphism(rng, blobs, n=1024, ks=(3, 5, 2047)):
    """Galois automorphism vectors tau_k: a(X) -> a(X^k) mod (X^n + 1),
    generated from first principles (big-int substitution), with the
    NTT-domain image via the already-certified C-core transform."""
    q = find_primes(n, 1)[0]
    pp = make_params(n, q)
    x = rng.integers(0, q, size=n, dtype=np.uint64)
    y = native.fwd_ntt(x[None, :], q, pp.roots, pp.precon64)[0]
    blobs["auto_q"] = np.uint64(q)
    blobs["auto_psi"] = np.uint64(pp.psi)
    blobs["auto_input"] = x
    blobs["auto_ntt"] = y
    for k in ks:
        out = [0] * n
        for j in range(n):
            e = (j * k) % (2 * n)
            if e < n:
                out[e] = (out[e] + int(x[j])) % q
            else:
                out[e - n] = (out[e - n] - int(x[j])) % q
        out = np.array(out, dtype=np.uint64)
        out_ntt = native.fwd_ntt(out[None, :], q, pp.roots, pp.precon64)[0]
        blobs[f"auto_k{k}_coeff"] = out
        blobs[f"auto_k{k}_ntt"] = out_ntt
    print(f"automorphism n={n}: ks={list(ks)} certified (big-int substitution)")


def gen_polydot(rng, blobs, n=1024, terms=3):
    """Inner-product vectors: c = sum_i a_i * b_i mod (X^n + 1, q),
    certified entirely by the O(k n^2) big-int convolution oracle."""
    q = find_primes(n, 1)[0]
    a = rng.integers(0, q, size=(terms, n), dtype=np.uint64)
    b = rng.integers(0, q, size=(terms, n), dtype=np.uint64)
    acc = [0] * n
    for i in range(terms):
        conv = G.negacyclic_convolution(a[i], b[i], q)
        acc = [(u + v) % q for u, v in zip(acc, conv)]
    blobs["pd_q"] = np.uint64(q)
    blobs["pd_a"] = a
    blobs["pd_b"] = b
    blobs["pd_c"] = np.array(acc, dtype=np.uint64)
    print(f"polydot n={n}: k={terms} certified (big-int convolutions)")


if __name__ == "__main__":
    main()
