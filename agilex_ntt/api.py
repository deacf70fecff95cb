"""Public batched API: rings, ntt/intt, negacyclic polynomial multiplication.

Replaces the reference's host driver + I/O kernels (components C6/C9/C10,
``/root/reference/src/main.cpp:14-89``, ``src/kernel/ntt.cpp:508-640``): frame
round-robin over compute units becomes jit batching over grid tiles; the SYCL
buffer/accessor plumbing becomes JAX device arrays; the broken
termination-signal protocol (C8, ntt.cpp:114-120 vs 597-603 — the producer
never sends a "go" message) needs no replacement at all, because jit dispatch
*is* the lifecycle.

Typical use::

    ring = Ring(4096)                      # 30-bit SEAL-Embedded-style prime
    y  = ring.ntt(x)                       # x: (..., 4096) uint32, values < q
    z  = ring.intt(y)
    c  = ring.polymul(a, b)                # negacyclic convolution mod q

    rns = RNSRing(4096, num_primes=3)      # CRT basis of 3 primes
    c_rns = rns.polymul(a_rns, b_rns)      # shapes (3, ..., 4096)
"""

from __future__ import annotations

from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from .config import NTTConfig
from .params import (
    CyclicParams,
    NTTParams,
    bit_reverse,
    find_primes,
    make_cyclic_params,
    make_params,
    primitive_root,
)
from .ops import fourstep, ntt_kernel
from .ops.modmul import U32, cond_sub, mont_mul_lazy, mont_qinv_neg, u32

# Above this size Ring switches to the four-step decomposition
# (ops/fourstep.py), whose two passes are radix-2 transforms of ~sqrt(n).
# 32768 is also the reference's hard ceiling (include/kernel/ntt.h:11-23) —
# everything beyond it is new capability.
MAX_RADIX2_N = 32768


def _as_u32(x) -> jnp.ndarray:
    # truncating cast; caller guarantees values < 2**32
    return jnp.asarray(x).astype(jnp.uint32)


class Ring:
    """The negacyclic polynomial ring R_q = Z_q[X] / (X^n + 1).

    Owns the precomputed parameters and runs its transforms through
    ``ops/ntt_kernel.py`` (the GPU kernel on a GPU, the plain XLA chains
    elsewhere; ``interpret=True`` runs the kernel in the Pallas
    interpreter, for tests without a GPU).  This is the runtime analog of
    the reference's compile-time (FPGA_NTT_SIZE, modulus) specialization (C11, ntt.cpp:20-24, main.cpp:9) — one Python object per
    ring instead of one bitstream per size.
    """

    def __init__(
        self,
        n: int,
        q: Optional[int] = None,
        *,
        psi: Optional[int] = None,
        method: Optional[str] = None,
        interpret: bool = False,
    ):
        if q is None:
            q = find_primes(n, 1)[0]
        self.config = NTTConfig(n=n, q=q)
        self.n = n
        self.q = q
        self.interpret = interpret
        if method == "auto":
            # the measured-best method for this (n, q-bits) on this device
            # kind from the autotune cache (utils/autotune.py); a miss falls
            # back to the static default below
            from .utils.autotune import cached_config  # lazy: import cycle

            method = (cached_config(n, q) or {}).get("method")
        if method is None:
            method = "fourstep" if n > MAX_RADIX2_N else "radix2"
        if method not in ("radix2", "fourstep"):
            raise ValueError(f"unknown method {method!r}")
        if method == "radix2" and n > MAX_RADIX2_N:
            raise ValueError(
                f"radix2 supports n <= {MAX_RADIX2_N}; use method='fourstep'"
            )
        self.method = method
        if method == "fourstep":
            # O(sqrt n) bignum setup; the full-size NTTParams (O(n) pows) is
            # only built if .params is actually touched (golden-model tests).
            self.plan: Optional[fourstep.FourStepPlan] = fourstep.make_plan(
                n, q, psi
            )
            self._psi = self.plan.psi
        else:
            self.plan = None
            self._psi = make_params(n, q, psi).psi
        # Montgomery constants for pointwise products (R = 2**32)
        self.qinv_neg = mont_qinv_neg(q)
        self.r_mod_q = (1 << 32) % q
        self.r2_mod_q = pow(1 << 32, 2, q)
        self.n_inv = pow(n, q - 2, q)
        # scale folding R out of mont-pointwise + n^-1, used by polymul
        self.polymul_scale = self.n_inv * self.r_mod_q % q
        # composite ops (polymul, pointwise, add/sub) jit once and cache:
        # eager jnp execution would dispatch each primitive as its own
        # unfused full-array pass (measured 4x polymul slowdown)
        self._jit_cache = {}

    def _jitted(self, name: str, builder):
        fn = self._jit_cache.get(name)
        if fn is None:
            fn = jax.jit(builder())
            self._jit_cache[name] = fn
        return fn

    @property
    def params(self) -> NTTParams:
        """Full-size table bundle (lazy: O(n) bignum setup, used by the
        radix-2 transform, the stage-sharded path, and golden-model tests)."""
        return make_params(self.n, self.q, self._psi)

    # -- shape plumbing ------------------------------------------------------

    def _flatten(self, x: jnp.ndarray) -> Tuple[jnp.ndarray, tuple, int]:
        if x.shape[-1] != self.n:
            raise ValueError(f"last dim must be n={self.n}, got {x.shape}")
        lead = x.shape[:-1]
        b = int(np.prod(lead, dtype=np.int64)) if lead else 1
        if b == 0:
            raise ValueError(f"empty batch: shape {x.shape}")
        return x.reshape(b, self.n), lead, b

    def _unflatten(self, y: jnp.ndarray, lead: tuple, b: int) -> jnp.ndarray:
        return y.reshape(lead + (self.n,))

    # -- transforms ----------------------------------------------------------

    def ntt(self, x) -> jnp.ndarray:
        """Forward negacyclic NTT, (..., n) -> (..., n), output in [0, q)."""
        flat, lead, b = self._flatten(_as_u32(x))
        if self.method == "fourstep":
            y = fourstep.fwd_ntt_fourstep(
                flat, self.plan, interpret=self.interpret
            )
        else:
            y = ntt_kernel.fwd_ntt(flat, self.params, interpret=self.interpret)
        return self._unflatten(y, lead, b)

    def intt(self, x, *, scale: Optional[int] = None) -> jnp.ndarray:
        """Inverse negacyclic NTT, (..., n) -> (..., n), output in [0, q)."""
        flat, lead, b = self._flatten(_as_u32(x))
        if self.method == "fourstep":
            y = fourstep.inv_ntt_fourstep(
                flat, self.plan, scale=scale, interpret=self.interpret
            )
        else:
            y = ntt_kernel.inv_ntt(
                flat, self.params, scale=scale, interpret=self.interpret
            )
        return self._unflatten(y, lead, b)

    # -- tiled-domain API (four-step rings) ----------------------------------
    #
    # Chained pipelines may keep four-step operands in the rank-3
    # (B, n1, n2) form: `to_tiled` once at ingress, `ntt_tiled` /
    # `intt_tiled` / `polymul_tiled` / the elementwise ops (which are
    # shape-agnostic) on the rank-3 form, `from_tiled` at egress.  On the
    # GPU the row-major reshape between the two forms is free, so this is a
    # convenience, bit-identical to the flat entry points.

    @property
    def tile_shape(self) -> Tuple[int, int]:
        """(n1, n2) of the four-step decomposition."""
        self._require_fourstep("tile_shape")
        return (self.plan.n1, self.plan.n2)

    def _require_fourstep(self, what: str) -> None:
        if self.method != "fourstep":
            raise ValueError(
                f"{what} is only available on four-step rings "
                f"(method='fourstep'); this ring is method={self.method!r}"
            )

    def _tiled_batch(self, x: jnp.ndarray) -> Tuple[jnp.ndarray, tuple]:
        n1, n2 = self.plan.n1, self.plan.n2
        if x.ndim < 2 or x.shape[-2:] != (n1, n2):
            raise ValueError(
                f"tiled operands must end in (n1, n2)=({n1}, {n2}), "
                f"got {x.shape}"
            )
        lead = x.shape[:-2]
        b = int(np.prod(lead, dtype=np.int64)) if lead else 1
        if b == 0:
            raise ValueError(f"empty batch: shape {x.shape}")
        return x.reshape((b, n1, n2)), lead

    def to_tiled(self, x) -> jnp.ndarray:
        """(..., n) -> (..., n1, n2): the one-time ingress relayout."""
        self._require_fourstep("to_tiled")
        x = _as_u32(x)
        if x.shape[-1] != self.n:
            raise ValueError(f"last dim must be n={self.n}, got {x.shape}")
        return x.reshape(x.shape[:-1] + self.tile_shape)

    def from_tiled(self, xt) -> jnp.ndarray:
        """(..., n1, n2) -> (..., n): the one-time egress relayout."""
        self._require_fourstep("from_tiled")
        xt = _as_u32(xt)
        n1, n2 = self.tile_shape
        if xt.ndim < 2 or xt.shape[-2:] != (n1, n2):
            raise ValueError(
                f"expected trailing (n1, n2)=({n1}, {n2}), got {xt.shape}"
            )
        return xt.reshape(xt.shape[:-2] + (self.n,))

    def ntt_tiled(self, xt) -> jnp.ndarray:
        """Forward NTT on the tiled layout, (..., n1, n2) -> (..., n1, n2).

        Bit-identical to ``from_tiled(...) |> ntt |> to_tiled``.
        Output [0, q)."""
        self._require_fourstep("ntt_tiled")
        x3, lead = self._tiled_batch(_as_u32(xt))
        y = fourstep.fwd_ntt_fourstep_tiled(
            x3, self.plan, interpret=self.interpret
        )
        return y.reshape(lead + self.tile_shape)

    def intt_tiled(self, xt, *, scale: Optional[int] = None) -> jnp.ndarray:
        """Inverse NTT on the tiled layout (accepts lazy [0, 2q) input)."""
        self._require_fourstep("intt_tiled")
        x3, lead = self._tiled_batch(_as_u32(xt))
        y = fourstep.inv_ntt_fourstep_tiled(
            x3, self.plan, scale=scale, interpret=self.interpret
        )
        return y.reshape(lead + self.tile_shape)

    def polymul_tiled(self, a, b) -> jnp.ndarray:
        """Negacyclic product on the tiled layout, (..., n1, n2) in/out."""
        self._require_fourstep("polymul_tiled")
        fn = self._jitted(
            "polymul_tiled",
            lambda: lambda x, y: self.intt_tiled(
                self._pointwise_lazy_expr(
                    self.ntt_tiled(x), self.ntt_tiled(y)
                ),
                scale=self.polymul_scale,
            ),
        )
        return fn(_as_u32(a), _as_u32(b))

    # -- ring arithmetic -----------------------------------------------------

    def polymul(self, a, b) -> jnp.ndarray:
        """Negacyclic product a*b mod (X^n + 1, q), coefficient domain in/out.

        NTT both operands, Montgomery pointwise multiply (lazy, [0, 2q)),
        inverse NTT with the stray R^{-1} folded into the n^{-1} scaling —
        so the pointwise step costs no extra reduction pass.  One jitted
        computation: XLA fuses the pointwise step between the transforms.
        """
        fn = self._jitted(
            "polymul",
            lambda: lambda x, y: self.intt(
                self._pointwise_lazy_expr(self.ntt(x), self.ntt(y)),
                scale=self.polymul_scale,
            ),
        )
        return fn(_as_u32(a), _as_u32(b))

    def _pointwise_lazy_expr(self, a, b) -> jnp.ndarray:
        return mont_mul_lazy(_as_u32(a), _as_u32(b), self.q, self.qinv_neg)

    def tensor(self, a0, a1, b0, b1):
        """RLWE tensor product (d0, d1, d2) = (a0 b0, a0 b1 + a1 b0, a1 b1)
        in ONE dispatch with 4 forward + 3 inverse transforms.

        Karatsuba in the evaluation domain: the cross term is
        (A0+A1)(B0+B1) - D0 - D2 computed on the transforms, so each
        ciphertext part is transformed once (a composed 3-polymul tensor
        pays 6 forward passes and 3 dispatches).  The scheme layer's
        ciphertext multiply sits on this.  No reference analog (the
        reference stops at the transform layer)."""

        def build():
            def f(x0, x1, y0, y1):
                fa0, fa1 = self.ntt(x0), self.ntt(x1)
                fb0, fb1 = self.ntt(y0), self.ntt(y1)
                sa = cond_sub(fa0 + fa1, self.q)
                sb = cond_sub(fb0 + fb1, self.q)
                d0 = cond_sub(self._pointwise_lazy_expr(fa0, fb0), self.q)
                d2 = cond_sub(self._pointwise_lazy_expr(fa1, fb1), self.q)
                cr = cond_sub(self._pointwise_lazy_expr(sa, sb), self.q)
                qq = U32(self.q)
                d1 = cond_sub(cond_sub(cr - d0 + qq, self.q) - d2 + qq,
                              self.q)
                # every term carries one stray R^-1 from the lazy Hadamard;
                # polymul_scale (= n^-1 * R) folds it into the inverse
                sc = self.polymul_scale
                return (
                    self.intt(d0, scale=sc),
                    self.intt(d1, scale=sc),
                    self.intt(d2, scale=sc),
                )

            return f

        return self._jitted("tensor", build)(
            _as_u32(a0), _as_u32(a1), _as_u32(b0), _as_u32(b1)
        )

    def tensor_square(self, a0, a1):
        """Tensor square (a0^2, 2 a0 a1, a1^2): 2 forward + 3 inverse
        transforms, one dispatch (see ``tensor``)."""

        def build():
            def f(x0, x1):
                fa0, fa1 = self.ntt(x0), self.ntt(x1)
                d0 = cond_sub(self._pointwise_lazy_expr(fa0, fa0), self.q)
                d2 = cond_sub(self._pointwise_lazy_expr(fa1, fa1), self.q)
                x = cond_sub(self._pointwise_lazy_expr(fa0, fa1), self.q)
                d1 = cond_sub(x + x, self.q)
                sc = self.polymul_scale
                return (
                    self.intt(d0, scale=sc),
                    self.intt(d1, scale=sc),
                    self.intt(d2, scale=sc),
                )

            return f

        return self._jitted("tensor_sq", build)(_as_u32(a0), _as_u32(a1))

    def pointwise_mul_lazy(self, a, b) -> jnp.ndarray:
        """Elementwise a*b*2^-32 mod q in [0, 2q) (NTT-domain Hadamard)."""
        fn = self._jitted("pw_lazy", lambda: self._pointwise_lazy_expr)
        return fn(_as_u32(a), _as_u32(b))

    def pointwise_mul(self, a, b) -> jnp.ndarray:
        """Elementwise exact a*b mod q in [0, q) for NTT-domain operands.

        Two REDC passes: mont(mont(a, b), R^2 mod q)."""

        def build():
            def f(x, y):
                t = self._pointwise_lazy_expr(x, y)
                t = mont_mul_lazy(t, u32(self.r2_mod_q), self.q, self.qinv_neg)
                return cond_sub(t, self.q)

            return f

        return self._jitted("pw_exact", build)(_as_u32(a), _as_u32(b))

    def add(self, a, b) -> jnp.ndarray:
        fn = self._jitted(
            "add", lambda: lambda x, y: cond_sub(x + y, self.q)
        )
        return fn(_as_u32(a), _as_u32(b))

    def sub(self, a, b) -> jnp.ndarray:
        fn = self._jitted(
            "sub", lambda: lambda x, y: cond_sub(x - y + U32(self.q), self.q)
        )
        return fn(_as_u32(a), _as_u32(b))

    def neg(self, a) -> jnp.ndarray:
        fn = self._jitted(
            "neg",
            lambda: lambda x: jnp.where(
                x == U32(0), U32(0), U32(self.q) - x
            ),
        )
        return fn(_as_u32(a))

    def polydot(self, a, b) -> jnp.ndarray:
        """Inner product of polynomial vectors: sum_i a_i * b_i mod (X^n+1, q).

        a, b: (..., k, n).  Costs 2k forward transforms + k pointwise + ONE
        inverse (vs 3k transforms for k separate polymuls) — the key-switch /
        external-product primitive in RNS-FHE.  Accumulation stays lazy in
        [0, 2q) with a conditional subtraction per term.
        """

        def build():
            def f(x, y):
                fx = self.ntt(x)
                fy = self.ntt(y)
                terms = self._pointwise_lazy_expr(fx, fy)  # (..., k, n) in [0,2q)
                two_q = U32(2 * self.q)
                k = terms.shape[-2]
                acc = terms[..., 0, :]
                for i in range(1, k):  # k is static; sum stays in [0, 2q)
                    acc = cond_sub(acc + terms[..., i, :], two_q)
                return self.intt(acc, scale=self.polymul_scale)

            return f

        a, b = _as_u32(a), _as_u32(b)
        if a.shape != b.shape or a.ndim < 2 or a.shape[-1] != self.n:
            raise ValueError(
                f"polydot expects matching (..., k, n={self.n}) shapes, got "
                f"{a.shape} and {b.shape}"
            )
        return self._jitted("polydot", build)(a, b)

    def rotate(self, x, k: int) -> jnp.ndarray:
        """Multiply by X^k (negacyclic rotation): coefficients shift by k with
        sign flips on wraparound (X^n = -1).  k may be any integer.  The
        gather/sign tables and the jitted apply are cached per k."""
        x = _as_u32(x)
        if x.shape[-1] != self.n:
            raise ValueError(f"last dim must be n={self.n}, got {x.shape}")
        k %= 2 * self.n
        n, q = self.n, self.q

        def build():
            # tables stay numpy here: creating device arrays in this closure
            # could run under an enclosing trace (e.g. RNSRing's fused jit)
            # and leak tracers into the cache; jnp.asarray inside f becomes
            # a constant of f's own jaxpr
            src = (np.arange(n) - k) % (2 * n)
            neg = src >= n
            idx = np.where(neg, src - n, src).astype(np.int32)

            def f(v):
                g = jnp.take(v, jnp.asarray(idx), axis=-1)
                return jnp.where(
                    jnp.asarray(neg),
                    jnp.where(g == U32(0), U32(0), U32(q) - g),
                    g,
                )

            return f

        return self._jitted(("rotate", k), build)(x)

    # -- Galois automorphisms -------------------------------------------------

    def _auto_tables(self, k: int):
        cached = self._jit_cache.get(("auto_tables", k))
        if cached is not None:
            return cached
        tables = self._build_auto_tables(k)
        # per-instance cache (not a class-level lru_cache, which would pin
        # dropped Ring instances and their device arrays forever)
        self._jit_cache[("auto_tables", k)] = tables
        return tables

    def _build_auto_tables(self, k: int):
        """Gather indices/signs for tau_k: a(X) -> a(X^k) mod (X^n + 1).

        Coefficient domain: X^j -> X^(jk mod 2n) with X^n = -1, so output
        position p takes source j = p * k^-1 mod 2n (sign +) or
        (p + n) * k^-1 (sign -), whichever lands in [0, n).
        NTT domain: evaluation points permute — slot p holds A(psi^(2br(p)+1)),
        so tau_k moves slot p' to p with 2br(p')+1 = (2br(p)+1)*k mod 2n.
        """
        n, logn = self.n, self.n.bit_length() - 1
        kinv = pow(k, -1, 2 * n)
        src = np.empty(n, dtype=np.int32)
        neg = np.empty(n, dtype=bool)
        for p in range(n):
            j = p * kinv % (2 * n)
            if j < n:
                src[p], neg[p] = j, False
            else:
                src[p], neg[p] = j - n, True
        ntt_src = np.empty(n, dtype=np.int32)
        for p in range(n):
            e = (2 * bit_reverse(p, logn) + 1) * k % (2 * n)
            ntt_src[p] = bit_reverse((e - 1) // 2, logn)
        # numpy, not device arrays: this may run under an enclosing trace
        # (RNSRing's fused jit) and cached tracers would leak
        return src, neg, ntt_src

    def automorphism(self, x, k: int, *, domain: str = "coeff") -> jnp.ndarray:
        """Galois automorphism tau_k: a(X) -> a(X^k) mod (X^n + 1), k odd.

        domain="coeff": x holds coefficients in [0, q).
        domain="ntt":   x holds NTT-domain evaluations (any values) — the
        automorphism is then a pure slot permutation, the cheap form FHE
        rotation keys rely on.  Beyond-reference capability (SURVEY.md §2:
        the reference has no ring-operation layer at all).
        """
        if k % 2 == 0:
            raise ValueError(f"k must be odd (unit mod 2n), got {k}")
        k %= 2 * self.n
        x = _as_u32(x)
        if x.shape[-1] != self.n:
            raise ValueError(f"last dim must be n={self.n}, got {x.shape}")
        src, neg, ntt_src = self._auto_tables(k)
        if domain == "ntt":
            return jnp.take(x, ntt_src, axis=-1)
        if domain != "coeff":
            raise ValueError(f"unknown domain {domain!r}")
        g = jnp.take(x, src, axis=-1)
        return jnp.where(neg, jnp.where(g == U32(0), U32(0), U32(self.q) - g), g)

    def check(self, x, *, bound: Optional[int] = None) -> jnp.ndarray:
        """Debug validation: raise if any value is outside [0, bound).

        bound defaults to q (fully-reduced coefficients).  The kernels accept
        lazy inputs up to 4q (fwd) / 2q (inv) and silently wrap beyond —
        the failure-detection aid the reference lacks entirely (its driver
        feeds invalid twiddles without noticing, main.cpp:49-55).

        Eager-only: it reads the violation count back to the host to raise.
        """
        from .utils.profiling import under_trace

        if under_trace():
            raise RuntimeError(
                "Ring.check is eager-only (it reads a violation count back "
                "to the host); call it outside jit/vmap, or validate with "
                "jnp.all(x < bound) inside the traced computation"
            )
        x = _as_u32(x)
        b = self.q if bound is None else bound
        bad = int(jnp.sum(x >= U32(b)))
        if bad:
            worst = int(jnp.max(x))
            raise ValueError(
                f"{bad} coefficient(s) outside [0, {b}); max value {worst}"
            )
        return x

    def digit_decompose(
        self, x, base_bits: int, *, balanced: bool = False
    ) -> jnp.ndarray:
        """Base-2^w gadget split: (..., n) in [0, q) -> (ndig, ..., n).

        The external-product primitive (BFV/TFHE-style key material):
        sum_j d_j * 2^(w*j) == x exactly; balanced=True centers digits
        (see ops/gadget.py for ranges and the carry rule).  Elementwise
        shifts/masks/adds only.
        """
        from .ops import gadget

        x = _as_u32(x)
        key = ("digit_decompose", int(base_bits), bool(balanced))
        fn = self._jit_cache.get(key)
        if fn is None:
            q, w, bal = self.q, int(base_bits), bool(balanced)
            fn = jax.jit(
                lambda v: gadget.digit_decompose(v, q, w, balanced=bal)
            )
            self._jit_cache[key] = fn
        return fn(x)

    def random_coeffs(self, key, shape=()) -> jnp.ndarray:
        """Uniform random ring elements, shape (..., n)."""
        return jax.random.randint(
            key, shape + (self.n,), 0, self.q, dtype=jnp.uint32
        )

    def __repr__(self):
        return (
            f"Ring(n={self.n}, q={self.q}, method={self.method!r},"
            f" interpret={self.interpret})"
        )


class CyclicRing:
    """The cyclic ring Z_q[X] / (X^n - 1): plain cyclic convolution.

    Runs the same butterfly transform as Ring with cyclic twiddle tables
    (params.make_cyclic_params) — the machinery the four-step row pass uses,
    exposed as a first-class ring.  Sizes beyond the single-pass wall use
    the all-cyclic four-step plan.  The reference is negacyclic-only; cyclic
    convolution (signal-processing style) is beyond-reference capability.
    Requires q ≡ 1 (mod n).
    """

    def __init__(
        self,
        n: int,
        q: Optional[int] = None,
        *,
        omega: Optional[int] = None,
        method: Optional[str] = None,
        interpret: bool = False,
    ):
        if q is None:
            q = find_primes(n, 1)[0]
        if q % n != 1:
            raise ValueError(f"q ≡ 1 (mod n) required: q={q} n={n}")
        # same arithmetic preconditions Ring enforces via NTTConfig/make_params
        # (q ≡ 1 mod 2n is not required here, so validate directly): the
        # uint32 Harvey-lazy invariant needs 4q < 2**32, and n_inv via
        # Fermat needs q prime
        if q >= (1 << 30):
            raise ValueError(
                f"q must be < 2**30 for uint32 lazy arithmetic, got {q}"
            )
        from .params import is_prime

        if not is_prime(q):
            raise ValueError(f"q={q} is not prime")
        if omega is None:
            g = primitive_root(q)
            omega = pow(g, (q - 1) // n, q)
        if method is None:
            method = "fourstep" if n > MAX_RADIX2_N else "radix2"
        if method not in ("radix2", "fourstep"):
            raise ValueError(f"unknown method {method!r}")
        if method == "radix2" and n > MAX_RADIX2_N:
            raise ValueError(
                f"radix2 supports n <= {MAX_RADIX2_N}; use method='fourstep'"
            )
        self.method = method
        if method == "fourstep":
            self.plan = fourstep.make_cyclic_plan(n, q, omega)
            self.params: Optional[CyclicParams] = None
        else:
            self.plan = None
            self.params = make_cyclic_params(n, q, omega)
        self.n, self.q, self.omega = n, q, omega
        self.interpret = interpret
        self.qinv_neg = mont_qinv_neg(q)
        self.r_mod_q = (1 << 32) % q
        self.n_inv = pow(n, q - 2, q)
        self.polymul_scale = self.n_inv * self.r_mod_q % q
        self._flatten = Ring._flatten.__get__(self)
        self._unflatten = Ring._unflatten.__get__(self)
        self._jit_cache = {}
        self._jitted = Ring._jitted.__get__(self)

    def ntt(self, x) -> jnp.ndarray:
        """Cyclic NTT: out[bitrev(k)] = A(omega^k), output in [0, q)."""
        flat, lead, b = self._flatten(_as_u32(x))
        if self.method == "fourstep":
            y = fourstep.fwd_ntt_fourstep(
                flat, self.plan, interpret=self.interpret
            )
        else:
            y = ntt_kernel.fwd_ntt(flat, self.params, interpret=self.interpret)
        return self._unflatten(y, lead, b)

    def intt(self, x, *, scale: Optional[int] = None) -> jnp.ndarray:
        flat, lead, b = self._flatten(_as_u32(x))
        if self.method == "fourstep":
            y = fourstep.inv_ntt_fourstep(
                flat, self.plan, scale=scale, interpret=self.interpret
            )
        else:
            y = ntt_kernel.inv_ntt(
                flat, self.params, scale=scale, interpret=self.interpret
            )
        return self._unflatten(y, lead, b)

    def _pointwise_lazy_expr(self, a, b) -> jnp.ndarray:
        return mont_mul_lazy(_as_u32(a), _as_u32(b), self.q, self.qinv_neg)

    def polymul(self, a, b) -> jnp.ndarray:
        """Cyclic convolution a*b mod (X^n - 1, q): the negacyclic
        composition with cyclic tables, one jitted computation."""
        fn = self._jitted(
            "polymul",
            lambda: lambda x, y: self.intt(
                self._pointwise_lazy_expr(self.ntt(x), self.ntt(y)),
                scale=self.polymul_scale,
            ),
        )
        return fn(_as_u32(a), _as_u32(b))

    def __repr__(self):
        return (
            f"CyclicRing(n={self.n}, q={self.q}, method={self.method!r})"
        )


def _evaldot_intt(erings, fx, fk, d: int) -> jnp.ndarray:
    """polydot's exact arithmetic on PRE-TRANSFORMED operands: per channel,
    Montgomery pointwise products accumulated lazily in ascending digit
    order ([0, 2q) with one conditional subtraction per term — bit-identical
    to Ring.polydot's composition), then the inverse transform with the
    Montgomery R folded into the scale.  fx: (K, d, ..., n) eval-domain
    digits; fk: (K, d, [1s,] n) eval-domain key (broadcasts); returns
    (K, ..., n) coefficient-domain in [0, q)."""
    chans = []
    for i, r in enumerate(erings):
        t = mont_mul_lazy(fx[i], fk[i], r.q, r.qinv_neg)
        acc = t[0]
        two_q = U32(2 * r.q)
        for dd in range(1, d):
            acc = cond_sub(acc + t[dd], two_q)
        chans.append(r.intt(acc, scale=r.polymul_scale))
    return jnp.stack(chans, axis=0)


class RNSRing:
    """Residue-number-system ring: L independent prime channels for one n.

    The multi-prime generalization the reference's single-modulus pipeline
    (modulusPipe carries exactly one q, ntt.cpp:64, 143-144) points toward:
    wide-coefficient arithmetic via CRT over a chain of 30-bit primes.
    Data layout: leading axis = prime channel, shape (L, ..., n).
    """

    def __init__(
        self,
        n: int,
        num_primes: int = 3,
        qs: Optional[Sequence[int]] = None,
        **ring_kwargs,
    ):
        if qs is None:
            qs = find_primes(n, num_primes)
        self.rings: List[Ring] = [Ring(n, q, **ring_kwargs) for q in qs]
        self.n = n
        self.qs = [r.q for r in self.rings]
        self.modulus = 1
        for q in self.qs:
            self.modulus *= q
        # all L channels trace into ONE jitted computation per op: a Python
        # loop of per-ring jit calls would pay L separate dispatches (and
        # XLA couldn't overlap the channels' kernels)
        self._jit_cache = {}
        # extended-basis rings built by keyswitch, keyed by prime tuple
        self._ext_rings: Dict[tuple, "RNSRing"] = {}

    @property
    def L(self) -> int:
        return len(self.rings)

    def _check(self, x: jnp.ndarray):
        if x.shape[0] != self.L or x.shape[-1] != self.n:
            raise ValueError(
                f"expected shape (L={self.L}, ..., n={self.n}), got {x.shape}"
            )

    def _map(self, fn_name: str, *xs) -> jnp.ndarray:
        for x in xs:
            self._check(x)
        fn = self._jit_cache.get(fn_name)
        if fn is None:
            rings = self.rings

            def stacked(*arrs):
                return jnp.stack(
                    [
                        getattr(r, fn_name)(*(a[i] for a in arrs))
                        for i, r in enumerate(rings)
                    ],
                    axis=0,
                )

            fn = jax.jit(stacked)
            self._jit_cache[fn_name] = fn
        return fn(*xs)

    def _radix2(self) -> bool:
        """True when every channel is a radix-2 ring: each transform of all
        L channels is then ONE call (channel = kernel grid axis, q and the
        tables per-channel operands).  Four-step rings use the stacked
        per-channel _map."""
        return all(r.method == "radix2" for r in self.rings)

    def _channels(self, name: str, fn):
        """jit ``fn`` over (L, B, n) operands: numpy broadcasting over the
        lead (batch) dims, flattened to one batch axis and back."""
        cached = self._jit_cache.get(name)
        if cached is None:
            L, n = self.L, self.n

            def f(*arrs):
                # broadcast first, matching the stacked per-ring path
                # (keygen multiplies a (K, dnum, n) noise block against a
                # (K, 1, n) secret); each array's lead dims right-align
                # against `lead` with explicit singleton axes after the
                # channel axis (a bare (L, n) operand must not have its L
                # axis collide with a batch axis)
                lead = jnp.broadcast_shapes(*(a.shape[1:-1] for a in arrs))
                arrs = [
                    a.reshape(a.shape[:1]
                              + (1,) * (len(lead) - (a.ndim - 2))
                              + a.shape[1:])
                    for a in arrs
                ]
                arrs = [
                    jnp.broadcast_to(a, (L,) + lead + (n,)) for a in arrs
                ]
                b = int(np.prod(lead, dtype=np.int64)) if lead else 1
                out = fn(*(a.reshape(L, b, n) for a in arrs))
                return out.reshape(arrs[0].shape)

            cached = jax.jit(f)
            self._jit_cache[name] = cached
        return cached

    @property
    def _params(self):
        return tuple(r.params for r in self.rings)

    def _fwd3(self, v):
        return ntt_kernel.rns_ntt(v, self._params,
                                  interpret=self.rings[0].interpret)

    def _inv3(self, v, scales=None):
        return ntt_kernel.rns_intt(v, self._params, scales=scales,
                                   interpret=self.rings[0].interpret)

    def _mont(self, a, b):
        """Per-channel Montgomery product of (L, ...) operands, [0, 2q)."""
        shape = (self.L,) + (1,) * (a.ndim - 1)
        qs = np.array(self.qs, dtype=np.uint32).reshape(shape)
        qi = np.array([r.qinv_neg for r in self.rings],
                      dtype=np.uint32).reshape(shape)
        return mont_mul_lazy(a, b, jnp.asarray(qs), jnp.asarray(qi))

    def ntt(self, x) -> jnp.ndarray:
        x = _as_u32(x)  # same truncating-cast contract as the _map path
        if self._radix2():
            self._check(x)
            return self._channels("ntt3", self._fwd3)(x)
        return self._map("ntt", x)

    def intt(self, x) -> jnp.ndarray:
        x = _as_u32(x)
        if self._radix2():
            self._check(x)
            return self._channels("intt3", self._inv3)(x)
        return self._map("intt", x)

    def polymul(self, a, b) -> jnp.ndarray:
        a, b = _as_u32(a), _as_u32(b)
        if self._radix2():
            self._check(a)
            self._check(b)
            scales = tuple(r.polymul_scale for r in self.rings)
            return self._channels(
                "polymul3",
                lambda x, y: self._inv3(
                    self._mont(self._fwd3(x), self._fwd3(y)), scales
                ),
            )(a, b)
        return self._map("polymul", a, b)

    def add(self, a, b) -> jnp.ndarray:
        return self._map("add", jnp.asarray(a), jnp.asarray(b))

    def sub(self, a, b) -> jnp.ndarray:
        return self._map("sub", jnp.asarray(a), jnp.asarray(b))

    def neg(self, a) -> jnp.ndarray:
        return self._map("neg", jnp.asarray(a))

    def polydot_multi(self, a, ws_ntt):
        """Multi-output fused inner product: out[j] = sum_k a_k (*) w_{j,k}
        for g weight bundles, with ``a`` forward-transformed ONCE.

        The giant-step core of the BSGS matvec: per giant step the baby
        bundle is identical, so a per-step ``polydot`` would re-transform
        it g times; here the k-entry bundle pays k forward transforms
        total, each output only a pointwise dot + one inverse.

        a:      (L, ..., k, n) coefficient-domain bundle.
        ws_ntt: (L, g, k, n) EVALUATION-domain weights (pre-transform once
                at bake time via ``ntt``).
        Returns (g, L, ..., n); one jitted dispatch.
        """
        a, ws_ntt = _as_u32(a), _as_u32(ws_ntt)
        self._check(a)
        if a.ndim < 3:
            raise ValueError(f"a must be (L, ..., k, n), got {a.shape}")
        if (ws_ntt.ndim != 4 or ws_ntt.shape[0] != self.L
                or ws_ntt.shape[2:] != a.shape[-2:]):
            raise ValueError(
                f"ws_ntt must be (L={self.L}, g, k={a.shape[-2]}, "
                f"n={self.n}), got {ws_ntt.shape}"
            )
        key = ("polydot_multi", a.ndim, int(ws_ntt.shape[1]))
        fn = self._jit_cache.get(key)
        if fn is None:
            rings = self.rings
            g = int(ws_ntt.shape[1])

            def f(av, wv):
                k = av.shape[-2]
                outs = []
                for i, r in enumerate(rings):
                    fa = r.ntt(av[i])  # (..., k, n), exact [0, q)
                    q, qi = r.q, r.qinv_neg
                    two_q = U32(2 * r.q)
                    per_g = []
                    for j in range(g):
                        w = wv[i, j].reshape(
                            (1,) * (fa.ndim - 2) + av.shape[-2:]
                        )
                        t = mont_mul_lazy(fa, w, q, qi)  # [0, 2q)
                        acc = t[..., 0, :]
                        for kk in range(1, k):
                            acc = cond_sub(acc + t[..., kk, :], two_q)
                        # one stray R^-1 from the Montgomery dot: fold via
                        # polymul_scale in the inverse (cf. Ring.polymul)
                        per_g.append(r.intt(acc, scale=r.polymul_scale))
                    outs.append(jnp.stack(per_g))  # (g, ..., n)
                return jnp.stack(outs, axis=1)     # (g, L, ..., n)

            fn = jax.jit(f)
            self._jit_cache[key] = fn
        return fn(a, ws_ntt)

    def tensor(self, a0, a1, b0, b1):
        """Per-channel RLWE tensor product (see Ring.tensor): ONE jitted
        dispatch over all L channels, 4 forward + 3 inverse transforms per
        channel instead of the composed form's 6 + 3."""
        arrs = tuple(_as_u32(v) for v in (a0, a1, b0, b1))
        for v in arrs:
            self._check(v)
        fn = self._jit_cache.get("tensor")
        if fn is None:
            rings = self.rings

            def stacked(x0, x1, y0, y1):
                outs = [
                    r.tensor(x0[i], x1[i], y0[i], y1[i])
                    for i, r in enumerate(rings)
                ]
                return tuple(
                    jnp.stack([o[j] for o in outs], axis=0)
                    for j in range(3)
                )

            fn = jax.jit(stacked)
            self._jit_cache["tensor"] = fn
        return fn(*arrs)

    def tensor_square(self, a0, a1):
        """Per-channel tensor square (see Ring.tensor_square)."""
        a0, a1 = _as_u32(a0), _as_u32(a1)
        self._check(a0)
        self._check(a1)
        fn = self._jit_cache.get("tensor_sq")
        if fn is None:
            rings = self.rings

            def stacked(x0, x1):
                outs = [
                    r.tensor_square(x0[i], x1[i])
                    for i, r in enumerate(rings)
                ]
                return tuple(
                    jnp.stack([o[j] for o in outs], axis=0)
                    for j in range(3)
                )

            fn = jax.jit(stacked)
            self._jit_cache["tensor_sq"] = fn
        return fn(a0, a1)

    def polydot(self, a, b) -> jnp.ndarray:
        """Per-channel fused inner product: shapes (L, ..., k, n)."""
        a, b = _as_u32(a), _as_u32(b)
        if a.shape != b.shape or a.ndim < 3 or a.shape[-1] != self.n:
            raise ValueError(
                f"polydot expects matching (L, ..., k, n={self.n}) shapes, "
                f"got {a.shape} and {b.shape}"
            )
        self._check(a)
        if self._radix2():
            fn = self._jit_cache.get("polydot3")
            if fn is None:
                L, n = self.L, self.n
                scales = tuple(r.polymul_scale for r in self.rings)
                two_q = np.array(
                    [2 * q for q in self.qs], dtype=np.uint32
                ).reshape(L, 1, 1)

                def f(x, y):
                    k = x.shape[-2]
                    bb = int(np.prod(x.shape[1:-2], dtype=np.int64))
                    fx = self._fwd3(x.reshape(L, bb * k, n))
                    fy = self._fwd3(y.reshape(L, bb * k, n))
                    t = self._mont(fx, fy).reshape(L, bb, k, n)
                    acc = t[:, :, 0]
                    for i in range(1, k):  # same order as Ring.polydot
                        acc = cond_sub(acc + t[:, :, i], jnp.asarray(two_q))
                    out = self._inv3(acc, scales)
                    return out.reshape(x.shape[:-2] + (n,))

                fn = jax.jit(f)
                self._jit_cache["polydot3"] = fn
            return fn(a, b)
        return self._map("polydot", a, b)

    def _map_static(self, key, per_ring) -> "jnp.ndarray":
        """Like _map but for ops parameterized by static values (k, domain):
        all channels trace into one cached jitted call."""
        fn = self._jit_cache.get(key)
        if fn is None:
            rings = self.rings

            def stacked(x):
                return jnp.stack(
                    [per_ring(r, x[i]) for i, r in enumerate(rings)], axis=0
                )

            fn = jax.jit(stacked)
            self._jit_cache[key] = fn
        return fn

    def automorphism(self, x, k: int, *, domain: str = "coeff") -> jnp.ndarray:
        """tau_k on every channel (the index tables are q-independent)."""
        x = jnp.asarray(x)
        self._check(x)
        fn = self._map_static(
            ("automorphism", k, domain),
            lambda r, xi: r.automorphism(xi, k, domain=domain),
        )
        return fn(x)

    def rotate(self, x, k: int) -> jnp.ndarray:
        """Multiply every channel by X^k."""
        x = jnp.asarray(x)
        self._check(x)
        fn = self._map_static(
            ("rotate", k), lambda r, xi: r.rotate(xi, k)
        )
        return fn(x)

    def base_convert(
        self, x, dst, *, correction: str = "none"
    ) -> jnp.ndarray:
        """Fast base conversion: residues (L, ..., n) -> dst basis (K, ..., n).

        `dst` is an RNSRing (same n) or a sequence of primes.  The
        key-switching / modulus-raising primitive: correction="none" is the
        classical BEHZ approximate conversion (result = x + e*Q mod p_j,
        0 <= e < L, absorbed downstream); correction="float" subtracts the
        HPS float32-estimated e*Q (see ops/basechange.py for the precision
        band).  Coefficient domain; inputs must be in [0, q_l).
        """
        from .ops import basechange

        x = _as_u32(x)
        self._check(x)
        qs_dst = tuple(dst.qs) if isinstance(dst, RNSRing) else tuple(
            int(q) for q in dst
        )
        key = ("base_convert", qs_dst, correction)
        fn = self._jit_cache.get(key)
        if fn is None:
            qs_src = tuple(self.qs)
            fn = jax.jit(
                lambda v: basechange.base_convert(
                    v, qs_src, qs_dst, correction=correction
                )
            )
            self._jit_cache[key] = fn
        return fn(x)

    def rescale(self, x) -> jnp.ndarray:
        """Divide-and-round by the last prime (CKKS rescale / BGV modulus
        switch): (L, ..., n) residues of x -> (L-1, ..., n) residues of
        round(x / q_{L-1}) in the basis ``self.qs[:-1]`` (pair with
        ``drop_prime()``).  Coefficient domain; inputs in [0, q_l)."""
        from .ops import basechange

        x = _as_u32(x)
        self._check(x)
        fn = self._jit_cache.get("rescale")
        if fn is None:
            qs = tuple(self.qs)
            fn = jax.jit(lambda v: basechange.rescale(v, qs))
            self._jit_cache["rescale"] = fn
        return fn(x)

    def rescale_bgv(self, x, t: int) -> jnp.ndarray:
        """BGV modulus switch by the last prime: the t-multiple-correcting
        divide (ops/basechange.rescale_bgv) — preserves the phase mod ``t``
        up to the q_L^-1 factor the scheme layer tracks."""
        from .ops import basechange

        x = _as_u32(x)
        self._check(x)
        key = ("rescale_bgv", int(t))
        fn = self._jit_cache.get(key)
        if fn is None:
            qs, tt = tuple(self.qs), int(t)
            fn = jax.jit(lambda v: basechange.rescale_bgv(v, qs, tt))
            self._jit_cache[key] = fn
        return fn(x)

    def mod_down_bgv(self, x, t: int, count: int = 1) -> jnp.ndarray:
        """Iterated t-correcting divide: the BGV ModDown (see
        ops/basechange.mod_down_bgv).  (L, ..., n) -> (L-count, ..., n)."""
        from .ops import basechange

        x = _as_u32(x)
        self._check(x)
        key = ("mod_down_bgv", int(t), int(count))
        fn = self._jit_cache.get(key)
        if fn is None:
            qs, tt, c = tuple(self.qs), int(t), int(count)
            if not 1 <= c <= len(qs) - 1:
                raise ValueError(
                    f"count must be in [1, {len(qs) - 1}], got {c}"
                )
            fn = jax.jit(lambda v: basechange.mod_down_bgv(v, qs, tt, c))
            self._jit_cache[key] = fn
        return fn(x)

    def mod_down(self, x, count: int = 1) -> jnp.ndarray:
        """Iterated rescale: drop the last ``count`` primes, i.e. the exact
        centered round(x / prod(dropped)) residues — the post-key-switch
        ModDown.  (L, ..., n) -> (L-count, ..., n); pair with
        ``drop_prime(count)``."""
        from .ops import basechange

        x = _as_u32(x)
        self._check(x)
        key = ("mod_down", int(count))
        fn = self._jit_cache.get(key)
        if fn is None:
            qs, c = tuple(self.qs), int(count)
            if not 1 <= c <= len(qs) - 1:
                raise ValueError(
                    f"count must be in [1, {len(qs) - 1}], got {c}"
                )
            fn = jax.jit(lambda v: basechange.mod_down(v, qs, c))
            self._jit_cache[key] = fn
        return fn(x)

    def keyswitch(
        self, x, ksk, ext, dnum: int, *, correction: str = "float",
        ksk_domain: str = "coeff", plain_mod: Optional[int] = None,
    ) -> jnp.ndarray:
        """One-call hybrid key-switch: gadget-decompose ``x`` into ``dnum``
        digits, raise them into the extended basis ``ext``, dot against the
        key material, and ModDown back to this basis.

        plain_mod: BGV plaintext modulus t — the ModDown then uses the
        t-multiple correction (exactness mod t) instead of centered
        rounding; requires key noise that is a t-multiple.

        x: (L, ..., n) residues in this ring's basis.
        ksk: key material generated in ``ext`` — (dnum, K, n) (shared
             across the batch, the production shape) or (dnum, K, ..., n)
             matching x's lead dims.
        ext: RNSRing or K primes; its first L primes MUST be this ring's
             (so the ModDown by the K-L special primes lands back here).
        ksk_domain: "coeff" transforms the key inside the call; "ntt"
             accepts keys pre-transformed once via ``ksk_to_ntt`` — the
             serving configuration, saving dnum*K forward transforms per
             call.  Bit-identical outputs.
        Returns (L, ..., n) residues of round(sum_d t_d * ksk_d / P).
        """
        from .ops import basechange, gadget

        x = _as_u32(x)
        self._check(x)
        ksk = _as_u32(ksk)
        if ksk_domain not in ("coeff", "ntt"):
            raise ValueError(f"unknown ksk_domain {ksk_domain!r}")
        qs_ext = tuple(ext.qs) if isinstance(ext, RNSRing) else tuple(
            int(q) for q in ext
        )
        if qs_ext[: self.L] != tuple(self.qs):
            raise ValueError(
                "ext basis must extend this ring's (first L primes equal); "
                f"got ext={qs_ext[:self.L]}... vs qs={tuple(self.qs)}"
            )
        K = len(qs_ext)
        if K <= self.L:
            raise ValueError("ext basis must add at least one special prime")
        ext_ring = self._ext_rings.get(qs_ext)
        if ext_ring is None:
            ext_ring = ext if isinstance(ext, RNSRing) else RNSRing(
                self.n, qs=qs_ext
            )
            self._ext_rings[qs_ext] = ext_ring
        shared = ksk.ndim == 3  # (dnum, K, n) broadcast over the batch
        if ksk.shape[:2] != (dnum, K) or ksk.shape[-1] != self.n:
            raise ValueError(
                f"ksk must be (dnum={dnum}, K={K}, [...,] n={self.n}), "
                f"got {ksk.shape}"
            )
        key = ("keyswitch", qs_ext, int(dnum), correction, shared, x.ndim,
               ksk_domain, plain_mod)
        fn = self._jit_cache.get(key)
        if fn is None:
            qs_src, d, corr = tuple(self.qs), int(dnum), correction
            gadget.gadget_groups(len(qs_src), d)  # validate eagerly
            spec = K - self.L
            pm = None if plain_mod is None else int(plain_mod)

            def down(prod):
                if pm is None:
                    return basechange.mod_down(prod, qs_ext, spec)
                return basechange.mod_down_bgv(prod, qs_ext, pm, spec)

            if ksk_domain == "ntt":
                erings = ext_ring.rings

                def f(v, kk):
                    dig = gadget.gadget_decompose(
                        v, qs_src, qs_ext, d, correction=corr
                    )  # (dnum, K, ..., n)
                    fx = ext_ring.ntt(jnp.moveaxis(dig, 0, 1))  # (K,d,...,n)
                    kb = jnp.moveaxis(kk, 0, 1)  # (K, d, [...,] n), eval dom
                    if shared:
                        kb = kb.reshape(
                            (K, d) + (1,) * (fx.ndim - 3) + (self.n,)
                        )
                    prod = _evaldot_intt(erings, fx, kb, d)  # (K, ..., n)
                    return down(prod)

            else:

                def f(v, kk):
                    dig = gadget.gadget_decompose(
                        v, qs_src, qs_ext, d, correction=corr
                    )  # (dnum, K, ..., n)
                    dig = jnp.moveaxis(dig, 0, -2)  # (K, ..., dnum, n)
                    kb = jnp.moveaxis(kk, 0, -2)    # (K, [...,] dnum, n)
                    if shared:
                        kb = jnp.broadcast_to(
                            kb.reshape(
                                (K,) + (1,) * (dig.ndim - 3) + kb.shape[-2:]
                            ),
                            dig.shape,
                        )
                    prod = ext_ring.polydot(dig, kb)  # (K, ..., n)
                    return down(prod)

            fn = jax.jit(f)
            self._jit_cache[key] = fn
        return fn(x, ksk)

    def ksk_to_ntt(self, ksk, ext, *, ch_axis: int = 1) -> jnp.ndarray:
        """Precompute evaluation-domain key material: per-channel NTT of
        coeff-domain keys, done ONCE at key setup instead of per call.

        ksk: any layout with the extended-basis channel axis at ``ch_axis``
        and coefficients last — (dnum, K, n) for ``keyswitch`` (default
        ch_axis=1), (nk, dnum, K, n) for ``hoisted_keyswitch`` (ch_axis=2).
        Pass the result with ksk_domain="ntt"; outputs are bit-identical
        to the coeff-domain path.
        """
        qs_ext = tuple(ext.qs) if isinstance(ext, RNSRing) else tuple(
            int(q) for q in ext
        )
        ext_ring = self._ext_rings.get(qs_ext)
        if ext_ring is None:
            ext_ring = ext if isinstance(ext, RNSRing) else RNSRing(
                self.n, qs=qs_ext
            )
            self._ext_rings[qs_ext] = ext_ring
        arr = jnp.moveaxis(_as_u32(ksk), ch_axis, 0)
        return jnp.moveaxis(ext_ring.ntt(arr), 0, ch_axis)

    def hoisted_keyswitch(
        self, x, ksks, ks, ext, dnum: int, *, correction: str = "float",
        ksk_domain: str = "coeff", plain_mod: Optional[int] = None,
    ) -> jnp.ndarray:
        """Hoisted (Halevi-Shoup) rotation batch: ONE gadget decomposition +
        ONE forward transform of the digits, shared by every Galois step.

        The BSGS matrix-vector serving primitive: where ``keyswitch`` per
        rotation costs a full ModUp + dnum*K forward transforms, here the
        digits are decomposed and NTT'd once; each step k then pays only a
        slot permutation (tau_k is a pure gather in the evaluation domain),
        the pointwise dot, one inverse transform, and the ModDown.  Valid
        because tau_k is a ring automorphism of R_Q: applying it to the
        gadget reconstruction identity sum_d t_d * g_d = x (mod Q) shows
        tau_k(t_d) is a decomposition of tau_k(x) with the same magnitude
        bound (so the same keyswitch noise), even though it differs
        digit-wise from decompose(tau_k(x)).

        x:    (L, ..., n) residues in this ring's basis (the c1 part).
        ksks: (nk, dnum, K, n) key material in ``ext``, one rotation key per
              step, shared across the batch (key k must encrypt
              P * g_d * tau_k(s)).  ksk_domain="ntt" accepts keys
              pre-transformed via ``ksk_to_ntt(ksks, ext, ch_axis=2)``.
        ks:   sequence of odd Galois exponents (static; cached per tuple).
        Returns (nk, L, ..., n): entry j is keyswitch(tau_{ks[j]}(x), ksks[j]),
        to be added to tau_{ks[j]}(c0) by the caller.

        No reference analog (the reference has no ring-operation layer);
        the hoisting recipe follows the public hybrid-key-switch literature
        (see PAPERS.md).
        """
        from .ops import basechange, gadget

        x = _as_u32(x)
        self._check(x)
        ksks = _as_u32(ksks)
        if ksk_domain not in ("coeff", "ntt"):
            raise ValueError(f"unknown ksk_domain {ksk_domain!r}")
        ks = tuple(int(k) % (2 * self.n) for k in ks)
        for k in ks:
            if k % 2 == 0:
                raise ValueError(f"Galois exponents must be odd, got {k}")
        qs_ext = tuple(ext.qs) if isinstance(ext, RNSRing) else tuple(
            int(q) for q in ext
        )
        if qs_ext[: self.L] != tuple(self.qs):
            raise ValueError(
                "ext basis must extend this ring's (first L primes equal)"
            )
        K = len(qs_ext)
        if K <= self.L:
            raise ValueError("ext basis must add at least one special prime")
        if ksks.shape != (len(ks), dnum, K, self.n):
            raise ValueError(
                f"ksks must be (nk={len(ks)}, dnum={dnum}, K={K}, "
                f"n={self.n}), got {ksks.shape}"
            )
        ext_ring = self._ext_rings.get(qs_ext)
        if ext_ring is None:
            ext_ring = ext if isinstance(ext, RNSRing) else RNSRing(
                self.n, qs=qs_ext
            )
            self._ext_rings[qs_ext] = ext_ring
        key = ("hoisted_keyswitch", qs_ext, int(dnum), ks, correction, x.ndim,
               ksk_domain, plain_mod)
        fn = self._jit_cache.get(key)
        if fn is None:
            qs_src, d, corr = tuple(self.qs), int(dnum), correction
            gadget.gadget_groups(len(qs_src), d)  # validate eagerly
            spec = K - self.L
            # evaluation-domain tau_k slot tables are q-independent: one
            # numpy table per step (numpy, not device arrays — builders may
            # run under an enclosing trace, see CLAUDE.md)
            perms = [ext_ring.rings[0]._auto_tables(k)[2] for k in ks]
            erings = ext_ring.rings
            pre_ntt = ksk_domain == "ntt"
            pm = None if plain_mod is None else int(plain_mod)

            def down(prod):
                if pm is None:
                    return basechange.mod_down(prod, qs_ext, spec)
                return basechange.mod_down_bgv(prod, qs_ext, pm, spec)

            def f(v, kk):
                dig = gadget.gadget_decompose(
                    v, qs_src, qs_ext, d, correction=corr
                )  # (dnum, K, ..., n)
                dnt = ext_ring.ntt(jnp.moveaxis(dig, 0, 1))  # (K, d, ..., n)
                kt = jnp.moveaxis(kk, 2, 0)                  # (K, nk, d, n)
                knt = kt if pre_ntt else ext_ring.ntt(kt)
                mid = dnt.ndim - 3  # x's middle dims
                outs = []
                for j in range(len(ks)):
                    pd = jnp.take(dnt, jnp.asarray(perms[j]), axis=-1)
                    kj = knt[:, j].reshape(
                        (K, d) + (1,) * mid + (self.n,)
                    )
                    prod = _evaldot_intt(erings, pd, kj, d)  # (K, ..., n)
                    outs.append(down(prod))
                return jnp.stack(outs, axis=0)

            fn = jax.jit(f)
            self._jit_cache[key] = fn
        return fn(x, ksks)

    def hoisted_linear_sum(
        self, c0, c1, pts, ksks_b, ksks_a, ks, ext, dnum: int, *,
        correction: str = "float", ksk_domain: str = "coeff",
        pt_domain: str = "coeff", plain_mod: Optional[int] = None,
    ):
        """Fused BSGS linear transform: sum_j pt_j (*) tau_{k_j}(ct) over a
        ciphertext ct = (c0, c1), with the key-switch hoisted AND the ModDown
        deferred — the homomorphic matrix-vector inner loop.

        On top of ``hoisted_keyswitch``'s sharing (one gadget decomposition +
        one digit transform for every step), this fuses the per-step
        plaintext multiply into the evaluation domain and accumulates the
        extended-basis products BEFORE the ModDown, so the whole nk-term sum
        pays ONE inverse-transform set and ONE ModDown per ciphertext part
        instead of nk — the standard deferred-ModDown BSGS recipe from the
        hybrid-key-switch literature (PAPERS.md).  Exact semantics (the spec
        the tests pin, built from public ops):

            accB = sum_j ext.polymul(pt_j, ext.polydot(tau_kj(digits), kb_j))
            accA = ...                  (same with ka_j)
            out0 = sum_j polymul(pt_j[:L], automorphism(c0, k_j))
                   + mod_down(accB)
            out1 = mod_down(accA)

        (The per-step ModDown rounding is therefore applied once to the
        accumulated sum — the scheme-level noise is sum_j |pt_j| * e_round
        either way; the deferred form is what production BSGS uses.)

        c0, c1: (L, ..., n) ciphertext parts, coefficient domain.
        pts:    (nk, K, n) plaintext weights as residues in the EXTENDED
                basis (first L rows double as the base-ring residues for the
                c0 part), shared across the batch.  pt_domain="ntt" accepts
                weights pre-transformed via ``ext.ntt(moveaxis(pts, 1, 0))``
                moved back — i.e. ``ksk_to_ntt(pts, ext, ch_axis=1)``.
        ksks_b, ksks_a: (nk, dnum, K, n) rotation-key halves (key j must
                encrypt P * g_d * tau_{k_j}(s)); ksk_domain="ntt" accepts
                ``ksk_to_ntt(..., ch_axis=2)`` material.
        ks:     odd Galois exponents, one per term (static, cached).
        Returns (out0, out1), each (L, ..., n): the linear-transform result
        as a fresh ciphertext under the original key.

        No reference analog (the reference stops at the transform layer);
        this is the production serving op its NTT feeds in an FHE stack.
        """
        from .ops import basechange, gadget

        c0 = _as_u32(c0)
        c1 = _as_u32(c1)
        self._check(c0)
        self._check(c1)
        pts = _as_u32(pts)
        ksks_b = _as_u32(ksks_b)
        ksks_a = _as_u32(ksks_a)
        for name, dom in (("ksk_domain", ksk_domain), ("pt_domain", pt_domain)):
            if dom not in ("coeff", "ntt"):
                raise ValueError(f"unknown {name} {dom!r}")
        ks = tuple(int(k) % (2 * self.n) for k in ks)
        for k in ks:
            if k % 2 == 0:
                raise ValueError(f"Galois exponents must be odd, got {k}")
        qs_ext = tuple(ext.qs) if isinstance(ext, RNSRing) else tuple(
            int(q) for q in ext
        )
        if qs_ext[: self.L] != tuple(self.qs):
            raise ValueError(
                "ext basis must extend this ring's (first L primes equal)"
            )
        K = len(qs_ext)
        if K <= self.L:
            raise ValueError("ext basis must add at least one special prime")
        nk = len(ks)
        for nm, arr in (("ksks_b", ksks_b), ("ksks_a", ksks_a)):
            if arr.shape != (nk, dnum, K, self.n):
                raise ValueError(
                    f"{nm} must be (nk={nk}, dnum={dnum}, K={K}, "
                    f"n={self.n}), got {arr.shape}"
                )
        if pts.shape != (nk, K, self.n):
            raise ValueError(
                f"pts must be (nk={nk}, K={K}, n={self.n}), got {pts.shape}"
            )
        ext_ring = self._ext_rings.get(qs_ext)
        if ext_ring is None:
            ext_ring = ext if isinstance(ext, RNSRing) else RNSRing(
                self.n, qs=qs_ext
            )
            self._ext_rings[qs_ext] = ext_ring
        key = ("hoisted_linear_sum", qs_ext, int(dnum), ks, correction,
               c0.ndim, ksk_domain, pt_domain, plain_mod)
        fn = self._jit_cache.get(key)
        if fn is None:
            qs_src, d, corr = tuple(self.qs), int(dnum), correction
            gadget.gadget_groups(len(qs_src), d)  # validate eagerly
            spec = K - self.L
            # eval-domain tau_k slot tables are q-independent (numpy, not
            # device arrays — builders may run under an enclosing trace)
            perms = [ext_ring.rings[0]._auto_tables(k)[2] for k in ks]
            erings = ext_ring.rings
            brings = self.rings
            pre_ntt = ksk_domain == "ntt"
            pre_pt = pt_domain == "ntt"
            this = self
            n = self.n
            pm = None if plain_mod is None else int(plain_mod)

            def down(prod):
                if pm is None:
                    return basechange.mod_down(prod, qs_ext, spec)
                return basechange.mod_down_bgv(prod, qs_ext, pm, spec)

            def f(v0, v1, pt, kb, ka):
                dig = gadget.gadget_decompose(
                    v1, qs_src, qs_ext, d, correction=corr
                )  # (dnum, K, ..., n)
                dnt = ext_ring.ntt(jnp.moveaxis(dig, 0, 1))  # (K, d, ..., n)
                kbt = jnp.moveaxis(kb, 2, 0)                 # (K, nk, d, n)
                kat = jnp.moveaxis(ka, 2, 0)
                if not pre_ntt:
                    kbt, kat = ext_ring.ntt(kbt), ext_ring.ntt(kat)
                ptt = jnp.moveaxis(pt, 1, 0)                 # (K, nk, n)
                if not pre_pt:
                    ptt = ext_ring.ntt(ptt)
                c0nt = this.ntt(v0)                          # (L, ..., n)
                mid = dnt.ndim - 3  # ciphertext middle (batch) dims
                kshape = (d,) + (1,) * mid + (n,)
                pshape = (1,) * mid + (n,)
                outB, outA = [], []
                for i, r in enumerate(erings):
                    q, qi, two_q = r.q, r.qinv_neg, U32(2 * r.q)
                    aB = aA = None
                    for j in range(nk):
                        pd = jnp.take(
                            dnt[i], jnp.asarray(perms[j]), axis=-1
                        )  # (d, ..., n)
                        tb = mont_mul_lazy(
                            pd, kbt[i, j].reshape(kshape), q, qi
                        )
                        ta = mont_mul_lazy(
                            pd, kat[i, j].reshape(kshape), q, qi
                        )
                        db, da = tb[0], ta[0]
                        for dd in range(1, d):
                            db = cond_sub(db + tb[dd], two_q)
                            da = cond_sub(da + ta[dd], two_q)
                        pj = ptt[i, j].reshape(pshape)
                        vb = mont_mul_lazy(pj, db, q, qi)
                        va = mont_mul_lazy(pj, da, q, qi)
                        aB = vb if aB is None else cond_sub(aB + vb, two_q)
                        aA = va if aA is None else cond_sub(aA + va, two_q)
                    # two stray R^{-1} (digit dot + pt multiply): fold R^2
                    s2 = r.n_inv * r.r2_mod_q % r.q
                    outB.append(r.intt(aB, scale=s2))
                    outA.append(r.intt(aA, scale=s2))
                Bdn = down(jnp.stack(outB, axis=0))
                out1 = down(jnp.stack(outA, axis=0))
                # c0 part on the base ring: one stray R^{-1} -> polymul_scale
                out0 = []
                for i, r in enumerate(brings):
                    q, qi, two_q = r.q, r.qinv_neg, U32(2 * r.q)
                    aC = None
                    for j in range(nk):
                        pc = jnp.take(
                            c0nt[i], jnp.asarray(perms[j]), axis=-1
                        )
                        vc = mont_mul_lazy(
                            ptt[i, j].reshape(pshape), pc, q, qi
                        )
                        aC = vc if aC is None else cond_sub(aC + vc, two_q)
                    csum = r.intt(aC, scale=r.polymul_scale)
                    out0.append(cond_sub(csum + Bdn[i], U32(q)))
                return jnp.stack(out0, axis=0), out1

            fn = jax.jit(f)
            self._jit_cache[key] = fn
        return fn(c0, c1, pts, ksks_b, ksks_a)

    def gadget_decompose(
        self, x, dst, dnum: int, *, correction: str = "float"
    ) -> jnp.ndarray:
        """Hybrid-key-switch gadget split: (L, ..., n) -> (dnum, K, ..., n).

        Digit d = fast base conversion of the d-th contiguous prime-group's
        residues into ``dst`` (an RNSRing or prime sequence — typically the
        extended basis Q u P, which may overlap this ring's primes).  With
        correction="float" each digit is exactly [x]_{Q_d} in dst; the
        (Q/Q_d)-gadget factors live in the evaluation key, so key-switching
        is polydot(digits, ksk) per digit summed.  dnum=L is per-prime GHS
        decomposition; dnum=1 is plain base conversion.  Coefficient
        domain; inputs in [0, q_l).
        """
        from .ops import gadget

        x = _as_u32(x)
        self._check(x)
        qs_dst = tuple(dst.qs) if isinstance(dst, RNSRing) else tuple(
            int(q) for q in dst
        )
        key = ("gadget_decompose", qs_dst, int(dnum), correction)
        fn = self._jit_cache.get(key)
        if fn is None:
            qs_src, d, corr = tuple(self.qs), int(dnum), correction
            gadget.gadget_groups(len(qs_src), d)  # validate eagerly
            fn = jax.jit(
                lambda v: gadget.gadget_decompose(
                    v, qs_src, qs_dst, d, correction=corr
                )
            )
            self._jit_cache[key] = fn
        return fn(x)

    def drop_prime(self, count: int = 1) -> "RNSRing":
        """The ring over ``qs[:-count]`` — the post-rescale/mod_down home
        basis."""
        if not 1 <= count <= self.L - 1:
            raise ValueError(
                f"count must be in [1, L-1={self.L - 1}], got {count}"
            )
        return RNSRing(self.n, qs=self.qs[:-count])

    def to_rns(self, coeffs) -> np.ndarray:
        """Host-side: big-int coefficients (..., n) -> residues (L, ..., n)."""
        arr = np.asarray(coeffs, dtype=object)
        out = np.stack(
            [(arr % q).astype(np.uint32) for q in self.qs], axis=0
        )
        return out

    def from_rns(self, residues) -> np.ndarray:
        """Host-side CRT reconstruction -> big-int array (..., n), object dtype."""
        from .utils.crt import crt_compose

        return crt_compose(np.asarray(residues), self.qs)


class WideRing:
    """R_q = Z_q[X]/(X^n + 1) at the reference's full u64 word width.

    The reference kernel's word size is u64 — its mulmod synthesizes a
    64x64->high-64 product from 32x32 partials (``HEXL_FPGA_USE_64BIT_MULT``,
    ``/root/reference/src/kernel/ntt.cpp:26-37, 346-363``), so it accepts any
    prime up to the Harvey bound q < 2**62.  ``Ring`` deliberately runs a
    32-bit word scheme (q < 2**30: the SEAL-Embedded primes the reference
    actually targets, README.md:13) and covers larger composite moduli via
    ``RNSRing``; WideRing restores the remaining generality — a SINGLE prime
    up to 2**62 — as an XLA correctness/compatibility tier built on
    ``ops/wide.py`` limb-pair arithmetic (uint32 words, 16-bit-limb partial
    products; pure jnp, runs on any backend).

    I/O convention: methods accept and return numpy uint64 arrays (host
    round-trip, the ergonomic default since JAX x64 is off) OR ``(lo, hi)``
    uint32 limb-pair tuples (device-resident, jit-composable).  The output
    kind matches the input kind.
    """

    def __init__(self, n: int, q: Optional[int] = None, *, psi: Optional[int] = None):
        from .ops import wide

        if q is None:
            q = find_primes(n, 1, bits=62)[0]
        if q >= (1 << 62):
            raise ValueError(
                f"q must be < 2**62 (Harvey lazy range 4q < 2**64), got {q}"
            )
        self.n = n
        self.q = q
        self.params = make_params(n, q, psi)  # u64 tables (roots/precon64)
        self.n_inv = self.params.n_inv
        self.qinv_neg = wide.mont_qinv_neg64(q)
        self.r_mod_q = (1 << 64) % q
        self.polymul_scale = self.n_inv * self.r_mod_q % q
        # stage tables as numpy uint32 limb pairs (numpy, not device arrays:
        # builders may run under an enclosing trace — see CLAUDE.md)
        self._fwd_tabs = wide.split_u64_np(self.params.roots) + wide.split_u64_np(
            self.params.precon64
        )
        self._inv_tabs = wide.split_u64_np(self.params.inv_roots) + wide.split_u64_np(
            self.params.inv_precon64
        )
        self._jit_cache = {}

    def _jitted(self, name, builder):
        fn = self._jit_cache.get(name)
        if fn is None:
            fn = jax.jit(builder())
            self._jit_cache[name] = fn
        return fn

    # -- I/O plumbing ---------------------------------------------------------

    def _ingest(self, x):
        """-> ((lo, hi), was_numpy).  Accepts numpy uint64 / ints or a
        (lo, hi) uint32 pair."""
        from .ops import wide

        if isinstance(x, tuple):
            lo, hi = x
            return (jnp.asarray(lo, jnp.uint32), jnp.asarray(hi, jnp.uint32)), False
        arr = np.asarray(x, dtype=np.uint64)
        if arr.shape[-1] != self.n:
            raise ValueError(f"last dim must be n={self.n}, got {arr.shape}")
        lo, hi = wide.split_u64_np(arr)
        return (jnp.asarray(lo), jnp.asarray(hi)), True

    def _egest(self, pair, was_numpy: bool):
        from .ops import wide

        if was_numpy:
            return wide.join_u64_np(np.asarray(pair[0]), np.asarray(pair[1]))
        return pair

    # -- transforms -----------------------------------------------------------

    def ntt(self, x):
        """Forward negacyclic NTT, output in [0, q) (full u64 word width)."""
        from .ops import wide

        pair, host = self._ingest(x)
        tabs, n, q = self._fwd_tabs, self.n, self.q
        fn = self._jitted(
            "ntt", lambda: lambda lo, hi: wide.fwd_stages64((lo, hi), tabs, n, q)
        )
        return self._egest(fn(*pair), host)

    def intt(self, x, *, scale: Optional[int] = None):
        """Inverse negacyclic NTT (accepts lazy [0, 2q) input), output [0, q)."""
        from .ops import wide

        pair, host = self._ingest(x)
        sc = self.n_inv if scale is None else scale
        tabs, n, q = self._inv_tabs, self.n, self.q
        fn = self._jitted(
            ("intt", sc),
            lambda: lambda lo, hi: wide.inv_stages64((lo, hi), tabs, n, q, sc),
        )
        return self._egest(fn(*pair), host)

    # -- ring arithmetic --------------------------------------------------------

    def polymul(self, a, b):
        """Negacyclic a*b mod (X^n + 1, q): NTT x2, Montgomery pointwise
        (R = 2**64), inverse with R^-1 folded into the n^-1 scale."""
        from .ops import wide

        pa, host = self._ingest(a)
        pb, _ = self._ingest(b)
        tabs_f, tabs_i = self._fwd_tabs, self._inv_tabs
        n, q, sc = self.n, self.q, self.polymul_scale
        qinv = self.qinv_neg

        def build():
            def f(alo, ahi, blo, bhi):
                fa = wide.fwd_stages64((alo, ahi), tabs_f, n, q)
                fb = wide.fwd_stages64((blo, bhi), tabs_f, n, q)
                prod = wide.mont_mul_lazy64(
                    fa, fb, wide.u64c(q), wide.u64c(qinv)
                )
                return wide.inv_stages64(prod, tabs_i, n, q, sc)

            return f

        fn = self._jitted("polymul", build)
        return self._egest(fn(*pa, *pb), host)

    def pointwise_mul(self, a, b):
        """Exact elementwise a*b mod q in [0, q) for NTT-domain operands."""
        from .ops import wide

        pa, host = self._ingest(a)
        pb, _ = self._ingest(b)
        q, qinv = self.q, self.qinv_neg
        r2 = pow(1 << 64, 2, q)

        def build():
            def f(alo, ahi, blo, bhi):
                t = wide.mont_mul_lazy64(
                    (alo, ahi), (blo, bhi), wide.u64c(q), wide.u64c(qinv)
                )
                t = wide.mont_mul_lazy64(
                    t, wide.u64c(r2), wide.u64c(q), wide.u64c(qinv)
                )
                return wide.cond_sub64(t, wide.u64c(q))

            return f

        fn = self._jitted("pw_exact", build)
        return self._egest(fn(*pa, *pb), host)

    def add(self, a, b):
        from .ops import wide

        pa, host = self._ingest(a)
        pb, _ = self._ingest(b)
        q = self.q
        fn = self._jitted(
            "add",
            lambda: lambda alo, ahi, blo, bhi: wide.cond_sub64(
                wide.add64((alo, ahi), (blo, bhi)), wide.u64c(q)
            ),
        )
        return self._egest(fn(*pa, *pb), host)

    def sub(self, a, b):
        from .ops import wide

        pa, host = self._ingest(a)
        pb, _ = self._ingest(b)
        q = self.q
        fn = self._jitted(
            "sub",
            lambda: lambda alo, ahi, blo, bhi: wide.cond_sub64(
                wide.add64(wide.sub64((alo, ahi), (blo, bhi)), wide.u64c(q)),
                wide.u64c(q),
            ),
        )
        return self._egest(fn(*pa, *pb), host)

    def __repr__(self):
        return f"WideRing(n={self.n}, q={self.q})"
