"""Leveled RNS-BFV evaluator: scale-invariant exact FHE on the RNS ring stack.

The third classical RNS scheme (with :mod:`.ckks` and :mod:`.bgv` — the
reference's transform is HEXL-FPGA's NTT, the accelerator kernel of exactly
these hosts, `/root/reference/src/kernel/ntt.cpp`).  BFV stores the message
in the HIGH bits — phase = Δ·m + e with Δ = floor(Q/t) — so, unlike BGV,
fresh noise never multiplies by t and ciphertexts at different moduli hold
the same message without tracked correction factors (scale-invariance).

What changes relative to the inherited BGV machinery:

- encode is Δ-scaled (per-channel host mulmod by [Δ]_{q_i}); decode is the
  exact big-int rounding m = round(t·phase/Q) mod t.  The [0, Q)
  representative suffices: x and x+Q round to values ≡ mod t.
- noise is plain e (``_noise_mul = 1``) and every key-switch ModDown is the
  plain divide-and-round (``_ks_plain_mod = None``) — rounding adds ~1/2,
  absorbed by Δ ≈ Q/t.
- multiply is the HPS/BEHZ big-base pipeline, fused into ONE dispatch:
  lift both ciphertexts from Q to the union basis Q ∪ B ∪ {m_sk}
  (float-corrected fast conversion; a band miss adds +Q to a coefficient,
  a standard bounded noise term), Karatsuba tensor in the big base through
  the fused multi-prime kernels, scale each part by t/Q with the HPS
  folded rounding (``ops/basechange.scale_round``), and come back to Q
  EXACTLY via the Shenoy-Kumaresan redundant-modulus conversion
  (``ops/basechange.base_convert_sk``) — no float band on the return path.
- modulus switching is the plain divide-and-round ``rescale`` (Δ scales
  with Q, so the message is preserved and ``scale`` stays 1); level
  alignment iterates it (RNS limb-dropping would destroy the high bits).

Rotations, conjugation, relinearization, fused BSGS linear transforms, and
the two-level BSGS matvec all inherit: the slot algebra is BGV's (packing
via the framework's own mod-t transform), and the key-switch hooks resolve
to the CKKS-style plain ModDown.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Dict, Optional, Tuple

import jax.numpy as jnp
import numpy as np

from ..api import RNSRing
from ..ops import basechange
from ..params import find_primes
from .bgv import BGVContext
from .ckks import Ciphertext, KeySet, Plaintext

__all__ = ["BFVContext"]


class BFVContext(BGVContext):
    """Leveled RNS-BFV over Z[X]/(X^n + 1): plaintexts in R_t, exact,
    scale-invariant (message in the high bits, Δ = floor(Q_level / t)).

    Slots: a (2, n/2) integer matrix mod t (the BGV slot structure).
    ``scale`` is always 1 — BFV tracks no message factor.
    """

    def __init__(self, n: int, num_primes: int = 3, **kwargs):
        super().__init__(n, num_primes, **kwargs)
        # undo the BGV noise/keyswitch hooks: BFV noise is plain e and the
        # key-switch ModDown is the plain divide-and-round
        self._noise_mul = 1
        self._ks_plain_mod = None
        self._bfv_aux: Dict[int, Tuple[Tuple[int, ...], RNSRing]] = {}

    # -- encoder ---------------------------------------------------------

    def delta_at(self, level: int) -> int:
        """Δ = floor(Q_level / t), the message scale at ``level``."""
        return self.q_at(level) // self.t

    def encode(self, mat, *, level: Optional[int] = None, scale=None
               ) -> Plaintext:
        """Slot matrix (..., 2, n/2) mod t -> Δ-scaled Plaintext (for
        encrypt / add_plain).  For multiplication plaintexts use
        :meth:`encode_mul` — a Δ² product would overflow."""
        level = self.L if level is None else int(level)
        if scale is not None and Fraction(scale) != 1:
            raise ValueError("BFV is scale-invariant; scale must be 1")
        m = self._slots_to_coeffs(mat).astype(np.uint64)  # [0, t)
        delta = self.delta_at(level)
        rns = np.stack(
            [((delta % q) * m % q).astype(np.uint32)
             for q in self.qs[:level]]
        )
        return Plaintext(jnp.asarray(rns), level, Fraction(1))

    def encode_mul(self, mat, *, level: Optional[int] = None) -> Plaintext:
        """Raw (un-scaled) encoding mod each prime — the mul_plain /
        LinearOp weight form: phase Δ·m times raw w stays Δ·(m·w)."""
        return BGVContext.encode(self, mat, level=level)

    def decode(self, pt: Plaintext) -> np.ndarray:
        """Plaintext (a decrypt phase) -> (..., 2, n/2) slots, exact:
        m = round(t·phase / Q) mod t via host big-int CRT."""
        if pt.scale != 1:
            raise ValueError(f"BFV plaintexts carry scale 1, got {pt.scale}")
        ring = self.base_ring(pt.level)
        big = ring.from_rns(np.asarray(pt.rns))  # object ints in [0, Q)
        q = ring.modulus
        m = ((2 * self.t * big + q) // (2 * q)) % self.t
        vals = np.asarray(self.tring.ntt(m.astype(np.uint32)))
        out = np.empty(m.shape[:-1] + (2, self.n // 2), dtype=np.int64)
        out[..., 0, :] = vals[..., self._slot_pos[0]]
        out[..., 1, :] = vals[..., self._slot_pos[1]]
        return out

    # -- plaintext ops ------------------------------------------------------

    def add_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        """Δ-encodings are level-specific (Δ depends on Q_level): unlike
        small-residue encodings they cannot be channel-sliced."""
        if pt.level != ct.level:
            raise ValueError(
                f"BFV add_plain needs the plaintext encoded at the "
                f"ciphertext's level ({ct.level}), got {pt.level}"
            )
        return super().add_plain(ct, pt)

    # -- modulus switching ----------------------------------------------------

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        """BFV modulus switch: plain divide-and-round by the level's last
        prime.  Δ scales with Q, so the message is untouched (scale-
        invariance); noise gains only the ~(1 + ||s||_1)/2 rounding term."""
        r = self.ring(ct.level)
        return Ciphertext(
            r.rescale(ct.c0), r.rescale(ct.c1), ct.level - 1, ct.scale
        )

    def mod_down_to(self, ct: Ciphertext, level: int) -> Ciphertext:
        """Align by iterated modulus switching (limb-dropping is a BGV/CKKS
        move — it would destroy BFV's high-bit message)."""
        if level > ct.level:
            raise ValueError(f"cannot raise level {ct.level} -> {level}")
        self.base_ring(max(level, 1))  # validates the target level
        while ct.level > level:
            ct = self.rescale(ct)
        return ct

    # -- the HPS multiply pipeline ---------------------------------------------

    def _aux(self, level: int) -> Tuple[Tuple[int, ...], RNSRing]:
        """Auxiliary basis for the big-base tensor at ``level``: primes
        B ∪ {m_sk} disjoint from (Q, P, t) with B > 4·n·t·Q_level·2^4 —
        the tensor of two [0, 2Q) representatives scales to
        y = round(t·x/Q) < 4·n·t·Q + 1, and Shenoy-Kumaresan needs y < B.
        Also returns the union ring Q_level ∪ B ∪ {m_sk} (the tensor runs
        through its fused multi-prime kernels)."""
        hit = self._bfv_aux.get(level)
        if hit is not None:
            return hit
        used = set(self.qs) | {self.p, self.t}
        bound = 64 * self.n * self.t * self.q_at(level)
        cands = [
            q for q in find_primes(self.n, self.L + 1 + level + 4)
            if q not in used
        ]
        bs, prod = [], 1
        for q in cands:
            if prod > bound:
                break
            bs.append(q)
            prod *= q
        if prod <= bound or len(cands) <= len(bs):
            raise ValueError(
                f"not enough auxiliary primes for level {level}"
            )
        aux = tuple(bs) + (cands[len(bs)],)   # last = m_sk
        rbig = RNSRing(
            self.n, qs=tuple(self.qs[:level]) + aux, **self._ring_kwargs
        )
        self._bfv_aux[level] = (aux, rbig)
        return aux, rbig

    def _mul_fused(self, level: int, square: bool):
        """One dispatch for the whole multiply: lift -> big-base Karatsuba
        tensor -> HPS scale-and-round -> SK-exact return -> relinearize."""
        rq = self.base_ring(level)
        aux, rbig = self._aux(level)
        qs = tuple(self.qs[:level])
        bs, m_sk = aux[:-1], aux[-1]
        t, ext, lvl = self.t, self.ext_ring(level), level

        def build():
            def lift(c):
                return jnp.concatenate(
                    [c, basechange.base_convert(
                        c, qs, aux, correction="float")],
                    axis=0,
                )

            def down(d):
                y = basechange.scale_round(d[:lvl], d[lvl:], qs, aux, t)
                return basechange.base_convert_sk(
                    y[:-1], y[-1], bs, m_sk, qs
                )

            def relin(d0, d1, d2, karr):
                hs = rq.hoisted_keyswitch(
                    d2, karr, (1, 1), ext, lvl, ksk_domain="ntt"
                )
                return rq.add(d0, hs[0]), rq.add(d1, hs[1])

            if square:
                def f(a0, a1, karr):
                    d0, d1, d2 = rbig.tensor_square(lift(a0), lift(a1))
                    return relin(down(d0), down(d1), down(d2), karr)
            else:
                def f(a0, a1, b0, b1, karr):
                    d0, d1, d2 = rbig.tensor(
                        lift(a0), lift(a1), lift(b0), lift(b1)
                    )
                    return relin(down(d0), down(d1), down(d2), karr)
            return f

        return self._fused(("bfvsq" if square else "bfvmul", level), build)

    def _big_sharded(self, level: int):
        """The union-basis ring Q_level (+) aux as a ShardedRNSRing placed
        like the context's base rings (dp/sp; channel axis replicated —
        the aux channels travel with their Q siblings)."""
        key = ("bfv_big", level)
        r = self._sharded.get(key)
        if r is None:
            from ..parallel.mesh import ShardedRNSRing

            _, rbig = self._aux(level)
            r = ShardedRNSRing(
                rbig, self.mesh,
                dp_axis=self.dp_axis, sp_axis=self.sp_axis,
            )
            self._sharded[key] = r
        return r

    def _multiply_mesh(
        self, a: Ciphertext, b: Optional[Ciphertext], keys: KeySet
    ) -> Ciphertext:
        """The HPS pipeline on the mesh, composed from sharded ring ops
        (cf. the CKKS mesh multiply): every stage — the float-corrected
        lift, the big-base Karatsuba tensor, the HPS t/Q scale + SK-exact
        return, the hoisted relinearization — is channel-mixing at most,
        so dp/sp shards never exchange data outside the polymul transforms
        themselves.  Bit-identical to the fused single-chip pipeline
        (tests/test_bfv_sharded.py)."""
        level = a.level
        rq = self.ring(level)                 # ShardedRNSRing over Q_level
        aux, _ = self._aux(level)
        rbig = self._big_sharded(level)
        qs = tuple(self.qs[:level])

        def lift(c):
            ext = rq.base_convert(c, aux, correction="float")
            return rbig.shard(jnp.concatenate(
                [jnp.asarray(c, jnp.uint32), ext], axis=0
            ))

        a0, a1 = lift(a.c0), lift(a.c1)
        if b is None:
            d0 = rbig.polymul(a0, a0)
            d2 = rbig.polymul(a1, a1)
            x = rbig.polymul(a0, a1)
            d1 = rbig.add(x, x)
        else:
            b0, b1 = lift(b.c0), lift(b.c1)
            d0 = rbig.polymul(a0, b0)
            d2 = rbig.polymul(a1, b1)
            cross = rbig.polymul(rbig.add(a0, a1), rbig.add(b0, b1))
            d1 = rbig.sub(rbig.sub(cross, d0), d2)
        down = lambda d: rq.shard(rq.hps_scale_sk(d, qs, aux, self.t))
        d0q, d1q, d2q = down(d0), down(d1), down(d2)
        hs = self._keyswitch_pair(d2q, self._key_pair(keys), level, 1)
        return Ciphertext(
            rq.add(d0q, hs[0]), rq.add(d1q, hs[1]), level, Fraction(1)
        )

    def multiply(
        self, a: Ciphertext, b: Ciphertext, keys: KeySet
    ) -> Ciphertext:
        if a.level != b.level:
            raise ValueError(
                f"level mismatch {a.level} != {b.level}; mod_down_to first"
            )
        if self.mesh is not None:
            return self._multiply_mesh(a, b, keys)
        c0, c1 = self._mul_fused(a.level, square=False)(
            a.c0, a.c1, b.c0, b.c1,
            self._sliced_keys(self._key_pair(keys), a.level),
        )
        return Ciphertext(c0, c1, a.level, Fraction(1))

    def square(self, a: Ciphertext, keys: KeySet) -> Ciphertext:
        if self.mesh is not None:
            return self._multiply_mesh(a, None, keys)
        c0, c1 = self._mul_fused(a.level, square=True)(
            a.c0, a.c1, self._sliced_keys(self._key_pair(keys), a.level)
        )
        return Ciphertext(c0, c1, a.level, Fraction(1))
