"""Leveled RNS-BGV evaluator: exact integer arithmetic on the RNS ring stack.

The exact-arithmetic sibling of :mod:`~agilex_ntt.schemes.ckks` (the
reference's transform serves both families — HEXL-FPGA's host library is the
accelerator back end of an integer-FHE stack, `/root/reference/src/kernel/
ntt.cpp`).  All of the ring/key/keyswitch machinery is inherited from
``CKKSContext``; what changes is the plaintext algebra:

- messages live in R_t for an NTT-friendly prime t ≡ 1 (mod 2n), so slot
  packing IS this framework's own transform: encode = ``Ring(n, q=t).intt``
  of the slot matrix, decode = ``ntt`` — the scheme layer eats its own dog
  food (no separate encoder math);
- every sampled error is t·e (``_noise_mul = t``), so phases are m + t·(...)
  and decryption is exact: centered phase mod t;
- key switching ModDown and modulus switching use the t-multiple correction
  (``ops/basechange.rescale_bgv``): the subtracted correction is ≡ 0 mod t,
  so exactness survives division by P or q_L;
- modulus switching multiplies the message by q_L^{-1} mod t; the
  ``Ciphertext.scale`` field tracks the accumulated correction factor f
  (message = [phase]_t · f mod t), exactly as SEAL's BGV does.

Slots form a (2, n/2) matrix: tau_5 rotates each row cyclically, tau_{2n-1}
swaps the rows (the standard Galois structure of Z_t slots).  ``rotate`` /
``conjugate`` (row swap), ``multiply``/``square`` + relinearization,
``mod_down_to``, and the key-slicing level reuse all inherit unchanged.
"""

from __future__ import annotations

from fractions import Fraction
from typing import Optional, Sequence

import jax.numpy as jnp
import numpy as np

from ..api import Ring
from ..params import find_primes
from .ckks import Ciphertext, CKKSContext, KeySet, Plaintext

__all__ = ["BGVContext"]


class BGVContext(CKKSContext):
    """Leveled RNS-BGV over Z[X]/(X^n + 1): plaintexts in R_t, exact.

    t: NTT-friendly plaintext prime ≡ 1 (mod 2n); default the largest
    below 2^t_bits (t_bits=16), disjoint from the 30-bit ciphertext chain.
    Slots: a (2, n/2) integer matrix mod t.
    """

    def __init__(
        self,
        n: int,
        num_primes: int = 3,
        *,
        t: Optional[int] = None,
        t_bits: int = 16,
        **kwargs,
    ):
        super().__init__(n, num_primes, **kwargs)
        self.t = int(t) if t is not None else find_primes(n, 1, bits=t_bits)[0]
        if (self.t - 1) % (2 * n):
            raise ValueError(f"t={self.t} is not ≡ 1 mod 2n")
        if self.t in self.qs or self.t == self.p:
            raise ValueError("t must be disjoint from the ciphertext chain")
        self._noise_mul = self.t
        self._ks_plain_mod = self.t
        self.delta = 1  # BGV has no encoding scale; factors default to 1
        # the plaintext ring: slot packing via this framework's own NTT
        self.tring = Ring(n, q=self.t)
        self._slot_pos = self._build_slot_positions()

    # -- slot structure ------------------------------------------------------

    def _build_slot_positions(self) -> np.ndarray:
        """(2, n/2) table: output index of the plaintext ring's NTT that
        holds the evaluation at psi^(5^j) (row 0) / psi^(-5^j) (row 1).

        Derived, not assumed: transform the monomial X — its NTT output at
        position i is psi^{e_i}, a discrete log over the odd exponents
        recovers e_i, and the rows are the two <5>-orbits of the odd
        residues mod 2n."""
        n, t = self.n, self.t
        x = np.zeros(n, dtype=np.uint32)
        x[1] = 1
        ev = np.asarray(self.tring.ntt(x))
        psi = self.tring._psi
        dlog = {}
        v = psi % t
        for k in range(1, 2 * n, 2):
            dlog[v] = k
            v = (v * psi * psi) % t
        e = np.array([dlog[int(w)] for w in ev])
        idx_of = {int(ex): i for i, ex in enumerate(e)}
        pos = np.empty((2, n // 2), dtype=np.int64)
        r = 1
        for j in range(n // 2):
            pos[0, j] = idx_of[r]
            pos[1, j] = idx_of[2 * n - r]
            r = (r * 5) % (2 * n)
        return pos

    # -- encoder ---------------------------------------------------------------

    def encode(self, mat, *, level: Optional[int] = None, scale=None
               ) -> Plaintext:
        """Slot matrix (..., 2, n/2) of ints mod t -> Plaintext.

        Slot packing is the inverse transform of the plaintext ring itself;
        residues broadcast across the ciphertext chain (coefficients are
        already < t < q_l).  ``scale`` is the BGV correction factor
        (default 1) — encode at ``ct.scale`` to add/multiply into a
        modulus-switched ciphertext."""
        level = self.L if level is None else int(level)
        scale = Fraction(1) if scale is None else Fraction(scale)
        m = self._slots_to_coeffs(mat)
        rns = np.broadcast_to(m[None], (level,) + m.shape)
        return Plaintext(jnp.asarray(rns.copy()), level, scale)

    def _slots_to_coeffs(self, mat) -> np.ndarray:
        """Slot matrix (..., 2, n/2) -> coefficients (..., n) in [0, t)."""
        mat = np.asarray(mat, dtype=np.int64) % self.t
        if mat.shape[-2:] != (2, self.n // 2):
            raise ValueError(
                f"expected slots (..., 2, {self.n // 2}), got {mat.shape}"
            )
        vals = np.zeros(mat.shape[:-2] + (self.n,), dtype=np.uint32)
        vals[..., self._slot_pos[0]] = mat[..., 0, :]
        vals[..., self._slot_pos[1]] = mat[..., 1, :]
        return np.asarray(self.tring.intt(vals))

    def decode(self, pt: Plaintext) -> np.ndarray:
        """Plaintext -> (..., 2, n/2) slot matrix mod t (exact)."""
        ring = self.base_ring(pt.level)
        big = ring.from_rns(np.asarray(pt.rns))
        q = ring.modulus
        centered = np.where(big > q // 2, big - q, big)
        m = (centered % self.t).astype(np.int64)  # object ints -> exact
        f = pt.scale
        if f != 1:
            fi = (int(f.numerator) * pow(int(f.denominator), -1, self.t)) \
                % self.t
            m = (m * fi) % self.t
        vals = np.asarray(self.tring.ntt(m.astype(np.uint32)))
        out = np.empty(m.shape[:-1] + (2, self.n // 2), dtype=np.int64)
        out[..., 0, :] = vals[..., self._slot_pos[0]]
        out[..., 1, :] = vals[..., self._slot_pos[1]]
        return out

    # -- modulus switching -------------------------------------------------------

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        """BGV modulus switch by the level's last prime: noise divides by
        ~q_L, the message picks up the q_L factor tracked in ``scale``."""
        r = self.ring(ct.level)
        q_last = self.qs[ct.level - 1]
        return Ciphertext(
            r.rescale_bgv(ct.c0, self.t), r.rescale_bgv(ct.c1, self.t),
            ct.level - 1, ct.scale * q_last,
        )

    # -- fused linear transforms -----------------------------------------------
    # make_linear_op / apply_linear inherit: the weight encoder below packs
    # slot matrices with the plaintext ring's own transform, and the
    # _ks_plain_mod hook routes hoisted_linear_sum through the t-correcting
    # ModDown — sum_j w_j (*) rot_j(ct) stays EXACT mod t.

    def _encode_weights(self, w, scale, qs) -> np.ndarray:
        if scale != 1:
            raise ValueError(
                f"BGV weights carry no scale (factor must be 1), got {scale}"
            )
        m = self._slots_to_coeffs(w)
        return np.stack([(m % np.uint32(q)).astype(np.uint32) for q in qs])

    # -- BSGS matvec hooks ---------------------------------------------------
    # make_matvec/apply_matvec inherit; the matrix is integer mod t and acts
    # PER ROW: y_r = M @ z_r for both slot rows r (rotations shift each row
    # cyclically, so the Halevi-Shoup diagonal structure is row-wise).

    def _matvec_matrix(self, M) -> np.ndarray:
        S = self.n // 2
        M = np.asarray(M, dtype=np.int64) % self.t
        if M.shape != (S, S):
            raise ValueError(f"M must be ({S}, {S}) mod t, got {M.shape}")
        return M

    def _diag_slots(self, v) -> np.ndarray:
        # the same diagonal multiplies both rows (row-wise matvec)
        return np.stack([v, v])

    # -- poly_eval hooks -------------------------------------------------------
    # poly_eval itself inherits (the BSGS Paterson-Stockmeyer recursion is
    # scheme-agnostic); these three hooks swap the scale algebra: the BGV
    # "scale" is a mod-t correction factor (decode MULTIPLIES by it), so a
    # constant plaintext dictated to scale s carries residues c / s mod t
    # and everything stays exact.

    def _rescale_factor(self, level: int) -> Fraction:
        """BGV modulus switch MULTIPLIES the correction by the dropped
        prime (see :meth:`rescale`)."""
        return Fraction(self.qs[level - 1])

    def _poly_eval_scale(self) -> Fraction:
        return Fraction(1)

    def _poly_eval_min_level(self) -> int:
        return 1  # exact mod t: any level decodes

    def _const_pt(self, c, level: int, scale: Fraction,
                  nbatch: int = 0) -> Plaintext:
        if c != int(c):
            raise ValueError(
                f"BGV coefficients must be integers mod t, got {c!r}"
            )
        s_mod_t = (scale.numerator
                   * pow(scale.denominator, -1, self.t)) % self.t
        f = (int(c) % self.t) * pow(s_mod_t, -1, self.t) % self.t
        mat = np.full((1,) * nbatch + (2, self.n // 2), f, dtype=np.int64)
        return self.encode(mat, level=level, scale=scale)
