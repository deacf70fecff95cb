"""RNS-CKKS evaluator: approximate-arithmetic FHE on the RNS ring stack.

The reference implements the forward NTT of an FHE accelerator
(`/root/reference/src/kernel/ntt.cpp`; HEXL-FPGA's host library drives it
from exactly this kind of evaluator).  This module is the scheme layer that
transform exists to serve: a full leveled RNS-CKKS context — canonical-
embedding encoder, key generation, public/secret-key encryption, and the
evaluator ops (add, multiply + relinearize, rescale, rotate, conjugate,
plaintext ops, fused BSGS linear transforms) — with every polynomial
operation dispatched through :class:`~agilex_ntt.api.RNSRing`'s cached
jitted ops (each transform of all prime channels one kernel call on a GPU).

Design notes (device-first, not a port):

- Every hot op is a cached-jit ``RNSRing`` call over all active prime
  channels at once; ciphertexts may carry arbitrary batch dims
  ``(L, ..., n)`` and the whole scheme vectorizes over them.
- Key material is generated once in the top basis ``Q·P`` and stored in the
  evaluation domain (``ksk_to_ntt``).  At level ``l`` the same arrays are
  reused by slicing digit rows ``:l`` and channels ``(0..l-1, K-1)``: the
  CRT idempotents satisfy ``g_d ≡ g_d^(l) (mod Q_l)`` (both are 1 mod q_d
  and 0 mod the other active primes) and the gadget identity only needs to
  hold mod ``Q_l`` — the P·g_d·s' term is 0 mod P either way — so one key
  set serves every level.
- Relinearization and rotation each need the SAME decomposition switched
  against two key halves; both go through ``hoisted_keyswitch`` with
  ``ks=(g, g)`` so the gadget decomposition + digit transform run once.
- Uniform sampling is per-channel (independent uniform residues mod each
  q_i ARE uniform mod Q by CRT) — no big-int sampling anywhere; keygen's
  only host arithmetic is the CRT idempotents.

THIS IS A RESEARCH-GRADE SCHEME IMPLEMENTATION: parameter selection,
constant-time guarantees, and formal noise tracking are out of scope; the
tests pin functional correctness (exact decrypt identities where exact,
approximation error well under 1/scale elsewhere).
"""

from __future__ import annotations

import dataclasses
import math
from fractions import Fraction
from typing import Dict, List, Optional, Sequence, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..api import RNSRing
from ..params import find_primes

__all__ = [
    "CKKSContext",
    "Ciphertext",
    "KeySet",
    "LinearOp",
    "MatVecOp",
    "Plaintext",
    "encode_coeffs",
    "decode_coeffs",
]


# ---------------------------------------------------------------------------
# canonical-embedding encoder (host-side numpy FFT, O(n log n))
# ---------------------------------------------------------------------------


def _rot_group(n: int) -> np.ndarray:
    """Slot evaluation order: 5^j mod 2n, j = 0..n/2-1.

    The points {5^j} enumerate one representative per conjugate pair of the
    primitive 2n-th roots; successive powers of 5 make tau_5 a cyclic slot
    shift (the CKKS rotation convention).
    """
    out = np.empty(n // 2, dtype=np.int64)
    r = 1
    for j in range(n // 2):
        out[j] = r
        r = (r * 5) % (2 * n)
    return out


def encode_coeffs(z, n: int, scale) -> np.ndarray:
    """Complex slots (..., n/2) -> signed integer coefficients (..., n).

    Inverse canonical embedding: fill a conjugate-symmetric length-2n
    spectrum (slot j at index 5^j mod 2n, its conjugate at the negated
    index), inverse-FFT, and round the scaled real part.  The spectrum is
    supported on odd frequencies only, so the length-2n time signal is the
    negacyclic extension (m, -m) and the first half is the coefficient
    vector of an element of Z[X]/(X^n + 1).
    """
    z = np.asarray(z, dtype=np.complex128)
    if z.shape[-1] != n // 2:
        raise ValueError(f"expected {n // 2} slots, got {z.shape[-1]}")
    m2 = 2 * n
    rg = _rot_group(n)
    spec = np.zeros(z.shape[:-1] + (m2,), dtype=np.complex128)
    spec[..., rg] = 2.0 * z
    spec[..., m2 - rg] = 2.0 * np.conj(z)
    m = np.real(np.fft.ifft(spec, axis=-1))[..., :n]
    return np.rint(m * float(scale)).astype(np.int64)


def decode_coeffs(m, n: int, scale) -> np.ndarray:
    """Signed coefficients (..., n) -> complex slots (..., n/2).

    Forward canonical embedding: evaluate at the primitive 2n-th roots in
    5^j order (odd lines of a length-2n FFT), divide by the scale.
    """
    m = np.asarray(m, dtype=np.float64)
    if m.shape[-1] != n:
        raise ValueError(f"expected n={n} coefficients, got {m.shape[-1]}")
    spec = np.fft.fft(m, n=2 * n, axis=-1)
    return spec[..., _rot_group(n)] / float(scale)


# ---------------------------------------------------------------------------
# data types
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Plaintext:
    """Encoded message: residues (level, ..., n) at a scale."""

    rns: jnp.ndarray
    level: int
    scale: Fraction


@dataclasses.dataclass
class Ciphertext:
    """Degree-1 RLWE ciphertext (c0, c1), each (level, ..., n)."""

    c0: jnp.ndarray
    c1: jnp.ndarray
    level: int
    scale: Fraction


@dataclasses.dataclass
class KeySet:
    """Everything keygen produces.  ``sk`` is the secret — evaluator ops
    only ever read ``rlk`` / ``gk`` (evaluation-domain public material)."""

    sk: np.ndarray                 # ternary secret, host (n,) int64
    sk_rns: jnp.ndarray            # its residues in the full ext basis (K, n)
    pk: Tuple[jnp.ndarray, jnp.ndarray]        # (p0, p1), each (L, n)
    rlk: Tuple[jnp.ndarray, jnp.ndarray]       # eval-domain (dnum, K, n) x2
    gk: Dict[int, Tuple[jnp.ndarray, jnp.ndarray]]  # galois elt -> pair
    # coefficient-domain halves of the same material: the mesh-sharded
    # keyswitch ops transform keys inside the call (no ksk_domain support
    # there yet), so both domains are kept (a few (dnum, K, n) arrays)
    rlk_coeff: Tuple[jnp.ndarray, jnp.ndarray] = None
    gk_coeff: Dict[int, Tuple[jnp.ndarray, jnp.ndarray]] = None


@dataclasses.dataclass
class MatVecOp:
    """Pre-baked two-level BSGS matrix-vector product (build once, apply
    per ciphertext): baby-step rotation keys interleaved for one hoisted
    call, per-giant-step diagonal bundles for fused polydots, and sliced
    giant rotation keys."""

    b: int                          # baby steps (inner rotations)
    g: int                          # giant steps (outer rotations)
    baby_gs: Tuple[int, ...]        # galois elts for j = 1..b-1
    baby_ks: Tuple[int, ...]        # interleaved (g_j, g_j) hoisting plan
    baby_ksks: Optional[jnp.ndarray]   # (2(b-1), dnum_l, K_l, n)
    pts: jnp.ndarray                # diagonals: domain "ntt" (off-mesh)
                                    # = (level, g, b, n) eval domain;
                                    # "coeff" (mesh) = (g, level, b, n)
    giants: Tuple[Tuple[int, jnp.ndarray], ...]  # (elt, sliced key pair)
    level: int
    scale: Fraction
    domain: str = "ntt"


@dataclasses.dataclass
class LinearOp:
    """Pre-baked BSGS linear transform: eval-domain weights + keys for one
    level — the serving object (build once, apply per ciphertext)."""

    gs: Tuple[int, ...]
    pts: jnp.ndarray               # (nk, K_l, n), ext basis
    kb: jnp.ndarray                # (nk, dnum_l, K_l, n)
    ka: jnp.ndarray
    level: int
    scale: Fraction
    domain: str = "ntt"            # "ntt" off-mesh; "coeff" on-mesh


class CKKSContext:
    """Leveled RNS-CKKS over Z[X]/(X^n + 1) with an L-prime chain Q and one
    special prime P (hybrid key switching, per-prime digits).

    Also the base for :class:`~agilex_ntt.schemes.bgv.BGVContext`: the
    ring/key/keyswitch machinery is scheme-agnostic apart from two hooks —
    ``_noise_mul`` (BGV noise is t*e) and ``_ks_plain_mod`` (BGV ModDown
    uses the t-multiple correction).

    Parameters
    ----------
    n:           ring degree (power of two); n/2 complex slots.
    num_primes:  L, the ciphertext chain length (levels L..1).
    delta:       encoding scale (default 2^(bits-1)).
    qs, p:       explicit chain / special prime (default: the largest
                 NTT-friendly prime below 2^bits is P, the next L are Q —
                 P >= q_i keeps the key-switch noise ~|e|).
    rng:         numpy Generator for all sampling (keygen/encrypt).
    error_std:   rounded-gaussian error width.
    mesh:        optional jax.sharding.Mesh — evaluator ops then run on
                 ShardedRNSRing (batch over ``dp_axis``, coefficients over
                 ``sp_axis``), bit-identical to the single-chip path.
                 Ciphertexts must carry exactly one batch dim (L, B, n);
                 place them with :meth:`place`.  Keygen/encode/encrypt/
                 decrypt stay host-driven on the base rings.
    ring_kwargs: forwarded to every RNSRing/Ring (backend/method/...).
    """

    _noise_mul: int = 1        # every sampled error is multiplied by this
    _ks_plain_mod: Optional[int] = None  # t-correcting ModDown when set

    def __init__(
        self,
        n: int,
        num_primes: int = 3,
        *,
        delta: Optional[int] = None,
        qs: Optional[Sequence[int]] = None,
        p: Optional[int] = None,
        bits: int = 30,
        rng: Optional[np.random.Generator] = None,
        error_std: float = 3.2,
        mesh=None,
        dp_axis: str = "dp",
        sp_axis: Optional[str] = None,
        **ring_kwargs,
    ):
        if qs is None or p is None:
            primes = find_primes(n, num_primes + 1, bits=bits)
            if p is None:
                p = primes[0]          # largest -> special prime
            if qs is None:
                qs = [q for q in primes if q != p][:num_primes]
        self.n = int(n)
        self.qs: Tuple[int, ...] = tuple(int(q) for q in qs)
        self.p = int(p)
        self.L = len(self.qs)
        self.delta = int(delta) if delta is not None else 1 << (bits - 1)
        self.error_std = float(error_std)
        self.rng = rng if rng is not None else np.random.default_rng(0)
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.sp_axis = sp_axis
        self._ring_kwargs = ring_kwargs
        self._rings: Dict[int, RNSRing] = {}
        self._ext: Dict[int, RNSRing] = {}
        self._sharded: Dict[int, object] = {}
        self._key_slices: Dict[tuple, tuple] = {}
        self._fused_cache: Dict[tuple, object] = {}

    # -- bases ------------------------------------------------------------

    def base_ring(self, level: int) -> RNSRing:
        """The single-chip ring at ``level`` (primes qs[:level])."""
        if not 1 <= level <= self.L:
            raise ValueError(f"level must be in [1, {self.L}], got {level}")
        r = self._rings.get(level)
        if r is None:
            r = RNSRing(self.n, qs=self.qs[:level], **self._ring_kwargs)
            self._rings[level] = r
        return r

    def ring(self, level: int):
        """The ring evaluator ops dispatch to: the base ring, or its
        ShardedRNSRing wrapper when the context has a mesh."""
        if self.mesh is None:
            return self.base_ring(level)
        r = self._sharded.get(level)
        if r is None:
            from ..parallel.mesh import ShardedRNSRing

            r = ShardedRNSRing(
                self.base_ring(level), self.mesh,
                dp_axis=self.dp_axis, sp_axis=self.sp_axis,
            )
            self._sharded[level] = r
        return r

    def place(self, ct: Ciphertext) -> Ciphertext:
        """Place a ciphertext's parts with the mesh sharding (no-op
        without a mesh)."""
        if self.mesh is None:
            return ct
        r = self.ring(ct.level)
        return Ciphertext(
            r.shard(ct.c0), r.shard(ct.c1), ct.level, ct.scale
        )

    def ext_ring(self, level: int) -> RNSRing:
        """The extended ring at ``level`` (primes qs[:level] + (P,))."""
        r = self._ext.get(level)
        if r is None:
            r = RNSRing(
                self.n, qs=self.qs[:level] + (self.p,), **self._ring_kwargs
            )
            self._ext[level] = r
        return r

    def q_at(self, level: int) -> int:
        out = 1
        for q in self.qs[:level]:
            out *= q
        return out

    # -- encoder ----------------------------------------------------------

    def encode(
        self, z, *, level: Optional[int] = None, scale=None
    ) -> Plaintext:
        """Complex slots (..., n/2) -> Plaintext residues (level, ..., n)."""
        level = self.L if level is None else int(level)
        scale = Fraction(self.delta) if scale is None else Fraction(scale)
        m = encode_coeffs(z, self.n, scale)
        rns = np.stack(
            [(m % q).astype(np.uint32) for q in self.qs[:level]], axis=0
        )
        return Plaintext(jnp.asarray(rns), level, scale)

    def decode(self, pt: Plaintext) -> np.ndarray:
        """Plaintext -> complex slots, via exact CRT + centered lift."""
        ring = self.base_ring(pt.level)
        big = ring.from_rns(np.asarray(pt.rns))
        q = ring.modulus
        centered = np.where(big > q // 2, big - q, big).astype(np.float64)
        return decode_coeffs(centered, self.n, pt.scale)

    # -- sampling (host RNG; uniform-per-channel == uniform mod Q by CRT) --

    def _uniform(self, qs: Sequence[int], shape) -> np.ndarray:
        return np.stack(
            [
                self.rng.integers(0, q, size=shape).astype(np.uint32)
                for q in qs
            ],
            axis=0,
        )

    def _gauss_rns(self, qs: Sequence[int], shape) -> np.ndarray:
        e = self._noise_mul * np.rint(
            self.rng.normal(0.0, self.error_std, shape)
        ).astype(np.int64)
        return np.stack([(e % q).astype(np.uint32) for q in qs], axis=0)

    def _ternary(self, shape) -> np.ndarray:
        return self.rng.integers(-1, 2, size=shape).astype(np.int64)

    # -- key generation -----------------------------------------------------

    def _pg_residues(self) -> np.ndarray:
        """(dnum=L, K) table: P * g_d mod each ext prime, g_d the CRT
        idempotent of q_d in Q (1 mod q_d, 0 mod the other chain primes).
        Host big-int once at keygen; see module docstring for why the same
        table is valid at every level."""
        Q = self.q_at(self.L)
        ext_qs = self.qs + (self.p,)
        out = np.empty((self.L, self.L + 1), dtype=np.uint32)
        for d, qd in enumerate(self.qs):
            qhat = Q // qd
            g = qhat * pow(qhat % qd, -1, qd)
            pg = self.p * g
            out[d] = [pg % q for q in ext_qs]
        return out

    def _make_ksk(
        self, target_ext: jnp.ndarray, s_ext: jnp.ndarray, rqp: RNSRing
    ) -> Tuple[jnp.ndarray, jnp.ndarray]:
        """Gadget-encrypt ``target`` (residues (K, n) of the polynomial the
        key must carry, e.g. s^2 or tau_g(s)) under s: row d is
        (-(a_d s) + e_d + P g_d target, a_d).  Returns eval-domain halves
        (dnum, K, n) in BOTH domains: (b_ntt, a_ntt, b_coeff, a_coeff)."""
        K, n = self.L + 1, self.n
        ext_qs = np.array(self.qs + (self.p,), dtype=np.uint64)
        pg = self._pg_residues()
        tgt = np.asarray(target_ext).astype(np.uint64)
        a = self._uniform(self.qs + (self.p,), (self.L, n))  # (K, dnum, n)
        a = np.moveaxis(a, 0, 1)                             # (dnum, K, n)
        a_s = np.asarray(rqp.polymul(jnp.asarray(np.moveaxis(a, 1, 0)),
                                     s_ext[:, None, :]))     # (K, dnum, n)
        a_s = np.moveaxis(a_s, 0, 1).astype(np.uint64)       # (dnum, K, n)
        b = np.empty((self.L, K, n), dtype=np.uint32)
        for d in range(self.L):
            e = self._gauss_rns(self.qs + (self.p,), (n,)).astype(np.uint64)
            pgt = (pg[d][:, None].astype(np.uint64) * tgt) % ext_qs[:, None]
            b[d] = ((pgt + e + ext_qs[:, None] - a_s[d]) % ext_qs[:, None]
                    ).astype(np.uint32)
        rq = self.base_ring(self.L)
        b, a = jnp.asarray(b), jnp.asarray(a)
        return (
            rq.ksk_to_ntt(b, rqp, ch_axis=1),
            rq.ksk_to_ntt(a, rqp, ch_axis=1),
            b,
            a,
        )

    def keygen(self, galois_steps: Sequence[int] = ()) -> KeySet:
        """Sample a ternary secret; derive the public key, the
        relinearization key, and rotation keys for ``galois_steps`` (slot
        shifts; the conjugation key is always included)."""
        n, K = self.n, self.L + 1
        rq, rqp = self.base_ring(self.L), self.ext_ring(self.L)
        s = self._ternary((n,))
        ext_qs = self.qs + (self.p,)
        s_ext = jnp.asarray(
            np.stack([(s % q).astype(np.uint32) for q in ext_qs])
        )
        # public key at the top level: (-(a s) + e, a)
        a = jnp.asarray(self._uniform(self.qs, (n,)))
        e = jnp.asarray(self._gauss_rns(self.qs, (n,)))
        p0 = rq.sub(e, rq.polymul(a, s_ext[: self.L]))
        # relinearization key: carries s^2 (its residues via one polymul)
        s2_ext = rqp.polymul(s_ext, s_ext)
        rb, ra, rbc, rac = self._make_ksk(s2_ext, s_ext, rqp)
        # rotation/conjugation keys: carry tau_g(s)
        gk: Dict[int, Tuple[jnp.ndarray, jnp.ndarray]] = {}
        elts = {self.galois_element(int(t)) for t in galois_steps}
        elts.add(2 * n - 1)  # conjugation
        # g=1 ("rotate by 0") gets a key too: it keeps identity terms on the
        # SAME fused hoisted_linear_sum path as every other BSGS term (a
        # tau_1 key is just a gadget encryption of s; switching c1 against
        # it re-encrypts the c1*s phase exactly like any rotation)
        elts.add(1)
        gk_coeff: Dict[int, Tuple[jnp.ndarray, jnp.ndarray]] = {}
        for g in sorted(elts):
            gb, ga, gbc, gac = self._make_ksk(
                rqp.automorphism(s_ext, g), s_ext, rqp
            )
            gk[g] = (gb, ga)
            gk_coeff[g] = (gbc, gac)
        return KeySet(sk=s, sk_rns=s_ext, pk=(p0, a), rlk=(rb, ra), gk=gk,
                      rlk_coeff=(rbc, rac), gk_coeff=gk_coeff)

    def galois_element(self, t: int) -> int:
        """Slot rotation by ``t`` (left) as a Galois element 5^t mod 2n."""
        return pow(5, t % (self.n // 2), 2 * self.n)

    # -- encryption ---------------------------------------------------------

    def encrypt(self, pt: Plaintext, keys: KeySet) -> Ciphertext:
        """Public-key encryption: (pk0 v + m + e0, pk1 v + e1)."""
        lvl = pt.level
        r = self.base_ring(lvl)
        shape = pt.rns.shape[1:]
        v = self._ternary(shape)
        v_rns = jnp.asarray(
            np.stack([(v % q).astype(np.uint32) for q in self.qs[:lvl]])
        )
        e0 = jnp.asarray(self._gauss_rns(self.qs[:lvl], shape))
        e1 = jnp.asarray(self._gauss_rns(self.qs[:lvl], shape))
        pk0, pk1 = keys.pk
        pk0, pk1 = pk0[:lvl], pk1[:lvl]
        c0 = r.add(r.add(r.polymul(pk0, v_rns), pt.rns), e0)
        c1 = r.add(r.polymul(pk1, v_rns), e1)
        return Ciphertext(c0, c1, lvl, pt.scale)

    def encrypt_symmetric(self, pt: Plaintext, keys: KeySet) -> Ciphertext:
        """Secret-key encryption: (-(a s) + m + e, a)."""
        lvl = pt.level
        r = self.base_ring(lvl)
        shape = pt.rns.shape[1:]
        a = jnp.asarray(self._uniform(self.qs[:lvl], shape))
        e = jnp.asarray(self._gauss_rns(self.qs[:lvl], shape))
        c0 = r.sub(r.add(pt.rns, e), r.polymul(a, keys.sk_rns[:lvl]))
        return Ciphertext(c0, a, lvl, pt.scale)

    def decrypt(self, ct: Ciphertext, keys: KeySet) -> Plaintext:
        """Phase c0 + c1 s as a Plaintext (decode() recovers the slots)."""
        r = self.base_ring(ct.level)
        ph = r.add(np.asarray(ct.c0),
                   r.polymul(np.asarray(ct.c1), keys.sk_rns[: ct.level]))
        return Plaintext(ph, ct.level, ct.scale)

    # -- evaluator: linear ops ---------------------------------------------

    def _aligned(self, a: Ciphertext, b: Ciphertext):
        if a.level != b.level:
            raise ValueError(
                f"level mismatch {a.level} != {b.level}; mod_down_to first"
            )
        if a.scale != b.scale:
            raise ValueError(
                f"scale mismatch {a.scale} != {b.scale}; rescale/encode to "
                "matching scales"
            )
        return self.ring(a.level)

    def add(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        r = self._aligned(a, b)
        return Ciphertext(
            r.add(a.c0, b.c0), r.add(a.c1, b.c1), a.level, a.scale
        )

    def sub(self, a: Ciphertext, b: Ciphertext) -> Ciphertext:
        r = self._aligned(a, b)
        return Ciphertext(
            r.sub(a.c0, b.c0), r.sub(a.c1, b.c1), a.level, a.scale
        )

    def negate(self, a: Ciphertext) -> Ciphertext:
        r = self.ring(a.level)
        return Ciphertext(r.neg(a.c0), r.neg(a.c1), a.level, a.scale)

    def _pt_at(self, pt: Plaintext, level: int) -> jnp.ndarray:
        """Plaintext residues restricted to ``level`` channels.  Valid
        because encodings are residues of SMALL signed integers (|m| <<
        Q_level/2), so dropping channels preserves the represented value."""
        if pt.level < level:
            raise ValueError(
                f"plaintext at level {pt.level} < ciphertext {level}"
            )
        return pt.rns[:level]

    def add_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        if pt.scale != ct.scale:
            raise ValueError(f"scale mismatch {pt.scale} != {ct.scale}")
        r = self.ring(ct.level)
        w = jnp.broadcast_to(self._pt_at(pt, ct.level), ct.c0.shape)
        return Ciphertext(
            r.add(ct.c0, w), ct.c1, ct.level, ct.scale,
        )

    def mul_plain(self, ct: Ciphertext, pt: Plaintext) -> Ciphertext:
        r = self.ring(ct.level)
        w = jnp.broadcast_to(self._pt_at(pt, ct.level), ct.c0.shape)
        return Ciphertext(
            r.polymul(ct.c0, w), r.polymul(ct.c1, w),
            ct.level, ct.scale * pt.scale,
        )

    # -- evaluator: multiply / relinearize / rescale -------------------------

    def _sliced_keys(
        self, pair: Tuple[jnp.ndarray, jnp.ndarray], level: int
    ) -> jnp.ndarray:
        """Stack the (b, a) eval-domain halves restricted to ``level``:
        digit rows :level, channels (0..level-1, K-1).  Cached per key;
        the cache entry pins the parent arrays so the id() key can never be
        recycled onto a different key's storage."""
        ck = (id(pair[0]), id(pair[1]), level)
        hit = self._key_slices.get(ck)
        if hit is not None:
            return hit[1]
        idx = np.concatenate([np.arange(level), [self.L]])
        out = jnp.stack(
            [pair[0][:level][:, idx], pair[1][:level][:, idx]], axis=0
        )
        self._key_slices[ck] = (pair, out)
        return out

    def _keyswitch_pair(
        self, x: jnp.ndarray, pair, level: int, g: int
    ) -> jnp.ndarray:
        """keyswitch(tau_g(x)) against both key halves with ONE hoisted
        decomposition: (2, level, ..., n) = (b-half, a-half) results.
        ``pair`` must be eval-domain material off-mesh and coeff-domain
        material on-mesh (the caller picks via :meth:`_key_pair`)."""
        r = self.ring(level)
        ks = self._sliced_keys(pair, level)
        if self.mesh is not None:
            return r.hoisted_keyswitch(
                x, ks, (g, g), self.ext_ring(level), level,
                plain_mod=self._ks_plain_mod,
            )
        return r.hoisted_keyswitch(
            x, ks, (g, g), self.ext_ring(level), level, ksk_domain="ntt",
            plain_mod=self._ks_plain_mod,
        )

    def _fused(self, key, build):
        """Scheme-level jit cache: whole evaluator ops (tensor + keyswitch
        + adds) trace into ONE dispatch.  Built once per (op, level) —
        never rebuild jax.jit in a call path (CLAUDE.md: 100x retrace
        loss); key material rides as an argument so one compiled fn
        serves every KeySet."""
        fn = self._fused_cache.get(key)
        if fn is None:
            fn = jax.jit(build())
            self._fused_cache[key] = fn
        return fn

    def _key_pair(self, keys: KeySet, g: Optional[int] = None):
        """The (b, a) halves in the domain the active ring dispatch needs:
        relinearization key when ``g`` is None, else the rotation key."""
        coeff = self.mesh is not None
        if g is None:
            return keys.rlk_coeff if coeff else keys.rlk
        table = keys.gk_coeff if coeff else keys.gk
        return (table or {}).get(g)

    def multiply(
        self, a: Ciphertext, b: Ciphertext, keys: KeySet
    ) -> Ciphertext:
        """Tensor product + relinearization (Karatsuba: 3 polymuls; the
        degree-2 term folds back through one hoisted two-half keyswitch).
        Scales need not match — they multiply through (only add/sub
        require alignment)."""
        if a.level != b.level:
            raise ValueError(
                f"level mismatch {a.level} != {b.level}; mod_down_to first"
            )
        r = self.ring(a.level)
        if self.mesh is None:
            # the WHOLE op — fused tensor (4 fwd + 3 inv), two-half
            # hoisted relinearization, final adds — in one dispatch
            lvl, ext, pm = a.level, self.ext_ring(a.level), self._ks_plain_mod

            def build():
                def f(a0, a1, b0, b1, karr):
                    d0, d1, d2 = r.tensor(a0, a1, b0, b1)
                    hs = r.hoisted_keyswitch(
                        d2, karr, (1, 1), ext, lvl,
                        ksk_domain="ntt", plain_mod=pm,
                    )
                    return r.add(d0, hs[0]), r.add(d1, hs[1])

                return f

            c0, c1 = self._fused(("mul", a.level), build)(
                a.c0, a.c1, b.c0, b.c1,
                self._sliced_keys(self._key_pair(keys), a.level),
            )
            return Ciphertext(c0, c1, a.level, a.scale * b.scale)
        d0 = r.polymul(a.c0, b.c0)
        d2 = r.polymul(a.c1, b.c1)
        cross = r.polymul(r.add(a.c0, a.c1), r.add(b.c0, b.c1))
        d1 = r.sub(r.sub(cross, d0), d2)
        hs = self._keyswitch_pair(d2, self._key_pair(keys), a.level, 1)
        return Ciphertext(
            r.add(d0, hs[0]), r.add(d1, hs[1]), a.level, a.scale * b.scale
        )

    def square(self, a: Ciphertext, keys: KeySet) -> Ciphertext:
        r = self.ring(a.level)
        if self.mesh is None:
            lvl, ext, pm = a.level, self.ext_ring(a.level), self._ks_plain_mod

            def build():
                def f(a0, a1, karr):
                    d0, d1, d2 = r.tensor_square(a0, a1)
                    hs = r.hoisted_keyswitch(
                        d2, karr, (1, 1), ext, lvl,
                        ksk_domain="ntt", plain_mod=pm,
                    )
                    return r.add(d0, hs[0]), r.add(d1, hs[1])

                return f

            c0, c1 = self._fused(("sq", a.level), build)(
                a.c0, a.c1,
                self._sliced_keys(self._key_pair(keys), a.level),
            )
            return Ciphertext(c0, c1, a.level, a.scale * a.scale)
        d0 = r.polymul(a.c0, a.c0)
        d2 = r.polymul(a.c1, a.c1)
        x = r.polymul(a.c0, a.c1)
        d1 = r.add(x, x)
        hs = self._keyswitch_pair(d2, self._key_pair(keys), a.level, 1)
        return Ciphertext(
            r.add(d0, hs[0]), r.add(d1, hs[1]), a.level, a.scale * a.scale
        )

    def rescale(self, ct: Ciphertext) -> Ciphertext:
        """Divide-and-round both parts by the level's last prime."""
        r = self.ring(ct.level)
        q_last = self.qs[ct.level - 1]
        return Ciphertext(
            r.rescale(ct.c0), r.rescale(ct.c1),
            ct.level - 1, ct.scale / q_last,
        )

    def mod_down_to(self, ct: Ciphertext, level: int) -> Ciphertext:
        """Align ``ct`` to a lower level by dropping RNS limbs.

        Valid without any arithmetic: the decryption congruence
        c0 + c1 s ≡ Δm + e (mod Q_l) implies the same congruence mod the
        divisor Q_level, and |Δm + e| << Q_level/2, so the remaining limbs
        still decrypt to the same message at the SAME scale.  (Divide-and-
        round modulus switching — ``RNSRing.mod_down`` — is the noise-
        control variant that also divides the scale; CKKS level alignment
        wants the drop.)"""
        if level > ct.level:
            raise ValueError(f"cannot raise level {ct.level} -> {level}")
        if level == ct.level:
            return ct
        self.base_ring(level)  # validates the target level
        return self.place(Ciphertext(
            ct.c0[:level], ct.c1[:level], level, ct.scale
        ))

    # -- evaluator: rotations -------------------------------------------------

    def _apply_galois(
        self, ct: Ciphertext, g: int, keys: KeySet
    ) -> Ciphertext:
        if g == 1:
            return ct
        pair = self._key_pair(keys, g)
        if pair is None:
            raise KeyError(
                f"no rotation key for Galois element {g}; pass the step to "
                "keygen(galois_steps=...)"
            )
        r = self.ring(ct.level)
        if self.mesh is None:
            lvl, ext, pm = ct.level, self.ext_ring(ct.level), \
                self._ks_plain_mod

            def build():
                def f(c0, c1, karr):
                    hs = r.hoisted_keyswitch(
                        c1, karr, (g, g), ext, lvl,
                        ksk_domain="ntt", plain_mod=pm,
                    )
                    return r.add(r.automorphism(c0, g), hs[0]), hs[1]

                return f

            c0, c1 = self._fused(("rot", g, ct.level), build)(
                ct.c0, ct.c1, self._sliced_keys(pair, ct.level)
            )
            return Ciphertext(c0, c1, ct.level, ct.scale)
        hs = self._keyswitch_pair(ct.c1, pair, ct.level, g)
        return Ciphertext(
            r.add(r.automorphism(ct.c0, g), hs[0]), hs[1],
            ct.level, ct.scale,
        )

    def rotate(self, ct: Ciphertext, t: int, keys: KeySet) -> Ciphertext:
        """Rotate slots left by ``t`` (negative t rotates right)."""
        return self._apply_galois(ct, self.galois_element(t), keys)

    def conjugate(self, ct: Ciphertext, keys: KeySet) -> Ciphertext:
        return self._apply_galois(ct, 2 * self.n - 1, keys)

    # -- evaluator: fused BSGS linear transform -------------------------------

    def make_linear_op(
        self,
        terms: Sequence[Tuple[int, np.ndarray]],
        keys: KeySet,
        level: int,
        *,
        scale=None,
    ) -> LinearOp:
        """Bake sum_j diag_j * rot_{t_j}(ct) into a LinearOp: weights are
        encoded into the EXTENDED basis and NTT'd once, rotation keys are
        sliced and stacked once — apply_linear then runs the whole transform
        as a single fused hoisted_linear_sum call (one decomposition, one
        deferred ModDown)."""
        scale = Fraction(self.delta) if scale is None else Fraction(scale)
        ext = self.ext_ring(level)
        domain = "coeff" if self.mesh is not None else "ntt"
        gs, pts, kbs, kas = [], [], [], []
        for t, w in terms:
            g = self.galois_element(int(t))
            pts.append(self._encode_weights(w, scale, ext.qs))
            pair = self._key_pair(keys, g)
            if pair is None:
                raise KeyError(
                    f"no rotation key for step {t} (element {g})"
                )
            sl = self._sliced_keys(pair, level)
            gs.append(g)
            kbs.append(sl[0])
            kas.append(sl[1])
        pts = jnp.asarray(np.stack(pts))
        if domain == "ntt":
            pts = self.base_ring(level).ksk_to_ntt(pts, ext, ch_axis=1)
        return LinearOp(
            gs=tuple(gs),
            pts=pts,
            kb=jnp.stack(kbs),
            ka=jnp.stack(kas),
            level=level,
            scale=scale,
            domain=domain,
        )

    def _encode_weights(self, w, scale, qs) -> np.ndarray:
        """Encode one weight vector as residues (len(qs), n) — the scheme-
        specific half of make_linear_op/make_matvec."""
        m = encode_coeffs(w, self.n, scale)
        return np.stack([(m % q).astype(np.uint32) for q in qs])

    def _matvec_matrix(self, M) -> np.ndarray:
        """Validate/canonicalize a matvec matrix (scheme hook): CKKS takes
        a complex (n/2, n/2) matrix acting on the slot vector."""
        S = self.n // 2
        M = np.asarray(M, dtype=np.complex128)
        if M.shape != (S, S):
            raise ValueError(f"M must be ({S}, {S}), got {M.shape}")
        return M

    def _diag_slots(self, v) -> np.ndarray:
        """Rotated diagonal -> the slot payload _encode_weights expects
        (scheme hook): CKKS slots are the (n/2,) vector itself."""
        return v

    def apply_linear(self, ct: Ciphertext, op: LinearOp) -> Ciphertext:
        """sum_j pt_j (*) rot_j(ct) — one fused call (see make_linear_op)."""
        if ct.level != op.level:
            raise ValueError(
                f"ciphertext level {ct.level} != op level {op.level}"
            )
        r = self.ring(ct.level)
        want = "coeff" if self.mesh is not None else "ntt"
        if op.domain != want:
            raise ValueError(
                f"LinearOp baked for domain {op.domain!r}; this context "
                f"dispatches {want!r} — rebuild it with make_linear_op"
            )
        if self.mesh is not None:
            o0, o1 = r.hoisted_linear_sum(
                ct.c0, ct.c1, op.pts, op.kb, op.ka, op.gs,
                self.ext_ring(ct.level), ct.level,
                plain_mod=self._ks_plain_mod,
            )
        else:
            o0, o1 = r.hoisted_linear_sum(
                ct.c0, ct.c1, op.pts, op.kb, op.ka, op.gs,
                self.ext_ring(ct.level), ct.level,
                ksk_domain="ntt", pt_domain="ntt",
                plain_mod=self._ks_plain_mod,
            )
        return Ciphertext(o0, o1, ct.level, ct.scale * op.scale)

    # -- evaluator: two-level BSGS matrix-vector product -----------------------

    def bsgs_split(self, count: int) -> Tuple[int, int]:
        """Default (baby, giant) factorization: b = ceil(sqrt(count))."""
        b = max(1, math.isqrt(count - 1) + 1) if count > 1 else 1
        g = -(-count // b)
        return b, g

    def bsgs_steps(self, count: Optional[int] = None,
                   bsgs: Optional[Tuple[int, int]] = None) -> Tuple[int, ...]:
        """The rotation steps keygen must cover for a BSGS matvec over
        ``count`` diagonals (default: all n/2)."""
        count = self.n // 2 if count is None else int(count)
        b, g = self.bsgs_split(count) if bsgs is None else bsgs
        return tuple(range(1, b)) + tuple(
            i * b for i in range(1, g)
        )

    def make_matvec(
        self,
        M: np.ndarray,
        keys: KeySet,
        level: int,
        *,
        bsgs: Optional[Tuple[int, int]] = None,
        scale=None,
    ) -> MatVecOp:
        """Bake the slot-space product y = M @ z (M: (n/2, n/2) complex)
        into a MatVecOp via the diagonal decomposition

            M z = sum_i rot_{i*b}( sum_j rot_{i*b}^{-1}(diag_{i*b+j}) * rot_j(z) )

        Cost per apply: ONE hoisted decomposition serving all b-1 baby
        rotations, one fused polydot pair per giant step, and g-1 giant
        rotations — b+g-2 key switches instead of n/2-1 for the naive
        per-diagonal sum (the Halevi-Shoup recipe, PAPERS.md; the
        reference's transform is the inner kernel of exactly this op)."""
        S = self.n // 2
        M = self._matvec_matrix(M)
        scale = Fraction(self.delta) if scale is None else Fraction(scale)
        b, g = self.bsgs_split(S) if bsgs is None else bsgs
        if b * g < S:
            raise ValueError(f"bsgs {b}x{g} covers {b * g} < {S} diagonals")
        domain = "coeff" if self.mesh is not None else "ntt"
        # diag_d[l] = M[l, (l+d) mod S]; pre-rotate by +i*b for the giant fold
        pts = np.zeros((g, level, b, self.n), dtype=np.uint32)
        qs_l = self.qs[:level]
        for i in range(g):
            for j in range(b):
                d = i * b + j
                if d >= S:
                    continue
                diag = M[np.arange(S), (np.arange(S) + d) % S]
                pts[i, :, j] = self._encode_weights(
                    self._diag_slots(np.roll(diag, i * b)), scale, qs_l
                )
        baby_gs, ks, kb = [], [], []
        for j in range(1, b):
            gj = self.galois_element(j)
            pair = self._key_pair(keys, gj)
            if pair is None:
                raise KeyError(
                    f"no rotation key for baby step {j}; generate keys for "
                    f"bsgs_steps({S}, bsgs=({b}, {g}))"
                )
            sl = self._sliced_keys(pair, level)
            baby_gs.append(gj)
            ks.extend((gj, gj))
            kb.extend((sl[0], sl[1]))
        giants = []
        for i in range(1, g):
            gi = self.galois_element(i * b)
            pair = self._key_pair(keys, gi)
            if pair is None:
                raise KeyError(
                    f"no rotation key for giant step {i * b}; generate keys "
                    f"for bsgs_steps({S}, bsgs=({b}, {g}))"
                )
            giants.append((gi, self._sliced_keys(pair, level)))
        pts_dev = jnp.asarray(pts)
        if domain == "ntt":
            # eval-domain diagonals, transformed ONCE at bake: apply then
            # pays a single polydot_multi (bundle transformed once) per part
            pts_dev = self.base_ring(level).ntt(jnp.moveaxis(pts_dev, 0, 1))
        return MatVecOp(
            b=b, g=g, baby_gs=tuple(baby_gs), baby_ks=tuple(ks),
            baby_ksks=jnp.stack(kb) if kb else None,
            pts=pts_dev, giants=tuple(giants),
            level=level, scale=scale, domain=domain,
        )

    def apply_matvec(self, ct: Ciphertext, op: MatVecOp) -> Ciphertext:
        """y = M @ z homomorphically (see make_matvec)."""
        if ct.level != op.level:
            raise ValueError(
                f"ciphertext level {ct.level} != op level {op.level}"
            )
        want = "coeff" if self.mesh is not None else "ntt"
        if op.domain != want:
            raise ValueError(
                f"MatVecOp baked for domain {op.domain!r}; this context "
                f"dispatches {want!r} — rebuild it with make_matvec"
            )
        r = self.ring(ct.level)
        lvl = ct.level
        # baby rotations: ONE hoisted decomposition for all b-1 steps
        c0s, c1s = [ct.c0], [ct.c1]
        if op.baby_ksks is not None:
            if self.mesh is not None:
                hs = r.hoisted_keyswitch(
                    ct.c1, op.baby_ksks, op.baby_ks,
                    self.ext_ring(lvl), lvl,
                    plain_mod=self._ks_plain_mod,
                )
            else:
                hs = r.hoisted_keyswitch(
                    ct.c1, op.baby_ksks, op.baby_ks,
                    self.ext_ring(lvl), lvl, ksk_domain="ntt",
                    plain_mod=self._ks_plain_mod,
                )
            for t, gj in enumerate(op.baby_gs):
                c0s.append(r.add(r.automorphism(ct.c0, gj), hs[2 * t]))
                c1s.append(hs[2 * t + 1])
        C0 = jnp.stack(c0s, axis=-2)  # (level, ..., b, n)
        C1 = jnp.stack(c1s, axis=-2)
        mid = (1,) * (C0.ndim - 3)
        if self.mesh is None:
            # both parts through ONE polydot_multi: the baby bundle is
            # forward-transformed once for ALL giant steps
            X = jnp.stack([C0, C1], axis=1)  # (level, 2, ..., b, n)
            inners = r.polydot_multi(X, op.pts)  # (g, level, 2, ..., n)
        out = None
        for i in range(op.g):
            if self.mesh is None:
                inner = Ciphertext(
                    inners[i][:, 0], inners[i][:, 1],
                    lvl, ct.scale * op.scale,
                )
            else:
                w = jnp.broadcast_to(
                    op.pts[i].reshape((lvl,) + mid + (op.b, self.n)),
                    C0.shape,
                )
                inner = Ciphertext(
                    r.polydot(C0, w), r.polydot(C1, w),
                    lvl, ct.scale * op.scale,
                )
            if i:
                gi, pair = op.giants[i - 1]
                if self.mesh is not None:
                    hg = r.hoisted_keyswitch(
                        inner.c1, pair, (gi, gi), self.ext_ring(lvl), lvl,
                        plain_mod=self._ks_plain_mod,
                    )
                else:
                    hg = r.hoisted_keyswitch(
                        inner.c1, pair, (gi, gi), self.ext_ring(lvl), lvl,
                        ksk_domain="ntt", plain_mod=self._ks_plain_mod,
                    )
                inner = Ciphertext(
                    r.add(r.automorphism(inner.c0, gi), hg[0]), hg[1],
                    lvl, inner.scale,
                )
            out = inner if out is None else self.add(out, inner)
        return out

    # -- evaluator: homomorphic polynomial evaluation -------------------------

    def _rescale_factor(self, level: int) -> Fraction:
        """Exact factor :meth:`rescale` applies to ``scale`` at ``level``.

        CKKS divides by the dropped prime; BGV overrides (the mod switch
        multiplies the tracked correction factor instead)."""
        return Fraction(1, self.qs[level - 1])

    def _poly_eval_scale(self) -> Fraction:
        """Dictated output scale for :meth:`poly_eval`.

        ~Delta^2 keeps every leaf's plaintext encode scale near Delta
        (full encoding precision); BGV overrides with 1 (exact mod t)."""
        return Fraction(self.delta) ** 2

    def _poly_eval_min_level(self) -> int:
        """Lowest level a poly_eval result may land on and still decode.

        The Delta^2 output convention needs Q_level >> Delta^2 of
        headroom — one ~30-bit prime is NOT enough (m*Delta^2 ~ 2^58
        wraps mod Q_1 ~ 2^30 and decodes to garbage), two are.  BGV
        overrides with 1: its scale is an exact mod-t factor, any level
        decodes."""
        return 2

    def _const_pt(self, c, level: int, scale: Fraction,
                  nbatch: int = 0) -> Plaintext:
        """Constant-``c`` plaintext at a DICTATED exact (level, scale).

        This free exact parameter is what lets poly_eval's recursion
        dictate every subtree's output scale so additions align with no
        scale-matching multiplies.  ``nbatch`` singleton axes make the
        residues broadcast against a batched ciphertext.  BGV overrides
        (its scale is a mod-t correction factor, so the residues carry
        c / scale)."""
        z = np.full((1,) * nbatch + (self.n // 2,), complex(c))
        return self.encode(z, level=level, scale=scale)

    def _zero_ct(self, like: Ciphertext, level: int,
                 scale: Fraction) -> Ciphertext:
        """An encryption-free zero at (level, scale), placed like ``like``
        (sub of a value with itself keeps mesh sharding)."""
        low = self.mod_down_to(like, level)
        r = self.ring(level)
        return Ciphertext(
            r.sub(low.c0, low.c0), r.sub(low.c1, low.c1), level, scale
        )

    @staticmethod
    def _cheb_divmod(cs: List, s: int) -> Tuple[List, List]:
        """Exact division ``p = q * T_s + r`` in the Chebyshev basis.

        Uses ``2 T_{m-s} T_s = T_m + T_{2s-m}`` (valid for s < m < 2s,
        the only range the giant split produces) to strip the top
        coefficients into q; all cross-term bookkeeping happens HERE on
        host coefficients, so the ciphertext recursion needs no
        correction terms.  Coefficient arithmetic stays in the input
        type (ints stay ints — BGV remains exact)."""
        assert s <= len(cs) - 1 < 2 * s, (
            f"_cheb_divmod contract: s <= deg < 2s, got deg={len(cs) - 1} "
            f"s={s}"
        )
        p = list(cs)
        q = [0] * (len(p) - s)
        for m in range(len(p) - 1, s - 1, -1):
            c = p[m]
            if c == 0:
                continue
            if m == s:
                q[0] = q[0] + c          # T_0 * T_s = T_s
            else:
                q[m - s] = q[m - s] + 2 * c
                p[2 * s - m] = p[2 * s - m] - c
            p[m] = 0
        return q, p[:s]

    def poly_eval(self, ct: Ciphertext, coeffs: Sequence,
                  keys: KeySet, *, basis: str = "power") -> Ciphertext:
        """Evaluate a polynomial on the slots (BSGS Paterson-Stockmeyer,
        depth-optimal giant splitting).

        ``basis="power"``: ``sum_i coeffs[i] * m**i``.
        ``basis="chebyshev"``: ``sum_i coeffs[i] * T_i(m)`` — the
        numerically stable form bootstrapping's EvalMod and minimax
        activation approximations use (inputs nominally in [-1, 1]).

        The workhorse for approximating non-linear functions; the
        reference stops at the forward transform this op dispatches
        (`/root/reference/src/kernel/ntt.cpp:86-506`).

        Structure: baby powers (balanced binary; Chebyshev even indices
        via ``T_2m = 2 T_m^2 - 1``, odd via ``T_i = 2 T_a T_b - T_1``),
        giant powers by squaring/doubling, then the recursion
        ``p = q * g + r`` — the quotient/remainder split is exact
        host-side coefficient arithmetic in either basis
        (:meth:`_cheb_divmod` carries the Chebyshev cross terms), so the
        ciphertext tree is identical in shape: ~2*sqrt(d) ciphertext
        multiplies at multiplicative depth ~ceil(log2 d).

        Scale discipline (the part that makes the additions exact): every
        tree node DICTATES its subtree's output scale as an exact
        Fraction; leaves realize any dictated scale for free by choosing
        each coefficient plaintext's encode scale as
        ``dictated / power.scale``.  A giant node dictates its quotient
        branch ``S / (g.scale * rescale_factor)`` so product and
        remainder land at identical (level, scale) and add with no
        adjustment.  The one place a free parameter is missing — the
        ``- T_1`` in the odd Chebyshev recurrence subtracts two
        independently-scaled ciphertexts — pays one plaintext ratio
        multiply per side (ratios ~q/4: full encode precision, wrap-safe
        headroom) before the subtraction.

        Returns at scale ~Delta^2 (the product convention, like
        :meth:`multiply` before :meth:`rescale`); rescale once to return
        to ~Delta.  Raises ValueError when the prime chain is too short
        for the degree — including the decode headroom the Delta^2
        convention needs (the result level must satisfy Q_level >>
        Delta^2, i.e. level >= 2 for CKKS; BGV is exact at level 1).
        """
        if basis not in ("power", "chebyshev"):
            raise ValueError(f"unknown basis {basis!r}")
        cheb = basis == "chebyshev"

        def trim(sl: List):
            """Drop trailing zeros; None for the all-zero polynomial."""
            while len(sl) > 1 and sl[-1] == 0:
                sl.pop()
            return None if len(sl) == 1 and sl[0] == 0 else sl

        cs = trim(list(coeffs)) or [0]
        d = len(cs) - 1
        if not list(coeffs):
            raise ValueError("coeffs must be non-empty")
        S = self._poly_eval_scale()
        nb = ct.c0.ndim - 2  # singleton axes for constant-pt broadcasting
        if d == 0:
            out = self._zero_ct(ct, ct.level, S)
            if cs[0] != 0:
                out = self.add_plain(
                    out, self._const_pt(cs[0], out.level, S, nb)
                )
            return out

        # -- node tree (host-side, exact).  Built BEFORE any ciphertext
        # work: the same tree drives the level plan and the evaluation,
        # so the two cannot disagree, and a too-short chain raises
        # cleanly instead of dying at level 0 mid-squaring.  Nodes:
        #   ("leaf", cs)            deg < k: plaintext dot with babies
        #   ("const", j, c, r)      deg == k*2^j: c * g_j is a PLAINTEXT
        #                           multiply (no relin, no level); r may
        #                           be None (zero remainder)
        #   ("mul", j, q, r)        full q * g_j + r node
        k = 1 << max(1, math.ceil(math.log2(math.sqrt(d + 1))))
        kappa = k.bit_length() - 1

        def tree(sl: List):
            deg = len(sl) - 1
            if deg < k:
                return ("leaf", sl)
            j = (deg // k).bit_length() - 1
            s = k << j
            if cheb:
                q, r = self._cheb_divmod(sl, s)
            else:
                q, r = sl[s:], sl[:s]
            q, r = trim(list(q)), trim(list(r))
            # q's top coefficient is (2x) the node's: never None
            if len(q) == 1:
                return ("const", j, q[0], tree(r) if r else None)
            return ("mul", j, tree(q), tree(r) if r else None)

        root = tree(cs)

        # -- level plan from predicted depths (exact: they mirror the
        # builders below).  Power babies sit ceil(log2 i) below the
        # input; Chebyshev even indices cost 1 over their half, odd
        # indices 2 (multiply + the T_1 alignment); giants sit
        # log2(k) + j below in both bases.
        bd_memo: Dict[int, int] = {1: 0}

        def bdepth(i: int) -> int:
            hit = bd_memo.get(i)
            if hit is not None:
                return hit
            if not cheb:
                out = (i - 1).bit_length()
            elif i % 2 == 0:
                out = bdepth(i // 2) + 1
            else:
                out = max(bdepth((i + 1) // 2), bdepth(i // 2)) + 2
            bd_memo[i] = out
            return out

        ceilings: List[int] = []
        used_babies: set = set()
        used_giants: set = set()

        def plan(node, off: int) -> None:
            kind = node[0]
            if kind == "leaf":
                sl = node[1]
                used = [i for i in range(1, len(sl)) if sl[i] != 0]
                if used:
                    used_babies.update(used)
                    depth = max(bdepth(i) for i in used)
                    ceilings.append(ct.level - depth - off)
                return
            j = node[1]
            used_giants.add(j)
            if kind == "const":
                ceilings.append(ct.level - kappa - j - off)
                if node[3] is not None:
                    plan(node[3], off)
                return
            ceilings.append(ct.level - kappa - j - 1 - off)
            plan(node[2], off + 1)   # quotient branch, one level up
            if node[3] is not None:
                plan(node[3], off)

        plan(root, 0)
        l_min = self._poly_eval_min_level()
        l_out = min(ceilings)  # non-empty: cs[d] != 0 after the trim
        if l_out < l_min:
            raise ValueError(
                f"degree {d} at level {ct.level} needs {l_min - l_out} "
                f"more prime level(s) (split k={k}, basis={basis}, "
                f"result must land at level >= {l_min}); increase "
                f"num_primes"
            )

        # -- power basis (dependency closure of the used powers only) -------
        babies: Dict[int, Ciphertext] = {1: ct}

        def pw_power(i: int) -> Ciphertext:
            hit = babies.get(i)
            if hit is not None:
                return hit
            h = i // 2
            a, b = pw_power(i - h), pw_power(h)
            lvl = min(a.level, b.level)
            a, b = self.mod_down_to(a, lvl), self.mod_down_to(b, lvl)
            out = self.rescale(
                self.square(a, keys) if i - h == h
                else self.multiply(a, b, keys)
            )
            babies[i] = out
            return out

        def _cheb_double(x: Ciphertext) -> Ciphertext:
            # T_2m = 2 T_m^2 - 1: the halving constant aligns for free
            t = self.rescale(self.square(x, keys))
            t = self.add(t, t)
            return self.add_plain(
                t, self._const_pt(-1, t.level, t.scale, nb)
            )

        def pw_cheb(i: int) -> Ciphertext:
            hit = babies.get(i)
            if hit is not None:
                return hit
            if i % 2 == 0:
                t = _cheb_double(pw_cheb(i // 2))
            else:
                # T_i = 2 T_a T_b - T_1 (a - b = 1): the subtraction has
                # no free scale parameter, so both sides pass through one
                # exact plaintext ratio (~q/4) to a common scale first
                a, b = (i + 1) // 2, i // 2
                xa, xb = pw_cheb(a), pw_cheb(b)
                lvl = min(xa.level, xb.level)
                xa = self.mod_down_to(xa, lvl)
                xb = self.mod_down_to(xb, lvl)
                t = self.rescale(self.multiply(xa, xb, keys))
                t = self.add(t, t)
                c1 = self.mod_down_to(ct, t.level)
                hi = max(t.scale, c1.scale)
                target = hi * Fraction(self.qs[t.level - 1], 4)
                t = self.mul_plain(
                    t, self._const_pt(1, t.level, target / t.scale, nb)
                )
                c1 = self.mul_plain(
                    c1, self._const_pt(1, t.level, target / c1.scale, nb)
                )
                t = self.rescale(self.sub(t, c1))
            babies[i] = t
            return t

        pw = pw_cheb if cheb else pw_power
        for i in sorted(used_babies):
            pw(i)
        giants: List[Ciphertext] = []
        if used_giants:
            giants.append(
                _cheb_double(pw(k // 2)) if cheb
                else self.rescale(self.square(pw(k // 2), keys))
            )
            while len(giants) <= max(used_giants):
                giants.append(
                    _cheb_double(giants[-1]) if cheb
                    else self.rescale(self.square(giants[-1], keys))
                )

        # -- tree evaluation with dictated (level, scale) -------------------
        def rec(node, level: int, scale: Fraction) -> Ciphertext:
            kind = node[0]
            if kind == "leaf":
                sl = node[1]
                acc = None
                for i in range(1, len(sl)):
                    if sl[i] == 0:
                        continue
                    p = self.mod_down_to(babies[i], level)
                    term = self.mul_plain(
                        p, self._const_pt(sl[i], level, scale / p.scale, nb)
                    )
                    acc = term if acc is None else self.add(acc, term)
                if acc is None:
                    acc = self._zero_ct(ct, level, scale)
                if sl[0] != 0:
                    acc = self.add_plain(
                        acc, self._const_pt(sl[0], level, scale, nb)
                    )
                return acc
            j = node[1]
            if kind == "const":
                g = self.mod_down_to(giants[j], level)
                prod = self.mul_plain(
                    g, self._const_pt(node[2], level, scale / g.scale, nb)
                )
            else:
                g = self.mod_down_to(giants[j], level + 1)
                sq = scale / (g.scale * self._rescale_factor(level + 1))
                q_ct = rec(node[2], level + 1, sq)
                prod = self.rescale(self.multiply(q_ct, g, keys))
            if prod.level != level or prod.scale != scale:
                raise AssertionError(
                    "poly_eval scale dictation broke: "
                    f"{prod.level}/{prod.scale} != {level}/{scale}"
                )
            if node[3] is None:
                return prod
            return self.add(prod, rec(node[3], level, scale))

        return rec(root, l_out, S)
