"""Four-step (Bailey) decomposition of the negacyclic NTT for large n.

The reference caps its transform size at n = 32768 because the whole
polynomial must fit one compute unit's BLOCK_RAM (state arrays at
``/root/reference/src/kernel/ntt.cpp:90-101``; size menu
``include/kernel/ntt.h:11-23``) — "one frame never spans compute units"
(SURVEY.md §5).  The GPU analog of that wall is one thread block's on-chip
storage: the radix-2 kernel holds whole polynomials on chip, which stops
paying above a few tens of KB per row.  The four-step factorization
n = n1 * n2 removes the wall: two passes of small transforms whose working
sets are sqrt(n)-sized, each pass one call of the radix-2 kernel.

Derivation (negacyclic, HEXL evaluation order).  For the size-n negacyclic
transform X(k) = sum_j x_j psi^((2k+1) j), write j = r*n2 + c and
k = k2*n1 + k1:

    X(k) = sum_c psi^((2k1+1) c) * omega^(k2 c) * G[k1, c]
    G[k1, c] = sum_r x[r*n2 + c] * psi1^((2k1+1) r)

with psi1 = psi^n2 (a primitive 2*n1-th root => the column pass is exactly a
size-n1 *negacyclic* NTT) and omega = psi^(2*n1) (a primitive n2-th root =>
the row pass is a size-n2 *cyclic* NTT).  Since our kernels emit bit-reversed
outputs, position p = bitrev_n(k) = bitrev(k1)*n2 + bitrev(k2) — the column
pass lands rows at bitrev(k1), the row pass lands columns at bitrev(k2), and
the composed output is **bit-identical to the single-pass kernel** with no
reordering pass at all.  The twiddle scale T[r1, c] = psi^((2*bitrev(r1)+1) c)
between the passes is one positional Shoup mulmod.

The same three steps with the coefficient axis sharded over a mesh give the
multi-chip transform: local column NTTs -> scale -> all-to-all transpose
-> local row NTTs (SURVEY.md §5; see ``parallel/fourstep_shard.py``).
"""

from __future__ import annotations

import dataclasses
import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from ..params import (
    CyclicParams,
    NTTParams,
    bit_reverse,
    find_psi,
    fourstep_split,
    is_prime,
    log2_exact,
    make_cyclic_params,
    make_params,
)
from . import ntt_kernel
from .modmul import shoup_mulmod_lazy


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash; interned by
# make_plan's lru_cache so it can ride jit static args like NTTParams does.
class FourStepPlan:
    """Precomputed decomposition of one (n, q) ring into n1 x n2 passes."""

    n: int
    q: int
    psi: int
    n1: int
    n2: int
    col: NTTParams      # size-n1 negacyclic transform, psi1 = psi^n2
    row: CyclicParams   # size-n2 cyclic transform, omega = psi^(2*n1)
    # inter-pass twiddle scale T[r1, c] = psi^((2*bitrev(r1)+1) c) and its
    # Shoup precons
    tw: np.ndarray      # uint32 (n1, n2)
    twp: np.ndarray     # uint32 (n1, n2) floor(tw * 2^32 / q)
    itw: np.ndarray     # inverse scale psi^(-(2*bitrev(r1)+1) c)
    itwp: np.ndarray
    n_inv: int          # n^-1 mod q

    @property
    def log_n(self) -> int:
        return log2_exact(self.n)


def _check_modulus(q: int) -> None:
    """Direct-plan entry points must enforce the same preconditions Ring
    does via NTTConfig: 4q < 2**32 (uint32 lazy invariant) and primality
    (Fermat n_inv)."""
    if q >= (1 << 30):
        raise ValueError(
            f"q must be < 2**30 for uint32 lazy arithmetic, got {q}"
        )
    if not is_prime(q):
        raise ValueError(f"q={q} is not prime")


def _with_precon(w: np.ndarray, q: int) -> Tuple[np.ndarray, np.ndarray]:
    """(w, floor(w * 2^32 / q)) as uint32 — w < 2^30 so w << 32 < 2^62 fits
    uint64 exactly."""
    p = (w.astype(np.uint64) << np.uint64(32)) // np.uint64(q)
    return w.astype(np.uint32), p.astype(np.uint32)


@functools.lru_cache(maxsize=32)
def make_plan(
    n: int, q: int, psi: Optional[int] = None, n1: Optional[int] = None
) -> FourStepPlan:
    """Build the four-step plan for Z_q[X]/(X^n + 1).

    Setup cost is O(n) host work but only O(sqrt(n)) Python bignum pows —
    the big (n1, n2) scale table is generated vectorized — so plans for
    n = 2^20 build in well under a second.
    """
    if q % (2 * n) != 1:
        raise ValueError(f"q ≡ 1 (mod 2n) required: q={q} n={n}")
    _check_modulus(q)
    if psi is None:
        psi = find_psi(n, q)
    elif pow(psi, n, q) != q - 1:
        raise ValueError("provided psi is not a primitive 2n-th root")
    if n1 is None:
        n1, n2 = fourstep_split(n)
    else:
        n2 = n // n1
    if n1 * n2 != n or n1 < 2 or n2 < 2:
        raise ValueError(f"bad split {n} = {n1} * {n2}")

    psi1 = pow(psi, n2, q)
    omega = pow(psi, 2 * n1, q)
    col = make_params(n1, q, psi1)
    row = make_cyclic_params(n2, q, omega)

    # scale table: psi^e with e = (2*bitrev(r1, log n1) + 1) * c mod 2n.
    # psi powers 0..2n-1 as a plain-int list (2n modmuls, ~0.5 s at n=2^20),
    # then a vectorized gather.
    pows = [1] * (2 * n)
    acc = 1
    for i in range(1, 2 * n):
        acc = acc * psi % q
        pows[i] = acc
    pows_np = np.array(pows, dtype=np.uint64)
    l1 = log2_exact(n1)
    k1 = np.array([bit_reverse(r, l1) for r in range(n1)], dtype=np.int64)
    e = ((2 * k1[:, None] + 1) * np.arange(n2, dtype=np.int64)[None, :]) % (2 * n)
    tw, twp = _with_precon(pows_np[e], q)
    itw, itwp = _with_precon(pows_np[(-e) % (2 * n)], q)

    return FourStepPlan(
        n=n, q=q, psi=psi, n1=n1, n2=n2, col=col, row=row,
        tw=tw, twp=twp, itw=itw, itwp=itwp,
        n_inv=pow(n, q - 2, q),
    )


@functools.lru_cache(maxsize=32)
def make_cyclic_plan(
    n: int, q: int, omega: int, n1: Optional[int] = None
) -> FourStepPlan:
    """Four-step plan for the size-n *cyclic* NTT (root omega of order n).

    Same machinery as the negacyclic plan with both passes cyclic:
    X(k) = sum_c omega^(c*k1) * omega2^(c*k2) * G[k1, c], where
    G[k1, c] is the size-n1 cyclic transform of column c with
    omega1 = omega^n2, and the row pass uses omega2 = omega^n1.  The
    inter-pass scale is T[r1, c] = omega^(c * bitrev(r1)).  Output order is
    bit-reversed exactly like the single-pass cyclic kernel.
    """
    _check_modulus(q)
    if pow(omega, n, q) != 1 or (n > 1 and pow(omega, n // 2, q) == 1):
        raise ValueError("omega is not a primitive n-th root")
    if n1 is None:
        n1, n2 = fourstep_split(n)
    else:
        n2 = n // n1
    if n1 * n2 != n or n1 < 2 or n2 < 2:
        raise ValueError(f"bad split {n} = {n1} * {n2}")
    col = make_cyclic_params(n1, q, pow(omega, n2, q))
    row = make_cyclic_params(n2, q, pow(omega, n1, q))

    pows = [1] * n
    acc = 1
    for i in range(1, n):
        acc = acc * omega % q
        pows[i] = acc
    pows_np = np.array(pows, dtype=np.uint64)
    l1 = log2_exact(n1)
    k1 = np.array([bit_reverse(r, l1) for r in range(n1)], dtype=np.int64)
    e = (k1[:, None] * np.arange(n2, dtype=np.int64)[None, :]) % n
    tw, twp = _with_precon(pows_np[e], q)
    itw, itwp = _with_precon(pows_np[(-e) % n], q)
    return FourStepPlan(
        n=n, q=q, psi=0, n1=n1, n2=n2, col=col, row=row,
        tw=tw, twp=twp, itw=itw, itwp=itwp,
        n_inv=pow(n, q - 2, q),
    )


def _fwd_pass(x, params, interpret):
    return ntt_kernel.fwd_ntt(x, params, interpret=interpret)


def _inv_pass(x, params, scale, interpret):
    return ntt_kernel.inv_ntt(x, params, scale=scale, interpret=interpret)


@functools.partial(jax.jit, static_argnames=("plan", "interpret"))
def fwd_ntt_fourstep_tiled(
    x3: jnp.ndarray, plan: FourStepPlan, *, interpret: bool = False
) -> jnp.ndarray:
    """Forward four-step NTT on the tiled layout: (B, n1, n2) in and out.
    Bit-identical to ``fwd_ntt_fourstep`` on the flattened input (on the GPU
    the flat <-> tiled reshape is free; the tiled entry points exist for
    callers that keep operands rank-3)."""
    b = x3.shape[0]
    n1, n2 = plan.n1, plan.n2
    # column pass: size-n1 negacyclic NTT down each of the n2 columns
    xc = x3.transpose(0, 2, 1).reshape(b * n2, n1)
    yc = _fwd_pass(xc, plan.col, interpret)
    m1 = yc.reshape(b, n2, n1).transpose(0, 2, 1)  # rows land at br(k1)
    # inter-pass twiddle scale (Shoup mulmod, lazy [0, 2q))
    m2 = shoup_mulmod_lazy(
        m1, jnp.asarray(plan.tw)[None], jnp.asarray(plan.twp)[None], plan.q
    )
    # row pass: size-n2 cyclic NTT along each row
    out = _fwd_pass(m2.reshape(b * n1, n2), plan.row, interpret)
    return out.reshape(b, n1, n2)


@functools.partial(jax.jit, static_argnames=("plan", "interpret"))
def fwd_ntt_fourstep(
    x: jnp.ndarray, plan: FourStepPlan, *, interpret: bool = False
) -> jnp.ndarray:
    """Forward negacyclic NTT of (batch, n) uint32 via two sqrt(n)-size passes.

    Input in [0, 4q); output in [0, q), bit-identical to the single-pass
    transform / the uint64 golden model.
    """
    b = x.shape[0]
    out = fwd_ntt_fourstep_tiled(
        x.reshape(b, plan.n1, plan.n2), plan, interpret=interpret
    )
    return out.reshape(b, plan.n)


@functools.partial(jax.jit, static_argnames=("plan", "scale", "interpret"))
def inv_ntt_fourstep_tiled(
    x3: jnp.ndarray,
    plan: FourStepPlan,
    *,
    scale: Optional[int] = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """Inverse four-step NTT on the tiled layout ((B, n1, n2) in and out).
    Bit-identical to ``inv_ntt_fourstep``."""
    if scale is None:
        scale = plan.n_inv
    col_scale = scale * plan.n2 % plan.q
    b = x3.shape[0]
    n1, n2 = plan.n1, plan.n2
    # row pass: inverse cyclic size-n2 (undoes the forward's last pass)
    r = _inv_pass(x3.reshape(b * n1, n2), plan.row, plan.row.n_inv, interpret)
    # unscale (inverse inter-pass twiddles)
    m = shoup_mulmod_lazy(
        r.reshape(b, n1, n2),
        jnp.asarray(plan.itw)[None],
        jnp.asarray(plan.itwp)[None],
        plan.q,
    )
    # column pass: inverse negacyclic size-n1 with the residual scale folded
    xc = m.transpose(0, 2, 1).reshape(b * n2, n1)
    c = _inv_pass(xc, plan.col, col_scale, interpret)
    return c.reshape(b, n2, n1).transpose(0, 2, 1)


@functools.partial(jax.jit, static_argnames=("plan", "scale", "interpret"))
def inv_ntt_fourstep(
    x: jnp.ndarray,
    plan: FourStepPlan,
    *,
    scale: Optional[int] = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """Inverse negacyclic NTT of (batch, n) uint32, mirroring the forward.

    `scale` overrides the overall n^-1 multiplier (e.g. to fold a Montgomery
    R factor, see api.polymul); it is split as row-pass n2^-1 then column-pass
    scale * n2.  Input may be lazy in [0, 2q); output in [0, q).
    """
    b = x.shape[0]
    out = inv_ntt_fourstep_tiled(
        x.reshape(b, plan.n1, plan.n2), plan, scale=scale, interpret=interpret
    )
    return out.reshape(b, plan.n)
