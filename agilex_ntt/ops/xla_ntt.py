"""The plain XLA transform: the shared stage chains as ordinary jnp ops.

Runs the *identical* stage math as the GPU kernel (``stage_math.py``), so
it serves as the kernel's differential-testing reference on any backend
and as the transform wherever no GPU is present.  On the GPU XLA gives each
stage its own pass over device memory (log2 n round trips per transform);
the kernel keeps every stage on chip (``ntt_kernel.py``).

Layout: channel-batched x (L, B, n) with per-channel moduli q (L,) and
compact tables (L, n) — one call serves every prime of an RNS basis.
"""

from __future__ import annotations

import functools
from typing import Optional, Sequence

import jax
import jax.numpy as jnp
import numpy as np

from .stage_math import fwd_chain, inv_chain


def fwd_tables(params):
    """(w, wp): the compact bit-reversed twiddles and Shoup precons, (n,)."""
    return params.roots32, params.precon32


@functools.lru_cache(maxsize=256)
def inv_tables(params, scale: Optional[int] = None):
    """(w, wp) for the inverse: the inverse twiddles with entries 0 and 1
    replaced by (scale, scale * w1) — the folded last stage of
    ``stage_math.inv_chain``.  scale defaults to n^-1."""
    q = params.q
    s = params.n_inv if scale is None else scale % q
    w = np.array(params.inv_roots32, dtype=np.uint32)
    pair = [s, s * int(w[1]) % q]
    w[0], w[1] = pair
    wp = np.array(params.inv_precon32, dtype=np.uint32)
    wp[0], wp[1] = [(v << 32) // q for v in pair]
    return w, wp


@functools.lru_cache(maxsize=128)
def stacked_tables(params_tuple: Sequence, inverse: bool = False,
                   scales: Optional[tuple] = None):
    """Per-channel (q (L,), w (L, n), wp (L, n)) numpy bundles for an RNS
    basis; inverse tables carry each channel's scale (default n^-1)."""
    if inverse:
        scales = scales or (None,) * len(params_tuple)
        tabs = [inv_tables(p, s) for p, s in zip(params_tuple, scales)]
    else:
        tabs = [fwd_tables(p) for p in params_tuple]
    qs = np.array([p.q for p in params_tuple], dtype=np.uint32)
    return (qs, np.stack([t[0] for t in tabs]), np.stack([t[1] for t in tabs]))


def _tw(w, wp, L):
    def tw(lo, k):
        shape = (L, 1, k, 1, 1)
        return (w[:, lo : lo + k].reshape(shape),
                wp[:, lo : lo + k].reshape(shape))

    return tw


def ntt(x, q, w, wp):
    """Forward transform of x (L, B, n) in [0, 4q_l); q (L,) uint32; w/wp
    (L, n) per-channel ``fwd_tables``.  Output [0, q_l)."""
    L = x.shape[0]
    return fwd_chain(x, jnp.asarray(q).reshape(L, 1, 1, 1, 1), _tw(w, wp, L))


def intt(x, q, w, wp):
    """Inverse of x (L, B, n) in [0, 2q_l) with per-channel ``inv_tables``.
    Output [0, q_l)."""
    L = x.shape[0]
    return inv_chain(x, jnp.asarray(q).reshape(L, 1, 1, 1, 1), _tw(w, wp, L))


@functools.partial(jax.jit, static_argnames=("params",))
def fwd_ntt_xla(x: jnp.ndarray, params) -> jnp.ndarray:
    """Forward NTT of (batch, n) uint32 through the plain XLA path."""
    qs, w, wp = stacked_tables((params,))
    return ntt(jnp.asarray(x, jnp.uint32)[None], qs, w, wp)[0]


@functools.partial(jax.jit, static_argnames=("params", "scale"))
def inv_ntt_xla(x: jnp.ndarray, params, *, scale: Optional[int] = None):
    """Inverse NTT of (batch, n) uint32 through the plain XLA path."""
    qs, w, wp = stacked_tables((params,), True, (scale,))
    return intt(jnp.asarray(x, jnp.uint32)[None], qs, w, wp)[0]
