"""Radix-2 NTT kernel for NVIDIA GPUs (Pallas, Triton route) and the one
place that decides which transform runs.

One program transforms ``rows`` whole polynomials of one RNS channel with
every stage held on chip: one read and one write of the batch per
transform, where the plain XLA composition of the same stages
(``xla_ntt``) makes one device-memory round trip per stage.

The stage math is ``stage_math.fwd_chain`` / ``inv_chain`` (the split form:
each butterfly computed once, compact bit-reversed twiddle tables), shared
with the plain path so the two cannot drift.  The modulus and the tables
are operands: one call serves every channel of an RNS basis, and the
channel-sharded paths pass their shard of both.  The high word of each
Shoup product comes from the 16-bit partial products of
``modmul.mulhi_u32``: on an H100 a ``mul.hi.u32`` inline-assembly form
measured the same time at every size from n = 128 to 32768 (the kernel is
bound by its data movement, not its multiplies), so the one form serves
both the compiled kernel and the interpreter.

Choice of transform (``ntt`` / ``intt``): the kernel on a GPU backend, the
plain XLA chains elsewhere; ``interpret=True`` runs the kernel in the
Pallas interpreter on any backend (how the CPU tests reach it).
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plt

from . import xla_ntt
from .stage_math import fwd_chain, inv_chain

# elements one program holds (rows * n): measured on an H100 over rows in
# {1, 2, 4} at n = 4096 and rows in {8 .. 64} at n = 128..512, this block
# size was the fastest or within 3% of it
_BLOCK_ELEMS = 4096


def on_gpu() -> bool:
    return jax.default_backend() == "gpu"


def _kernel(q_ref, w_ref, wp_ref, x_ref, o_ref, *, inverse):
    q = q_ref[...]

    def tw(lo, k):
        return (
            w_ref[lo : lo + k].reshape(1, k, 1, 1),
            wp_ref[lo : lo + k].reshape(1, k, 1, 1),
        )

    chain = inv_chain if inverse else fwd_chain
    o_ref[...] = chain(x_ref[...], q, tw)


def block_rows(n: int, batch: int) -> int:
    """Polynomials per program: ~_BLOCK_ELEMS elements, at most the batch."""
    rows = max(1, _BLOCK_ELEMS // n)
    while rows > 1 and rows > batch:
        rows //= 2
    return rows


def num_warps(n: int) -> int:
    """4 warps up to n = 8192, then one more warp per 2048 elements (the
    measured best at n = 16384 and 32768, where one row fills a program)."""
    return max(4, n // 2048)


@functools.partial(jax.jit, static_argnames=("inverse", "interpret"))
def _call(x, q, w, wp, *, inverse, interpret):
    L, B, n = x.shape
    rows = block_rows(n, B)
    pad = (-B) % rows
    if pad:
        x = jnp.pad(x, ((0, 0), (0, pad), (0, 0)))
    bp = B + pad
    kern = functools.partial(_kernel, inverse=inverse)
    tab = pl.BlockSpec((None, n), lambda i, l: (l, 0))
    blk = pl.BlockSpec((None, rows, n), lambda i, l: (l, i, 0))
    out = pl.pallas_call(
        kern,
        out_shape=jax.ShapeDtypeStruct((L, bp, n), jnp.uint32),
        grid=(bp // rows, L),
        in_specs=[pl.BlockSpec((None, 1), lambda i, l: (l, 0)), tab, tab, blk],
        out_specs=blk,
        compiler_params=plt.CompilerParams(
            num_warps=num_warps(n), num_stages=1
        ),
        backend="triton",
        interpret=interpret,
        name="ntt_inv" if inverse else "ntt_fwd",
    )(
        jnp.asarray(q, jnp.uint32).reshape(L, 1),
        jnp.asarray(w, jnp.uint32),
        jnp.asarray(wp, jnp.uint32),
        jnp.asarray(x, jnp.uint32),
    )
    return out[:, :B] if pad else out


def ntt(x, q, w, wp, *, interpret: bool = False):
    """Forward transform of x (L, B, n) uint32 in [0, 4q_l); q (L,), w/wp
    (L, n) from ``xla_ntt.fwd_tables``.  Output [0, q_l)."""
    if interpret or on_gpu():
        return _call(x, q, w, wp, inverse=False, interpret=interpret)
    return xla_ntt.ntt(x, q, w, wp)


def intt(x, q, w, wp, *, interpret: bool = False):
    """Inverse transform of x (L, B, n) in [0, 2q_l), scale folded into the
    tables (``xla_ntt.inv_tables``).  Output [0, q_l)."""
    if interpret or on_gpu():
        return _call(x, q, w, wp, inverse=True, interpret=interpret)
    return xla_ntt.intt(x, q, w, wp)


@functools.partial(jax.jit, static_argnames=("params", "interpret"))
def fwd_ntt(x, params, *, interpret: bool = False):
    """Forward NTT of (B, n) uint32 for one ring (negacyclic or cyclic
    params).  Output [0, q)."""
    qs, w, wp = xla_ntt.stacked_tables((params,))
    return ntt(jnp.asarray(x, jnp.uint32)[None], qs, w, wp,
               interpret=interpret)[0]


@functools.partial(jax.jit, static_argnames=("params", "scale", "interpret"))
def inv_ntt(x, params, *, scale: Optional[int] = None,
            interpret: bool = False):
    """Inverse NTT of (B, n) uint32 in [0, 2q); ``scale`` overrides the n^-1
    multiplier (e.g. to fold a Montgomery factor).  Output [0, q)."""
    qs, w, wp = xla_ntt.stacked_tables((params,), True, (scale,))
    return intt(jnp.asarray(x, jnp.uint32)[None], qs, w, wp,
                interpret=interpret)[0]


def rns_ntt(x, params_tuple, *, interpret: bool = False):
    """Forward NTT of every channel of x (L, B, n) in one call."""
    qs, w, wp = xla_ntt.stacked_tables(tuple(params_tuple))
    return ntt(x, qs, w, wp, interpret=interpret)


def rns_intt(x, params_tuple, *, scales=None, interpret: bool = False):
    """Inverse NTT of every channel of x (L, B, n); ``scales`` per channel
    (default n^-1)."""
    qs, w, wp = xla_ntt.stacked_tables(
        tuple(params_tuple), True, None if scales is None else tuple(scales)
    )
    return intt(x, qs, w, wp, interpret=interpret)
