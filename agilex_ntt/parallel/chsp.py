"""Channel x coefficient sharding: RNS four-step transforms on a
(ch, sp[, dp]) mesh — the L x large-n production shape.

Channel parallelism shards the prime-channel axis with each channel's
tables riding alongside (the expert-parallel analog, ``mesh.ShardedRNSRing
ch_axis``); coefficient sharding splits one large transform over devices
with two all-to-all retiles (``fourstep_shard.py``).  Composing them needs
both at once inside ONE SPMD program: every device runs the same code, so
per-channel constants arrive as *sharded array operands*, not static
parameters — exactly the form of the channel-batched transform
(``ntt_kernel.ntt``: moduli and tables are operands).  This module is
``fourstep_shard``'s body rewritten over a local channel block:

    x (L, B, n) with spec P(ch, dp, sp)
      -> per-device (L/ch, B/dp, n/sp): n1/sp rows of each (n1, n2) matrix
      -> all-to-all over sp: rows -> columns retile
      -> size-n1 negacyclic column NTTs, channels batched in one call
      -> inter-pass scale (per-channel tables + moduli, sharded over ch/sp)
      -> all-to-all back, size-n2 cyclic row NTTs
    two retiles per transform, zero channel-axis communication — the same
    communication volume as the single-channel four-step.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import ntt_kernel, xla_ntt
from ..ops.fourstep import FourStepPlan
from ..ops.modmul import shoup_mulmod_lazy


def check_plans(plans: Tuple[FourStepPlan, ...], mesh: Mesh, ch_axis: str,
                sp_axis: str) -> None:
    n1, n2 = plans[0].n1, plans[0].n2
    if any((p.n1, p.n2) != (n1, n2) for p in plans):
        raise ValueError("all channels must share the (n1, n2) split")
    Psp = mesh.shape[sp_axis]
    if n1 % Psp or n2 % Psp:
        raise ValueError(
            f"four-step sharding needs P | n1 and P | n2: "
            f"P={Psp}, n1={n1}, n2={n2}"
        )
    if len(plans) % mesh.shape[ch_axis]:
        raise ValueError(
            f"the ch axis size ({mesh.shape[ch_axis]}) must divide "
            f"L={len(plans)} (whole channels per device)"
        )


# -- stacked per-channel table bundles (numpy; cached per plan tuple) --------


@functools.lru_cache(maxsize=32)
def _fwd_bundle(plans: Tuple[FourStepPlan, ...]):
    qs, cw, cwp = xla_ntt.stacked_tables(tuple(p.col for p in plans))
    _, rw, rwp = xla_ntt.stacked_tables(tuple(p.row for p in plans))
    tw = np.stack([p.tw for p in plans])
    twp = np.stack([p.twp for p in plans])
    return qs, cw, cwp, tw, twp, rw, rwp


@functools.lru_cache(maxsize=32)
def _inv_bundle(plans: Tuple[FourStepPlan, ...], scales: Tuple[int, ...]):
    """Row-pass inverse tables carry n2^-1; the column pass carries the
    remaining scale * n2 (the same split as fourstep_shard._inv_body)."""
    qs, rw, rwp = xla_ntt.stacked_tables(
        tuple(p.row for p in plans), True, tuple(p.row.n_inv for p in plans)
    )
    _, cw, cwp = xla_ntt.stacked_tables(
        tuple(p.col for p in plans), True,
        tuple(s * p.n2 % p.q for p, s in zip(plans, scales)),
    )
    itw = np.stack([p.itw for p in plans])
    itwp = np.stack([p.itwp for p in plans])
    return qs, rw, rwp, itw, itwp, cw, cwp


# -- shard_map bodies ----------------------------------------------------------


def _fwd_body(x, qs, cw, cwp, tw, twp, rw, rwp, *, sp_axis: str, n1: int,
              n2: int, Psp: int, interpret):
    """x: (L_loc, B_loc, n/Psp) — n1/Psp whole rows of each channel's
    (n1, n2) matrix; tables: channel-local slices (see _specs)."""
    Lc, b, _ = x.shape
    n1p, n2p = n1 // Psp, n2 // Psp
    xm = x.reshape(Lc, b, n1p, n2)
    # rows -> columns retile (channel axis untouched)
    xc = lax.all_to_all(xm, sp_axis, split_axis=3, concat_axis=2, tiled=True)
    cols = xc.transpose(0, 1, 3, 2).reshape(Lc, b * n2p, n1)
    yc = ntt_kernel.ntt(cols, qs, cw, cwp, interpret=interpret)
    m1 = yc.reshape(Lc, b, n2p, n1).transpose(0, 1, 3, 2)  # (Lc, b, n1, n2p)
    m2 = shoup_mulmod_lazy(m1, tw[:, None], twp[:, None],
                           qs.reshape(Lc, 1, 1, 1))
    # columns -> rows retile
    xr = lax.all_to_all(m2, sp_axis, split_axis=2, concat_axis=3, tiled=True)
    rows = xr.reshape(Lc, b * n1p, n2)
    out = ntt_kernel.ntt(rows, qs, rw, rwp, interpret=interpret)
    return out.reshape(Lc, b, n1p * n2)


def _inv_body(y, qs, rw, rwp, itw, itwp, cw, cwp, *, sp_axis: str, n1: int,
              n2: int, Psp: int, interpret):
    Lc, b, _ = y.shape
    n1p, n2p = n1 // Psp, n2 // Psp
    rows = y.reshape(Lc, b * n1p, n2)
    r = ntt_kernel.intt(rows, qs, rw, rwp, interpret=interpret)
    m = r.reshape(Lc, b, n1p, n2)
    mc = lax.all_to_all(m, sp_axis, split_axis=3, concat_axis=2, tiled=True)
    mu = shoup_mulmod_lazy(mc, itw[:, None], itwp[:, None],
                           qs.reshape(Lc, 1, 1, 1))
    cols = mu.transpose(0, 1, 3, 2).reshape(Lc, b * n2p, n1)
    c = ntt_kernel.intt(cols, qs, cw, cwp, interpret=interpret)
    cm = c.reshape(Lc, b, n2p, n1).transpose(0, 1, 3, 2)
    out = lax.all_to_all(cm, sp_axis, split_axis=2, concat_axis=3, tiled=True)
    return out.reshape(Lc, b, n1p * n2)


# -- public entry points -------------------------------------------------------


def _specs(ch_axis: str, sp_axis: str, dp_axis: Optional[str]):
    x = P(ch_axis, dp_axis, sp_axis)
    q = P(ch_axis)
    pass_tab = P(ch_axis, None)              # (L, n1|n2) whole per device
    scale_tab = P(ch_axis, None, sp_axis)    # (L, n1, n2) column slices
    return x, q, pass_tab, scale_tab


@functools.lru_cache(maxsize=64)
def _fn(plans, mesh, ch_axis, sp_axis, dp_axis, inverse, interpret):
    x_spec, q_spec, t_spec, s_spec = _specs(ch_axis, sp_axis, dp_axis)
    body = functools.partial(
        _inv_body if inverse else _fwd_body, sp_axis=sp_axis,
        n1=plans[0].n1, n2=plans[0].n2, Psp=mesh.shape[sp_axis],
        interpret=interpret,
    )
    in_specs = (x_spec, q_spec, t_spec, t_spec, s_spec, s_spec, t_spec,
                t_spec)
    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=in_specs, out_specs=x_spec, check_vma=False,
    ))


def chsp_fwd(
    x: jnp.ndarray,
    plans: Tuple[FourStepPlan, ...],
    mesh: Mesh,
    *,
    ch_axis: str = "ch",
    sp_axis: str = "sp",
    dp_axis: Optional[str] = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """Forward RNS four-step NTT, channels over ch_axis, coefficients over
    sp_axis, batch optionally over dp_axis.  x: (L, B, n) uint32 in [0, 4q_l)
    per channel; output [0, q_l), bit-identical per channel to the
    single-device four-step transform."""
    check_plans(plans, mesh, ch_axis, sp_axis)
    fn = _fn(plans, mesh, ch_axis, sp_axis, dp_axis, False, interpret)
    return fn(x, *(jnp.asarray(t) for t in _fwd_bundle(plans)))


def chsp_inv(
    y: jnp.ndarray,
    plans: Tuple[FourStepPlan, ...],
    mesh: Mesh,
    *,
    ch_axis: str = "ch",
    sp_axis: str = "sp",
    dp_axis: Optional[str] = None,
    scales: Optional[Tuple[int, ...]] = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """Inverse (sharding as chsp_fwd).  y: (L, B, n) in [0, 2q_l); output
    [0, q_l).  scales: per-channel overall multipliers (default n^-1 mod
    q_l; polymul folds the Montgomery R in)."""
    check_plans(plans, mesh, ch_axis, sp_axis)
    if scales is None:
        scales = tuple(p.n_inv for p in plans)
    fn = _fn(plans, mesh, ch_axis, sp_axis, dp_axis, True, interpret)
    return fn(y, *(jnp.asarray(t) for t in _inv_bundle(plans, tuple(scales))))
