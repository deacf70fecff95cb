"""Stage-sharded (coefficient-parallel) NTT across a mesh axis.

The reference never splits one transform across compute units — a frame's
whole polynomial lives in one CU's BLOCK_RAM (SURVEY.md §5, "one frame never
spans compute units").  But its first stage already contains the structural
seam a distributed NTT exploits: the producer pre-pairs each element with its
partner n/2 away (``/root/reference/src/kernel/ntt.cpp:183-205, 586-589``),
i.e. the early stages pair data that lives far apart.

Here the coefficient axis is sharded over `P = mesh.shape[axis]` devices
(shard size S = n/P).  Forward stages run in HEXL order m = 1 -> n/2:

  * m < P (the first log2 P stages, stride t >= S): the butterfly partner
    lives on device d XOR (t/S).  Each device ``ppermute``s its whole shard
    to its partner and computes its half of every butterfly — the whole
    shard shares one twiddle and one u/v role.
  * m >= P: purely local.  Shard d's groups are groups d*m/P ... of the
    global stage, so the local stages are one size-S transform over a
    per-shard table (``_local_tables``) — the same radix-2 transform
    (``ops/ntt_kernel.py``) as a single-device ring.

The inverse mirrors this: the local Gentleman-Sande stages first (one
size-S inverse transform), then log2 P cross-device stages, then the
scaling.  Outputs are bit-identical to the single-device transforms.

Communication cost: log2(P) shard-sized ppermutes each way.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import ntt_kernel
from ..ops.stage_math import apply_scale, fwd_stage_step, inv_stage_step
from ..params import NTTParams
from ..utils.profiling import under_trace


@functools.lru_cache(maxsize=256)
def _local_tables(params: NTTParams, num_devices: int, inverse: bool):
    """Per-shard tables (each (P, ...) uint32, row d for device d):

    lw/lwp (P, S): shard d's local size-S table — entry m + g holds the
    global twiddle of stage P*m, group d*m + g.  For the inverse, entries
    0 and 1 are (1, w[P + d]): the local transform's folded last stage is
    then global stage P (a plain GS stage; its outputs land fully reduced,
    inside the lazy range the cross stages accept).
    cw/cwp (P, log2 P): shard d's one twiddle for each cross stage.
    """
    n, q, Pd = params.n, params.q, num_devices
    S = n // Pd
    if inverse:
        w, wp = params.inv_roots32, params.inv_precon32
    else:
        w, wp = params.roots32, params.precon32
    idx = np.zeros((Pd, S), dtype=np.int64)
    m = 1
    while m < S:
        g = np.arange(m)
        for d in range(Pd):
            idx[d, m + g] = Pd * m + d * m + g
        m *= 2
    lw, lwp = w[idx], wp[idx]
    if inverse:
        lw[:, 0] = 1
        lwp[:, 0] = (1 << 32) // q
        lw[:, 1] = w[Pd + np.arange(Pd)]
        lwp[:, 1] = wp[Pd + np.arange(Pd)]
    logp = Pd.bit_length() - 1
    cidx = np.zeros((Pd, logp), dtype=np.int64)
    for s in range(logp):
        # forward cross stage s is global m = 2^s; the inverse runs them in
        # reverse (m = P/2 ... 1), so its stage s is m = P >> (s + 1)
        m = (Pd >> (s + 1)) if inverse else (1 << s)
        tdev = Pd // (2 * m)
        for d in range(Pd):
            cidx[d, s] = m + d // (2 * tdev)
    return lw, lwp, w[cidx], wp[cidx]


def _fwd_body(x, lw, lwp, cw, cwp, *, axis: str, num_devices: int, q: int,
              interpret: bool):
    """shard_map body.  x: (B, S) local shard; tables: this device's row."""
    idx = lax.axis_index(axis)
    for s in range(num_devices.bit_length() - 1):
        tdev = num_devices >> (s + 1)  # partner distance in shards
        recv = lax.ppermute(
            x, axis, [(d, d ^ tdev) for d in range(num_devices)]
        )
        is_u = ((idx // tdev) & 1) == 0  # the whole shard shares one role
        x = fwd_stage_step(x, recv, is_u, cw[0, s], cwp[0, s], q=q)
    qa = jnp.full((1,), q, jnp.uint32)
    return ntt_kernel.ntt(x[None], qa, lw, lwp, interpret=interpret)[0]


def _inv_body(x, lw, lwp, cw, cwp, *, axis: str, num_devices: int, q: int,
              scale: int, interpret: bool):
    qa = jnp.full((1,), q, jnp.uint32)
    x = ntt_kernel.intt(x[None], qa, lw, lwp, interpret=interpret)[0]
    idx = lax.axis_index(axis)
    for s in range(num_devices.bit_length() - 1):
        tdev = 1 << s
        recv = lax.ppermute(
            x, axis, [(d, d ^ tdev) for d in range(num_devices)]
        )
        is_u = ((idx // tdev) & 1) == 0
        x = inv_stage_step(x, recv, is_u, cw[0, s], cwp[0, s], q=q)
    return apply_scale(x, q=q, scale=scale)


# jitted shard_map wrappers are cached: rebuilding jax.jit(...) per call would
# retrace and recompile every invocation (Mesh, NTTParams and all remaining
# keys are hashable; params is interned by make_params's lru_cache).
@functools.lru_cache(maxsize=256)
def _sharded_fn(params, mesh, axis, dp_axis, inverse, scale, interpret):
    tab = P(axis, None)
    x_spec = P(dp_axis, axis)
    kw = dict(axis=axis, num_devices=mesh.shape[axis], q=params.q,
              interpret=interpret)
    if inverse:
        body = functools.partial(_inv_body, scale=scale, **kw)
    else:
        body = functools.partial(_fwd_body, **kw)
    return jax.jit(jax.shard_map(
        body, mesh=mesh, in_specs=(x_spec, tab, tab, tab, tab),
        out_specs=x_spec, check_vma=False,
    ))


@functools.lru_cache(maxsize=256)
def _device_tables(params, num_devices, inverse):
    return tuple(jnp.asarray(t)
                 for t in _local_tables(params, num_devices, inverse))


def _tables(params, num_devices, inverse):
    # device arrays created under a trace must not be cached (tracer leak);
    # there the numpy tables become constants of the enclosing trace
    if under_trace():
        return _local_tables(params, num_devices, inverse)
    return _device_tables(params, num_devices, inverse)


def _check(params: NTTParams, num_devices: int):
    if params.n % (2 * num_devices):
        raise ValueError(
            f"n={params.n} must split into shards of >= 2 coefficients "
            f"over {num_devices} devices"
        )


def stage_sharded_fwd(
    x: jnp.ndarray,
    params: NTTParams,
    mesh: Mesh,
    *,
    axis: str = "sp",
    dp_axis: Optional[str] = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """Forward NTT with coefficients sharded over `axis` (and optionally the
    batch over `dp_axis`).  x: (B, n) uint32 in [0, 4q); output [0, q),
    bit-identical to the single-device transform."""
    _check(params, mesh.shape[axis])
    fn = _sharded_fn(params, mesh, axis, dp_axis, False, None, interpret)
    return fn(x, *_tables(params, mesh.shape[axis], False))


def stage_sharded_inv(
    x: jnp.ndarray,
    params: NTTParams,
    mesh: Mesh,
    *,
    axis: str = "sp",
    dp_axis: Optional[str] = None,
    scale: Optional[int] = None,
    interpret: bool = False,
) -> jnp.ndarray:
    """Inverse NTT with coefficients sharded over `axis`.  x: (B, n) uint32 in
    [0, 2q); output [0, q), bit-identical to the single-device transform."""
    _check(params, mesh.shape[axis])
    if scale is None:
        scale = params.n_inv
    fn = _sharded_fn(params, mesh, axis, dp_axis, True, scale % params.q,
                     interpret)
    return fn(x, *_tables(params, mesh.shape[axis], True))
