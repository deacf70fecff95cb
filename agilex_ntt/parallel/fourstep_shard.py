"""Distributed four-step NTT: local small transforms + all-to-all.

This is the multi-chip pattern SURVEY.md §5 plans for large-N transforms:
"local column NTTs -> twiddle scale -> all-to-all transpose -> local row
NTTs".  It complements ``stage_shard.py`` (which exchanges butterfly halves
with log2(P) whole-shard ``ppermute`` hops): the four-step form moves each
element between devices exactly twice regardless of P —

    comm volume per transform:  stage-shard  log2(P) * n/P  per device/way
                                four-step    2 * (P-1)/P * n/P  per device

so beyond P = 4 the all-to-all transpose wins, and its two collectives give
XLA longer uninterrupted compute regions to overlap.

Sharding layout (coefficient axis over `axis`, P devices, P | n1 and P | n2):
a device's contiguous n/P coefficient block is n1/P whole rows of the
(n1, n2) four-step matrix.  The first all-to-all retiles rows->columns
(each device ends with all n1 rows of n2/P columns — exactly what the
column-pass negacyclic NTT needs), the second retiles back for the row pass.
The inter-pass scale table rides the same column sharding
(PartitionSpec(None, axis)), the mesh analog of the reference broadcasting
twiddle words to every compute unit (``/root/reference/src/kernel/
ntt.cpp:552-554``).  Outputs are bit-identical to the single-chip kernels.
"""

from __future__ import annotations

import functools
from typing import Optional

import jax
import jax.numpy as jnp
from jax import lax
from jax.sharding import Mesh, PartitionSpec as P

from ..ops import ntt_kernel
from ..ops.fourstep import FourStepPlan
from ..ops.modmul import shoup_mulmod_lazy
from ..utils.profiling import under_trace


def _check(plan: FourStepPlan, num_devices: int):
    if plan.n1 % num_devices or plan.n2 % num_devices:
        raise ValueError(
            f"four-step sharding needs P | n1 and P | n2: "
            f"P={num_devices}, n1={plan.n1}, n2={plan.n2}"
        )


def _fwd_body(
    x, tw, twp, *, axis: str, plan: FourStepPlan, num_devices: int,
    interpret: bool,
):
    """shard_map body.  x: (B, n/P) local rows block; tw/twp: (n1, n2/P)
    local column slice of the inter-pass scale table."""
    b = x.shape[0]
    n1, n2 = plan.n1, plan.n2
    n1p, n2p = n1 // num_devices, n2 // num_devices
    xm = x.reshape(b, n1p, n2)
    # rows -> columns retile: (B, n1/P, n2) -> (B, n1, n2/P)
    xc = lax.all_to_all(xm, axis, split_axis=2, concat_axis=1, tiled=True)
    cols = xc.transpose(0, 2, 1).reshape(b * n2p, n1)
    yc = ntt_kernel.fwd_ntt(cols, plan.col, interpret=interpret)
    m1 = yc.reshape(b, n2p, n1).transpose(0, 2, 1)  # (B, n1, n2/P)
    m2 = shoup_mulmod_lazy(m1, tw[None], twp[None], plan.q)
    # columns -> rows retile: (B, n1, n2/P) -> (B, n1/P, n2)
    xr = lax.all_to_all(m2, axis, split_axis=1, concat_axis=2, tiled=True)
    rows = xr.reshape(b * n1p, n2)
    out = ntt_kernel.fwd_ntt(rows, plan.row, interpret=interpret)
    return out.reshape(b, n1p * n2)


def _inv_body(
    y, itw, itwp, *, axis: str, plan: FourStepPlan, num_devices: int,
    scale: int, interpret: bool,
):
    b = y.shape[0]
    n1, n2 = plan.n1, plan.n2
    n1p, n2p = n1 // num_devices, n2 // num_devices
    col_scale = scale * plan.n2 % plan.q
    rows = y.reshape(b * n1p, n2)
    r = ntt_kernel.inv_ntt(
        rows, plan.row, scale=plan.row.n_inv, interpret=interpret
    )
    m = r.reshape(b, n1p, n2)
    mc = lax.all_to_all(m, axis, split_axis=2, concat_axis=1, tiled=True)
    # unscale in column layout so the inverse table shares the forward
    # table's (None, axis) sharding
    mu = shoup_mulmod_lazy(mc, itw[None], itwp[None], plan.q)
    cols = mu.transpose(0, 2, 1).reshape(b * n2p, n1)
    c = ntt_kernel.inv_ntt(cols, plan.col, scale=col_scale,
                           interpret=interpret)
    cm = c.reshape(b, n2p, n1).transpose(0, 2, 1)  # (B, n1, n2/P)
    out = lax.all_to_all(cm, axis, split_axis=1, concat_axis=2, tiled=True)
    return out.reshape(b, n1p * n2)


def _specs(dp_axis: Optional[str], sp_axis: str):
    return (P(dp_axis, sp_axis), P(None, sp_axis), P(None, sp_axis)), \
        P(dp_axis, sp_axis)


# device-resident scale tables, cached per plan: fresh jnp.asarray(numpy)
# arguments would re-upload the (n1, n2) tables host->device every call.
# Under an enclosing trace return numpy (constants of that trace) so no
# tracer is ever cached.
@functools.lru_cache(maxsize=256)
def _dev_scale_cached(plan, inverse):
    if inverse:
        return jnp.asarray(plan.itw), jnp.asarray(plan.itwp)
    return jnp.asarray(plan.tw), jnp.asarray(plan.twp)


def _dev_scale(plan, inverse):
    if under_trace():
        return (plan.itw, plan.itwp) if inverse else (plan.tw, plan.twp)
    return _dev_scale_cached(plan, inverse)


# comm="overlap": split the local batch into independent chunks inside the
# shard_map body.  Each chunk's column pass -> all-to-all -> scale ->
# all-to-all -> row pass is a dataflow-independent chain, so XLA's async
# collective scheduler overlaps chunk c's all-to-all with chunk c±1's
# transform compute.  Bit-identical: transforms are row-independent.
_OVERLAP_CHUNKS = 4


def _chunked(body_fn, x, *tabs):
    b = x.shape[0]
    nch = _OVERLAP_CHUNKS
    while nch > 1 and b % nch:
        nch //= 2
    if nch == 1:
        return body_fn(x, *tabs)
    step = b // nch
    outs = [
        body_fn(lax.slice_in_dim(x, c * step, (c + 1) * step, axis=0), *tabs)
        for c in range(nch)
    ]
    return jnp.concatenate(outs, axis=0)


# cached jitted shard_map wrappers (plan/Mesh are hashable; rebuilding
# jax.jit per call would recompile every invocation)
@functools.lru_cache(maxsize=256)
def _fwd_fn(plan, mesh, axis, dp_axis, interpret, comm="ppermute"):
    in_specs, out_spec = _specs(dp_axis, axis)
    body = functools.partial(
        _fwd_body, axis=axis, plan=plan, num_devices=mesh.shape[axis],
        interpret=interpret,
    )
    if comm == "overlap":
        body = functools.partial(_chunked, body)
    return jax.jit(
        jax.shard_map(
            body, mesh=mesh, in_specs=in_specs, out_specs=out_spec,
            check_vma=False,
        )
    )


@functools.lru_cache(maxsize=256)
def _inv_fn(plan, mesh, axis, dp_axis, scale, interpret, comm="ppermute"):
    in_specs, out_spec = _specs(dp_axis, axis)
    body = functools.partial(
        _inv_body, axis=axis, plan=plan, num_devices=mesh.shape[axis],
        scale=scale, interpret=interpret,
    )
    if comm == "overlap":
        body = functools.partial(_chunked, body)
    return jax.jit(
        jax.shard_map(
            body, mesh=mesh, in_specs=in_specs, out_specs=out_spec,
            check_vma=False,
        )
    )


def fourstep_sharded_fwd(
    x: jnp.ndarray,
    plan: FourStepPlan,
    mesh: Mesh,
    *,
    axis: str = "sp",
    dp_axis: Optional[str] = None,
    interpret: bool = False,
    comm: str = "ppermute",
) -> jnp.ndarray:
    """Forward four-step NTT, coefficients sharded over `axis` (and the batch
    optionally over `dp_axis`).  x: (B, n) uint32 in [0, 4q); output [0, q),
    bit-identical to the single-chip transform.

    comm="overlap" pipelines independent batch chunks so the all-to-all
    retiles overlap transform compute (see ``_chunked``)."""
    num_devices = mesh.shape[axis]
    _check(plan, num_devices)
    if comm not in ("ppermute", "overlap"):
        raise ValueError(f"unknown comm {comm!r}")
    fn = _fwd_fn(plan, mesh, axis, dp_axis, interpret, comm)
    return fn(x, *_dev_scale(plan, False))


def fourstep_sharded_inv(
    x: jnp.ndarray,
    plan: FourStepPlan,
    mesh: Mesh,
    *,
    axis: str = "sp",
    dp_axis: Optional[str] = None,
    scale: Optional[int] = None,
    interpret: bool = False,
    comm: str = "ppermute",
) -> jnp.ndarray:
    """Inverse four-step NTT (sharding as in ``fourstep_sharded_fwd``).
    x: (B, n) uint32 in [0, 2q); output [0, q).  `scale` overrides the
    overall n^-1 multiplier (Montgomery fold, see api.polymul).  ``comm``
    as in :func:`fourstep_sharded_fwd`."""
    num_devices = mesh.shape[axis]
    _check(plan, num_devices)
    if comm not in ("ppermute", "overlap"):
        raise ValueError(f"unknown comm {comm!r}")
    if scale is None:
        scale = plan.n_inv
    fn = _inv_fn(plan, mesh, axis, dp_axis, scale, interpret, comm)
    return fn(x, *_dev_scale(plan, True))
