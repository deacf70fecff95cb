"""Machine-derived element-op census of a traced computation.

The reference's static report derives its cycle model from the compiler's
II/occupancy analysis (``/root/reference/Makefile:26,38-39``).  This module
traces any jittable function to a jaxpr and counts **element-weighted
integer ops** per primitive class, so an op count quoted for a kernel is the
executed computation's, not a hand estimate.

Classes:
  * ``alu``    — elementwise integer ops: mul, add, sub, and, or, xor,
                 shifts, compares, select_n (counted once), min/max.
  * ``layout`` — data-movement ops (split, concatenate, transpose, roll,
                 gather, slices): not ALU work, reported separately.
  * ``free``   — trace artifacts with no per-element cost: broadcast_in_dim
                 of scalars, same-width converts, iota, reshapes.

Counting is at trace level (before XLA optimization), so it is an *upper
bound* on executed ALU ops — CSE and fusion can only remove work.
"""

from __future__ import annotations

import math
from collections import Counter
from typing import Any, Callable, Dict

import jax

# primitive name -> (class, ops per output element)
_ALU_1 = {
    "mul", "add", "sub", "and", "or", "xor", "shift_right_logical",
    "shift_left", "shift_right_arithmetic", "not", "neg",
    "eq", "ne", "ge", "gt", "le", "lt", "min", "max",
    "add_any",
}
_SELECT = {"select_n"}  # one vselect per element regardless of arity
_LAYOUT = {
    "roll", "transpose", "gather", "rev", "concatenate", "pad", "split",
    "dynamic_slice", "dynamic_update_slice", "slice",
}
_FREE = {
    "broadcast_in_dim", "convert_element_type", "reshape", "squeeze",
    "expand_dims", "iota", "stop_gradient", "copy", "bitcast_convert_type",
}


def _elems(aval) -> int:
    return int(math.prod(aval.shape)) if aval.shape else 1


def _count_jaxpr(jaxpr, counts: Counter, prim_counts: Counter) -> None:
    for eqn in jaxpr.eqns:
        name = eqn.primitive.name
        # recurse into sub-jaxprs (pjit, scan bodies, pallas kernels, ...)
        sub = []
        if name in ("pjit", "jit"):
            sub = [eqn.params["jaxpr"].jaxpr]
        elif name in ("closed_call", "core_call", "custom_jvp_call",
                      "custom_vjp_call"):
            j = eqn.params.get("call_jaxpr")
            if j is not None:
                sub = [j.jaxpr if hasattr(j, "jaxpr") else j]
        elif name == "pallas_call":
            j = eqn.params.get("jaxpr")
            if j is not None:
                sub = [j.jaxpr if hasattr(j, "jaxpr") else j]
        elif name == "scan":
            j = eqn.params.get("jaxpr")
            length = eqn.params.get("length", 1)
            if j is not None:
                inner = Counter()
                inner_p = Counter()
                _count_jaxpr(j.jaxpr if hasattr(j, "jaxpr") else j, inner,
                             inner_p)
                for k, v in inner.items():
                    counts[k] += v * length
                for k, v in inner_p.items():
                    prim_counts[k] += v * length
                continue
        elif name in ("while", "cond"):
            # bound unknown for while; count one body execution
            for key in ("body_jaxpr", "cond_jaxpr", "branches"):
                j = eqn.params.get(key)
                if j is None:
                    continue
                js = j if isinstance(j, (tuple, list)) else [j]
                sub += [ji.jaxpr if hasattr(ji, "jaxpr") else ji for ji in js]
        if sub:
            for j in sub:
                _count_jaxpr(j, counts, prim_counts)
            continue

        out_elems = max((_elems(v.aval) for v in eqn.outvars), default=0)
        prim_counts[name] += out_elems
        if name in _ALU_1 or name in _SELECT:
            counts["alu"] += out_elems
        elif name in _LAYOUT:
            counts["layout"] += out_elems
        elif name in _FREE:
            counts["free"] += out_elems
        else:
            counts["other"] += out_elems


def op_census(fn: Callable, *args: Any, **kwargs) -> Dict[str, Any]:
    """Trace fn(*args) and return element-weighted op counts.

    Returns dict with keys ``alu``, ``layout``, ``free``, ``other`` (total
    element-ops per call) and ``per_primitive`` (Counter by primitive name).
    """
    closed = jax.make_jaxpr(fn, **kwargs)(*args)
    counts: Counter = Counter()
    prims: Counter = Counter()
    _count_jaxpr(closed.jaxpr, counts, prims)
    return {
        "alu": int(counts["alu"]),
        "layout": int(counts["layout"]),
        "free": int(counts["free"]),
        "other": int(counts["other"]),
        "per_primitive": dict(prims),
    }


def ntt_alu_ops(params, batch: int, direction: str = "fwd") -> Dict[str, Any]:
    """Op census of one (batch, n) transform: the shared split-form stage
    chain (``stage_math.fwd_chain`` / ``inv_chain``) that both the GPU
    kernel and the plain XLA path execute.  ``per_elem_stage`` normalizes
    each class by batch * n * log2(n) element-stages."""
    import jax.numpy as jnp

    from ..ops import xla_ntt

    if direction == "fwd":
        qs, w, wp = xla_ntt.stacked_tables((params,))
        fn = xla_ntt.ntt
    elif direction == "inv":
        qs, w, wp = xla_ntt.stacked_tables((params,), True)
        fn = xla_ntt.intt
    else:
        raise ValueError(f"direction must be fwd|inv, got {direction!r}")
    n, logn = params.n, params.log_n
    x = jax.ShapeDtypeStruct((1, batch, n), jnp.uint32)
    census = op_census(lambda v: fn(v, qs, w, wp), x)
    census["alu_denom"] = batch * n * logn  # element-stages per call
    census["per_elem_stage"] = {
        k: census[k] / (batch * n * logn)
        for k in ("alu", "layout", "free", "other")
    }
    return census
