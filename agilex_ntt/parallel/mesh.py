"""Device-mesh helpers and the sharded ring front end.

Data-parallel batch sharding is the mesh equivalent of the reference's frame
round-robin over NUM_NTT_COMPUTE_UNITS replicated kernels
(``/root/reference/src/kernel/ntt.cpp:8-12, 526-536, 579-595``): the batch
axis shards over mesh devices, each device runs the same transform on its
shard, and the per-CU mini-batch-size protocol (C6) reduces to a
PartitionSpec.  Twiddle tables are replicated — the mesh analog of the
producer broadcasting twiddle words to every CU (ntt.cpp:552-554).
"""

from __future__ import annotations

from typing import Optional

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..api import CyclicRing, Ring, RNSRing
from ..ops import fourstep, ntt_kernel, xla_ntt
from ..ops.modmul import U32, cond_sub, mont_mul_lazy
from . import fourstep_shard, stage_shard


def make_mesh(**axes: int) -> Mesh:
    """Build a named mesh, e.g. make_mesh(dp=4, sp=2).

    Axis types are Auto (classic sharding propagation): this library manages
    shardings itself via shard_map, so the new explicit-sharding mode only
    gets in the way of in-body constants.  GPUs in one host reach each other
    all to all over NVLink, so the mesh shape follows the algorithm alone.
    """
    names = tuple(axes.keys())
    shape = tuple(axes.values())
    want = int(np.prod(shape))
    have = len(jax.devices())
    if want > have:
        raise ValueError(f"mesh needs {want} devices, only {have} available")
    axis_types = (jax.sharding.AxisType.Auto,) * len(names)
    return jax.make_mesh(shape, names, axis_types=axis_types)


def dp_shard_batch(x: jnp.ndarray, mesh: Mesh, axis: str = "dp") -> jnp.ndarray:
    """Place (B, ..., n) with the batch axis sharded over `axis`."""
    spec = P(axis, *([None] * (x.ndim - 1)))
    return jax.device_put(x, NamedSharding(mesh, spec))


class ShardedRing:
    """A Ring distributed over a device mesh.

    dp_axis: batch sharding (frame round-robin analog; linear scaling).
    sp_axis: coefficient sharding for large n (the sequence-parallel analog).
    sp_method: how the coefficient-sharded transform communicates —
        "stage":    per-stage butterfly exchange, log2(P) ppermute hops
                    (parallel/stage_shard.py);
        "fourstep": local column/row transforms with two all-to-all
                    retiles (parallel/fourstep_shard.py) — fewer, larger
                    collectives; the default for four-step rings.
    sp_comm ("fourstep" method): "ppermute" runs the whole local batch
        through each all-to-all; "overlap" splits it into independent
        chunks so XLA can overlap one chunk's all-to-all with another's
        transform (parallel/fourstep_shard.py) — bit-identical.
    Either axis may be None.  All results are bit-identical to the
    single-chip Ring.
    """

    def __init__(
        self,
        ring: Ring,
        mesh: Mesh,
        *,
        dp_axis: Optional[str] = "dp",
        sp_axis: Optional[str] = None,
        sp_method: Optional[str] = None,
        sp_comm: str = "ppermute",
    ):
        if not isinstance(ring, (Ring, CyclicRing)):
            raise TypeError(
                f"ShardedRing wraps a Ring or CyclicRing; got "
                f"{type(ring).__name__}"
            )
        self.ring = ring
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.sp_axis = sp_axis
        if dp_axis is None and sp_axis is None:
            raise ValueError("need at least one mesh axis")
        for ax in (dp_axis, sp_axis):
            if ax is not None and ax not in mesh.axis_names:
                raise ValueError(f"axis {ax!r} not in mesh {mesh.axis_names}")
        if sp_method is None:
            sp_method = "fourstep" if ring.method == "fourstep" else "stage"
        if sp_method not in ("stage", "fourstep"):
            raise ValueError(f"unknown sp_method {sp_method!r}")
        if sp_method == "stage" and getattr(ring, "params", None) is None:
            raise ValueError(
                "stage-sharded transform needs single-pass tables; "
                "use sp_method='fourstep' for four-step cyclic rings"
            )
        self.sp_method = sp_method
        if sp_comm not in ("ppermute", "overlap"):
            raise ValueError(f"unknown sp_comm {sp_comm!r}")
        if sp_comm == "overlap" and sp_method != "fourstep":
            raise ValueError("sp_comm='overlap' needs sp_method='fourstep'")
        self.sp_comm = sp_comm
        if sp_axis is not None and sp_method == "fourstep":
            if ring.plan is not None:
                self._plan = ring.plan
            elif isinstance(ring, CyclicRing):
                self._plan = fourstep.make_cyclic_plan(
                    ring.n, ring.q, ring.omega
                )
            else:
                self._plan = fourstep.make_plan(ring.n, ring.q, ring._psi)
        else:
            self._plan = None
        self._dp_cache = {}

    # -- plumbing ------------------------------------------------------------

    @property
    def _x_spec(self) -> P:
        return P(self.dp_axis, self.sp_axis)

    def shard(self, x: jnp.ndarray) -> jnp.ndarray:
        """Place a (B, n) array with this ring's sharding."""
        return jax.device_put(x, NamedSharding(self.mesh, self._x_spec))

    def _dp_pad(self, x: jnp.ndarray):
        """Pad the batch up to a multiple of the dp axis size.

        The SPMD analog of the reference's remainder-frame distribution: the
        producer gives the first numFrames % NUM_CUs compute units one extra
        frame (miniBatchSize + 1, /root/reference/src/kernel/ntt.cpp:526-536).
        Under SPMD every device must run the same program on an equal shard,
        so the remainder is handled by zero-padding the batch and slicing the
        result — transforms are row-independent, so real rows are bit-exact.
        Returns (padded, true_batch).
        """
        b = x.shape[0]
        if self.dp_axis is None:
            return x, b
        P_dp = self.mesh.shape[self.dp_axis]
        pad = (-b) % P_dp
        if pad:
            x = jnp.pad(x, ((0, pad), (0, 0)))
        return x, b

    def _true_rows(self, out: jnp.ndarray, b: int) -> jnp.ndarray:
        """Slice padded result rows back off (remainder-frame batches only).

        A slice to a size not divisible by the dp axis is rejected by the
        sharding type system, eagerly and under jit, so the batch axis is
        first unsharded (a dp-axis all-gather — remainder batches trade one
        gather for the reference's uneven per-CU frame counts); coefficients
        stay sharded over sp.  Runs under jit so GSPMD inserts the gather.
        """
        if out.shape[0] == b:
            return out
        fn = self._dp_cache.get("slice_rows")
        if fn is None:
            unshard = NamedSharding(self.mesh, P(None, self.sp_axis))

            def f(o, n):
                o = jax.lax.with_sharding_constraint(o, unshard)
                return jax.lax.slice_in_dim(o, 0, n, axis=0)

            fn = jax.jit(f, static_argnums=1)
            self._dp_cache["slice_rows"] = fn
        return fn(out, b)

    def _dp_map(self, key, fn, *xs):
        """shard_map a per-shard (B_local, n) -> (B_local, n) function over
        the dp axis only.  `key` memoizes the jitted wrapper — rebuilding
        jax.jit per call would retrace and recompile every invocation."""
        wrapped = self._dp_cache.get(key)
        if wrapped is None:
            spec = P(self.dp_axis, None)
            wrapped = jax.jit(
                jax.shard_map(
                    fn, mesh=self.mesh, in_specs=(spec,) * len(xs),
                    out_specs=spec, check_vma=False,
                )
            )
            self._dp_cache[key] = wrapped
        return wrapped(*xs)

    # -- transforms ----------------------------------------------------------

    def ntt(self, x: jnp.ndarray) -> jnp.ndarray:
        x = jnp.asarray(x, dtype=jnp.uint32)
        if x.ndim != 2 or x.shape[-1] != self.ring.n:
            raise ValueError(f"expected (B, n={self.ring.n}), got {x.shape}")
        x, b = self._dp_pad(x)
        if self.sp_axis is not None:
            if self.sp_method == "fourstep":
                out = fourstep_shard.fourstep_sharded_fwd(
                    x, self._plan, self.mesh,
                    axis=self.sp_axis, dp_axis=self.dp_axis,
                    interpret=self.ring.interpret, comm=self.sp_comm,
                )
            else:
                out = stage_shard.stage_sharded_fwd(
                    x, self.ring.params, self.mesh,
                    axis=self.sp_axis, dp_axis=self.dp_axis,
                    interpret=self.ring.interpret,
                )
            return self._true_rows(out, b)
        if self.ring.method == "fourstep":
            fn = lambda xl: fourstep.fwd_ntt_fourstep(
                xl, self.ring.plan, interpret=self.ring.interpret
            )
        else:
            fn = lambda xl: ntt_kernel.fwd_ntt(
                xl, self.ring.params, interpret=self.ring.interpret
            )
        out = self._dp_map("ntt", fn, x)
        return self._true_rows(out, b)

    def intt(self, x: jnp.ndarray, *, scale: Optional[int] = None) -> jnp.ndarray:
        x = jnp.asarray(x, dtype=jnp.uint32)
        if x.ndim != 2 or x.shape[-1] != self.ring.n:
            raise ValueError(f"expected (B, n={self.ring.n}), got {x.shape}")
        x, b = self._dp_pad(x)
        if self.sp_axis is not None:
            if self.sp_method == "fourstep":
                out = fourstep_shard.fourstep_sharded_inv(
                    x, self._plan, self.mesh,
                    axis=self.sp_axis, dp_axis=self.dp_axis, scale=scale,
                    interpret=self.ring.interpret, comm=self.sp_comm,
                )
            else:
                out = stage_shard.stage_sharded_inv(
                    x, self.ring.params, self.mesh,
                    axis=self.sp_axis, dp_axis=self.dp_axis, scale=scale,
                    interpret=self.ring.interpret,
                )
            return self._true_rows(out, b)
        if self.ring.method == "fourstep":
            fn = lambda xl: fourstep.inv_ntt_fourstep(
                xl, self.ring.plan, scale=scale, interpret=self.ring.interpret
            )
        else:
            fn = lambda xl: ntt_kernel.inv_ntt(
                xl, self.ring.params, scale=scale,
                interpret=self.ring.interpret,
            )
        out = self._dp_map(("intt", scale), fn, x)
        return self._true_rows(out, b)

    def polymul(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """Negacyclic product; pointwise stage is elementwise so it keeps
        whatever sharding the transforms produce.  The composition runs as
        one jitted computation (single dispatch)."""
        fn = self._dp_cache.get("polymul")
        if fn is None:

            def f(x, y):
                fa = self.ntt(x)
                fb = self.ntt(y)
                prod = self.ring._pointwise_lazy_expr(fa, fb)
                return self.intt(prod, scale=self.ring.polymul_scale)

            fn = jax.jit(f)
            self._dp_cache["polymul"] = fn
        return fn(a, b)

    def polydot(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """Inner product sum_i a_i * b_i mod (X^n + 1, q) of (B, k, n)
        operands — the key-switch primitive, distributed: 2k sharded
        transforms, lazy accumulation, one sharded inverse, in one jitted
        computation.  Bit-identical to Ring.polydot (same accumulation
        order)."""
        a = jnp.asarray(a, dtype=jnp.uint32)
        b = jnp.asarray(b, dtype=jnp.uint32)
        ring = self.ring
        if a.shape != b.shape or a.ndim != 3 or a.shape[-1] != ring.n:
            raise ValueError(
                f"polydot expects matching (B, k, n={ring.n}) shapes, got "
                f"{a.shape} and {b.shape}"
            )
        k = a.shape[1]
        key = ("polydot", k)
        fn = self._dp_cache.get(key)
        if fn is None:
            two_q = 2 * ring.q

            def f(x, y):
                acc = None
                for i in range(k):  # k static: unrolled at trace time
                    fa = self.ntt(x[:, i])
                    fb = self.ntt(y[:, i])
                    term = ring._pointwise_lazy_expr(fa, fb)
                    acc = (
                        term if acc is None
                        else cond_sub(acc + term, U32(two_q))
                    )
                return self.intt(acc, scale=ring.polymul_scale)

            fn = jax.jit(f)
            self._dp_cache[key] = fn
        return fn(a, b)

    # -- batch-elementwise ring ops (coefficient-axis gathers) ---------------

    def _gather_delegate(self, key, x, call):
        """Run a batch-elementwise Ring op on the sharded array and pin the
        output back to this ring's sharding.  Under dp the gather is purely
        local; under sp it permutes the coefficient axis, so GSPMD inserts
        the cross-shard collective — the constraint keeps the result laid
        out for the next sharded op instead of drifting to replicated."""
        fn = self._dp_cache.get(key)
        if fn is None:
            out_shard = NamedSharding(self.mesh, self._x_spec)

            def f(v):
                return jax.lax.with_sharding_constraint(call(v), out_shard)

            fn = jax.jit(f)
            self._dp_cache[key] = fn
        return fn(x)

    def rotate(self, x: jnp.ndarray, k: int) -> jnp.ndarray:
        """Multiply by X^k on the mesh (see Ring.rotate)."""
        x = jnp.asarray(x, dtype=jnp.uint32)
        k = int(k) % (2 * self.ring.n)
        return self._gather_delegate(
            ("rotate", k), x, lambda v: self.ring.rotate(v, k)
        )

    def automorphism(self, x: jnp.ndarray, k: int, *, domain: str = "coeff") -> jnp.ndarray:
        """Galois automorphism tau_k on the mesh (see Ring.automorphism)."""
        x = jnp.asarray(x, dtype=jnp.uint32)
        return self._gather_delegate(
            ("automorphism", int(k), domain), x,
            lambda v: self.ring.automorphism(v, k, domain=domain),
        )

    # elementwise modular arithmetic is sharding-transparent (no cross-
    # device data flow); delegate under jit with the output pinned to this
    # ring's placement so downstream ops see the canonical layout
    def add(self, a, b) -> jnp.ndarray:
        return self._gather_delegate(
            "add2", jnp.stack([jnp.asarray(a, dtype=jnp.uint32),
                       jnp.asarray(b, dtype=jnp.uint32)]),
            lambda v: self.ring.add(v[0], v[1]),
        )

    def sub(self, a, b) -> jnp.ndarray:
        return self._gather_delegate(
            "sub2", jnp.stack([jnp.asarray(a, dtype=jnp.uint32),
                       jnp.asarray(b, dtype=jnp.uint32)]),
            lambda v: self.ring.sub(v[0], v[1]),
        )

    def neg(self, a) -> jnp.ndarray:
        return self._gather_delegate(
            "neg", jnp.asarray(a, dtype=jnp.uint32),
            lambda v: self.ring.neg(v),
        )


class ShardedRNSRing:
    """An RNSRing distributed over a device mesh: L prime channels, each
    batch- and/or coefficient-sharded like ShardedRing, with all channels
    traced into one jitted computation per op (single dispatch).

    The production FHE deployment shape: residues (L, B, n) with B sharded
    over dp and, for large n, coefficients over sp.  Bit-identical to the
    single-chip RNSRing.
    """

    def __init__(
        self,
        rns: RNSRing,
        mesh: Mesh,
        *,
        dp_axis: Optional[str] = "dp",
        sp_axis: Optional[str] = None,
        sp_method: Optional[str] = None,
        ch_axis: Optional[str] = None,
    ):
        self.rns = rns
        self.mesh = mesh
        self.dp_axis = dp_axis
        self.sp_axis = sp_axis
        # ch_axis: shard the PRIME-CHANNEL axis over mesh devices — the RNS
        # analog of expert parallelism (channels are fully independent, so
        # the only communication is the initial placement).  The transform
        # takes its per-channel moduli and tables as array operands, which
        # shard alongside the channels; needs L % ch == 0.
        self.ch_axis = ch_axis
        self._chsp_plans = None
        # extended-basis sharded rings built by keyswitch, keyed by primes
        self._ext_sharded: dict = {}
        if ch_axis is not None:
            for ax in (ch_axis, dp_axis, sp_axis):
                if ax is not None and ax not in mesh.axis_names:
                    raise ValueError(
                        f"axis {ax!r} not in mesh {mesh.axis_names}"
                    )
            if rns.L % mesh.shape[ch_axis]:
                raise ValueError(
                    f"the ch axis size ({mesh.shape[ch_axis]} devices) must "
                    f"divide L={rns.L} (whole channels per device)"
                )
            if sp_axis is not None:
                # ch x sp: the L x large-n production shape.  Needs every
                # channel four-step with a shared (n1, n2) split — per-
                # channel tables ride the mesh as sharded operands into the
                # column/row passes.
                from . import chsp

                rings = rns.rings
                if not all(r.method == "fourstep" for r in rings):
                    raise ValueError(
                        "ch_axis + sp_axis needs every channel four-step "
                        "(large n); for radix-2 rings shard channels or "
                        "coefficients, not both"
                    )
                self._chsp_plans = tuple(r.plan for r in rings)
                chsp.check_plans(self._chsp_plans, mesh, ch_axis, sp_axis)
            elif not rns._radix2():
                raise ValueError(
                    "ch_axis without sp_axis needs radix-2 channels"
                )
        self.srs = [
            ShardedRing(
                r, mesh, dp_axis=dp_axis, sp_axis=sp_axis, sp_method=sp_method
            )
            for r in rns.rings
        ] if ch_axis is None else []
        self._jit_cache = {}

    @property
    def L(self) -> int:
        return self.rns.L

    def shard(self, x: jnp.ndarray) -> jnp.ndarray:
        """Place (L, B, n) residues: channels over ch (if set), batch over
        dp, coefficients over sp."""
        spec = P(self.ch_axis, self.dp_axis, self.sp_axis)
        return jax.device_put(x, NamedSharding(self.mesh, spec))

    def _stacked(self, name: str, per_channel):
        fn = self._jit_cache.get(name)
        if fn is None:
            srs = self.srs

            def f(*arrs):
                return jnp.stack(
                    [
                        per_channel(sr, *(a[i] for a in arrs))
                        for i, sr in enumerate(srs)
                    ],
                    axis=0,
                )

            fn = jax.jit(f)
            self._jit_cache[name] = fn
        return fn

    def _dp_fused(self, name: str, kernel_call, *, in_rank: int = 3,
                  out_rank: int = 3):
        """dp-only sharding of the channel-batched transforms: ONE
        shard_map whose body transforms all L channels of the local
        (L, B/P, ...) shard in one call — instead of L separate shard_maps.
        Remainder-frame batches pad to the dp axis and slice back, exactly
        like ShardedRing (the unpad all-gathers the batch axis first: an
        uneven slice of a sharded dim is rejected by the type system).
        in_rank/out_rank: operand/result ranks — (L, B, n) transforms are
        3/3, polydot is (L, B, k, n) -> (L, B, n), i.e. 4/3 (round 3)."""
        fn = self._jit_cache.get(name)
        if fn is None:
            in_spec = P(None, self.dp_axis, *([None] * (in_rank - 2)))
            out_spec = P(None, self.dp_axis, *([None] * (out_rank - 2)))
            P_dp = self.mesh.shape[self.dp_axis]
            unshard = NamedSharding(self.mesh, P(*([None] * out_rank)))

            def f(*arrs):
                b = arrs[0].shape[1]
                pad = (-b) % P_dp
                if pad:
                    arrs = [
                        jnp.pad(
                            a,
                            [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2),
                        )
                        for a in arrs
                    ]
                body = jax.shard_map(
                    kernel_call, mesh=self.mesh,
                    in_specs=(in_spec,) * len(arrs), out_specs=out_spec,
                    check_vma=False,
                )
                out = body(*arrs)
                if pad:
                    out = jax.lax.with_sharding_constraint(out, unshard)
                    out = jax.lax.slice_in_dim(out, 0, b, axis=1)
                return out

            fn = jax.jit(f)
            self._jit_cache[name] = fn
        return fn

    def _use_dp_fused(self) -> bool:
        return (
            self.sp_axis is None
            and self.dp_axis is not None
            and self.ch_axis is None
            and self.rns._radix2()
        )

    def _ch_op(self, name: str, *arrs):
        """Channel-parallel execution: ONE shard_map sharding the prime-
        channel axis (and optionally the batch over dp) with the moduli and
        tables sharded alongside — each device transforms its own channels
        with its own tables/moduli, zero collectives.  The RNS analog of
        expert parallelism (SURVEY.md §2: the reference has no EP; prime
        channels are this workload's 'experts')."""
        fn = self._jit_cache.get(("ch", name))
        if fn is None:
            rings = self.rns.rings
            params_tuple = tuple(r.params for r in rings)
            interp = rings[0].interpret
            x_spec = P(self.ch_axis, self.dp_axis, None)
            q_spec = P(self.ch_axis)
            t_spec = P(self.ch_axis, None)
            P_dp = self.mesh.shape[self.dp_axis] if self.dp_axis else 1
            unshard = NamedSharding(
                self.mesh, P(self.ch_axis, None, None)
            )

            out_spec = x_spec
            if name in ("ntt", "intt"):
                bundle = xla_ntt.stacked_tables(params_tuple, name == "intt")
                core = ntt_kernel.ntt if name == "ntt" else ntt_kernel.intt

                def body(v, qs, w, wp):
                    return core(v, qs, w, wp, interpret=interp)

                in_specs = (x_spec, q_spec, t_spec, t_spec)
            else:  # polymul / polydot: transforms + pointwise per shard
                fqs, fw, fwp = xla_ntt.stacked_tables(params_tuple)
                _, iw, iwp = xla_ntt.stacked_tables(
                    params_tuple, True,
                    tuple(r.polymul_scale for r in rings),
                )
                qinvs = np.array([r.qinv_neg for r in rings], dtype=np.uint32)
                bundle = (fqs, qinvs, fw, fwp, iw, iwp)
                # polydot operands are (L, B, k, n); result is (L, B, n)
                a_spec = (
                    x_spec if name == "polymul"
                    else P(self.ch_axis, self.dp_axis, None, None)
                )
                dot = name == "polydot"

                def body(a, b, qs, qinv, fw_, fwp_, iw_, iwp_):
                    Lc, bb, n = a.shape[0], a.shape[1], a.shape[-1]
                    k = a.shape[2] if dot else 1
                    fa = ntt_kernel.ntt(a.reshape(Lc, bb * k, n), qs, fw_,
                                        fwp_, interpret=interp)
                    fb = ntt_kernel.ntt(b.reshape(Lc, bb * k, n), qs, fw_,
                                        fwp_, interpret=interp)
                    q3 = qs.reshape(Lc, 1, 1, 1)
                    t = mont_mul_lazy(fa.reshape(Lc, bb, k, n),
                                      fb.reshape(Lc, bb, k, n), q3,
                                      qinv.reshape(Lc, 1, 1, 1))
                    acc = t[:, :, 0]
                    for i in range(1, k):  # same order as RNSRing.polydot
                        acc = cond_sub(acc + t[:, :, i], q3[..., 0] * 2)
                    return ntt_kernel.intt(acc, qs, iw_, iwp_,
                                           interpret=interp)

                in_specs = (a_spec, a_spec, q_spec, q_spec,
                            t_spec, t_spec, t_spec, t_spec)

            tables = tuple(jnp.asarray(t) for t in bundle)

            def f(*data):
                b = data[0].shape[1]
                pad = (-b) % P_dp
                if pad:
                    data = tuple(
                        jnp.pad(
                            a,
                            [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2),
                        )
                        for a in data
                    )
                sm = jax.shard_map(
                    body, mesh=self.mesh, in_specs=in_specs,
                    out_specs=out_spec, check_vma=False,
                )
                out = sm(*data, *tables)
                if pad:
                    out = jax.lax.with_sharding_constraint(out, unshard)
                    out = jax.lax.slice_in_dim(out, 0, b, axis=1)
                return out

            fn = jax.jit(f)
            self._jit_cache[("ch", name)] = fn
        for a in arrs:
            self.rns._check(a)
        return fn(*arrs)

    def _chsp_op(self, name: str, *arrs):
        """ch x sp (x dp) execution: per-channel four-step transforms with
        coefficient sharding, channels and tables sharded together — see
        parallel/chsp.py.  Remainder batches pad/slice like _ch_op."""
        from . import chsp

        fn = self._jit_cache.get(("chsp", name))
        if fn is None:
            plans = self._chsp_plans
            mesh = self.mesh
            rings = self.rns.rings
            r0 = rings[0]
            kw = dict(
                ch_axis=self.ch_axis, sp_axis=self.sp_axis,
                dp_axis=self.dp_axis, interpret=r0.interpret,
            )
            P_dp = mesh.shape[self.dp_axis] if self.dp_axis else 1
            unshard = NamedSharding(
                mesh, P(self.ch_axis, None, self.sp_axis)
            )
            # numpy constants (traced-closure rule: convert inside the jit)
            qs_np = np.array([[[p.q]] for p in plans], dtype=np.uint32)
            qinv_np = np.array(
                [[[r.qinv_neg]] for r in rings], dtype=np.uint32
            )
            pm_scales = tuple(r.polymul_scale for r in rings)

            if name == "ntt":
                core = lambda v: chsp.chsp_fwd(v, plans, mesh, **kw)
            elif name == "intt":
                core = lambda v: chsp.chsp_inv(v, plans, mesh, **kw)
            elif name == "polymul":

                def core(a, b):
                    fa = chsp.chsp_fwd(a, plans, mesh, **kw)
                    fb = chsp.chsp_fwd(b, plans, mesh, **kw)
                    prod = mont_mul_lazy(
                        fa, fb, jnp.asarray(qs_np), jnp.asarray(qinv_np)
                    )
                    return chsp.chsp_inv(
                        prod, plans, mesh, scales=pm_scales, **kw
                    )

            else:  # polydot: (L, B, k, n) operands, k static from shape

                def core(a, b):
                    k = a.shape[2]
                    two_q = jnp.asarray(2 * qs_np)
                    acc = None
                    for i in range(k):
                        fa = chsp.chsp_fwd(a[:, :, i], plans, mesh, **kw)
                        fb = chsp.chsp_fwd(b[:, :, i], plans, mesh, **kw)
                        term = mont_mul_lazy(
                            fa, fb, jnp.asarray(qs_np), jnp.asarray(qinv_np)
                        )
                        acc = (
                            term if acc is None else cond_sub(acc + term, two_q)
                        )
                    return chsp.chsp_inv(
                        acc, plans, mesh, scales=pm_scales, **kw
                    )

            def f(*data):
                b = data[0].shape[1]
                pad = (-b) % P_dp
                if pad:
                    data = tuple(
                        jnp.pad(
                            a,
                            [(0, 0), (0, pad)] + [(0, 0)] * (a.ndim - 2),
                        )
                        for a in data
                    )
                out = core(*data)
                if pad:
                    out = jax.lax.with_sharding_constraint(out, unshard)
                    out = jax.lax.slice_in_dim(out, 0, b, axis=1)
                return out

            fn = jax.jit(f)
            self._jit_cache[("chsp", name)] = fn
        for a in arrs:
            self.rns._check(a)
        return fn(*arrs)

    def ntt(self, x: jnp.ndarray) -> jnp.ndarray:
        x = jnp.asarray(x, dtype=jnp.uint32)
        if self.ch_axis is not None:
            if self.sp_axis is not None:
                return self._chsp_op("ntt", x)
            return self._ch_op("ntt", x)
        if self._use_dp_fused():
            return self._dp_fused("ntt_fused", self.rns._fwd3)(x)
        return self._stacked("ntt", lambda sr, xi: sr.ntt(xi))(x)

    def intt(self, x: jnp.ndarray) -> jnp.ndarray:
        x = jnp.asarray(x, dtype=jnp.uint32)
        if self.ch_axis is not None:
            if self.sp_axis is not None:
                return self._chsp_op("intt", x)
            return self._ch_op("intt", x)
        if self._use_dp_fused():
            return self._dp_fused("intt_fused", self.rns._inv3)(x)
        return self._stacked("intt", lambda sr, xi: sr.intt(xi))(x)

    def polymul(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        a = jnp.asarray(a, dtype=jnp.uint32)
        b = jnp.asarray(b, dtype=jnp.uint32)
        if self.ch_axis is not None:
            if self.sp_axis is not None:
                return self._chsp_op("polymul", a, b)
            return self._ch_op("polymul", a, b)
        if self._use_dp_fused():
            rns = self.rns
            scales = tuple(r.polymul_scale for r in rns.rings)
            return self._dp_fused(
                "polymul_fused",
                lambda x, y: rns._inv3(
                    rns._mont(rns._fwd3(x), rns._fwd3(y)), scales
                ),
            )(a, b)
        return self._stacked(
            "polymul", lambda sr, ai, bi: sr.polymul(ai, bi)
        )(a, b)

    def polydot(self, a: jnp.ndarray, b: jnp.ndarray) -> jnp.ndarray:
        """Inner product sum_i a_i * b_i per prime channel, distributed —
        the RNS key-switch / external-product primitive on the mesh.

        a, b: (L, B, k, n) residues.  ch: ONE shard_map, channels and their
        tables sharded together (zero collectives).  dp (radix-2): ONE
        shard_map over RNSRing.polydot's channel-batched form.  Otherwise
        (sp sharding / four-step channels): per-channel ShardedRing.polydot
        stacked into one jitted computation.  Bit-identical to
        RNSRing.polydot.
        """
        a = jnp.asarray(a, dtype=jnp.uint32)
        b = jnp.asarray(b, dtype=jnp.uint32)
        n = self.rns.n
        if a.shape != b.shape or a.ndim != 4 or a.shape[0] != self.L or \
                a.shape[-1] != n:
            raise ValueError(
                f"polydot expects matching (L={self.L}, B, k, n={n}) "
                f"shapes, got {a.shape} and {b.shape}"
            )
        if self.ch_axis is not None:
            if self.sp_axis is not None:
                return self._chsp_op("polydot", a, b)
            return self._ch_op("polydot", a, b)
        if self._use_dp_fused():
            return self._dp_fused(
                "polydot_fused", self.rns.polydot, in_rank=4
            )(a, b)
        return self._stacked(
            "polydot", lambda sr, ai, bi: sr.polydot(ai, bi)
        )(a, b)

    # -- batch-elementwise ring ops -------------------------------------------

    def _gather_delegate(self, key, x, call):
        """Per-channel gather ops on the sharded residues; output pinned
        back to this ring's (ch, dp, sp) placement (cf. ShardedRing)."""
        fn = self._jit_cache.get(key)
        if fn is None:
            out_shard = NamedSharding(
                self.mesh, P(self.ch_axis, self.dp_axis, self.sp_axis)
            )

            def f(v):
                return jax.lax.with_sharding_constraint(call(v), out_shard)

            fn = jax.jit(f)
            self._jit_cache[key] = fn
        return fn(x)

    def rotate(self, x: jnp.ndarray, k: int) -> jnp.ndarray:
        """Multiply every channel by X^k on the mesh (see RNSRing.rotate)."""
        x = jnp.asarray(x, dtype=jnp.uint32)
        return self._gather_delegate(
            ("rotate", int(k)), x, lambda v: self.rns.rotate(v, k)
        )

    def automorphism(self, x: jnp.ndarray, k: int, *, domain: str = "coeff") -> jnp.ndarray:
        """Galois tau_k per channel on the mesh (see RNSRing.automorphism)."""
        x = jnp.asarray(x, dtype=jnp.uint32)
        return self._gather_delegate(
            ("automorphism", int(k), domain), x,
            lambda v: self.rns.automorphism(v, k, domain=domain),
        )

    # elementwise modular arithmetic is sharding-transparent; delegate under
    # jit with the output pinned back to the (ch, dp, sp) placement
    def add(self, a, b) -> jnp.ndarray:
        return self._gather_delegate(
            "add2",
            jnp.stack([jnp.asarray(a, dtype=jnp.uint32),
                       jnp.asarray(b, dtype=jnp.uint32)]),
            lambda v: self.rns.add(v[0], v[1]),
        )

    def sub(self, a, b) -> jnp.ndarray:
        return self._gather_delegate(
            "sub2",
            jnp.stack([jnp.asarray(a, dtype=jnp.uint32),
                       jnp.asarray(b, dtype=jnp.uint32)]),
            lambda v: self.rns.sub(v[0], v[1]),
        )

    def neg(self, a) -> jnp.ndarray:
        return self._gather_delegate(
            "neg", jnp.asarray(a, dtype=jnp.uint32),
            lambda v: self.rns.neg(v),
        )

    def _mixing_op(self, key, x, call):
        """Channel-MIXING ops (base_convert / rescale) on the mesh: batch and
        coefficient axes stay elementwise-sharded (dp/sp, zero collectives —
        XLA's partitioner keeps them local); the channel axis is where data
        crosses shards, so the OUTPUT channel axis is replicated (its size
        differs from L and its basis from this ring's — callers re-place
        with ``shard`` on the destination ring).  Under ch sharding XLA
        inserts the cross-channel gathers that the math genuinely needs."""
        fn = self._jit_cache.get(key)
        if fn is None:
            out_shard = NamedSharding(
                self.mesh, P(None, self.dp_axis, self.sp_axis)
            )

            def f(v):
                return jax.lax.with_sharding_constraint(call(v), out_shard)

            fn = jax.jit(f)
            self._jit_cache[key] = fn
        return fn(x)

    def base_convert(self, x, dst, *, correction: str = "none") -> jnp.ndarray:
        """Fast base conversion on the mesh (see RNSRing.base_convert)."""
        x = jnp.asarray(x, dtype=jnp.uint32)
        qs_dst = tuple(dst.qs) if hasattr(dst, "qs") else tuple(
            int(q) for q in dst
        )
        return self._mixing_op(
            ("base_convert", qs_dst, correction), x,
            lambda v: self.rns.base_convert(v, qs_dst, correction=correction),
        )

    def rescale(self, x) -> jnp.ndarray:
        """Divide-and-round by the last prime on the mesh (see
        RNSRing.rescale); output channel axis replicated over ch."""
        x = jnp.asarray(x, dtype=jnp.uint32)
        return self._mixing_op("rescale", x, self.rns.rescale)

    def mod_down(self, x, count: int = 1) -> jnp.ndarray:
        """Iterated rescale on the mesh (see RNSRing.mod_down)."""
        x = jnp.asarray(x, dtype=jnp.uint32)
        return self._mixing_op(
            ("mod_down", int(count)), x,
            lambda v: self.rns.mod_down(v, count),
        )

    def rescale_bgv(self, x, t: int) -> jnp.ndarray:
        """BGV t-correcting modulus switch on the mesh (see
        RNSRing.rescale_bgv)."""
        x = jnp.asarray(x, dtype=jnp.uint32)
        return self._mixing_op(
            ("rescale_bgv", int(t)), x,
            lambda v: self.rns.rescale_bgv(v, t),
        )

    def mod_down_bgv(self, x, t: int, count: int = 1) -> jnp.ndarray:
        """Iterated t-correcting divide on the mesh (see
        RNSRing.mod_down_bgv)."""
        x = jnp.asarray(x, dtype=jnp.uint32)
        return self._mixing_op(
            ("mod_down_bgv", int(t), int(count)), x,
            lambda v: self.rns.mod_down_bgv(v, t, count),
        )

    def hps_scale_sk(self, d, qs, aux, t: int) -> jnp.ndarray:
        """BFV HPS scale-and-round + Shenoy-Kumaresan exact return, on the
        mesh: round(t*d/Q) converted EXACTLY back to the Q basis.

        ``d``: (len(qs)+len(aux), B, n) residues of a big-base tensor part
        in the union basis qs (+) aux, where aux = B-primes + (m_sk,).
        Channel-mixing but coefficient-pointwise, so dp/sp shards stay
        local (zero collectives) — the ShardedRNSRing BFV-multiply
        primitive (`schemes/bfv.py`); bit-identical to the single-chip
        ``ops/basechange`` composition.
        """
        from ..ops import basechange

        d = jnp.asarray(d, dtype=jnp.uint32)
        qs = tuple(int(q) for q in qs)
        aux = tuple(int(q) for q in aux)
        lvl, bs, m_sk = len(qs), aux[:-1], aux[-1]

        def call(v):
            y = basechange.scale_round(v[:lvl], v[lvl:], qs, aux, t)
            return basechange.base_convert_sk(y[:-1], y[-1], bs, m_sk, qs)

        return self._mixing_op(("hps_scale_sk", qs, aux, int(t)), d, call)

    def _sharded_ext(self, qs_ext: tuple, ext) -> "ShardedRNSRing":
        """The extended-basis ring, sharded like this one (dp/sp; channel
        axis replicated — K generally does not divide the ch axis), cached
        per prime tuple."""
        sext = self._ext_sharded.get(qs_ext)
        if sext is None:
            ext_ring = self.rns._ext_rings.get(qs_ext)
            if ext_ring is None:
                from ..api import RNSRing

                ext_ring = ext if isinstance(ext, RNSRing) else RNSRing(
                    self.rns.n, qs=qs_ext
                )
                self.rns._ext_rings[qs_ext] = ext_ring
            sext = ShardedRNSRing(
                ext_ring, self.mesh, dp_axis=self.dp_axis,
                sp_axis=self.sp_axis,
            )
            self._ext_sharded[qs_ext] = sext
        return sext

    def hoisted_keyswitch(
        self, x, ksks, ks, ext, dnum: int, *, correction: str = "float",
        plain_mod: Optional[int] = None,
    ) -> jnp.ndarray:
        """Hoisted rotation batch on the mesh (see
        RNSRing.hoisted_keyswitch): ONE sharded gadget decomposition (the
        ModUp base conversions — the channel-mixing cost) shared by every
        Galois step; each step then runs the sharded digit automorphism +
        sharded polydot + sharded ModDown.  The single-chip op additionally
        hoists the digits' forward transform; on the mesh each step's
        polydot re-transforms its permuted digits — the result is
        bit-identical to the single-chip op either way (the hoisting
        identity, tested in tests/test_keyswitch.py).

        x: (L, B, n) placed on this ring; ksks: (nk, dnum, K, n) shared key
        material.  Returns (nk, L, B, n)."""
        x = jnp.asarray(x, dtype=jnp.uint32)
        ksks = jnp.asarray(ksks, dtype=jnp.uint32)
        ks = tuple(int(k) % (2 * self.rns.n) for k in ks)
        for k in ks:
            if k % 2 == 0:
                raise ValueError(f"Galois exponents must be odd, got {k}")
        qs_ext = tuple(ext.qs) if hasattr(ext, "qs") else tuple(
            int(q) for q in ext
        )
        L, K, n = self.rns.L, len(qs_ext), self.rns.n
        if qs_ext[:L] != tuple(self.rns.qs) or K <= L:
            raise ValueError(
                "ext basis must extend this ring's primes by >= 1 special"
            )
        if ksks.shape != (len(ks), dnum, K, n):
            raise ValueError(
                f"ksks must be (nk={len(ks)}, dnum={dnum}, K={K}, n={n}), "
                f"got {ksks.shape}"
            )
        sext = self._sharded_ext(qs_ext, ext)
        digits = self.gadget_decompose(
            x, qs_ext, dnum, correction=correction
        )  # (dnum, K, B, n), batch dp-sharded
        b = x.shape[1]
        dig_flat = jnp.moveaxis(digits, 0, 1).reshape(K, dnum * b, n)
        outs = []
        for j, k in enumerate(ks):
            tau = sext.automorphism(dig_flat, k)
            dig_k = jnp.moveaxis(tau.reshape(K, dnum, b, n), 1, -2)
            kb = jnp.broadcast_to(
                jnp.moveaxis(ksks[j], 0, -2)[:, None], dig_k.shape
            )
            prod = sext.polydot(sext.shard(dig_k), sext.shard(kb))
            if plain_mod is None:
                outs.append(sext.mod_down(prod, count=K - L))
            else:
                outs.append(
                    sext.mod_down_bgv(prod, plain_mod, count=K - L)
                )
        return jnp.stack(outs, axis=0)

    def hoisted_linear_sum(
        self, c0, c1, pts, ksks_b, ksks_a, ks, ext, dnum: int, *,
        correction: str = "float", plain_mod: Optional[int] = None,
    ):
        """BSGS linear transform on the mesh (see RNSRing.hoisted_linear_sum):
        sum_j pt_j (*) tau_{k_j}(ct) with ONE sharded gadget decomposition
        and ONE deferred ModDown per ciphertext part.  Built as the sharded
        public-op composition (automorphism -> polydot -> polymul ->
        extended-basis accumulate), which the single-chip fused op is
        bit-identical to by construction (tests/test_keyswitch.py pins the
        spec); dp/sp shardings ride each constituent op.

        c0, c1: (L, B, n) placed on this ring; pts: (nk, K, n) and
        ksks_b/ksks_a: (nk, dnum, K, n) shared material.
        Returns (out0, out1), each (L, B, n)."""
        c0 = jnp.asarray(c0, dtype=jnp.uint32)
        c1 = jnp.asarray(c1, dtype=jnp.uint32)
        pts = jnp.asarray(pts, dtype=jnp.uint32)
        ksks_b = jnp.asarray(ksks_b, dtype=jnp.uint32)
        ksks_a = jnp.asarray(ksks_a, dtype=jnp.uint32)
        ks = tuple(int(k) % (2 * self.rns.n) for k in ks)
        for k in ks:
            if k % 2 == 0:
                raise ValueError(f"Galois exponents must be odd, got {k}")
        qs_ext = tuple(ext.qs) if hasattr(ext, "qs") else tuple(
            int(q) for q in ext
        )
        L, K, n = self.rns.L, len(qs_ext), self.rns.n
        if qs_ext[:L] != tuple(self.rns.qs) or K <= L:
            raise ValueError(
                "ext basis must extend this ring's primes by >= 1 special"
            )
        nk = len(ks)
        for nm, arr in (("ksks_b", ksks_b), ("ksks_a", ksks_a)):
            if arr.shape != (nk, dnum, K, n):
                raise ValueError(
                    f"{nm} must be (nk={nk}, dnum={dnum}, K={K}, n={n}), "
                    f"got {arr.shape}"
                )
        if pts.shape != (nk, K, n):
            raise ValueError(
                f"pts must be (nk={nk}, K={K}, n={n}), got {pts.shape}"
            )
        sext = self._sharded_ext(qs_ext, ext)
        digits = self.gadget_decompose(
            c1, qs_ext, dnum, correction=correction
        )  # (dnum, K, B, n), batch dp-sharded
        b = c1.shape[1]
        dig_flat = jnp.moveaxis(digits, 0, 1).reshape(K, dnum * b, n)
        accB = accA = c0sum = None
        for j, k in enumerate(ks):
            tau = sext.automorphism(dig_flat, k)
            dig_k = jnp.moveaxis(tau.reshape(K, dnum, b, n), 1, -2)
            kb = jnp.broadcast_to(
                jnp.moveaxis(ksks_b[j], 0, -2)[:, None], dig_k.shape
            )
            ka = jnp.broadcast_to(
                jnp.moveaxis(ksks_a[j], 0, -2)[:, None], dig_k.shape
            )
            dig_s = sext.shard(dig_k)
            pdb = sext.polydot(dig_s, sext.shard(kb))
            pda = sext.polydot(dig_s, sext.shard(ka))
            ptj = sext.shard(
                jnp.broadcast_to(pts[j][:, None], (K, b, n))
            )
            tb = sext.polymul(ptj, pdb)
            ta = sext.polymul(ptj, pda)
            accB = tb if accB is None else sext.rns.add(accB, tb)
            accA = ta if accA is None else sext.rns.add(accA, ta)
            tau_c0 = self.automorphism(c0, k)
            ptl = self.shard(
                jnp.broadcast_to(pts[j][:L, None], (L, b, n))
            )
            tc = self.polymul(ptl, tau_c0)
            c0sum = tc if c0sum is None else self.rns.add(c0sum, tc)
        if plain_mod is None:
            bdn = sext.mod_down(accB, count=K - L)
            out1 = sext.mod_down(accA, count=K - L)
        else:
            bdn = sext.mod_down_bgv(accB, plain_mod, count=K - L)
            out1 = sext.mod_down_bgv(accA, plain_mod, count=K - L)
        out0 = self.rns.add(c0sum, bdn)
        return out0, out1

    def keyswitch(
        self, x, ksk, ext, dnum: int, *, correction: str = "float",
        plain_mod: Optional[int] = None,
    ) -> jnp.ndarray:
        """Hybrid key-switch on the mesh (see RNSRing.keyswitch): sharded
        gadget digits -> sharded polydot in the extended basis -> sharded
        ModDown.  The extended-basis ring runs dp/sp-sharded with its
        channel axis replicated (K generally does not divide the ch axis).

        x: (L, B, n) placed on this ring; ksk: (dnum, K, n) shared key
        material or (dnum, K, B, n).  Returns (L, B, n)."""
        x = jnp.asarray(x, dtype=jnp.uint32)
        ksk = jnp.asarray(ksk, dtype=jnp.uint32)
        qs_ext = tuple(ext.qs) if hasattr(ext, "qs") else tuple(
            int(q) for q in ext
        )
        L, K, n = self.rns.L, len(qs_ext), self.rns.n
        if qs_ext[:L] != tuple(self.rns.qs) or K <= L:
            raise ValueError(
                "ext basis must extend this ring's primes by >= 1 special"
            )
        sext = self._sharded_ext(qs_ext, ext)
        digits = self.gadget_decompose(
            x, qs_ext, dnum, correction=correction
        )  # (dnum, K, B, n), batch dp-sharded
        dig = jnp.moveaxis(digits, 0, -2)  # (K, B, dnum, n)
        if ksk.ndim == 3:
            kb = jnp.broadcast_to(
                jnp.moveaxis(ksk, 0, -2)[:, None], dig.shape
            )
        else:
            kb = jnp.moveaxis(ksk, 0, -2)
        prod = sext.polydot(sext.shard(dig), sext.shard(kb))
        if plain_mod is None:
            return sext.mod_down(prod, count=K - L)
        return sext.mod_down_bgv(prod, plain_mod, count=K - L)

    def gadget_decompose(
        self, x, dst, dnum: int, *, correction: str = "float"
    ) -> jnp.ndarray:
        """Hybrid gadget split on the mesh (see RNSRing.gadget_decompose):
        (L, B, n) -> (dnum, K, B, n).  Batch/coefficient axes stay
        dp/sp-sharded; the digit and output-channel axes are replicated
        (like the other channel-mixing ops, callers re-place per digit)."""
        x = jnp.asarray(x, dtype=jnp.uint32)
        qs_dst = tuple(dst.qs) if hasattr(dst, "qs") else tuple(
            int(q) for q in dst
        )
        key = ("gadget_decompose", qs_dst, int(dnum), correction)
        fn = self._jit_cache.get(key)
        if fn is None:
            out_shard = NamedSharding(
                self.mesh, P(None, None, self.dp_axis, self.sp_axis)
            )
            d, corr = int(dnum), correction

            def f(v):
                y = self.rns.gadget_decompose(v, qs_dst, d, correction=corr)
                return jax.lax.with_sharding_constraint(y, out_shard)

            fn = jax.jit(f)
            self._jit_cache[key] = fn
        return fn(x)
