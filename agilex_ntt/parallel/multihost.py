"""Multi-host setup helpers.

The reference never crosses a node — its transports are on-chip FIFO pipes
and PCIe buffers (SURVEY.md §5 "Distributed communication backend").  Here
the multi-host story is standard JAX SPMD: every host runs the same
program, ``jax.distributed.initialize`` wires the processes together, and
the mesh spans all hosts' devices.  The transforms in this package then
work unchanged — ``shard_map`` bodies see per-device shards regardless of
which host owns them, with XLA handing collectives to NCCL (NVLink within
a host, the network across hosts).

Axis-order rule of thumb: put the coefficient/sp axis on the *innermost*
mesh dimension so the per-stage butterfly exchanges and all-to-all retiles
stay inside a host; keep dp outermost so only data-parallel traffic (none,
for independent transforms) would cross hosts.  ``pod_mesh`` encodes that
convention.
"""

from __future__ import annotations

from typing import Optional

import jax
import numpy as np
from jax.sharding import Mesh


def init_distributed(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
    *,
    force: bool = False,
) -> None:
    """Initialize the JAX distributed runtime (no-op for single-process).

    Under a cluster launcher (SLURM, Open MPI, a coordinator address in
    the environment) JAX detects the three arguments; otherwise pass them
    (e.g. ``"localhost:<port>"``, process count, this process's index).
    Must run before any other JAX call on every process.  With no arguments and no
    cluster environment detected this is a no-op (calling
    jax.distributed.initialize on a lone dev box would error or hang
    waiting for a coordinator); pass force=True to attempt auto-detection
    anyway.
    """
    import os

    if num_processes is not None and num_processes <= 1:
        return
    cluster_env = any(
        os.environ.get(v)
        for v in (
            "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
            "SLURM_JOB_NUM_NODES", "OMPI_COMM_WORLD_SIZE",
        )
    )
    if (
        coordinator_address is None
        and num_processes is None
        and not cluster_env
        and not force
    ):
        return
    jax.distributed.initialize(
        coordinator_address=coordinator_address,
        num_processes=num_processes,
        process_id=process_id,
    )


def pod_mesh(dp: int = 1, sp: int = 1) -> Mesh:
    """Global (dp, sp) mesh over every device of every host.

    sp is placed on the innermost axis so coefficient-sharded exchanges
    (stage_shard ppermutes / fourstep all-to-alls) stay inside a host;
    dp spans the remaining (possibly cross-host) dimension.
    """
    devs = jax.devices()  # global across processes after init_distributed
    if dp * sp != len(devs):
        raise ValueError(
            f"mesh dp*sp = {dp * sp} must equal global device count {len(devs)}"
        )
    # jax.make_mesh orders devices host by host (a raw reshape of
    # jax.devices() could put sp "neighbors" on different hosts).  Axis
    # types are Auto like
    # make_mesh: this library manages shardings itself via shard_map, and
    # the default Explicit axes reject the with_sharding_constraint the
    # remainder-batch path uses.
    axis_types = (jax.sharding.AxisType.Auto,) * 2
    return jax.make_mesh((dp, sp), ("dp", "sp"), axis_types=axis_types)


def process_local_batch(global_batch: int) -> slice:
    """The slice of a (host-partitioned) global batch this process feeds.

    For `jax.make_array_from_process_local_data`-style input pipelines:
    each host materializes only its slice of the batch.
    """
    n_proc = jax.process_count()
    if global_batch % n_proc:
        raise ValueError(
            f"global batch {global_batch} must divide over {n_proc} processes"
        )
    per = global_batch // n_proc
    i = jax.process_index()
    return slice(i * per, (i + 1) * per)
