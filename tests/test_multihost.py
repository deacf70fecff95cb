"""Tests for parallel/multihost.py and for uneven-batch (remainder-frame)
handling in ShardedRing.

Multi-host behavior is single-process-simulated: init_distributed's env
sniffing is exercised by monkeypatching the environment and intercepting
jax.distributed.initialize; pod_mesh runs on the 8 virtual CPU devices.
"""

import jax
import numpy as np
import pytest

from agilex_ntt import Ring
from agilex_ntt import golden as G
from agilex_ntt.parallel import multihost
from agilex_ntt.parallel.mesh import ShardedRing, make_mesh


@pytest.fixture(scope="module")
def devices8():
    if len(jax.devices()) < 8:
        pytest.skip("needs 8 (virtual) devices")
    return jax.devices()


@pytest.fixture
def no_cluster_env(monkeypatch):
    for v in (
        "JAX_COORDINATOR_ADDRESS", "COORDINATOR_ADDRESS",
        "SLURM_JOB_NUM_NODES", "OMPI_COMM_WORLD_SIZE",
    ):
        monkeypatch.delenv(v, raising=False)


@pytest.fixture
def captured_init(monkeypatch):
    calls = []

    def fake_initialize(**kwargs):
        calls.append(kwargs)

    monkeypatch.setattr(jax.distributed, "initialize", fake_initialize)
    return calls


# -- init_distributed --------------------------------------------------------


def test_init_noop_without_cluster_env(no_cluster_env, captured_init):
    multihost.init_distributed()
    assert captured_init == []


def test_init_noop_for_single_process(no_cluster_env, captured_init):
    multihost.init_distributed(num_processes=1)
    assert captured_init == []


def test_init_force_initializes(no_cluster_env, captured_init):
    multihost.init_distributed(force=True)
    assert len(captured_init) == 1


def test_init_explicit_args_passed_through(no_cluster_env, captured_init):
    multihost.init_distributed("10.0.0.1:1234", 4, 2)
    assert captured_init == [
        dict(
            coordinator_address="10.0.0.1:1234",
            num_processes=4,
            process_id=2,
        )
    ]


@pytest.mark.parametrize(
    "var", ["JAX_COORDINATOR_ADDRESS", "SLURM_JOB_NUM_NODES",
            "OMPI_COMM_WORLD_SIZE"]
)
def test_init_cluster_env_triggers(no_cluster_env, captured_init,
                                   monkeypatch, var):
    monkeypatch.setenv(var, "4")
    multihost.init_distributed()
    assert len(captured_init) == 1


def test_init_unrelated_env_is_not_a_cluster(
    no_cluster_env, captured_init, monkeypatch
):
    # only a launcher's variables are evidence of several processes
    monkeypatch.setenv("CUDA_VISIBLE_DEVICES", "0,1,2,3")
    multihost.init_distributed()
    assert captured_init == []


# -- pod_mesh ----------------------------------------------------------------


def test_pod_mesh_shapes(devices8):
    mesh = multihost.pod_mesh(dp=4, sp=2)
    assert mesh.axis_names == ("dp", "sp")
    assert mesh.shape == {"dp": 4, "sp": 2}


def test_pod_mesh_rejects_wrong_product(devices8):
    with pytest.raises(ValueError, match="must equal global device count"):
        multihost.pod_mesh(dp=3, sp=2)


# -- process_local_batch -----------------------------------------------------


def test_process_local_batch_single_process():
    # single process: the slice is the whole batch
    assert multihost.process_local_batch(32) == slice(0, 32)


def test_process_local_batch_multi_process(monkeypatch):
    monkeypatch.setattr(jax, "process_count", lambda: 4)
    monkeypatch.setattr(jax, "process_index", lambda: 2)
    assert multihost.process_local_batch(32) == slice(16, 24)
    with pytest.raises(ValueError, match="must divide"):
        multihost.process_local_batch(30)


# -- uneven (remainder-frame) dp batches ------------------------------------


@pytest.mark.parametrize("batch", [5, 9, 13])
def test_dp_uneven_batch_bitexact(devices8, rng, batch):
    # the reference distributes numFrames % NUM_CUs leftover frames
    # (ntt.cpp:526-536); here the batch pads to the dp axis and slices back
    ring = Ring(256)
    mesh = make_mesh(dp=8)
    sr = ShardedRing(ring, mesh, dp_axis="dp")
    x = rng.integers(0, ring.q, size=(batch, 256), dtype=np.uint32)
    got = np.asarray(sr.ntt(x))
    assert got.shape == x.shape
    assert (got == G.fwd_ntt_u32(x, ring.params)).all()
    back = np.asarray(sr.intt(sr.ntt(x)))
    assert (back == x).all()


def test_dp_uneven_batch_polymul(devices8, rng):
    ring = Ring(256)
    mesh = make_mesh(dp=8)
    sr = ShardedRing(ring, mesh, dp_axis="dp")
    a = rng.integers(0, ring.q, size=(3, 256), dtype=np.uint32)
    b = rng.integers(0, ring.q, size=(3, 256), dtype=np.uint32)
    got = np.asarray(sr.polymul(a, b))
    want = np.asarray(Ring(256).polymul(a, b))
    assert (got == want).all()


def test_dp_sp_uneven_batch_bitexact(devices8, rng):
    # both axes at once: batch 3 over dp=2, coefficients over sp=4
    ring = Ring(1024)
    mesh = make_mesh(dp=2, sp=4)
    sr = ShardedRing(ring, mesh, dp_axis="dp", sp_axis="sp")
    x = rng.integers(0, ring.q, size=(3, 1024), dtype=np.uint32)
    got = np.asarray(sr.ntt(x))
    assert got.shape == x.shape
    assert (got == G.fwd_ntt_u32(x, ring.params)).all()
