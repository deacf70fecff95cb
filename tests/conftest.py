"""Test harness configuration.

The suite runs on the CPU (``JAX_PLATFORMS=cpu``, as ROADMAP.md's tier-1
command passes it) with 8 virtual XLA devices — the analog of the
reference's FPGA emulator flow (``-DFPGA_EMULATOR``, Makefile:24 /
main.cpp:16-20): the same code paths, device-free.  The GPU kernel runs in
the Pallas interpreter where a test asks for ``interpret=True``; mesh
tests run on the virtual devices.  Tests marked ``gpu`` need a card and
skip elsewhere; ``chip_smoke.py`` runs them on one.
"""

import jax

jax.config.update("jax_num_cpu_devices", 8)

import numpy as np
import pytest

from agilex_ntt.params import make_params, find_primes


@pytest.fixture(scope="session")
def rng():
    return np.random.default_rng(20260816)


def params_for(n: int, idx: int = 0):
    q = find_primes(n, idx + 1)[idx]
    return make_params(n, q)


def require_devices(k: int) -> None:
    """Skip the calling test unless k devices exist.  Mesh tests need the
    8-virtual-device CPU harness; on a one-card run they skip, not fail."""
    import jax

    if len(jax.devices()) < k:
        pytest.skip(f"needs {k} (virtual) devices")
