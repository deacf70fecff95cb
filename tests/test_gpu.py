"""Tests of the compiled GPU kernel: they need a card and skip elsewhere.

``chip_smoke.py`` runs them on one card (``pytest -m gpu``, in its own
process); on the CPU the same kernel is covered in the Pallas interpreter
(test_kernels.py).  Whether a card is present is decided inside the
fixture, never at import, so every test worker collects the same tests.
"""

import numpy as np
import pytest

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (compiled Triton kernel)")


@pytest.mark.parametrize("logn", [3, 7, 12, 15])
def test_compiled_kernel_matches_golden(gpu, logn):
    from agilex_ntt import golden as G
    from agilex_ntt.ops import ntt_kernel as K
    from agilex_ntt.params import find_primes, make_params

    n = 1 << logn
    pp = make_params(n, find_primes(n, 1)[0])
    x = np.random.default_rng(logn).integers(0, pp.q, (5, n), np.uint32)
    y = np.asarray(K.fwd_ntt(x, pp))
    assert (y == G.fwd_ntt_u32(x, pp)).all()
    assert (np.asarray(K.inv_ntt(y, pp)) == x).all()


def test_compiled_kernel_per_channel_moduli(gpu):
    from agilex_ntt import RNSRing
    from agilex_ntt.ops import xla_ntt as X

    rns = RNSRing(1024, num_primes=3)
    rng = np.random.default_rng(3)
    x = np.stack([rng.integers(0, q, (7, 1024), np.uint32) for q in rns.qs])
    q, w, wp = X.stacked_tables(tuple(r.params for r in rns.rings))
    want = np.asarray(X.ntt(x, q, w, wp))
    assert (np.asarray(rns.ntt(x)) == want).all()
    assert (np.asarray(rns.intt(want)) == x).all()
