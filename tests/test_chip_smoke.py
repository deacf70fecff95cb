"""``chip_smoke.py``'s phases rehearsed on the CPU at tiny sizes.

The script refuses to run without a GPU; its phase functions take their
sizes as arguments, so the same checks (golden, big-int and one-device
comparisons) run here on the plain XLA path and on the virtual mesh.
"""

import os
import sys

import jax
import pytest

from conftest import require_devices

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as C  # noqa: E402


def test_phase_device_refuses_a_cpu():
    if jax.devices()[0].platform == "gpu":
        pytest.skip("runs where JAX finds no GPU")
    with pytest.raises(SystemExit, match="needs a GPU"):
        C.phase_device(jax, 1)


@pytest.mark.parametrize("n", [64, 512])
def test_phase_transform_small(n, capsys):
    C.phase_transform(n, 16, rows=4)
    assert "polymul bit-exact vs golden" in capsys.readouterr().out


def test_phase_rns_small(capsys):
    C.phase_rns(n=256, L=3, batch=16, rows=4, ks_batch=2, bc_batch=4)
    out = capsys.readouterr().out
    assert "keyswitch (L=3+1, dnum=3)" in out
    assert "scale_round offset identical in every channel" in out


def test_phase_fourstep_small(capsys):
    C.phase_fourstep(n=1 << 16, batch=2, rows=1)
    assert "four-step ntt bit-exact vs golden" in capsys.readouterr().out


def test_phase_ckks_small(capsys):
    C.phase_ckks(n=256, L=3, count=2)
    assert "matches numpy" in capsys.readouterr().out


def test_plain_fourstep_matches_ring(rng):
    import numpy as np

    from agilex_ntt import Ring

    r = Ring(1 << 14, method="fourstep")
    x = rng.integers(0, r.q, size=(2, 1 << 14), dtype=np.uint32)
    got = np.asarray(C._plain_fourstep(jax.numpy.asarray(x), r.plan))
    assert (got == np.asarray(r.ntt(x))).all()


def test_phase_cards_on_virtual_devices(capsys):
    require_devices(4)
    C.phase_cards(jax, 4, n=256, batch=8, big_n=1 << 12, big_batch=2,
                  rns_batch=4)
    out = capsys.readouterr().out
    for what in ("dp ntt == one-card ntt", "sp fourstep ntt == one-card",
                 "sp stage ntt == one-card", "ch polymul == one-card",
                 "sharded keyswitch"):
        assert what in out
