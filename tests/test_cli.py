"""Smoke tests: the module CLI (host-driver analog) and profiling helpers."""

import numpy as np
import jax.numpy as jnp
import pytest

from agilex_ntt.__main__ import main as cli_main
from agilex_ntt import Ring
from agilex_ntt.utils.profiling import device_time, dump_hlo


def test_cli_smoke(capsys):
    cli_main(["32", "2"])
    out = capsys.readouterr().out
    assert "all checks passed" in out
    assert "FAIL" not in out


def test_dump_hlo_and_device_time():
    r = Ring(128)
    x = jnp.zeros((8, 128), dtype=jnp.uint32)
    hlo = dump_hlo(r.ntt, x)
    assert "HloModule" in hlo or len(hlo) > 500
    t = device_time(r.ntt, x, iters=2)
    assert t > 0
