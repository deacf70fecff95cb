"""Every runnable example executes cleanly end to end.

Each example runs on the default platform (the CPU here, as the suite
runs with JAX_PLATFORMS=cpu, which the child inherits), carries its own
exact assertions (golden models / big-int oracles), and exits nonzero on
any failure, so rc==0 is a real check, not a smoke ritual.
"""

import os
import subprocess
import sys

import pytest

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

# (name, timeout_s) — budgets ~3x the measured CPU runtime
_EXAMPLES = [
    ("rlwe_toy.py", 120),
    ("keyswitch_pipeline.py", 180),
    ("production_rns_serving.py", 240),
    ("basic_usage.py", 600),       # includes a four-step n=2^17 compile
    ("ckks_rns_toy.py", 900),      # big-int oracle convolutions dominate
    ("bsgs_matvec.py", 900),       # 9-term host-oracle linear map
    ("ckks_scheme.py", 600),       # first-class scheme API
    ("bgv_exact.py", 600),         # exact-integer scheme API
    ("bfv_exact.py", 900),         # scale-invariant sibling (HPS multiply)
]


@pytest.mark.parametrize("name,timeout", _EXAMPLES,
                         ids=[e[0] for e in _EXAMPLES])
def test_example_runs(name, timeout):
    env = dict(os.environ)
    proc = subprocess.run(
        [sys.executable, os.path.join(_ROOT, "examples", name)],
        capture_output=True, text=True, timeout=timeout, env=env,
        cwd=_ROOT,
    )
    assert proc.returncode == 0, (
        f"{name} failed (rc={proc.returncode})\n"
        f"stdout:\n{proc.stdout[-2000:]}\nstderr:\n{proc.stderr[-2000:]}"
    )
