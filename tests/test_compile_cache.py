"""Where the persistent XLA compile cache lands: JAX_COMPILATION_CACHE_DIR
when it is set (and no other directory), else ``<repo>/.jax_cache``."""

import os
import subprocess
import sys

_ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_PROBE = ("import agilex_ntt, jax; "
          "print(jax.config.jax_compilation_cache_dir)")


def _cache_dir(env):
    out = subprocess.run(
        [sys.executable, "-c", _PROBE], capture_output=True, text=True,
        env=env, cwd=_ROOT, timeout=300,
    )
    assert out.returncode == 0, out.stderr[-2000:]
    return out.stdout.strip().splitlines()[-1]


def test_cache_dir_default_in_checkout():
    env = dict(os.environ)
    env.pop("JAX_COMPILATION_CACHE_DIR", None)
    assert _cache_dir(env) == os.path.join(_ROOT, ".jax_cache")


def test_cache_dir_from_env(tmp_path):
    env = dict(os.environ, JAX_COMPILATION_CACHE_DIR=str(tmp_path / "c"))
    assert _cache_dir(env) == str(tmp_path / "c")
