"""Autotuner: candidate spaces, argmin selection, cache round-trip, and the
Ring(method="auto") dispatch that reads the cache.

The timing pass itself is hardware-dependent; here the timer is injected
so selection and persistence logic are pinned deterministically.  Reference analog for the capability:
one synthesized config per (FPGA_NTT_SIZE, modulus)
(``/root/reference/include/kernel/ntt.h:11-23``) — here measured + cached
per device kind.
"""

import json

import numpy as np
import jax.numpy as jnp
import pytest

from agilex_ntt import Ring
from agilex_ntt.utils import autotune


def test_candidate_space_small_n_cpu():
    assert autotune.candidate_configs(4096) == [{"method": "radix2"}]
    both = autotune.candidate_configs(16384)
    assert both == [{"method": "radix2"}, {"method": "fourstep"}]


def test_candidate_space_gpu(monkeypatch):
    # the space is the same on every device kind: one transform per
    # platform, only the timings differ
    monkeypatch.setattr(autotune, "device_key",
                        lambda: "NVIDIA H100 80GB HBM3")
    cfgs = autotune.candidate_configs(65536)
    assert cfgs == [{"method": "fourstep"}]  # radix2 tops out at 32768
    assert all(set(c) == {"method"} for c in autotune.candidate_configs(16384))


def test_default_cache_path_inside_checkout(monkeypatch):
    import os

    monkeypatch.delenv("NTT_AUTOTUNE_CACHE", raising=False)
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert autotune.default_cache_path() == os.path.join(
        root, ".autotune", "autotune.json")
    monkeypatch.setenv("NTT_AUTOTUNE_CACHE", "/elsewhere/c.json")
    assert autotune.default_cache_path() == "/elsewhere/c.json"


def _fake_timer(times_by_cfg):
    """timer(fn, x, iters) keyed on the Ring the op closure captured."""

    def timer(fn, x, iters):
        ring = fn.__closure__[0].cell_contents
        key = ring.method
        t = times_by_cfg[key]
        if t is None:
            raise RuntimeError("injected candidate failure")
        return t

    return timer


@pytest.fixture
def xla_candidate_space(monkeypatch):
    """Pin the candidate space to the two methods the injected-timer tests
    enumerate; the space itself is covered by the candidate-space tests
    above."""
    monkeypatch.setattr(
        autotune, "candidate_configs",
        lambda n: [{"method": "radix2"}, {"method": "fourstep"}],
    )


def test_tune_picks_argmin_and_caches(xla_candidate_space, tmp_path):
    path = str(tmp_path / "cache.json")
    times = {
        "radix2": 3.0,
        "fourstep": 1.0,
    }
    r = autotune.tune(16384, 8, "ntt", timer=_fake_timer(times),
                      cache_path=path)
    assert r["tuned"] and r["config"]["method"] == "fourstep"
    assert r["seconds"] == 1.0
    # persisted under the device namespace with full candidate-free shape
    with open(path) as f:
        cache = json.load(f)
    assert autotune.device_key() in cache
    # second call: cache hit, no timing (a raising timer proves it)
    def boom(*a):
        raise AssertionError("timer ran on a cache hit")
    r2 = autotune.tune(16384, 8, "ntt", timer=boom, cache_path=path)
    assert not r2["tuned"] and r2["config"] == r["config"]
    # refresh re-times
    times["radix2"] = 0.5
    r3 = autotune.tune(16384, 8, "ntt", timer=_fake_timer(times),
                       cache_path=path, refresh=True)
    assert r3["tuned"] and r3["config"]["method"] == "radix2"


def test_tune_skips_failing_candidate(xla_candidate_space, tmp_path):
    times = {
        "radix2": None,        # fails to run
        "fourstep": 2.0,
    }
    r = autotune.tune(16384, 8, "intt", timer=_fake_timer(times),
                      cache_path=str(tmp_path / "c.json"))
    assert r["config"]["method"] == "fourstep"
    failed = [c for c in r["candidates"] if c["seconds"] is None]
    assert len(failed) == 1 and "error" in failed[0]


def test_tune_all_candidates_fail(xla_candidate_space, tmp_path):
    times = {
        "radix2": None,
        "fourstep": None,
    }
    with pytest.raises(RuntimeError, match="no candidate"):
        autotune.tune(16384, 8, "ntt", timer=_fake_timer(times),
                      cache_path=str(tmp_path / "c.json"))


def test_tuned_ring_computes_correctly(xla_candidate_space, tmp_path, rng):
    times = {
        "radix2": 1.0,
        "fourstep": 9.0,
    }
    ring = autotune.tuned_ring(16384, 4, "ntt", timer=_fake_timer(times),
                               cache_path=str(tmp_path / "c.json"))
    assert ring.method == "radix2"
    x = rng.integers(0, ring.q, size=(4, 16384), dtype=np.uint32)
    want = Ring(16384, ring.q, method="fourstep").ntt(x)
    assert (np.asarray(ring.ntt(jnp.asarray(x)))
            == np.asarray(want)).all()


# -- Ring(method="auto"): persisted-cache-consulting dispatch ----------------


def _write_cache(path, n, q, entries):
    """entries: list of (op, batch, config) persisted under this device."""
    ns = {}
    for op, batch, config in entries:
        key = f"{op}|n={n}|b={batch}|qbits={q.bit_length()}"
        ns[key] = {"config": config, "seconds": 1.0}
    with open(path, "w") as f:
        json.dump({autotune.device_key(): ns}, f)


def test_cached_config_prefers_largest_batch(tmp_path):
    path = str(tmp_path / "cache.json")
    q = Ring(16384).q
    _write_cache(path, 16384, q, [
        ("ntt", 8, {"method": "radix2"}),
        ("ntt", 512, {"method": "fourstep"}),
    ])
    cfg = autotune.cached_config(16384, q, cache_path=path)
    assert cfg["method"] == "fourstep"          # batch 512 wins over 8
    # miss: different n, different qbits, empty file
    assert autotune.cached_config(8192, q, cache_path=path) is None
    assert autotune.cached_config(16384, 97, cache_path=path) is None
    assert autotune.cached_config(
        16384, q, cache_path=str(tmp_path / "nope.json")) is None


def test_ring_method_auto_cache_hit(tmp_path, monkeypatch):
    path = str(tmp_path / "cache.json")
    q = Ring(16384).q
    _write_cache(path, 16384, q, [
        # keys of older cache versions are ignored
        ("ntt", 256, {"method": "fourstep", "block_rows": 64}),
    ])
    monkeypatch.setenv("NTT_AUTOTUNE_CACHE", path)
    ring = Ring(16384, method="auto")
    assert ring.method == "fourstep"
    assert autotune.cached_config(16384, q, cache_path=path) == {
        "method": "fourstep"}


def test_ring_method_auto_miss_falls_back(tmp_path, monkeypatch):
    monkeypatch.setenv("NTT_AUTOTUNE_CACHE",
                       str(tmp_path / "empty.json"))
    ring = Ring(4096, method="auto")
    assert ring.method == "radix2"              # static default preserved
    big = Ring(65536, method="auto")
    assert big.method == "fourstep"


def test_ring_method_auto_computes_correctly(tmp_path, monkeypatch, rng):
    path = str(tmp_path / "cache.json")
    q = Ring(4096).q
    _write_cache(path, 4096, q, [
        ("ntt", 64, {"method": "fourstep"}),
    ])
    monkeypatch.setenv("NTT_AUTOTUNE_CACHE", path)
    ring = Ring(4096, method="auto")
    assert ring.method == "fourstep"
    x = rng.integers(0, ring.q, size=(4, 4096), dtype=np.uint32)
    want = Ring(4096, ring.q, method="radix2").ntt(x)
    assert (np.asarray(ring.ntt(jnp.asarray(x))) == np.asarray(want)).all()
