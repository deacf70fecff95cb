"""Measured method selection with a persisted per-device cache.

``Ring`` ships one static dispatch default: radix-2 up to ``MAX_RADIX2_N``,
four-step above.  Between n = 2^14 and 2^15 both methods exist and which is
faster depends on the device and the batch, so ``tune()`` times every valid
candidate for an (op, n, batch) workload on the *current* device and
persists the winner in a JSON cache keyed by device kind: the timing pass
runs once per device generation, not once per process.  ``tuned_ring()`` is
the one-call form; ``Ring(method="auto")`` reads the cache.

Reference analog: the FPGA flow specializes per (FPGA_NTT_SIZE, modulus) at
synthesis time (``/root/reference/include/kernel/ntt.h:11-23``, one
bitstream per config); here specialization is a runtime timing pass whose
result persists per device kind — the JIT-era equivalent of keeping the
best bitstream per board.

Typical use::

    from agilex_ntt.utils import autotune
    ring = autotune.tuned_ring(16384, batch=2048, op="ntt")
    # first call on a new device kind: times the candidates, caches winner
    # every later call: cache hit, no timing

CLI (one line of JSON per workload)::

    python -m agilex_ntt.utils.autotune 16384 2048 --op ntt
"""

from __future__ import annotations

import json
import os
import tempfile
from typing import Callable, Dict, List, Optional

import jax
import jax.numpy as jnp

from ..api import MAX_RADIX2_N, Ring
from .profiling import device_time

#: Ring kwargs that a candidate/cached config may carry.  Anything else in
#: a cache entry is ignored (forward compatibility across versions).
_CONFIG_KEYS = ("method",)

_OPS = ("ntt", "intt", "polymul")

_REPO = os.path.dirname(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))))


def default_cache_path() -> str:
    """$NTT_AUTOTUNE_CACHE, else ``<repo>/.autotune/autotune.json``."""
    env = os.environ.get("NTT_AUTOTUNE_CACHE")
    if env:
        return env
    return os.path.join(_REPO, ".autotune", "autotune.json")


def device_key() -> str:
    """Cache namespace: the device kind as JAX reports it (methods tuned
    on one H100 transfer to every H100, not to another GPU or a CPU)."""
    try:
        d = jax.devices()[0]
    except RuntimeError:
        return "cpu"
    return getattr(d, "device_kind", d.platform) or d.platform


def candidate_configs(n: int) -> List[Dict]:
    """Every valid Ring method for size n: radix-2 for n <= MAX_RADIX2_N,
    four-step from n = 2^14 (where both passes reach n1, n2 >= 128).  The
    transform under each is the same on every platform (the GPU kernel on
    a GPU, the plain XLA chains elsewhere), so the space does not depend on
    the device; only the timings do."""
    out: List[Dict] = []
    if n <= MAX_RADIX2_N:
        out.append({"method": "radix2"})
    if n >= (1 << 14):
        out.append({"method": "fourstep"})
    return out


def _op_timer(ring: Ring, op: str) -> Callable:
    """y = f(y) self-chaining form for the delta-method timer (each call's
    input depends on the previous output, so calls cannot overlap)."""
    if op == "ntt":
        return lambda v: ring.ntt(v)
    if op == "intt":
        return lambda v: ring.intt(v)
    if op == "polymul":
        return lambda v: ring.polymul(v, v)
    raise ValueError(f"unknown op {op!r}; expected one of {_OPS}")


def _load_cache(path: str) -> Dict:
    try:
        with open(path) as f:
            return json.load(f)
    except (OSError, ValueError):
        return {}


def _store_cache(path: str, cache: Dict) -> None:
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    # atomic replace: concurrent tuners must not interleave partial JSON
    fd, tmp = tempfile.mkstemp(dir=os.path.dirname(path) or ".")
    try:
        with os.fdopen(fd, "w") as f:
            json.dump(cache, f, indent=1, sort_keys=True)
        os.replace(tmp, path)
    except BaseException:
        try:
            os.unlink(tmp)
        except OSError:
            pass
        raise


def _cache_key(op: str, n: int, batch: int, q: int) -> str:
    return f"{op}|n={n}|b={batch}|qbits={q.bit_length()}"


def cached_config(
    n: int,
    q: int,
    op: str = "ntt",
    *,
    cache_path: Optional[str] = None,
) -> Optional[Dict]:
    """Best persisted config for (op, n, q-bits) on this device kind, or
    None on a miss.  ``Ring(..., method="auto")`` consults this at
    construction (no timing, no device work beyond reading the device
    kind); batch is not known at Ring construction, so among cached
    batches the LARGEST wins — the throughput regime.  Entries are written by ``tune()`` / the CLI.
    """
    dev = device_key()
    entries = _load_cache(cache_path or default_cache_path()).get(dev, {})
    prefix = f"{op}|n={n}|b="
    suffix = f"|qbits={q.bit_length()}"
    best_batch, hit = -1, None
    for key, val in entries.items():
        if not (key.startswith(prefix) and key.endswith(suffix)):
            continue
        try:
            batch = int(key[len(prefix):-len(suffix)])
        except ValueError:
            continue
        if batch > best_batch:
            best_batch, hit = batch, val
    if hit is None:
        return None
    return {k: hit["config"][k] for k in _CONFIG_KEYS if k in hit["config"]}


def tune(
    n: int,
    batch: int,
    op: str = "ntt",
    *,
    q: Optional[int] = None,
    iters: int = 8,
    timer: Optional[Callable] = None,
    cache_path: Optional[str] = None,
    use_cache: bool = True,
    refresh: bool = False,
) -> Dict:
    """Pick the fastest Ring config for (op, n, batch) on this device.

    Times every ``candidate_configs(n)`` entry with the delta-method device
    timer (min of trials, see utils/profiling.py) and returns::

        {"config": {...Ring kwargs...}, "seconds": t, "tuned": bool,
         "candidates": [{"config": ..., "seconds": ...}, ...]}

    The winner is persisted under (device kind, op, n, batch, q-bits); a
    cache hit skips timing entirely (``tuned=False``, empty candidates).
    A candidate that fails to build or run is recorded with
    ``seconds=None`` and skipped; if none survives, tuning raises.

    ``timer(fn, x, iters)`` is injectable for tests; the default is
    ``profiling.device_time``.
    """
    if op not in _OPS:
        raise ValueError(f"unknown op {op!r}; expected one of {_OPS}")
    ring0 = Ring(n, q)  # resolves the default prime once for the cache key
    qv = ring0.q
    path = cache_path or default_cache_path()
    dev = device_key()
    key = _cache_key(op, n, batch, qv)
    if use_cache and not refresh:
        hit = _load_cache(path).get(dev, {}).get(key)
        if hit is not None:
            cfg = {k: hit["config"][k] for k in _CONFIG_KEYS
                   if k in hit["config"]}
            return {"config": cfg, "seconds": hit.get("seconds"),
                    "tuned": False, "candidates": []}

    time_fn = timer or (
        lambda fn, x, it: min(device_time(fn, x, iters=it) for _ in range(3))
    )
    rng_x = jax.random.randint(
        jax.random.PRNGKey(0), (batch, n), 0, qv, dtype=jnp.uint32
    )
    results = []
    for cfg in candidate_configs(n):
        try:
            ring = Ring(n, qv, **cfg)
            t = float(time_fn(_op_timer(ring, op), rng_x, iters))
        except Exception as e:  # candidate invalid on this device: skip
            results.append({"config": cfg, "seconds": None, "error": str(e)})
            continue
        results.append({"config": cfg, "seconds": t})
    alive = [r for r in results if r["seconds"] is not None]
    if not alive:
        raise RuntimeError(
            f"no candidate config survived for op={op} n={n} batch={batch}: "
            + "; ".join(str(r.get("error")) for r in results)
        )
    best = min(alive, key=lambda r: r["seconds"])
    if use_cache:
        cache = _load_cache(path)
        cache.setdefault(dev, {})[key] = {
            "config": best["config"], "seconds": best["seconds"],
        }
        _store_cache(path, cache)
    return {"config": dict(best["config"]), "seconds": best["seconds"],
            "tuned": True, "candidates": results}


def tuned_ring(
    n: int,
    batch: int,
    op: str = "ntt",
    *,
    q: Optional[int] = None,
    cache_path: Optional[str] = None,
    **tune_kwargs,
) -> Ring:
    """A Ring built from the measured-best config for (op, n, batch)."""
    picked = tune(n, batch, op, q=q, cache_path=cache_path, **tune_kwargs)
    return Ring(n, q, **picked["config"])


def main(argv: Optional[List[str]] = None) -> None:
    import argparse

    ap = argparse.ArgumentParser(
        description="time candidate Ring methods, print + cache winners"
    )
    ap.add_argument("n", type=int)
    ap.add_argument("batch", type=int)
    ap.add_argument("--op", default="all", choices=("all",) + _OPS)
    ap.add_argument("--iters", type=int, default=8)
    ap.add_argument("--refresh", action="store_true",
                    help="re-time even on a cache hit")
    args = ap.parse_args(argv)
    for op in _OPS if args.op == "all" else (args.op,):
        r = tune(args.n, args.batch, op, iters=args.iters,
                 refresh=args.refresh)
        print(json.dumps({
            "device": device_key(), "op": op, "n": args.n,
            "batch": args.batch, **r,
        }), flush=True)


if __name__ == "__main__":
    main()
