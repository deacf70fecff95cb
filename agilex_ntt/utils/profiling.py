"""Runtime tracing / timing helpers (SURVEY.md §5 tracing plan).

The reference has *no* runtime tracing — its profiling story is the static
FPGA report (``/root/reference/Makefile:26,38-39``), covered here by
``utils/report.py``.  This module supplies the runtime half:

  * ``trace(dir)`` — context manager around ``jax.profiler`` producing a
    TensorBoard/XProf trace of everything executed inside.
  * ``device_time_profiled(fn, x)`` — device seconds per call from such a
    trace; ``device_time(fn, x)`` — the wall-clock delta-method estimate.
  * ``dump_hlo(fn, *args)`` — optimized HLO text for any jittable callable.
"""

from __future__ import annotations

import contextlib
import time
from typing import Callable

import jax
import jax.numpy as jnp


def under_trace() -> bool:
    """True when called inside an enclosing jax trace (jit/vmap/grad/...).

    Pure trace-state query — no device computation on the fast path.  Used
    to keep device arrays created under a trace out of eager caches (tracer
    leak) and to give eager-only debug helpers a clear error instead of an
    opaque TracerConversionError.

    ``jax.core.trace_ctx`` is a private attribute; if a JAX upgrade renames
    it we fall back to a behavioral probe (does arithmetic on a fresh array
    yield a Tracer?) rather than silently reporting "not traced"
    (``tests/test_report.py`` pins both behaviors).
    """
    try:
        return type(jax.core.trace_ctx.trace).__name__ != "EvalTrace"
    except AttributeError:
        return isinstance(
            jnp.zeros((), jnp.uint32) + jnp.uint32(0), jax.core.Tracer
        )


@contextlib.contextmanager
def trace(log_dir: str):
    """Capture a jax.profiler trace of the enclosed block into `log_dir`."""
    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def dump_hlo(fn: Callable, *args, **kwargs) -> str:
    """Optimized (post-XLA-passes) HLO text for fn(*args, **kwargs)."""
    return jax.jit(fn).lower(*args, **kwargs).compile().as_text()


def _trace_per_call_seconds(tr: dict, iters: int | None = None) -> float | None:
    """Device seconds per call from a loaded ``*.trace.json`` dict (pure
    parser, unit-tested against a GPU trace recorded on an H100 and
    synthetic fixtures in ``tests/test_profiling.py``).  The rules:

    1. **Device processes only** (``/device:GPU:0`` ...) — host threads
       carry dispatch jitter, and host<->device copies (``MemcpyH2D`` /
       ``MemcpyD2H``) move arguments and results, not the call's work.
    2. **Top-level events only.**  A trace may hold a module event and its
       nested op events with identical or contained spans on other lines of
       the same device; an event is kept iff no already-kept event on the
       same device covers its whole span (identical spans keep one).
    3. **Executables that ran once are per-chain, not per-call** (a result
       readback after the chain) and are excluded.  An event's executable
       is its ``hlo_module`` argument (the GPU trace names the jitted
       module on every kernel and copy), else its name.
    4. **Per call = kept busy time / iters**, exact for any number of
       executables and of dispatches per call.  Without ``iters`` the
       count of the most frequent executable stands in for it; if nothing
       repeats, the dominant event is the call.
    """
    from collections import defaultdict

    evs = tr.get("traceEvents", [])
    device_pids = {
        e["pid"]
        for e in evs
        if e.get("ph") == "M"
        and e.get("name") == "process_name"
        and str(e.get("args", {}).get("name", "")).startswith("/device:")
    }
    if not device_pids:
        return None
    # Top-level filter: per device pid, sweep events by (start asc, dur
    # desc); an event whose end falls at or before the running max end of
    # already-kept events is covered by one of them (all kept events
    # started no later than it) and is dropped.
    by_pid: defaultdict[object, list] = defaultdict(list)
    for e in evs:
        if e.get("ph") != "X" or e.get("pid") not in device_pids:
            continue
        if str(e.get("name", "")).startswith(("MemcpyH2D", "MemcpyD2H")):
            continue
        key = e.get("args", {}).get("hlo_module") or e["name"]
        by_pid[e["pid"]].append(
            (float(e.get("ts", 0.0)), -float(e.get("dur", 0.0)), key)
        )
    totals: defaultdict[str, list] = defaultdict(lambda: [0.0, 0])
    for pid_events in by_pid.values():
        pid_events.sort()
        max_end = float("-inf")
        for ts, neg_dur, key in pid_events:
            end = ts - neg_dur
            if end <= max_end:
                continue  # covered by an earlier-starting kept event
            max_end = end
            t = totals[key]
            t[0] += -neg_dur
            t[1] += 1
    if not totals:
        return None
    repeated = [t for t in totals.values() if t[1] > 1]
    if not repeated:  # nothing repeated: the dominant event is the call
        busy_us, count = max(totals.values(), key=lambda t: t[0])
        return busy_us * 1e-6 / count
    calls = iters or max(t[1] for t in repeated)
    return sum(t[0] for t in repeated) / calls * 1e-6


def device_time_profiled(
    fn: Callable,
    x: jnp.ndarray,
    iters: int = 8,
    log_dir: str | None = None,
) -> float | None:
    """On-device seconds per call of y = fn(y), from a profiler trace.

    Captures a ``jax.profiler`` trace of `iters` chained calls, ended by
    ``block_until_ready``, and accounts the device events per the rules in
    ``_trace_per_call_seconds``.  Host dispatch time cannot contaminate
    device timestamps, so this is the device time where the wall-clock
    delta method (``device_time``) is an estimator.

    Returns None when no device events are captured (the CPU backend
    writes none) — callers fall back to ``device_time``.
    """
    import glob
    import gzip
    import json
    import os
    import tempfile

    def run(k):
        v = x
        for _ in range(k):
            v = fn(v)
        v.block_until_ready()

    run(1)  # warm / compile
    ctx = (
        tempfile.TemporaryDirectory()
        if log_dir is None
        else contextlib.nullcontext(log_dir)
    )
    with ctx as d:
        jax.profiler.start_trace(d)
        try:
            run(iters)
        finally:
            jax.profiler.stop_trace()
        traces = sorted(
            glob.glob(os.path.join(d, "plugins/profile/*/*.trace.json.gz"))
        )
        if not traces:
            return None
        with gzip.open(traces[-1]) as f:
            tr = json.load(f)
    return _trace_per_call_seconds(tr, iters=iters)


def device_time(
    fn: Callable, x: jnp.ndarray, iters: int = 10, trials: int = 3
) -> float:
    """Seconds per call of y = fn(y) on device, excluding constant dispatch
    and sync overhead (delta method: time k chained calls minus one call;
    each call's input depends on the previous output so nothing overlaps).

    Host stalls are one-sided noise, so the baseline and the chained
    measurement are min-reduced SEPARATELY before subtracting — subtracting
    a single (possibly stalled) baseline sample from a clean chained sample
    would overestimate throughput.
    """

    def run(k):
        v = x
        for _ in range(k):
            v = fn(v)
        v.block_until_ready()

    run(1)  # warm / compile

    def sample(k):
        best = float("inf")
        for _ in range(trials):
            t0 = time.perf_counter()
            run(k)
            best = min(best, time.perf_counter() - t0)
        return best

    t_one = sample(1)
    t_many = sample(1 + iters)
    return max((t_many - t_one) / iters, 1e-9)
