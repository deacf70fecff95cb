"""Unit tests for the profiler trace-event accounting.

Pins the rules of ``utils.profiling._trace_per_call_seconds`` against a
trace recorded on an NVIDIA H100 (``fixtures/h100_ring256_ntt.trace.json.gz``:
four chained ``Ring(256).ntt`` calls on 64 rows, then a scalar readback,
reduced to its device events) and against synthetic fixtures — among them
the nested module/op double-count that once reported a time 2.0x too low
(a trace holding BOTH a module event and its nested op event with identical
spans).  The reference has no runtime profiling at all
(/root/reference/Makefile:26,38-39 is a static report).
"""

import gzip
import json
import os

from agilex_ntt.utils.profiling import _trace_per_call_seconds

US = 1.0  # trace timestamps/durations are microseconds
FIXTURE = os.path.join(os.path.dirname(__file__), "fixtures",
                       "h100_ring256_ntt.trace.json.gz")


def _meta(pid, name):
    return {"ph": "M", "pid": pid, "name": "process_name", "args": {"name": name}}


def _ev(pid, name, ts, dur, tid=0):
    return {"ph": "X", "pid": pid, "tid": tid, "name": name, "ts": ts, "dur": dur}


def _trace(events):
    return {"traceEvents": [_meta(7, "/device:GPU:0"), _meta(1, "/host:CPU")]
            + events}


def _fixture():
    with gzip.open(FIXTURE, "rt") as f:
        return json.load(f)


def test_gpu_trace_fixture_kernel_time():
    # 4 launches of the ntt_fwd kernel (4.288, 4.224, 4.256, 4.16 us); the
    # readback's once-only modules and the host<->device copies excluded
    sec = _trace_per_call_seconds(_fixture(), iters=4)
    assert abs(sec - (4.288 + 4.224 + 4.256 + 4.16) / 4 * 1e-6) < 1e-12


def test_gpu_trace_fixture_without_iters():
    # the most frequent executable (jit_fwd_ntt, 4 launches) gives iters
    sec = _trace_per_call_seconds(_fixture())
    assert abs(sec - 4.232e-6) < 1e-12


def test_gpu_trace_fixture_device_plane():
    tr = _fixture()
    names = {e["args"]["name"] for e in tr["traceEvents"]
             if e["ph"] == "M" and e["name"] == "process_name"}
    assert "/device:GPU:0" in names
    # without its device plane the trace holds no device time
    host_only = {"traceEvents": [e for e in tr["traceEvents"]
                                 if e["pid"] != 1]}
    assert _trace_per_call_seconds(host_only, iters=4) is None


def test_nested_module_and_op_counted_once():
    # 8 calls; each call emits the module event AND a same-span nested op
    # event on a different tid of the device pid
    evs = []
    for i in range(8):
        t0 = 1000.0 * i
        evs.append(_ev(7, "jit_fwd_ntt(...)", t0, 100 * US, tid=1))
        evs.append(_ev(7, "fwd_ntt.1", t0, 100 * US, tid=2))
    sec = _trace_per_call_seconds(_trace(evs), iters=8)
    assert abs(sec - 100e-6) < 1e-12  # NOT 200e-6


def test_strictly_nested_op_dropped():
    # Op event strictly inside the module span (ts later, end earlier).
    evs = []
    for i in range(4):
        t0 = 1000.0 * i
        evs.append(_ev(7, "jit_fwd_ntt(...)", t0, 100 * US, tid=1))
        evs.append(_ev(7, "fusion.42", t0 + 5, 90 * US, tid=2))
    assert abs(_trace_per_call_seconds(_trace(evs), iters=4) - 100e-6) < 1e-12


def test_multi_executable_path_sums_both():
    # two disjoint top-level executables per call must BOTH count
    evs = []
    for i in range(4):
        t0 = 1000.0 * i
        evs.append(_ev(7, "jit_columns(...)", t0, 70 * US, tid=1))
        evs.append(_ev(7, "jit_rows(...)", t0 + 80, 30 * US, tid=1))
    assert abs(_trace_per_call_seconds(_trace(evs), iters=4) - 100e-6) < 1e-12


def test_hlo_module_groups_kernels_of_one_executable():
    # the GPU trace names each kernel after its op; the executable is the
    # hlo_module argument, so one module's several kernels form one group
    evs = []
    for i in range(3):
        for k, dur in (("fusion.1", 20), ("ntt_fwd", 30)):
            e = _ev(7, k, 1000.0 * i + (0 if k == "fusion.1" else 50), dur)
            e["args"] = {"hlo_module": "jit_polymul"}
            evs.append(e)
    assert abs(_trace_per_call_seconds(_trace(evs), iters=3) - 50e-6) < 1e-12


def test_once_only_readback_excluded():
    # the scalar readback runs once per chained run, not per call
    evs = [_ev(7, "jit_a(...)", 1000.0 * i, 50 * US, tid=1) for i in range(6)]
    evs.append(_ev(7, "reduce.99", 9000.0, 500 * US, tid=1))
    assert abs(_trace_per_call_seconds(_trace(evs), iters=6) - 50e-6) < 1e-12


def test_host_pid_ignored():
    evs = [_ev(7, "jit_a(...)", 1000.0 * i, 50 * US, tid=1) for i in range(4)]
    evs += [_ev(1, "dispatch", 1000.0 * i, 900 * US) for i in range(4)]
    assert abs(_trace_per_call_seconds(_trace(evs), iters=4) - 50e-6) < 1e-12


def test_no_device_pid_returns_none():
    tr = {"traceEvents": [_meta(1, "/host:CPU"), _ev(1, "x", 0, 10)]}
    assert _trace_per_call_seconds(tr) is None


def test_nothing_repeated_falls_back_to_dominant():
    evs = [
        _ev(7, "jit_a(...)", 0.0, 80 * US, tid=1),
        _ev(7, "jit_b(...)", 100.0, 20 * US, tid=1),
    ]
    assert abs(_trace_per_call_seconds(_trace(evs)) - 80e-6) < 1e-12


def test_multi_dispatch_per_call_counts_multiplicity():
    # a Python loop dispatching the same jitted executable 16x per call:
    # 4 calls x (16 x 10us + 1 x 20us) = 180us per call
    evs = []
    for c in range(4):
        t0 = 10000.0 * c
        for j in range(16):
            evs.append(_ev(7, "jit_keyswitch(...)", t0 + 100 * j, 10 * US, tid=1))
        evs.append(_ev(7, "jit_auto(...)", t0 + 1700, 20 * US, tid=1))
    assert abs(_trace_per_call_seconds(_trace(evs), iters=4) - 180e-6) < 1e-12


def test_multiplicity_accounting_excludes_readback_and_flush_loss():
    # the per-chain readback stays excluded with iters given; host<->device
    # copies are argument/result traffic, not the call's work
    evs = [_ev(7, "jit_a(...)", 1000.0 * i, 50 * US, tid=1) for i in range(8)]
    evs.append(_ev(7, "reduce.99", 9000.0, 500 * US, tid=1))
    evs += [_ev(7, "MemcpyH2D", 1000.0 * i + 60, 5 * US, tid=2)
            for i in range(8)]
    assert abs(_trace_per_call_seconds(_trace(evs), iters=8) - 50e-6) < 1e-12
