"""Static per-transform analysis report — the analog of `make report`.

The reference's report flow does a partial hardware compile and emits
``fpga_report.prj/reports/report.html`` with II / occupancy / RAM-banking
analysis (``/root/reference/Makefile:26,38-39``, ``README.md:28-32``); its
kernel attributes exist mainly to make that report clean (SURVEY.md §5).
Here the same role is played by the XLA AOT pipeline: for each transform
size we lower + compile the forward/inverse transforms, dump the optimized
HLO, and report what the computation needs from its shapes: the traced
integer-op count (``utils/opcount``), the minimum bytes moved (one read
and one write of the batch) and their ratio.  Device peaks and timings are
not part of this report: they come from a run on the device.

Run: ``python -m agilex_ntt.utils.report [n ...]``  (writes report_out/).
"""

from __future__ import annotations

import os
import sys

import jax
import jax.numpy as jnp

def _fmt(v: float) -> str:
    if v != v:  # NaN: XLA's cost hook returns no flops for integer kernels
        return "    n/a"
    for unit in ("", "K", "M", "G", "T", "P"):
        if abs(v) < 1000:
            return f"{v:7.2f}{unit}"
        v /= 1000
    return f"{v:.2f}E"


def kernel_report(n: int, batch: int = 512, out_dir: str = "report_out"):
    """Compile fwd+inv for one size; dump HLO and return an analysis dict."""
    from ..api import Ring
    from .opcount import ntt_alu_ops, op_census

    os.makedirs(out_dir, exist_ok=True)
    ring = Ring(n)
    x = jnp.zeros((batch, n), dtype=jnp.uint32)

    rows = []
    for name, fn in (("fwd", ring.ntt), ("inv", ring.intt)):
        lowered = jax.jit(fn).lower(x)
        compiled = lowered.compile()
        hlo_path = os.path.join(out_dir, f"ntt_{name}_n{n}.hlo.txt")
        with open(hlo_path, "w") as f:
            f.write(compiled.as_text())
        try:
            cost = compiled.cost_analysis() or {}
        except Exception:
            cost = {}
        mem = compiled.memory_analysis()

        logn = n.bit_length() - 1
        elems = batch * n
        if ring.method == "radix2":
            census = ntt_alu_ops(ring.params, batch, direction=name)
            model_ops = census["alu"]
            ops_note = "traced"
        else:
            # the whole four-step computation (both passes + the scale)
            model_ops = op_census(fn, x)["alu"]
            ops_note = "traced(four-step)"
        ops_per_es = model_ops / (elems * logn)
        min_bytes = 2 * 4 * elems  # read input + write output once
        intensity = model_ops / min_bytes
        rows.append(
            dict(
                name=name,
                n=n,
                batch=batch,
                method=ring.method,
                hlo=hlo_path,
                xla_flops=cost.get("flops", float("nan")),
                xla_bytes=cost.get("bytes accessed", float("nan")),
                model_ops=model_ops,
                ops_per_elem_stage=ops_per_es,
                ops_note=ops_note,
                min_bytes=min_bytes,
                intensity=intensity,
                temp_bytes=getattr(mem, "temp_size_in_bytes", float("nan")),
            )
        )
    return rows


def main(argv=None):
    sizes = [int(a) for a in (argv or sys.argv[1:])] or [1024, 4096, 16384]
    out_dir = "report_out"
    all_rows = []
    for n in sizes:
        all_rows += kernel_report(n, out_dir=out_dir)

    hdr = (
        f"{'kernel':>10} {'n':>7} {'method':>9} {'ops/e/s':>8} {'model ops':>10} "
        f"{'min bytes':>10} {'ops/B':>7}"
    )
    lines = [
        "per-transform op/byte report (shape-derived; op model traced via "
        "utils.opcount; device times come from a device run)",
        hdr,
        "-" * len(hdr),
    ]
    for r in all_rows:
        lines.append(
            f"{r['name']:>10} {r['n']:>7} {r['method']:>9} "
            f"{r['ops_per_elem_stage']:8.2f} "
            f"{_fmt(r['model_ops']):>10} {_fmt(r['min_bytes']):>10} "
            f"{r['intensity']:7.1f}"
        )
        lines.append(
            f"{'':>10} xla flops={_fmt(r['xla_flops'])} "
            f"xla bytes={_fmt(r['xla_bytes'])} ops={r['ops_note']} "
            f"hlo={r['hlo']}"
        )
    text = "\n".join(lines)
    print(text)
    with open(os.path.join(out_dir, "report.txt"), "w") as f:
        f.write(text + "\n")


if __name__ == "__main__":
    main()
