"""Smoke tests for the static analysis report (the `make report` analog of
the reference's FPGA report flow, /root/reference/Makefile:26,38-39)."""

import json
import os

from agilex_ntt.utils import report


def test_kernel_report_smoke(tmp_path):
    rows = report.kernel_report(256, batch=16, out_dir=str(tmp_path))
    assert {r["name"] for r in rows} == {"fwd", "inv"}
    for r in rows:
        assert os.path.exists(r["hlo"])
        assert os.path.getsize(r["hlo"]) > 1000  # real HLO text
        assert r["model_ops"] > 0 and r["min_bytes"] > 0
        assert r["intensity"] == r["model_ops"] / r["min_bytes"]
        assert 10 < r["ops_per_elem_stage"] < 15


def test_report_main_writes_summary(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    report.main(["256"])
    assert os.path.exists("report_out/report.txt")
    text = open("report_out/report.txt").read()
    assert "op/byte" in text and "fwd" in text and "inv" in text
