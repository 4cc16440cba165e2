"""Tests of the per-layer metrics that read the program's own spans and
counters (``portbench/program.py`` and its seven readers), on the CPU.

    python -m pytest portbench/tests -q
"""

from __future__ import annotations

import io
import json
import pathlib
import time

import pytest
import torch

from fdeflate_tpu_torch.utils import profiling
from portbench import run as RN

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "idat6_inflate_batch16"
SPAN_METRICS = ["stage1_ms", "host_parse_ms", "stitch_ms", "fallback_ms"]
COUNTER_METRICS = ["fallback_stream_pct", "lane_yield_pct",
                   "kernel_launches_per_call"]
METRICS = SPAN_METRICS + COUNTER_METRICS


@pytest.fixture
def program(monkeypatch):
    """The program's span seconds and counters, as the test sets them."""
    spans: dict = {}
    counts: dict = {}
    monkeypatch.setattr(profiling, "span_seconds", lambda: dict(spans))
    monkeypatch.setattr(profiling, "counts", lambda: dict(counts))
    return spans, counts


def _read(name, ctx):
    return RN.metric_reader(name).read(ctx)


def test_program_readers_give_known_answers(program):
    spans, counts = program
    spans.update({"discovery.stage1": 0.4, "discovery.parse": 0.3,
                  "discovery.tables": 0.1, "discovery.stitch": 0.2,
                  "inflate.sequential": 1.0, "discovery.records": 9.0,
                  "inflate.batch": 20.0})
    counts.update({"discovery.streams": 64, "discovery.fallback.chain": 2,
                   "discovery.fallback.header": 0, "discovery.lanes": 400,
                   "discovery.lanes_chained": 100, "launch.inflate_records": 6,
                   "launch.validate_headers": 6, "launch.adler32_tiles": 12,
                   "inflate.calls": 6, "indexed.fallback": 5})
    ctx = {"device_ops": [], "busy_s": 0.5, "window_s": 1.0, "calls": 4}
    assert _read("stage1_ms", ctx) == pytest.approx(100.0)
    assert _read("host_parse_ms", ctx) == pytest.approx(100.0)
    assert _read("stitch_ms", ctx) == pytest.approx(50.0)
    assert _read("fallback_ms", ctx) == pytest.approx(250.0)
    assert _read("fallback_stream_pct", ctx) == pytest.approx(3.125)
    assert _read("lane_yield_pct", ctx) == pytest.approx(25.0)
    assert _read("kernel_launches_per_call", ctx) == pytest.approx(4.0)


@pytest.mark.parametrize("name", METRICS)
def test_a_reader_with_nothing_to_read_gives_none(program, name):
    """No span or counter of its own (no fallback in the window, no
    discovery, no call of the entry), or no call in the window."""
    spans, counts = program
    spans["inflate.batch"] = 2.0
    counts.update({"launch.inflate_records": 3, "discovery.fallback.chain": 1})
    assert _read(name, {"device_ops": [], "calls": 2}) is None
    spans.update(dict.fromkeys(["discovery.stage1", "discovery.parse",
                                "discovery.stitch", "inflate.sequential"], 1.0))
    counts.update({"discovery.streams": 16, "discovery.lanes": 9,
                   "inflate.calls": 3})
    assert _read(name, {"device_ops": [], "calls": 2}) is not None
    assert _read(name, {"device_ops": [], "calls": 0}) is None
    assert _read(name, {"device_ops": []}) is None


@pytest.mark.parametrize("name", METRICS)
def test_a_program_without_spans_or_counters_reads_none(monkeypatch, name):
    """A program that keeps neither (the one before them) gives no
    reading and no error."""
    monkeypatch.delattr(profiling, "span_seconds")
    monkeypatch.delattr(profiling, "counts")
    assert _read(name, {"device_ops": [], "calls": 3}) is None


def test_the_metrics_are_entered_for_the_batch_cell():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    entries = {m["name"]: m for m in bench["per_layer"]}
    for name in METRICS:
        m = entries[name]
        assert m["workloads"] == [CELL] and m["moves"] == "inflate_gbps"
        assert m["source"] == ("program_span" if name in SPAN_METRICS
                               else "program_counter")
        assert m["layer"] == ("kernels" if name == "kernel_launches_per_call"
                              else "inflate entry")


def test_a_traced_dry_run_reads_the_program(monkeypatch):
    """On the CPU the cell's small streams all take the sequential path:
    the fallback's span and the launches (none) are read, block
    discovery's metrics have nothing to read."""
    full = RN.cell_spec

    def small(workload, _bench_path=None):
        s = full(workload)
        s["config"] = dict(s["config"], image_bytes=1 << 13)
        s["traffic"] = dict(s["traffic"], images_per_call=4, stride=4,
                            distinct_images=8)
        return s

    monkeypatch.setattr(RN, "cell_spec", small)
    buf = io.StringIO()
    rc = RN.run(["--workload", CELL, "--seed", str(2 ** 33 + 5), "--seconds",
                 "0.2", "--trace", "1"], device=torch.device("cpu"),
                t_start=time.perf_counter(), out=buf)
    assert rc == 0
    res = json.loads(buf.getvalue().strip().splitlines()[-1])
    assert res["correct"] is True
    got = res["metrics"]
    assert got["fallback_ms"]["value"] > 0 and got["fallback_ms"]["unit"] == "ms"
    assert got["kernel_launches_per_call"]["value"] == 0
    assert not set(got) & {"stage1_ms", "host_parse_ms", "stitch_ms",
                           "fallback_stream_pct", "lane_yield_pct"}
