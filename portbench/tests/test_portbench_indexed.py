"""Tests of the indexed cell (``idatfast_indexed_batch16``: the driver
``indexed_batch`` and the readers of its per-layer metrics), on the CPU.

    python -m pytest portbench/tests -q

Dry runs use a spec of their own, tiny images at C = 8, so that the plain
K11 and the sequential path finish in seconds.
"""

from __future__ import annotations

import io
import json
import pathlib
import subprocess
import sys
import time

import pytest
import torch

from fdeflate_tpu_torch.utils import profiling
from portbench import run as RN

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "idatfast_indexed_batch16"
SPAN_METRICS = {"indexed_stage_ms": "indexed.stage",
                "indexed_decode_ms": "indexed.decode",
                "indexed_readback_ms": "indexed.readback",
                "indexed_verify_ms": "indexed.verify"}
DEVICE_METRICS = ["decode_symbols_roofline", "device_idle_pct.indexed"]
METRICS = [*SPAN_METRICS, *DEVICE_METRICS]


@pytest.fixture
def small(monkeypatch):
    """The cell at 4 KiB images, 8 chunks, 4 a call from a pool of 8."""
    full = RN.cell_spec

    def spec(workload, _bench_path=None):
        s = full(workload)
        s["config"] = dict(s["config"], image_bytes=1 << 12, chunks=8)
        s["traffic"] = dict(s["traffic"], images_per_call=4, stride=4,
                            distinct_images=8, judged_samples=2)
        return s

    monkeypatch.setattr(RN, "cell_spec", spec)


def _dry_run(*, fault=None, control=0, trace_on=0, seconds=0.3):
    buf = io.StringIO()
    rc = RN.run(["--workload", CELL, "--seed", str(2 ** 33 + 29), "--seconds",
                 str(seconds), "--trace", str(trace_on), "--control",
                 str(control)], device=torch.device("cpu"), fault=fault,
                t_start=time.perf_counter(), out=buf)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_the_cell_is_entered_with_its_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "png_fast_indexed_inflate", "batch16", 1)
    spec = RN.cell_spec(CELL)
    assert spec["config"]["driver"] == "indexed_batch"
    assert {m["name"] for m in spec["end_to_end"]} == {"inflate_gbps",
                                                        "setup_s"}
    assert [m["name"] for m in spec["per_layer"]] == METRICS
    assert all(m["moves"] == "inflate_gbps" for m in spec["per_layer"])


def test_dry_run_is_correct(small):
    res = _dry_run()
    assert res["correct"] is True
    assert res["attempted"] >= 4 and res["failed"] == 0
    assert set(res["checks"]) == {"answers_missing", "answers_wrong",
                                  "inputs_wrong", "indexed_fallbacks"}
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert set(res["metrics"]) == {"inflate_gbps", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())


@pytest.mark.parametrize("fault", ["stale", "half", "token"])
def test_a_broken_timed_path_is_not_correct(small, fault):
    res = _dry_run(fault=fault)
    assert res["correct"] is False
    assert res["checks"]["answers_wrong"]["value"] > 0


def test_control_is_not_correct_by_its_fallbacks(small):
    """A lost index sends every stream to ``decompress_batch``: the bytes
    are right, and the fallbacks alone make the run not correct."""
    res = _dry_run(control=1, seconds=0.1)
    assert res["correct"] is False
    checks = {n: c["value"] for n, c in res["checks"].items()}
    assert checks["indexed_fallbacks"] == res["attempted"] > 0
    assert checks["answers_wrong"] == checks["inputs_wrong"] == 0


def test_a_traced_dry_run_reads_the_indexed_spans(small):
    """On the CPU the four span metrics read the program; the device's
    metrics have nothing to read."""
    res = _dry_run(trace_on=1, seconds=0.1)
    assert res["correct"] is True
    got = res["metrics"]
    assert set(got) == set(SPAN_METRICS)
    assert all(v["value"] > 0 and v["unit"] == "ms" for v in got.values())


# -- the readers -----------------------------------------------------------

def _read(name, ctx):
    return RN.metric_reader(name).read(ctx)


def test_readers_give_known_answers(monkeypatch):
    spans = {"indexed.stage": 0.4, "indexed.decode": 2.0,
             "indexed.readback": 0.8, "indexed.verify": 1.2,
             "indexed.batch": 9.0}
    monkeypatch.setattr(profiling, "span_seconds", lambda: dict(spans))
    # K11 for 10 us over 33.5 MB in and out: 1 us at 3.35 TB/s, 10%.
    ctx = {"device_ops": [("void decode_symbols_kernel<true, false>(...)",
                           0.0, 1e-5), ("inflate_kernel", 0.0, 1.0)],
           "busy_s": 0.25, "window_s": 1.0, "calls": 4,
           "compressed_bytes": 1.35e6, "decoded_bytes": 2.0e6}
    want = {"indexed_stage_ms": 100.0, "indexed_decode_ms": 500.0,
            "indexed_readback_ms": 200.0, "indexed_verify_ms": 300.0,
            "decode_symbols_roofline": 10.0, "device_idle_pct.indexed": 75.0}
    assert {m: _read(m, ctx) for m in METRICS} == pytest.approx(want)


@pytest.mark.parametrize("name", METRICS)
def test_a_reader_with_nothing_to_read_gives_none(monkeypatch, name):
    """An empty trace, a window with no call, a program without the span
    (the one before it) or without spans at all."""
    assert _read(name, {"device_ops": [], "busy_s": 0, "window_s": 1.0}) is None
    monkeypatch.setattr(profiling, "span_seconds",
                        lambda: {"indexed.batch": 1.0})
    ctx = {"device_ops": [("inflate_kernel", 0.0, 1.0)], "busy_s": 0,
           "window_s": 1.0, "calls": 2, "compressed_bytes": 10,
           "decoded_bytes": 20}
    assert _read(name, ctx) is None
    monkeypatch.delattr(profiling, "span_seconds")
    assert _read(name, ctx) is None


def test_a_run_of_the_cell_loads_no_jax_module():
    code = ("import sys, torch, portbench.run as r\n"
            "r.load_module(r.HERE / 'drivers' / 'indexed_batch.py')\n"
            "print(r.forbidden_modules(), 'fdeflate_tpu_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "True"]
