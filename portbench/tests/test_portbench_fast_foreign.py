"""Tests of the index-less fast-mode cell (``idatfast_foreign_batch16``:
the driver ``fast_foreign_batch``, the single-block check and the readers
of its per-layer metrics), on the CPU.

    python -m pytest portbench/tests -q

Dry runs use 4 KiB images, 4 a call from a pool of 8, so that the plain
K4 finishes in seconds (their streams stay under block discovery's
threshold: ``tests/test_torch_fast_foreign.py`` holds the route past it);
the control, which runs no program, uses 128 KiB images, longer than the
65,536 bytes it answers.
"""

from __future__ import annotations

import io
import json
import pathlib
import time
import zlib

import pytest
import torch

import fdeflate_tpu_torch as P
from fdeflate_tpu_torch.utils import profiling
from portbench import run as RN
from portbench import single_block as SB
from portbench.corpus import make_idat_corpus

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "idatfast_foreign_batch16"
SPAN_METRICS = {"seq_parse_ms.foreign": "sequential.parse",
                "seq_records_ms.foreign": "sequential.records",
                "seq_materialize_ms.foreign": "sequential.materialize"}
METRICS = ["discovery_ms", "seq_launches_per_call", *SPAN_METRICS,
           "fallback_stream_pct.foreign", "inflate_records_roofline.foreign",
           "device_idle_pct.foreign"]
CHECKS = {"answers_missing", "answers_wrong", "inputs_wrong", "multi_block"}


def _spec(monkeypatch, image_bytes: int):
    full = RN.cell_spec

    def spec(workload, _bench_path=None):
        s = full(workload)
        s["config"] = dict(s["config"], image_bytes=image_bytes)
        s["traffic"] = dict(s["traffic"], images_per_call=4, stride=4,
                            distinct_images=8, judged_samples=2)
        return s

    monkeypatch.setattr(RN, "cell_spec", spec)


@pytest.fixture
def small(monkeypatch):
    _spec(monkeypatch, 1 << 12)


def _dry_run(*, fault=None, control=0, trace_on=0, seconds=0.3):
    buf = io.StringIO()
    rc = RN.run(["--workload", CELL, "--seed", str(2 ** 33 + 27), "--seconds",
                 str(seconds), "--trace", str(trace_on), "--control",
                 str(control)], device=torch.device("cpu"), fault=fault,
                t_start=time.perf_counter(), out=buf)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def _cell(spec):
    driver = RN.load_module(ROOT / "portbench" / "drivers"
                            / "fast_foreign_batch.py")
    return driver.Cell(spec["config"], spec["traffic"], 5, torch.device("cpu"))


def test_the_cell_is_entered_with_its_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "png_fast_foreign_inflate", "batch16", 1)
    spec = RN.cell_spec(CELL)
    cfg = spec["config"]
    assert cfg["driver"] == "fast_foreign_batch"
    assert (cfg["image_bytes"], cfg["row_px"], cfg["bit_depth"],
            cfg["filter"], cfg["corpus_seed"]) == (1 << 20, 1024, 8, "Sub", 0)
    assert cfg["reduced"] == [] and "chunks" not in cfg
    indexed = RN.cell_spec("idatfast_indexed_batch16")["config"]["assumed"]
    assert all(cfg["assumed"][k] == indexed[k] for k in ("shapes", "rows"))
    t = spec["traffic"]
    assert (t["images_per_call"], t["distinct_images"], t["judged_samples"],
            t["loop"], t["clients"]) == (16, 32, 4, "closed", 1)
    assert {m["name"] for m in spec["end_to_end"]} == {"inflate_gbps",
                                                        "setup_s"}
    assert [m["name"] for m in spec["per_layer"]] == METRICS
    assert all(m["moves"] == "inflate_gbps" and m["workloads"] == [CELL]
               for m in spec["per_layer"])


# -- the single-block check --------------------------------------------------

def test_single_block_reads_the_first_header_of_each_kind():
    image = make_idat_corpus(1, 1 << 20, 0)[0].tobytes()
    fast = P.compress_batch_ultra_fast([image[:1 << 14]], device="cpu")[0]
    fixed = zlib.compressobj(6, strategy=zlib.Z_FIXED)
    assert SB.first_block_header(fast) == (1, SB.DYNAMIC)
    assert SB.is_single_dynamic_block(fast)
    # zlib 6 on 1 MiB of the corpus: several dynamic blocks, the first not
    # the last.
    assert SB.first_block_header(zlib.compress(image, 6)) == (0, SB.DYNAMIC)
    assert SB.first_block_header(zlib.compress(b"x" * 99, 0)) == (1, 0)
    assert SB.first_block_header(
        fixed.compress(b"x" * 99) + fixed.flush()) == (1, 1)
    assert SB.first_block_header(fast[:2]) is None
    for z in (zlib.compress(image, 6), zlib.compress(b"x" * 99, 0), b""):
        assert not SB.is_single_dynamic_block(z)


def test_the_setup_streams_are_single_blocks_that_give_their_images(small):
    cell = _cell(RN.cell_spec(CELL))
    assert {n: v for n, v, _limit in cell.check()
            if n != "answers_missing"} == {
        "answers_wrong": 0, "inputs_wrong": 0, "multi_block": 0}


def test_a_zlib6_pool_stream_fails_multi_block_alone(small):
    """A stream of the same image at zlib 6, a block every 1 KiB: zlib
    gives back the image, so only ``multi_block`` sees it."""
    cell = _cell(RN.cell_spec(CELL))
    co = zlib.compressobj(6)
    im = cell.images[3].tobytes()
    cell.streams[3] = b"".join(co.compress(im[i: i + 1024])
                               + co.flush(zlib.Z_BLOCK)
                               for i in range(0, len(im), 1024)) + co.flush()
    checks = {n: v for n, v, _limit in cell.check()}
    assert checks["multi_block"] == 1
    assert checks["inputs_wrong"] == 0


# -- the driver ------------------------------------------------------------

def test_dry_run_is_correct(small):
    before = profiling.counts()
    res = _dry_run()
    assert res["correct"] is True
    assert res["attempted"] >= 4 and res["failed"] == 0
    assert set(res["checks"]) == CHECKS
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert set(res["metrics"]) == {"inflate_gbps", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    after = profiling.counts()
    # 4 KiB streams: under discovery's threshold, all sequential.
    assert (after["sequential.streams"]
            - before.get("sequential.streams", 0)) >= 12


@pytest.mark.parametrize("fault", ["stale", "half", "token"])
def test_a_broken_timed_path_is_not_correct(small, fault):
    res = _dry_run(fault=fault)
    assert res["correct"] is False
    assert res["checks"]["answers_wrong"]["value"] > 0


def test_control_is_not_correct(monkeypatch):
    """Each stream answers its first 65,536 bytes: every judged answer of
    a 128 KiB image is short."""
    _spec(monkeypatch, 1 << 17)
    res = _dry_run(control=1, seconds=0.1)
    assert res["correct"] is False
    checks = {n: c["value"] for n, c in res["checks"].items()}
    assert checks["answers_wrong"] > 0 and checks["answers_missing"] == 0
    assert checks["inputs_wrong"] == checks["multi_block"] == 0


def test_a_traced_dry_run_reads_the_sequential_spans_and_launches(small):
    """On the CPU the sequential span metrics and the launches per call
    read the program; the device's metrics have nothing to read."""
    res = _dry_run(trace_on=1, seconds=0.1)
    assert res["correct"] is True
    got = res["metrics"]
    assert set(SPAN_METRICS) | {"seq_launches_per_call"} <= set(got)
    assert not {"inflate_records_roofline.foreign",
                "device_idle_pct.foreign"} & set(got)
    assert all(got[m]["value"] > 0 and got[m]["unit"] == "ms"
               for m in SPAN_METRICS)
    assert got["seq_launches_per_call"]["value"] > 0


# -- the readers -----------------------------------------------------------

def _read(name, ctx):
    return RN.metric_reader(name).read(ctx)


def test_readers_give_known_answers(monkeypatch):
    spans = {"discovery.stage1": 0.3, "discovery.validate": 0.02,
             "discovery.parse": 0.01, "discovery.tables": 0.03,
             "discovery.records": 0.04, "discovery.chain": 0.0,
             "sequential.parse": 0.8, "sequential.records": 0.2,
             "sequential.materialize": 2.0, "inflate.sequential": 3.1,
             "inflate.batch": 3.6}
    counts = {"inflate.calls": 6, "sequential.launches": 270,
              "discovery.streams": 96, "discovery.fallback.budget": 96,
              "launch.inflate_records": 276}
    monkeypatch.setattr(profiling, "span_seconds", lambda: dict(spans))
    monkeypatch.setattr(profiling, "counts", lambda: dict(counts))
    # K4 for 10 us over 33.5 MB in and out: 1 us at 3.35 TB/s, 10%.
    ctx = {"device_ops": [("void inflate_kernel(...)", 0.0, 1e-5),
                          ("decode_symbols_kernel", 0.0, 1.0)],
           "busy_s": 0.2, "window_s": 1.0, "calls": 4,
           "compressed_bytes": 1.35e6, "decoded_bytes": 2.0e6}
    want = {"discovery_ms": 100.0, "seq_launches_per_call": 45.0,
            "seq_parse_ms.foreign": 200.0, "seq_records_ms.foreign": 50.0,
            "seq_materialize_ms.foreign": 500.0,
            "fallback_stream_pct.foreign": 100.0,
            "inflate_records_roofline.foreign": 10.0,
            "device_idle_pct.foreign": 80.0}
    assert {m: _read(m, ctx) for m in METRICS} == pytest.approx(want)


@pytest.mark.parametrize("name", ["discovery_ms", "seq_launches_per_call"])
def test_a_new_reader_with_nothing_to_read_gives_none(monkeypatch, name):
    """A window with no call, a program with no discovery span or no
    ``decompress_batch`` call, a program without spans or counters."""
    monkeypatch.setattr(profiling, "span_seconds",
                        lambda: {"inflate.sequential": 1.0})
    monkeypatch.setattr(profiling, "counts",
                        lambda: {"sequential.launches": 3})
    ctx = {"device_ops": [], "calls": 2}
    assert _read(name, ctx) is None
    assert _read(name, dict(ctx, calls=0)) is None
    monkeypatch.delattr(profiling, "span_seconds")
    monkeypatch.delattr(profiling, "counts")
    assert _read(name, ctx) is None
