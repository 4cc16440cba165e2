"""Tests of the thumbnail cell (``thumb128_inflate_batch256``: the RGB
corpus, the driver ``thumbnail_batch`` and the readers of its per-layer
metrics), on the CPU.

    python -m pytest portbench/tests -q

Dry runs use 32 x 32 images, 4 a call from a pool of 8, so that the plain
K4 finishes in seconds; the control, which runs no program, uses the
published 128 x 128, whose streams hold two blocks.
"""

from __future__ import annotations

import io
import json
import pathlib
import time
import zlib

import numpy as np
import pytest
import torch

from fdeflate_tpu_torch.utils import profiling
from portbench import reference as R
from portbench import run as RN
from portbench import thumbnails as T

ROOT = pathlib.Path(__file__).resolve().parents[2]
CELL = "thumb128_inflate_batch256"
SPAN_METRICS = {"seq_parse_ms": "sequential.parse",
                "seq_records_ms": "sequential.records",
                "seq_materialize_ms": "sequential.materialize"}
METRICS = [*SPAN_METRICS, "inflate_records_roofline.thumbs",
           "device_idle_pct.thumbs", "kernel_launches_per_call.thumbs"]
THRESHOLD = 49152   # block discovery takes streams of this many bytes or more


def _spec(monkeypatch, width: int):
    full = RN.cell_spec

    def spec(workload, _bench_path=None):
        s = full(workload)
        s["config"] = dict(s["config"], width_px=width, height_px=width,
                           idat_bytes=width * (1 + 3 * width))
        s["traffic"] = dict(s["traffic"], images_per_call=4, stride=4,
                            distinct_images=8)
        return s

    monkeypatch.setattr(RN, "cell_spec", spec)


@pytest.fixture
def small(monkeypatch):
    _spec(monkeypatch, 32)


def _dry_run(*, fault=None, control=0, trace_on=0, seconds=0.3):
    buf = io.StringIO()
    rc = RN.run(["--workload", CELL, "--seed", str(2 ** 33 + 41), "--seconds",
                 str(seconds), "--trace", str(trace_on), "--control",
                 str(control)], device=torch.device("cpu"), fault=fault,
                t_start=time.perf_counter(), out=buf)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


def test_the_cell_is_entered_with_its_metrics():
    bench = json.loads((ROOT / "BENCHMARK.json").read_text())
    cell = {w["name"]: w for w in bench["workloads"]}[CELL]
    assert (cell["config"], cell["traffic"], cell["chips"]) == (
        "ffhq_thumb128_inflate", "batch256", 1)
    spec = RN.cell_spec(CELL)
    cfg = spec["config"]
    assert cfg["driver"] == "thumbnail_batch"
    assert (cfg["width_px"], cfg["height_px"], cfg["channels"],
            cfg["bit_depth"], cfg["idat_bytes"]) == (128, 128, 3, 8, 49280)
    assert cfg["reduced"] == ["images"] and cfg["images"] == 512
    assert spec["traffic"]["images_per_call"] == 256
    assert spec["traffic"]["distinct_images"] == 512
    assert {m["name"] for m in spec["end_to_end"]} == {"inflate_gbps",
                                                        "setup_s"}
    assert [m["name"] for m in spec["per_layer"]] == METRICS
    assert all(m["moves"] == "inflate_gbps" and m["workloads"] == [CELL]
               for m in spec["per_layer"])


# -- the corpus ------------------------------------------------------------

def _predict(kind: int, row, prev, i: int) -> int:
    """Filter ``kind``'s prediction of byte ``i`` of ``row`` (PNG spec
    9.2-9.4): from the byte a pixel left, the byte above and the byte above
    left, 0 outside the image."""
    a = row[i - 3] if i >= 3 else 0
    b = prev[i]
    c = prev[i - 3] if i >= 3 else 0
    if kind == T.PAETH:
        p = a + b - c
        pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
        return a if pa <= pb and pa <= pc else (b if pb <= pc else c)
    return (0, a, b, (a + b) // 2)[kind]


def _plain_filter(row, prev, kind: int) -> list[int]:
    """One row under one PNG filter, byte by byte."""
    return [(x - _predict(kind, row, prev, i)) % 256
            for i, x in enumerate(row)]


def _unfilter(idat: bytes, height: int, row_bytes: int) -> np.ndarray:
    """A PNG decoder's reconstruction of the rows, byte by byte."""
    prev = [0] * row_bytes
    rows = []
    for y in range(height):
        line = idat[y * (1 + row_bytes): (y + 1) * (1 + row_bytes)]
        cur: list[int] = []
        for i, r in enumerate(line[1:]):
            cur.append((r + _predict(line[0], cur, prev, i)) % 256)
        rows.append(cur)
        prev = cur
    return np.array(rows, np.uint8)


def test_the_corpus_is_real_idat_rows_of_the_heuristics_filters():
    """Each row is its filter type (0-4) and its residuals; the type is the
    one of least sum of |signed residual| (the first on a tie), checked
    byte by byte; a PNG decoder's reconstruction gives the image back."""
    W = H = 16
    rows = T.make_rgb_thumbnails(3, W, H, seed=5)
    images = T.rgb_fields(3, W, H, seed=5)
    assert rows.shape == (3, H * (1 + 3 * W)) and rows.dtype == np.uint8
    for b in range(3):
        img = images[b].astype(int).tolist()
        lines = rows[b].reshape(H, 1 + 3 * W)
        for y in range(H):
            prev = img[y - 1] if y else [0] * (3 * W)
            outs = [_plain_filter(img[y], prev, k) for k in range(5)]
            costs = [sum(min(v, 256 - v) for v in o) for o in outs]
            kind = int(lines[y, 0])
            assert kind == costs.index(min(costs))
            assert lines[y, 1:].tolist() == outs[kind]
        assert (_unfilter(rows[b].tobytes(), H, 3 * W) == images[b]).all()


def test_the_published_size_rows_use_several_filters():
    rows = T.make_rgb_thumbnails(4, seed=0)
    assert rows.shape == (4, 49280)
    kinds = rows.reshape(4, 128, 385)[:, :, 0]
    assert set(np.unique(kinds)) <= set(range(5))
    assert len(np.unique(kinds)) >= 3
    assert (_unfilter(rows[1].tobytes(), 128, 384)
            == T.rgb_fields(4, 128, 128, seed=0)[1]).all()


def test_the_published_size_streams_stay_under_discovery_in_two_blocks():
    """At zlib level 6 every stream is shorter than discovery's threshold
    and its second block reaches back into its first, so that decoding
    each block from an empty window (the control) gives other bytes."""
    for row in T.make_rgb_thumbnails(4, seed=0):
        z = zlib.compress(row.tobytes(), 6)
        assert len(z) < THRESHOLD
        assert R.inflate(z) == row.tobytes()
        assert R.inflate_blocks(z) != row.tobytes()


# -- the driver ------------------------------------------------------------

def test_dry_run_is_correct(small):
    before = profiling.counts()
    res = _dry_run()
    assert res["correct"] is True
    assert res["attempted"] >= 4 and res["failed"] == 0
    assert set(res["checks"]) == {"answers_missing", "answers_wrong"}
    assert all(c["value"] == 0 for c in res["checks"].values())
    assert set(res["metrics"]) == {"inflate_gbps", "setup_s"}
    assert all(v["value"] > 0 for v in res["metrics"].values())
    after = profiling.counts()
    assert (after.get("discovery.streams", 0)
            == before.get("discovery.streams", 0))
    assert (after["sequential.streams"]
            - before.get("sequential.streams", 0)) >= 12


@pytest.mark.parametrize("fault", ["stale", "half", "token"])
def test_a_broken_timed_path_is_not_correct(small, fault):
    res = _dry_run(fault=fault)
    assert res["correct"] is False
    assert res["checks"]["answers_wrong"]["value"] > 0


def test_control_is_not_correct(monkeypatch):
    """Each block decoded from an empty window: the published size's
    second blocks read zeros where they reach back."""
    _spec(monkeypatch, 128)
    res = _dry_run(control=1, seconds=0.1)
    assert res["correct"] is False
    assert res["checks"]["answers_wrong"]["value"] == res["attempted"] > 0


def test_a_traced_dry_run_reads_the_sequential_spans(small):
    """On the CPU the three span metrics read the program and the plain
    versions launch no kernel; the device's metrics have nothing to read."""
    res = _dry_run(trace_on=1, seconds=0.1)
    assert res["correct"] is True
    got = res["metrics"]
    assert set(got) == {*SPAN_METRICS, "kernel_launches_per_call.thumbs"}
    assert all(got[m]["value"] > 0 and got[m]["unit"] == "ms"
               for m in SPAN_METRICS)
    assert got["kernel_launches_per_call.thumbs"]["value"] == 0


def test_the_driver_refuses_a_configuration_it_cannot_make(small):
    spec = RN.cell_spec(CELL)
    driver = RN.load_module(ROOT / "portbench" / "drivers"
                            / "thumbnail_batch.py")
    for bad in ({"channels": 4}, {"bit_depth": 16}, {"idat_bytes": 3104 + 1},
                {"images": 4}):
        with pytest.raises(ValueError):
            driver.Cell(dict(spec["config"], **bad), spec["traffic"], 1,
                        torch.device("cpu"))


# -- the readers -----------------------------------------------------------

def _read(name, ctx):
    return RN.metric_reader(name).read(ctx)


def test_readers_give_known_answers(monkeypatch):
    spans = {"sequential.parse": 1.2, "sequential.records": 0.4,
             "sequential.materialize": 0.2, "inflate.sequential": 2.0,
             "inflate.batch": 2.1}
    counts = {"launch.inflate_records": 12, "inflate.calls": 4}
    monkeypatch.setattr(profiling, "span_seconds", lambda: dict(spans))
    monkeypatch.setattr(profiling, "counts", lambda: dict(counts))
    # K4 for 10 us over 33.5 MB in and out: 1 us at 3.35 TB/s, 10%.
    ctx = {"device_ops": [("void inflate_kernel(...)", 0.0, 1e-5),
                          ("decode_symbols_kernel", 0.0, 1.0)],
           "busy_s": 0.1, "window_s": 1.0, "calls": 4,
           "compressed_bytes": 1.35e6, "decoded_bytes": 2.0e6}
    want = {"seq_parse_ms": 300.0, "seq_records_ms": 100.0,
            "seq_materialize_ms": 50.0,
            "inflate_records_roofline.thumbs": 10.0,
            "device_idle_pct.thumbs": 90.0,
            "kernel_launches_per_call.thumbs": 3.0}
    assert {m: _read(m, ctx) for m in METRICS} == pytest.approx(want)


@pytest.mark.parametrize("name", list(SPAN_METRICS))
def test_a_program_without_the_sequential_spans_reads_none(monkeypatch, name):
    """The program before the spans (it opens ``inflate.sequential``
    alone), a window with no call, a program without spans at all."""
    monkeypatch.setattr(profiling, "span_seconds",
                        lambda: {"inflate.sequential": 1.0,
                                 "inflate.batch": 1.1})
    assert _read(name, {"device_ops": [], "calls": 2}) is None
    monkeypatch.setattr(profiling, "span_seconds",
                        lambda: {SPAN_METRICS[name]: 1.0})
    assert _read(name, {"device_ops": [], "calls": 2}) == pytest.approx(500.0)
    assert _read(name, {"device_ops": [], "calls": 0}) is None
    monkeypatch.delattr(profiling, "span_seconds")
    assert _read(name, {"device_ops": [], "calls": 2}) is None
