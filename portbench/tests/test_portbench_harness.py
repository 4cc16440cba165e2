"""Tests of the benchmark harness on the CPU (the program's plain versions
stand in for its kernels), and one on the card.

    python -m pytest portbench/tests -q

Dry runs use tiny images so that the plain kernels finish in seconds;
the card test runs each cell briefly at its own size.
"""

from __future__ import annotations

import ast
import io
import json
import pathlib
import subprocess
import sys
import time
import zlib

import numpy as np
import pytest
import torch

from portbench import reference as R
from portbench import run as RN
from portbench import stats, trace
from portbench.corpus import make_idat_corpus

ROOT = pathlib.Path(__file__).resolve().parents[2]
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
CELLS = [w["name"] for w in BENCH["workloads"]]

# Cells whose drivers, configurations, traffic and readers are in the
# folder while the cells themselves are left out of BENCHMARK.json: the
# device codec's (its 16-image steps are bound by the host's launches and
# spread more than a bound holds) and the single-stream inflate cell (one
# stream a request, host-bound, spread more than a bound holds).  Their
# entries, so that the dry runs keep their drivers and traffic proven.
CODEC_CELL = "idat_roundtrip"
SINGLE_CELL = "idat6_inflate"
OUT_ENTRIES = {
    "configs": [{"name": "png_fast_idat", "source": "see the file",
                 "file": "portbench/configs/png_fast_idat.json",
                 "reduced": [], "why": "the device codec"}],
    "workloads": [{"name": CODEC_CELL, "config": "png_fast_idat",
                   "traffic": "batch16", "chips": 1, "why": "16 x 1 MiB"},
                  {"name": SINGLE_CELL, "config": "png_default_inflate",
                   "traffic": "single", "chips": 1, "why": "1 x 1 MiB"}],
    "end_to_end": [
        {"name": "codec_gbps", "unit": "GB/s", "better": "higher",
         "bound": 0.25, "source": "host_clock", "workloads": [CODEC_CELL]},
        {"name": "compressed_ratio", "unit": "B/B", "better": "lower",
         "bound": 0.01, "source": "host_clock", "workloads": [CODEC_CELL]},
        {"name": "inflate_p95_ms", "unit": "ms", "better": "lower",
         "bound": 0.25, "source": "host_clock", "workloads": [SINGLE_CELL]}],
    "per_layer": [
        {"name": name, "unit": unit, "better": better, "source": "device_trace",
         "layer": name, "moves": "codec_gbps", "workloads": [CODEC_CELL]}
        for name, unit, better in [
            ("encode_leg_ms", "ms", "lower"), ("decode_leg_ms", "ms", "lower"),
            ("assign_pack_roofline", "%", "higher"),
            ("decode2_roofline", "%", "higher"),
            ("device_idle_pct.codec", "%", "lower")]],
}


def _with_out_cells(bench: dict) -> dict:
    """``bench`` with the cells left out added back; the inflate metrics
    also serve the single-stream cell."""
    out = {k: (v + OUT_ENTRIES.get(k, []) if isinstance(v, list) else v)
           for k, v in bench.items()}
    for kind in ("end_to_end", "per_layer"):
        out[kind] = [
            dict(m, workloads=m["workloads"] + [SINGLE_CELL])
            if "idat6_inflate_batch16" in m.get("workloads", []) else m
            for m in out[kind]]
    return out


WITH_CODEC = _with_out_cells(BENCH)


@pytest.fixture
def with_codec(tmp_path):
    """A BENCHMARK.json that also holds the cells left out."""
    path = tmp_path / "BENCHMARK.json"
    path.write_text(json.dumps(WITH_CODEC))
    return path


# -- found by name ---------------------------------------------------------

@pytest.mark.parametrize("cell", CELLS + [CODEC_CELL, SINGLE_CELL])
def test_cell_files_are_found_by_name(with_codec, cell):
    spec = RN.cell_spec(cell, with_codec)
    assert spec["cell"]["name"] == cell
    assert spec["config"]["name"] == spec["cell"]["config"]
    assert (ROOT / "portbench" / "drivers"
            / f"{spec['config']['driver']}.py").is_file()
    assert spec["traffic"]["images_per_call"] >= 1
    names = {m["name"] for m in spec["end_to_end"]}
    assert "setup_s" in names and len(names) >= 2
    assert spec["per_layer"]


@pytest.mark.parametrize("metric",
                         [m["name"] for m in WITH_CODEC["per_layer"]])
def test_every_per_layer_metric_has_a_reader(metric):
    mod = RN.metric_reader(metric)
    assert callable(mod.read)
    assert mod.read({"device_ops": [], "busy_s": 0, "window_s": 1.0}) is None


def test_a_split_metric_shares_its_base_name_reader():
    assert not (ROOT / "portbench" / "metrics"
                / "device_idle_pct.inflate.py").exists()
    assert (RN.metric_reader("device_idle_pct.inflate").__file__
            == RN.metric_reader("device_idle_pct.codec").__file__
            == str(ROOT / "portbench" / "metrics" / "device_idle_pct.py"))
    with pytest.raises(FileNotFoundError):
        RN.metric_reader("no_such_metric.inflate")


def test_configuration_files_match_the_benchmark():
    for c in BENCH["configs"]:
        cfg = json.loads((ROOT / c["file"]).read_text())
        assert cfg["source"] == c["source"]
        assert cfg["reduced"] == c["reduced"]
        assert cfg["guarantees"]


def test_per_layer_metrics_move_a_metric_their_cells_report():
    e2e = {m["name"]: m for m in BENCH["end_to_end"]}
    for m in BENCH["per_layer"]:
        moved = e2e[m["moves"]]
        assert set(m["workloads"]) <= set(moved.get("workloads", CELLS))


def test_unknown_workload_is_refused():
    with pytest.raises(KeyError):
        RN.cell_spec("no_such_cell")


# -- arithmetic ------------------------------------------------------------

@pytest.mark.parametrize("seed", [0, 2 ** 31 + 7, 2 ** 33 + 17])
def test_every_seed_sends_the_same_batches(seed):
    from portbench.harness import call_images, seeded_order
    images = np.arange(32)
    traffic = {"distinct_images": 32, "images_per_call": 16, "stride": 16}
    order = seeded_order(images, seed, group=16)
    assert sorted(order) == list(range(32))
    batches = {frozenset(order[call_images(traffic, i)].tolist())
               for i in range(2)}
    assert batches == {frozenset(range(16)), frozenset(range(16, 32))}
    # One image a call: the order of all images, as drawn before groups.
    plain = images[np.random.default_rng(seed).permutation(32)]
    assert (seeded_order(images, seed) == plain).all()


def test_percentile_is_nearest_rank_over_all_values():
    xs = list(range(1, 101))           # 1..100
    assert stats.percentile(xs, 95) == 95
    assert stats.percentile(xs, 100) == 100
    assert stats.percentile([5.0, 1.0, 3.0], 95) == 5.0
    assert stats.percentile([7.0], 95) == 7.0
    assert stats.percentile(list(range(20)), 95) == 18


def test_rate_ratio_and_roofline():
    assert stats.rate_gbps(3e9, 2.0) == pytest.approx(1.5)
    assert stats.ratio(35, 100) == pytest.approx(0.35)
    # 3.35 MB at 3.35 TB/s is 1 us; a kernel of 10 us reads 10%.
    assert stats.roofline_pct(3.35e6, 10e-6) == pytest.approx(10.0)


def test_busy_and_idle_from_a_kernel_timeline():
    iv = [(0.0, 1.0), (0.5, 2.0), (3.0, 4.0), (3.5, 3.6)]
    assert stats.merge(iv) == [(0.0, 2.0), (3.0, 4.0)]
    assert stats.busy_seconds(iv) == pytest.approx(3.0)
    assert stats.busy_seconds(iv, 1.0, 3.5) == pytest.approx(1.5)
    assert stats.idle_pct(3.0, 5.0) == pytest.approx(40.0)


def test_idle_gaps_are_named_by_the_innermost_host_operation():
    device = [("k1", 0.0, 1.0), ("k2", 2.0, 3.0), ("k3", 5.0, 6.0)]
    host = [("window", 0.0, 6.0), ("parse", 1.0, 2.0), ("aten::copy_", 3.2, 3.4)]
    gaps = dict(trace.idle_gaps(device, host, 0.0, 6.0))
    assert gaps == pytest.approx({"parse": 1.0, "window": 2.0})


def test_kernel_names_select_one_kernel_each():
    device = [("void fdt::decode_kernel<4>(unsigned int const*)", 0.0, 1.0),
              ("decode_sep_kernel", 0.0, 2.0),
              ("decode_symbols_kernel(int)", 0.0, 4.0),
              ("void (anonymous namespace)::assign_pack_kernel(...)", 0.0, 8.0),
              ("inflate_kernel", 0.0, 16.0)]
    assert trace.kernel_seconds(device, r"\bdecode_kernel\b") == 1.0
    assert trace.kernel_seconds(device, r"\bassign_pack_kernel\b") == 8.0
    assert trace.kernel_seconds(device, r"\binflate_kernel\b") == 16.0
    assert trace.kernel_seconds(device, r"\bcombine_kernel\b") is None
    assert trace.short_name(device[0][0]) == "fdt::decode_kernel"


def test_metric_readers_give_known_answers():
    ctx = {"device_ops": [("assign_pack_kernel", 0.0, 1e-5),
                          ("decode_kernel", 1e-5, 3e-5),
                          ("inflate_kernel", 0.0, 1e-3)],
           "busy_s": 0.25, "window_s": 1.0, "steps": 4,
           "span_ms": {"encode_leg": 2.0, "decode_leg": 6.0},
           "input_bytes": 2.0e7, "compressed_bytes": 1.35e7,
           "decoded_bytes": 2.0e7}

    def read(name):
        return RN.metric_reader(name).read(ctx)

    assert read("encode_leg_ms") == pytest.approx(0.5)
    assert read("decode_leg_ms") == pytest.approx(1.5)
    assert read("assign_pack_roofline") == pytest.approx(100.0)  # 33.5 MB, 10 us
    assert read("decode2_roofline") == pytest.approx(50.0)        # 33.5 MB, 20 us
    assert read("inflate_records_roofline") == pytest.approx(1.0)
    assert read("device_idle_pct.codec") == pytest.approx(75.0)
    assert read("device_idle_pct.inflate") == pytest.approx(75.0)


def test_calls_rotate_round_the_pool():
    from portbench.harness import call_images, distinct_calls
    t = {"distinct_images": 32, "images_per_call": 128, "stride": 16}
    assert call_images(t, 0)[:3] == [0, 1, 2] and call_images(t, 0)[32] == 0
    assert call_images(t, 1)[:2] == [16, 17]
    assert call_images(t, 2) == call_images(t, 0)
    assert distinct_calls(t) == 2
    assert distinct_calls({"distinct_images": 16, "stride": 1}) == 16
    assert distinct_calls({"distinct_images": 32, "stride": 16}) == 2


# -- the reference ---------------------------------------------------------

def test_decode_table_reads_the_fixed_code():
    lit = [8] * 144 + [9] * 112 + [7] * 24 + [8] * 8
    tab = R.decode_table(lit)
    # Literal 0 is 00110000 (8 bits), sent MSB first: LSB-first peek 0b00001100.
    assert tab[0b00001100] >> 4 == 0 and tab[0b00001100] & 15 == 8
    # End of block, 256, is seven zero bits.
    assert tab[0] >> 4 == 256 and tab[0] & 15 == 7


@pytest.mark.parametrize("level", [0, 1, 6, 9])
def test_plain_inflater_reads_one_block_exactly(level):
    data = make_idat_corpus(1, 4096, seed=5)[0].tobytes()
    stream = zlib.compress(data, level)
    assert R.inflate_blocks(stream) == data == R.inflate(stream)


def test_plain_inflater_breaks_streams_of_several_blocks():
    data = make_idat_corpus(1, 1 << 18, seed=6)[0].tobytes()
    stream = zlib.compress(data, 6)
    got = R.inflate_blocks(stream)
    assert len(got) == len(data) and got != data


def test_frame_lays_out_rfc1950():
    words = np.array([0x01020304, 0x05060708], np.int64).astype(np.int32)
    assert R.frame(words, 48, 0x0A0B0C0D) == bytes(
        [4, 3, 2, 1, 8, 7, 0x0A, 0x0B, 0x0C, 0x0D])


# -- imports ---------------------------------------------------------------

def _imports(path: pathlib.Path) -> set[str]:
    tree = ast.parse(path.read_text())
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for f in ("reference.py", "corpus.py", "stats.py"):
        assert _imports(ROOT / "portbench" / f) <= {"__future__", "math",
                                                    "numpy", "zlib"}


def test_no_file_of_the_benchmark_names_jax_or_the_jax_package():
    for f in (ROOT / "portbench").rglob("*.py"):
        assert not _imports(f) & set(RN.FORBIDDEN), f


def test_a_run_loads_no_jax_module():
    code = ("import sys, torch, portbench.run as r\n"
            "for d in ('codec_roundtrip', 'inflate_batch'):\n"
            "    r.load_module(r.HERE / 'drivers' / f'{d}.py')\n"
            "print(r.forbidden_modules(), 'fdeflate_tpu_torch' in sys.modules)\n")
    out = subprocess.run([sys.executable, "-c", code], cwd=ROOT,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.split() == ["[]", "True"]


def test_forbidden_names_are_compared_whole(monkeypatch):
    monkeypatch.setitem(sys.modules, "fdeflate_tpu_torch_like", sys)
    assert "fdeflate_tpu" not in RN.forbidden_modules()
    monkeypatch.setitem(sys.modules, "bench", sys)
    assert RN.forbidden_modules() == ["bench"]


# -- dry runs --------------------------------------------------------------

SMALL = {"png_fast_idat": {"image_bytes": 1 << 14, "chunks": 8},
         "png_default_inflate": {"image_bytes": 1 << 13}}


def _small_spec(monkeypatch, bench_path, image_bytes=None):
    full = RN.cell_spec

    def spec(workload, _bench_path=None):
        s = full(workload, bench_path)
        cfg = dict(s["config"], **SMALL[s["config"]["name"]])
        if image_bytes:
            cfg["image_bytes"] = image_bytes
        tr = s["traffic"]
        s["config"] = cfg
        B = min(tr["images_per_call"], 4)
        s["traffic"] = dict(tr, images_per_call=B, stride=min(tr["stride"], B),
                            distinct_images=min(tr["distinct_images"], 8),
                            judged_samples=2, judged_rows=3)
        return s

    monkeypatch.setattr(RN, "cell_spec", spec)


def _dry_run(cell, *, fault=None, control=0, trace_on=0, seconds=0.5):
    buf = io.StringIO()
    rc = RN.run(["--workload", cell, "--seed", str(2 ** 33 + 17), "--seconds",
                 str(seconds), "--trace", str(trace_on), "--control",
                 str(control)], device=torch.device("cpu"), fault=fault,
                t_start=time.perf_counter(), out=buf)
    assert rc == 0
    return json.loads(buf.getvalue().strip().splitlines()[-1])


@pytest.mark.parametrize("cell", [CODEC_CELL, SINGLE_CELL])
def test_dry_run_is_correct(monkeypatch, with_codec, cell):
    _small_spec(monkeypatch, with_codec)
    res = _dry_run(cell)
    assert res["correct"] is True
    assert list(res)[:5] == ["correct", "attempted", "failed", "metrics", "device"]
    assert list(res)[-1] == "checks"
    assert res["attempted"] >= 1 and res["failed"] == 0
    spec = RN.cell_spec(cell, with_codec)
    assert set(res["metrics"]) == {m["name"] for m in spec["end_to_end"]}
    assert all(v["value"] > 0 for v in res["metrics"].values())


def test_traced_dry_run_gives_a_breakdown(monkeypatch, with_codec):
    _small_spec(monkeypatch, with_codec)
    res = _dry_run(CODEC_CELL, trace_on=1, seconds=0.2)
    assert res["correct"] is True
    assert set(res["breakdown"]) == {"device_ops", "idle_gaps"}
    assert res["device"]["window_s"] > 0
    # No device on the CPU: the device's metrics read nothing.
    assert set(res["metrics"]) <= {"encode_leg_ms", "decode_leg_ms"}


@pytest.mark.parametrize("cell", [CODEC_CELL, "idat6_inflate_batch16"])
@pytest.mark.parametrize("fault", ["stale", "half", "token"])
def test_a_broken_timed_path_is_not_correct(monkeypatch, with_codec, cell,
                                            fault):
    _small_spec(monkeypatch, with_codec)
    res = _dry_run(cell, fault=fault)
    assert res["correct"] is False
    assert any(c["value"] > c["limit"] for c in res["checks"].values())


def test_codec_control_is_not_correct(monkeypatch, with_codec):
    _small_spec(monkeypatch, with_codec)
    res = _dry_run(CODEC_CELL, control=1)
    assert res["correct"] is False
    assert res["checks"]["streams_not_inflating"]["value"] > 0


def test_inflate_control_is_not_correct(monkeypatch, with_codec):
    _small_spec(monkeypatch, with_codec, image_bytes=1 << 18)   # several blocks
    res = _dry_run(SINGLE_CELL, control=1)
    assert res["correct"] is False
    assert res["checks"]["answers_wrong"]["value"] > 0


def test_no_device_means_no_result(monkeypatch, capsys):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    buf = io.StringIO()
    rc = RN.run(["--workload", CELLS[0], "--seed", "1", "--seconds",
                 "1"], out=buf)
    assert rc != 0 and buf.getvalue() == ""


# -- on the card -----------------------------------------------------------

@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU")


@pytest.mark.cuda
@pytest.mark.parametrize("cell", CELLS)
def test_cell_is_correct_on_the_card(card, cell):
    out = subprocess.run(
        [sys.executable, "-m", "portbench.run", "--workload", cell, "--seed",
         str(2 ** 31 + 99), "--seconds", "2", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-4000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["correct"] is True and res["device"]["platform"] == "gpu"
