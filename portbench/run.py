"""Run one cell of ``BENCHMARK.json`` and print its result.

    python -m portbench.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``fdeflate_tpu_torch``.  The cell
names a configuration and a traffic mix; the configuration's file names
its driver (``portbench/drivers/<driver>.py``), whose ``Cell`` makes the
inputs from the seed, warms up every shape it will use (set-up), runs one
closed-loop step at a time for ``--seconds`` (the window), and after the
window judges what the timed steps produced against the plain reference.
With ``--trace 1`` the window (at most ``TRACE_WINDOW_S``) runs under
``torch.profiler`` and the cell's per-layer metrics are read from the
trace and the driver's counts by ``portbench/metrics/<metric>.py``.

The last line of standard output is one JSON object: ``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each number compared, with its
limit), which are also the last lines of standard error.  The run exits
with another code than 0 and prints no result when there is no CUDA
device, or when a module of JAX or of the JAX package is loaded.
``--control 1`` runs the cell's control (a guarantee broken; see the
drivers), which has to come out not correct.
"""

from __future__ import annotations

import time

_T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib.util  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import pathlib  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

ROOT = pathlib.Path(__file__).resolve().parent.parent
HERE = ROOT / "portbench"
FORBIDDEN = ("jax", "jaxlib", "flax", "fdeflate_tpu", "bench")
TRACE_WINDOW_S = 3.0


def _pin_caches() -> None:
    """Every cache a run may write lies at a fixed path in the checkout
    (the port's kernels build into ``build/fdeflate_tpu_torch``; the
    driver's JIT cache goes here)."""
    os.environ["CUDA_CACHE_PATH"] = str(ROOT / "build" / "portbench" / "nv")


def load_module(path: pathlib.Path):
    """A module of the benchmark found by file name (names may hold dots)."""
    if not path.is_file():
        raise FileNotFoundError(f"no such file: {path}")
    name = f"portbench.{path.parent.name}.{path.stem.replace('.', '_')}"
    spec = importlib.util.spec_from_file_location(name, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def metric_reader(name: str):
    """The reader of per-layer metric ``name``: ``metrics/<name>.py``, or,
    for a metric split by the cells it serves (``device_idle_pct.inflate``),
    the reader of its base name, ``metrics/device_idle_pct.py``."""
    path = HERE / "metrics" / f"{name}.py"
    if not path.is_file():
        path = HERE / "metrics" / f"{name.split('.')[0]}.py"
    return load_module(path)


def cell_spec(workload: str, bench_path: pathlib.Path | None = None) -> dict:
    """Everything ``BENCHMARK.json`` and the cell's files say about
    ``workload``: the cell, its configuration file's content, its traffic
    file's content, and the end-to-end and per-layer metrics it reports."""
    bench = json.loads((bench_path or ROOT / "BENCHMARK.json").read_text())
    cells = {w["name"]: w for w in bench["workloads"]}
    if workload not in cells:
        raise KeyError(f"no workload {workload!r} in BENCHMARK.json")
    cell = cells[workload]
    entry = {c["name"]: c for c in bench["configs"]}[cell["config"]]

    def reports(m):
        return workload in m.get("workloads", [workload])

    return {
        "cell": cell,
        "config": json.loads((ROOT / entry["file"]).read_text()),
        "traffic": json.loads(
            (HERE / "traffic" / f"{cell['traffic']}.json").read_text()),
        "end_to_end": [m for m in bench["end_to_end"] if reports(m)],
        "per_layer": [m for m in bench["per_layer"] if reports(m)],
    }


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is JAX's or the JAX package's."""
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(FORBIDDEN))


def _device_info(torch, device) -> dict:
    if device.type != "cuda":
        return {"platform": "cpu", "kind": "cpu", "count": 1,
                "memory_peak_bytes": 0}
    return {"platform": "gpu", "kind": torch.cuda.get_device_name(device),
            "count": 1,
            "memory_peak_bytes": int(torch.cuda.max_memory_allocated(device))}


def _power_limit() -> str | None:
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=20)
    except (OSError, subprocess.TimeoutExpired):
        return None
    return res.stdout.strip().splitlines()[0] if res.stdout.strip() else None


def parse_args(argv):
    p = argparse.ArgumentParser(prog="python -m portbench.run")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    p.add_argument("--control", type=int, choices=(0, 1), default=0)
    return p.parse_args(argv)


def run(argv=None, *, device=None, fault: str | None = None,
        t_start: float | None = None, out=None) -> int:
    """One run; returns the exit code.  ``device`` set (a test) skips the
    look for a CUDA device; ``fault`` breaks the timed path (a test)."""
    out = out or sys.stdout
    t_start = _T_START if t_start is None else t_start
    args = parse_args(argv)
    _pin_caches()
    import torch

    torch.set_num_threads(1)   # one caller: no idle CPU pool beside it

    from . import stats, trace

    def progress(what):
        print(f"portbench: {what} at {time.perf_counter() - t_start:.3f} s",
              file=sys.stderr)

    progress("torch imported")

    spec = cell_spec(args.workload)
    if device is None:
        want = spec["cell"]["chips"]
        if not torch.cuda.is_available() or torch.cuda.device_count() < want:
            print(f"portbench: needs {want} CUDA device(s); found "
                  f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 2
        device = torch.device("cuda", 0)
        torch.cuda.set_device(device)
        torch.empty(1, device=device)
        progress("CUDA context made")
    driver = load_module(HERE / "drivers" / f"{spec['config']['driver']}.py")
    cell = driver.Cell(spec["config"], spec["traffic"], args.seed, device,
                       trace=bool(args.trace), control=bool(args.control),
                       fault=fault)
    progress("inputs made")
    cell.warm()
    from .harness import synchronize
    synchronize(device)
    setup_s = time.perf_counter() - t_start
    print(f"portbench: {args.workload} seed {args.seed}: set-up {setup_s:.3f} s",
          file=sys.stderr)

    seconds = min(args.seconds, TRACE_WINDOW_S) if args.trace else args.seconds

    step_s: list[float] = []

    def window():
        i = 0
        t0 = t = time.perf_counter()
        deadline = t0 + seconds
        while True:
            cell.step(i)
            i += 1
            now = time.perf_counter()
            step_s.append(now - t)
            t = now
            if now >= deadline:
                return now - t0

    result_metrics, extra = {}, {}
    if args.trace:
        from torch.profiler import ProfilerActivity, profile, record_function
        acts = [ProfilerActivity.CPU]
        if device.type == "cuda":
            acts.append(ProfilerActivity.CUDA)
        with profile(activities=acts) as prof:
            with record_function("window"):
                window()
        dev_ev, host_ev = trace.timelines(prof)
        del prof
        lo, hi = next((s, t) for n, s, t in host_ev if n == "window")
        busy = stats.busy_seconds([(s, t) for _n, s, t in dev_ev], lo, hi)
        ctx = {"device_ops": dev_ev, "busy_s": busy, "window_s": hi - lo,
               **cell.layer_counts()}
        for m in spec["per_layer"]:
            value = metric_reader(m["name"]).read(ctx)
            if value is not None:
                result_metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra = {"busy_s": busy, "window_s": hi - lo}
        breakdown = {"device_ops": trace.top_ops(dev_ev),
                     "idle_gaps": trace.idle_gaps(dev_ev, host_ev, lo, hi)}
        del dev_ev, host_ev, ctx
    else:
        window_s = window()
        e2e = cell.end_to_end(window_s)
        for m in spec["end_to_end"]:
            if m["name"] == "setup_s":
                result_metrics["setup_s"] = {"value": setup_s, "unit": "s"}
            elif m["name"] in e2e:
                value, unit = e2e[m["name"]]
                result_metrics[m["name"]] = {"value": value, "unit": unit}
    q = [stats.percentile(step_s, p) * 1e3 for p in (5, 25, 50, 75, 95, 100)]
    print(f"portbench: {len(step_s)} steps, ms p5/25/50/75/95/max "
          + " ".join(f"{x:.3f}" for x in q), file=sys.stderr)
    device_info = {**_device_info(torch, device), **extra}
    attempted, failed = cell.work()

    cell.release()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    checks = cell.check()
    correct = all(v <= limit for _n, v, limit in checks)

    found = forbidden_modules()
    if found:
        print(f"portbench: loaded in this process: {', '.join(found)}",
              file=sys.stderr)
        return 3
    if device.type == "cuda":
        limit = _power_limit()
        if limit:
            device_info["power"] = limit
    result = {"correct": correct, "attempted": attempted, "failed": failed,
              "metrics": result_metrics, "device": device_info}
    if args.trace:
        result["breakdown"] = breakdown
    result["checks"] = {n: {"value": v, "limit": limit}
                        for n, v, limit in checks}
    for n, v, limit in checks:
        print(f"check {n} {v} limit {limit}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), file=out, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(run())
