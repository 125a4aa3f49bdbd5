"""The benchmark of the PyTorch port (`madrigal_tpu_torch`) on NVIDIA GPUs.

    python3 benchmark/run.py --workload NAME --seed N --seconds S --trace 0|1

run from the root of a checkout. It reads the cell NAME of
`BENCHMARK.json`, its configuration (`configs/<config>.json` under the
file the entry names) and its traffic mix (`traffic/<mix>.json`, whose
`runner` names the general runner `runners/<runner>.py`), makes every
input from the seed, builds the port's object for the cell (set-up,
printed by part), then with --trace 0 runs its timed path for S seconds
and reports
the cell's end-to-end metrics; with --trace 1 it runs the mix's
`trace_units` units once untraced (their seconds are what the MFU
metrics divide by) and once under torch.profiler, and reports the
per-layer metrics, each read by `metrics/<metric>.py`. Either way the port's state
is then freed and the plain reference (`reference/`) decides `correct`
against the limits of `limits/<workload>.json`.

Standard output: the set-up's parts, the kernels' launch counts and the
card on earlier lines; last, one JSON line with `correct`, `attempted`,
`failed`, `metrics`, `device` (and with --trace 1 `breakdown`), and
`checks`, each compared number beside its limit, which also end standard
error. It exits 2 without a result when no card is present or fewer than
the cell asks for, and 3 when a module of JAX, flax or the JAX package
(`madrigal_tpu`) was loaded. Kernel builds and compiler caches stay
under `build/` in the checkout; traces go to TMPDIR.
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
for p in (str(BENCH), str(ROOT)):
    if p not in sys.path:
        sys.path.insert(0, p)

import torch  # noqa: E402

import harness  # noqa: E402
from harness import precision  # noqa: E402


def cache_dirs(root: Path) -> None:
    """Every compiler cache at a fixed path inside the checkout."""
    for var, sub in (("TRITON_CACHE_DIR", "triton"),
                     ("TORCHINDUCTOR_CACHE_DIR", "inductor"),
                     ("CUDA_CACHE_PATH", "cuda")):
        os.environ[var] = str(root / "build" / "cache" / sub)


def parse(argv):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    return ap.parse_args(argv)


def cell(root: Path, name: str) -> tuple:
    """(BENCHMARK.json, the cell's entry, its configuration, its mix)."""
    with open(root / "BENCHMARK.json") as f:
        bench = json.load(f)
    work = {w["name"]: w for w in bench["workloads"]}[name]
    entry = {c["name"]: c for c in bench["configs"]}[work["config"]]
    with open(root / entry["file"]) as f:
        config = json.load(f)
    with open(BENCH / "traffic" / f"{work['traffic']}.json") as f:
        mix = json.load(f)
    return bench, work, config, mix


def metric_names(bench: dict, work: dict, key: str) -> list:
    """The `key` ('end_to_end' or 'per_layer') metrics the cell reports:
    those listing it, and those with no list whose moved metric it
    reports."""
    e2e = metric_names(bench, work, "end_to_end") if key == "per_layer" \
        else None
    out = []
    for m in bench[key]:
        if "workloads" in m:
            if work["name"] in m["workloads"]:
                out.append(m["name"])
        elif key == "end_to_end" or m["moves"] in e2e:
            out.append(m["name"])
    return out


def load(kind: str, name: str):
    """The module `<kind>/<name>.py` of the benchmark's folder."""
    spec = importlib.util.spec_from_file_location(
        f"bench_{kind}_" + name.replace(".", "_").replace("-", "_"),
        BENCH / kind / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def runner_class(mix: dict):
    """The class `Runner` of the mix's runner, `runners/<runner>.py`. A
    runner is built as Runner(config, mix, seed, device, clock) in
    set-up and offers unit() and traced_unit() (one unit of the timed
    path), attempted(units), end_to_end(units, seconds), free_program(),
    checks(limits), layer_context(units, trace) and calibration(control,
    units)."""
    return load("runners", mix["runner"]).Runner


def read_metric(name: str, ctx):
    return load("metrics", name).read(ctx)


def card_line(device) -> dict:
    if torch.device(device).type != "cuda":
        return {"card": "cpu"}
    try:
        res = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30)
        smi = res.stdout.strip().splitlines()[:1]
    except (OSError, subprocess.SubprocessError) as e:
        smi = [f"nvidia-smi: {e}"]
    return {"card": torch.cuda.get_device_name(device), "nvidia_smi": smi}


def launches() -> dict:
    from madrigal_tpu_torch.ops import bilinear, segment_sorted

    return {"bilinear_scores": bilinear.bilinear_scores.launches,
            "sorted_segment_sum": segment_sorted.sorted_segment_sum.launches}


def timed_window(runner, seconds: float, units: int = 0) -> tuple:
    """(units, seconds): units of the timed path until `seconds` have
    passed, the last one finished; or, with `units`, that many."""
    harness.sync(runner.device)
    t0 = time.perf_counter()
    done = 0
    while True:
        runner.unit()
        done += 1
        if (done >= units if units
                else time.perf_counter() - t0 >= seconds):
            break
    harness.sync(runner.device)
    return done, time.perf_counter() - t0


def traced_window(runner, units: int, trace_path: Path) -> tuple:
    """(seconds, Trace) of `units` units under the profiler, inside the
    span harness.WINDOW_SPAN."""
    with harness.profiled(runner.device, trace_path):
        harness.sync(runner.device)
        t0 = time.perf_counter()
        with torch.profiler.record_function(harness.WINDOW_SPAN):
            for _ in range(units):
                runner.traced_unit()
            harness.sync(runner.device)
        seconds = time.perf_counter() - t0
    trace = harness.Trace.from_file(trace_path)
    trace_path.unlink()
    return seconds, trace


def run(argv=None, device=None, root: Path = ROOT, limits=None) -> dict:
    """One run; returns the result line's object. `device` None is the
    command's run (a card is required); tests pass the CPU, a small
    BENCHMARK.json `root` and `limits`."""
    args = parse(argv)
    bench, work, config, mix = cell(root, args.workload)
    if device is None:
        if (not torch.cuda.is_available()
                or torch.cuda.device_count() < work["chips"]):
            raise SystemExit(2)
        device = torch.device("cuda", 0)
        cache_dirs(root)
    if limits is None:
        limits = harness.load_limits(BENCH, args.workload)
    clock = harness.SetupClock(device)
    with precision("f32", device):
        runner = runner_class(mix)(config, mix, args.seed, device, clock)
    setup_s = clock.total()
    harness.emit({"setup_s": setup_s, "parts": clock.parts})
    if torch.device(device).type == "cuda":
        set_up_peak = torch.cuda.max_memory_allocated(device)
        torch.cuda.reset_peak_memory_stats(device)
    else:
        set_up_peak = 0

    with precision("f32", device):
        if args.trace:
            # the same units untimed by the profiler first: the rates of
            # the model's operations are taken over them
            units, untraced_s = timed_window(runner, 0.0,
                                             mix["trace_units"])
            path = Path(tempfile.gettempdir()) / (
                f"bench_{args.workload}_{os.getpid()}.json")
            seconds, trace = traced_window(runner, units, path)
        else:
            units, seconds = timed_window(runner, args.seconds)
    values = runner.end_to_end(units, seconds)
    peak = (max(set_up_peak, torch.cuda.max_memory_allocated(device))
            if torch.device(device).type == "cuda" else 0)
    harness.emit({"launches": launches(), "units": units,
                  "window_s": seconds, **card_line(device)})
    runner.free_program()
    t0 = time.perf_counter()
    checks = runner.checks(limits)
    harness.emit({"reference_s": time.perf_counter() - t0})

    dev = {"platform": "gpu" if torch.device(device).type == "cuda"
           else "cpu",
           "kind": (torch.cuda.get_device_name(device)
                    if torch.device(device).type == "cuda" else "cpu"),
           "count": work["chips"], "memory_peak_bytes": int(peak)}
    done = runner.attempted(units)  # steps or outcomes
    out = {"correct": all(c.ok for c in checks), "attempted": done,
           "failed": sum(not c.ok for c in checks)}
    if args.trace:
        ops = trace.window_ops()
        ctx = harness.LayerContext(
            units=done, window_s=seconds, untraced_s=untraced_s,
            busy_s=trace.busy_us(ops) / 1e6, ops=ops,
            **runner.layer_context(units, trace))
        unit = {m["name"]: m["unit"] for m in bench["per_layer"]}
        metrics = {}
        for name in metric_names(bench, work, "per_layer"):
            v = read_metric(name, ctx)
            if v is not None:
                metrics[name] = {"value": v, "unit": unit[name]}
        dev.update(busy_s=ctx.busy_s, window_s=seconds)
        out.update(metrics=metrics, device=dev,
                   breakdown=trace.breakdown(ops))
    else:
        units_of = {m["name"]: m["unit"] for m in bench["end_to_end"]}
        values["setup_s"] = setup_s
        out.update(metrics={k: {"value": values[k], "unit": units_of[k]}
                            for k in metric_names(bench, work,
                                                  "end_to_end")},
                   device=dev)
    out["checks"] = {c.name: {"value": c.value, "limit": c.limit}
                     for c in checks}
    return out


def main(argv=None) -> int:
    try:
        out = run(argv)
    except SystemExit as e:
        if e.code == 2:
            print("benchmark: no CUDA card, or fewer than the cell asks "
                  "for: no result", file=sys.stderr)
        raise
    found = harness.forbidden_modules()
    if found:
        print(f"benchmark: forbidden modules loaded: {found}",
              file=sys.stderr)
        return 3
    harness.emit(out)
    for name, c in out["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})",
              file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
