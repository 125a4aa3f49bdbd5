"""Readings that the limits of `limits/<workload>.json` are set from.

    python3 benchmark/calibrate.py --workload NAME --seeds S1,S2,... \
        [--controls K] [--units U]

For each seed, in one process: the port's object built as a run builds
it, and its readings beside the plain reference's (the lower readings);
for the first K seeds also the control, the reference in TF32 (the
nearest precision below the configurations' float32 with TF32 off) put
in the port's place, and each fault the runner plants in the reference
(the upper readings): each runner's `calibration`. Training cells also
print the three leaves with the widest gaps of the program's readings;
rank cells run U units of the timed path first. One JSON line a seed,
then a summary line: each number's largest program reading and the
smallest of each control or fault. Needs a card.
"""
from __future__ import annotations

import argparse
import sys
import time
from pathlib import Path

BENCH = Path(__file__).resolve().parent
sys.path[:0] = [str(BENCH), str(BENCH.parent)]

import torch  # noqa: E402

import harness  # noqa: E402
import run  # noqa: E402
from harness import free, precision  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--units", type=int, default=6)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("calibrate: no CUDA card", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    run.cache_dirs(run.ROOT)
    _, _, config, mix = run.cell(run.ROOT, args.workload)
    table = {}
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        clock = harness.SetupClock(device)
        with precision("f32", device):
            runner = run.runner_class(mix)(config, mix, seed, device, clock)
        got = runner.calibration(i < args.controls, args.units)
        del runner
        free(device)
        for kind, nums in got.items():
            if kind == "worst_leaves":
                continue
            for k, v in nums.items():
                table.setdefault(kind, {}).setdefault(k, []).append(v)
        harness.emit({"seed": seed, "seconds": time.perf_counter() - t0,
                      "parts": clock.parts, **got})
    summary = {k: max(v) for k, v in table["program"].items()}
    harness.emit({"workload": args.workload, "lower": summary,
                  "upper": {kind: {k: min(v) for k, v in nums.items()}
                            for kind, nums in table.items()
                            if kind != "program"},
                  "card": torch.cuda.get_device_name(device)})
    return 0


if __name__ == "__main__":
    sys.exit(main())
