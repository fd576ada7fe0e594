"""The readings that the limits of ``correct`` are set from, on the card:

    python -m portbench.calibrate --workload <cell> --seeds 1-12 \\
        --control-seeds 1-3 --seconds 2

For each seed, in one process: the cell's inputs, its warm-up request and
``--seconds`` of its traffic, then the judged numbers of the program's
sampled answers (the lower readings) and, for the control seeds, of the
control's answers to the same inputs (the reference in bfloat16: the upper
readings).  One JSON line a seed; the benchmark's own runs never run the
control.
"""

from __future__ import annotations

import argparse
import gc
import json
import time
from pathlib import Path

import torch

from . import check, manifest, run, traffic


def seeds(text: str) -> list:
    out = []
    for part in text.split(","):
        lo, _, hi = part.partition("-")
        out.extend(range(int(lo), int(hi or lo) + 1))
    return out


def readings(cell, seed: int, seconds: float, control: bool, device) -> dict:
    s = traffic.setup(cell.config, seed, device)
    driver = traffic.Driver(s, cell.traffic, seed)
    with torch.no_grad():
        driver.request(0, keep=False)
        driver.reset()
        durations, answers, items, window_s = run.serve(driver, seconds)
    failed = run.failed_requests(answers)
    driver.close()
    del driver, answers
    gc.collect()
    t0 = time.perf_counter()
    profiles = cell.limits["profiles"]
    out = {"seed": seed, "requests": len(durations), "failed": failed,
           "items": len(items),
           "program": check.judge(items, s, profiles=profiles)}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    out["reference_s"] = time.perf_counter() - t0
    if profiles != "all":
        # the gaps of every judged answer, for the record
        out["program_every_launch"] = check.judge(items, s)
    if control:
        out["control"] = check.judge(items, s, control=True, profiles=profiles)
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python -m portbench.calibrate")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", default="1-12")
    ap.add_argument("--control-seeds", default="1-3")
    ap.add_argument("--seconds", type=float, default=2.0)
    args = ap.parse_args(argv)
    cell = manifest.load(Path.cwd(), args.workload)
    if not torch.cuda.is_available():
        raise SystemExit("portbench.calibrate: no CUDA device")
    device = torch.device("cuda", 0)
    ctrl = set(seeds(args.control_seeds))
    for seed in sorted(set(seeds(args.seeds)) | ctrl):
        print(json.dumps(readings(cell, seed, args.seconds, seed in ctrl, device)),
              flush=True)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
