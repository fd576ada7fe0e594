"""One run of one benchmark cell:

    python -m portbench --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout.  A fresh process builds the port's kernels
(or finds them built in the checkout), makes the cell's inputs from the
seed on the card, serves one warm-up request, then serves requests for
``--seconds`` seconds (a closed loop, one client), and prints one JSON
line last: ``correct``, ``attempted``, ``failed``, ``metrics``, ``device``
and, with ``--trace 1``, ``breakdown``, then ``checks``: each judged
number beside its limit, which are also the last lines on standard error.

With ``--trace 0`` the metrics are the cell's end-to-end metrics; with
``--trace 1`` its per-layer metrics, read from a traced window of fixed
length after the measured one.  Without a card, or with fewer cards than
the cell asks for, the run fails and prints no result; it never falls
back to the CPU.  It also fails if JAX or the JAX package was loaded.
"""

from __future__ import annotations

import argparse
import gc
import json
import os
import subprocess
import sys
import time
from pathlib import Path
from types import SimpleNamespace

import torch

from . import check, manifest, trace, traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "msgwam_tpu")


def process_start() -> float:
    """The wall-clock time at which this process started (``/proc``),
    or now where that cannot be read."""
    try:
        ticks = os.sysconf("SC_CLK_TCK")
        start = int(Path("/proc/self/stat").read_text().rsplit(")", 1)[1].split()[19])
        uptime = float(Path("/proc/uptime").read_text().split()[0])
        return time.time() - (uptime - start / ticks)
    except (OSError, ValueError, IndexError):
        return time.time()


def forbidden_modules() -> list:
    """Loaded modules whose top-level name is JAX's or the JAX
    package's, compared whole."""
    return sorted({name.split(".")[0] for name in sys.modules
                   if name.split(".")[0] in FORBIDDEN})


def card(device) -> dict:
    """The card's name, count and power limit as ``nvidia-smi`` reads
    them."""
    name = torch.cuda.get_device_name(device)
    try:
        out = subprocess.run(
            ["nvidia-smi", "-i", str(device.index or 0),
             "--query-gpu=power.limit", "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
        limit = out.stdout.strip().splitlines()[0]
    except (OSError, subprocess.SubprocessError, IndexError):
        limit = "not measured"
    return {"kind": name, "power_limit": limit}


def covered_cells(s, rays_list) -> float:
    """Mean covered cells per active ray over ``rays_list`` of
    ``(r, active)``, each flattened over the members of a member-stacked
    configuration."""
    from .roofline import covered_cells as cc

    dz = float(s.bg.centers[1] - s.bg.centers[0])
    n = s.bg.centers.shape[0]
    dr = s.state0.rays.dr.double().flatten()
    vals = [cc(r.to(dr.device).double().flatten(), dr,
               act.to(dr.device).flatten(), dz, n)
            for r, act in rays_list]
    return sum(vals) / len(vals)


def serve(driver, seconds: float):
    """Requests until ``seconds`` have passed: ``(durations, answers,
    judged items, window seconds)``.  The caller's check of each request
    (:meth:`.traffic.Driver.verify`) runs between requests, outside the
    window's time."""
    durations, answers, items = [], [], []
    t_start = time.perf_counter()
    paused = 0.0
    i = 0
    while True:
        t0 = time.perf_counter()
        ans = driver.request(i)
        t1 = time.perf_counter()
        durations.append(t1 - t0)
        window_s = t1 - t_start - paused
        ans = driver.verify(ans)
        paused += time.perf_counter() - t1
        answers.append(ans)
        items.extend(ans.items)
        i += 1
        if window_s >= seconds:
            break
    return durations, answers, items, window_s


def failed_requests(answers) -> int:
    """Requests whose host copy holds a non-finite value, or whose files
    the caller's read-back found short."""
    return sum(1 for a in answers
               if a.failed or not bool(torch.isfinite(a.host).all()))


def run_cell(cell: manifest.Cell, seed: int, seconds: float, want_trace: bool,
             device, t_process: float, bench_dir: Path = manifest.HERE) -> dict:
    """The result line of one run of ``cell`` as a dict, ``checks`` last."""
    if device.type == "cuda":
        from msgwam_tpu_torch import _build

        _build.library()
    s = traffic.setup(cell.config, seed, device)
    driver = traffic.Driver(s, cell.traffic, seed)
    with torch.no_grad():
        driver.request(0, keep=False)           # the warm-up request
        driver.reset()
        if device.type == "cuda":
            torch.cuda.synchronize(device)
        t_first = time.time()
        durations, answers, items, window_s = serve(driver, seconds)
        failed = failed_requests(answers)
        n_req = len(durations)
        ctx = SimpleNamespace(
            cell=cell, setup=s, driver=driver, slots=s.state0.rays.r.numel(),
            setup_s=t_first - t_process, window_s=window_s, durations=durations,
            requests=n_req, window_steps=n_req * driver.steps, trace=None)
        breakdown = None
        if want_trace:
            n_trace = int(cell.traffic["trace_requests"])
            first = n_req

            def traced():
                for j in range(first, first + n_trace):
                    driver.request(j, keep=False)

            in_state = driver.state
            window = trace.profiled(traced)
            if driver.kind == "whole_run":
                hist = driver.last
                frames = [(s.state0.rays.r, s.statics0.active)] + [
                    (hist[3][f], hist[5][f]) for f in range(hist[3].shape[0])]
            elif driver.kind == "cli_run":
                # the last traced request's frames, as read back
                frames = ([(s.state0.rays.r, s.statics0.active)]
                          + driver.cli.covered_frames())
            else:
                frames = [(in_state.rays.r, s.statics0.active),
                          (driver.state.rays.r, driver.statics.active)]
            ctx.trace = window
            ctx.trace_requests = n_trace
            ctx.trace_steps = n_trace * driver.steps
            ctx.cells = covered_cells(s, frames)
            # the program's frames: active rays a frame
            ctx.active_rays = sum(float(act.sum()) for _, act in frames[1:]) / (
                len(frames) - 1)
            del frames
            breakdown = {"device_ops": trace.top_ops(window.device),
                         "idle_gaps": trace.top_gaps(window)}
    metrics_of = cell.per_layer if want_trace else cell.end_to_end
    metrics = {}
    for m in metrics_of:
        value = manifest.reader(m["name"], bench_dir)(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    if device.type == "cuda":
        torch.cuda.synchronize(device)
        peak = torch.cuda.max_memory_allocated(device)
    else:
        peak = 0
    dev = {"platform": "gpu" if device.type == "cuda" else device.type,
           "count": cell.chips, "memory_peak_bytes": int(peak)}
    if device.type == "cuda":
        info = card(device)
        dev["kind"] = info["kind"]
        dev["power_limit"] = info["power_limit"]
    if ctx.trace is not None:
        dev["busy_s"] = trace.busy_s(ctx.trace.device)
        dev["window_s"] = ctx.trace.wall_s
        dev["sleeps_lost"] = ctx.trace.sleeps_lost
    # the program's state is freed before the reference runs
    driver.close()
    del ctx, driver, answers
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = check.judge(items, s, profiles=cell.limits["profiles"])
    correct, rows = check.verdict(numbers, cell.limits["limits"])
    result = {"correct": bool(correct and failed == 0), "attempted": n_req,
              "failed": failed, "metrics": metrics, "device": dev}
    if breakdown is not None:
        result["breakdown"] = breakdown
    result["checks"] = {name: {"value": value, "limit": limit}
                        for name, value, limit in rows}
    result["checks"]["failed_requests"] = {"value": failed, "limit": 0}
    return result


def main(argv=None, t_process=None) -> int:
    t_process = process_start() if t_process is None else t_process
    ap = argparse.ArgumentParser(prog="python -m portbench")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    cell = manifest.load(Path.cwd(), args.workload)
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell.chips:
        have = torch.cuda.device_count() if torch.cuda.is_available() else 0
        print(f"portbench: {args.workload} needs {cell.chips} CUDA device(s), "
              f"found {have}", file=sys.stderr)
        return 2
    device = torch.device("cuda", 0)
    result = run_cell(cell, args.seed, args.seconds, bool(args.trace), device,
                      t_process)
    bad = forbidden_modules()
    if bad:
        print(f"portbench: the run loaded {', '.join(bad)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(result), flush=True)
    return 0
