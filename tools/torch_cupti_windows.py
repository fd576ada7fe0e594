"""Which events make ``torch.profiler`` windows lose the records of the
port's kernels on the card (``chip_smoke.py``'s ``measure``).

Each scenario runs in a process of its own (stderr kept beside its
JSON): a first round of profiled
windows, one event, then a second round.  A round is ``--reps`` pairs of
windows of ``chip_smoke``'s own kinds: one K1 call on the random 1e5
population and 10 Path A steps at 1e5 (30 K4 launches and the torch glue).
The events:

- ``none``: nothing (a long process: two rounds back to back);
- ``profiled_child``: ``chip_smoke.remeasure`` (one K4 step profiled in a
  fresh process, as ``chip_smoke.py`` [17] and its fallback do);
- ``cuda_child``: a fresh process that runs one K4 step on the card with
  no profiler (as the gloo ranks, the dry run's ranks and the bench's
  subprocesses do);
- ``busy_window``: one profiled window of 20,000 K1 launches (the
  profiler's buffers under load);
- ``resident``: one profiled window of a 72-step K5 launch (a cooperative
  launch, as [7]);
- ``events``: ``--reps`` turns of three events (a fresh process that only
  makes a CUDA context, ``nvidia-smi``, nothing), each followed by the two
  windows with the ``short`` lead (:func:`profiled`), without and with
  ``MARGIN_S`` of host time at each end of the window, in alternating
  order;
- ``leads``: the same turns, the windows with each of ``LEADS`` before the
  measured call: one short sleep kernel, one of ~20 ms, or 64 short ones.

For every window: the port's launches (the launch counters), its records
(``PORT_KERNELS`` by name), the device records of other kernels, the
runtime-API records of launches, the records of the sleep kernels that
bracket it, and whether a profiler was already on.  The windows of the
rounds take the ``short`` lead.
Run from the root of the repository, on the card:

    python3 tools/torch_cupti_windows.py --out results/cupti_windows.json

``--tally LOG ...`` prints the profiled windows of whole ``chip_smoke.py``
runs from their logs, anywhere.
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from pathlib import Path

REPO = Path(__file__).resolve().parents[1]
SCENARIOS = ("none", "cuda_child", "busy_window", "resident",
             "profiled_child", "events", "leads")
EVENTS = ("cuda_context", "nvidia_smi", "nothing")
MARGIN_S = 0.1
LEADS = ("short", "spin", "many")
SPIN_CYCLES = 40_000_000   # ~20 ms at the H100's clocks
MANY = 64
BUSY_LAUNCHES = 20_000
CHILD_TIMEOUT_S = 300


def profiled(fn, lead: str = "short", margin_s: float = 0.0):
    """``chip_smoke.profiled`` with a chosen lead before ``fn``: ``short``
    (one 1000-cycle sleep kernel), ``spin`` (one sleep kernel of
    ``SPIN_CYCLES``), ``many`` (``MANY`` 1000-cycle sleep kernels, as
    ``chip_smoke.LEAD_KERNELS``); and ``margin_s`` of host time at each end
    of the window."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        time.sleep(margin_s)
        for _ in range(MANY if lead == "many" else 1):
            torch.cuda._sleep(SPIN_CYCLES if lead == "spin" else 1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        time.sleep(margin_s)
    return prof, wall


def window(cs, fn, args, n_steps, lead="short", margin_s=0.0):
    """One profiled call of ``fn(*args)`` (:func:`profiled`): what was
    launched and what the profiler recorded, and where the device records
    lie against the launches' host records (µs; ``None`` where a side has
    none)."""
    import torch

    already = torch.autograd.profiler._is_profiler_enabled
    before = cs.port_launches()
    prof, wall = profiled(lambda: fn(*args), lead, margin_s)
    launched = cs.port_launches() - before
    dev = cs.device_events(prof)
    port = [e for e in dev if any(p in e.name for p in cs.PORT_KERNELS)]
    cuda = torch.autograd.DeviceType.CUDA
    every_dev = [e for e in prof.events() if e.device_type == cuda]
    launch = [e for e in prof.events() if e.device_type != cuda
              and "aunch" in e.name]
    api = {}
    for e in launch:
        api[e.name] = api.get(e.name, 0) + 1
    first = lambda evs: min(e.time_range.start for e in evs) if evs else None
    last = lambda evs: max(e.time_range.end for e in evs) if evs else None
    gap = lambda a, b: None if a is None or b is None else a - b
    return {"launched": launched, "recorded": len(port),
            "other_device_records": len(dev) - len(port),
            "sleep_records": len(every_dev) - len(dev),
            "launch_api_records": api, "profiler_was_on": bool(already),
            "first_device_after_first_launch_us":
                gap(first(every_dev), first(launch)),
            "last_device_after_last_launch_us":
                gap(last(every_dev), last(launch)),
            "lead": lead, "margin_s": margin_s,
            "wall_ms_per_step": wall * 1e3 / n_steps}


def scenario(name: str, reps: int) -> dict:
    import torch

    sys.path.insert(0, str(REPO))
    import chip_smoke as cs
    from msgwam_tpu_torch.ops import projection_cuda

    torch.backends.cuda.matmul.allow_tf32 = False
    cs._build.library()
    device = torch.device("cuda")
    k1_args = cs.deposit_population(cs.N_MAIN, device)
    work = projection_cuda.scratch(cs.N_MAIN, k1_args[5].shape[0] - 1, device)
    cfg, bg, state, statics = cs.bench_setup(cs.N_MAIN, device,
                                             window_cells=-1)
    cs.k1_call(k1_args, work)
    cs.timed_simulate(state, statics, bg, cfg, 2)
    torch.cuda.synchronize()

    def one_round():
        out = []
        for _ in range(reps):
            out.append({"kind": "K1",
                        **window(cs, cs.k1_call, (k1_args, work), 1)})
            out.append({"kind": "PathA10", **window(
                cs, cs.timed_simulate, (state, statics, bg, cfg, 10), 10)})
        return out

    if name in ("events", "leads"):
        variants = ([("short", 0.0), ("short", MARGIN_S)] if name == "events"
                    else [(lead, 0.0) for lead in LEADS])
        return {"scenario": name, "windows": events_round(
            cs, reps, (k1_args, work), (state, statics, bg, cfg, 10),
            variants)}
    res = {"scenario": name, "first": one_round()}
    t0 = time.perf_counter()
    if name == "profiled_child":
        child = cs.remeasure(cs.k4_step, (state, statics, bg, cfg), 1)
        res["event"] = {k: child[k] for k in ("launched", "recorded")}
    elif name == "cuda_child":
        code = ("import sys, torch; sys.path.insert(0, %r); import chip_smoke "
                "as cs; cs._build.library(); d = torch.device('cuda'); "
                "cfg, bg, s, st = cs.bench_setup(cs.N_MAIN, d, "
                "window_cells=-1); cs.k4_step(s, st, bg, cfg); "
                "torch.cuda.synchronize()" % str(REPO))
        p = subprocess.run([sys.executable, "-c", code], capture_output=True,
                           text=True, timeout=CHILD_TIMEOUT_S)
        res["event"] = {"returncode": p.returncode, "stderr": p.stderr[-500:]}
    elif name == "busy_window":
        res["event"] = window(cs, busy_k1, (cs, k1_args, work), BUSY_LAUNCHES)
    elif name == "resident":
        res["event"] = window(cs, cs.timed_resident,
                              (state, statics, bg, cfg, 72, 72), 72)
    res["event_s"] = time.perf_counter() - t0
    res["second"] = one_round()
    return res


def events_round(cs, reps, k1, path_a, variants):
    """``reps`` times each of ``EVENTS``, in turn: after each, the K1 and
    Path A windows with each of ``variants`` (``(lead, margin_s)`` of
    :func:`profiled`), their order rotated from one turn to the next."""
    out = []
    for i in range(reps):
        for event in EVENTS:
            if event == "cuda_context":
                subprocess.run([sys.executable, "-c", "import torch; "
                                "torch.zeros(1, device='cuda'); "
                                "torch.cuda.synchronize()"], check=True,
                               timeout=CHILD_TIMEOUT_S)
            elif event == "nvidia_smi":
                cs.nvidia_smi()
            k = i % len(variants)
            for lead, margin in variants[k:] + variants[:k]:
                for kind, fn, args, n in (("K1", cs.k1_call, k1, 1),
                                          ("PathA10", cs.timed_simulate,
                                           path_a, 10)):
                    out.append({"rep": i, "event": event, "kind": kind,
                                **window(cs, fn, args, n, lead, margin)})
    return out


def busy_k1(cs, k1_args, work):
    for _ in range(BUSY_LAUNCHES):
        cs.k1_call(k1_args, work)


def summary(res: dict) -> dict:
    if "windows" in res:
        out = {}
        for w in res["windows"]:
            key = f"{w['event']}, lead {w['lead']}, margin {w['margin_s']} s"
            o = out.setdefault(key, {"windows": 0, "lost_windows": 0,
                                     "launched": 0, "recorded": 0})
            o["windows"] += 1
            o["lost_windows"] += w["recorded"] < w["launched"]
            o["launched"] += w["launched"]
            o["recorded"] += w["recorded"]
        return out
    out = {}
    for part in ("first", "second"):
        ws = res[part]
        lost = [w for w in ws if w["recorded"] < w["launched"]]
        out[part] = {"windows": len(ws), "lost_windows": len(lost),
                     "launched": sum(w["launched"] for w in ws),
                     "recorded": sum(w["recorded"] for w in ws),
                     "lost": [(w["kind"], w["recorded"], w["launched"])
                              for w in lost]}
    return out


def tally(logs) -> dict:
    """Every profiled window of whole ``chip_smoke.py`` runs, from the
    ``profiler_windows`` of each log's ``[9] details`` line: recorded /
    launched, the lead's lost records (where the run counted them) and
    whether the window was measured again."""
    out = {}
    for log in logs:
        text = Path(log).read_text()
        details = [ln for ln in text.splitlines()
                   if ln.startswith("[9] details ")]
        if not details:
            out[log] = {"details": None, "ok": '"ok": true' in text}
            continue
        windows = json.loads(details[-1][len("[9] details "):])[
            "profiler_windows"]
        out[log] = {"ok": '"ok": true' in text, "windows": [
            [w["label"], w["recorded"], w["launched"], w.get("sleeps_lost"),
             "remeasured" in w] for w in windows]}
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--scenario", choices=SCENARIOS,
                    help="run one scenario in this process (a child)")
    ap.add_argument("--scenarios", default=",".join(SCENARIOS + ("none",)),
                    help="in order, each in a fresh process (the last "
                         "'none' shows whether an earlier one's effect "
                         "outlives its process)")
    ap.add_argument("--reps", type=int, default=10)
    ap.add_argument("--out", default="results/cupti_windows.json")
    ap.add_argument("--tally", nargs="+", metavar="LOG",
                    help="print the profiled windows of these chip_smoke.py "
                         "logs and exit")
    args = ap.parse_args(argv)
    if args.tally:
        print(json.dumps(tally(args.tally), indent=1))
        return 0
    out = Path(args.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    if args.scenario:
        out.write_text(json.dumps(scenario(args.scenario, args.reps)))
        return 0
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    results = {"card": smi}
    for i, name in enumerate(args.scenarios.split(",")):
        key = f"{i}_{name}"
        part = out.with_name(f"{out.stem}_{key}.json")
        t0 = time.perf_counter()
        p = subprocess.run(
            [sys.executable, __file__, "--scenario", name, "--reps",
             str(args.reps), "--out", str(part)], capture_output=True,
            text=True, timeout=20 * CHILD_TIMEOUT_S)
        part.with_suffix(".err").write_text(p.stderr)
        if p.returncode:
            results[key] = {"returncode": p.returncode,
                            "stderr": p.stderr[-3000:]}
        else:
            res = json.loads(part.read_text())
            results[key] = {**summary(res), "event": res.get("event"),
                            "seconds": time.perf_counter() - t0}
        print(key, json.dumps(results[key]), flush=True)
    out.write_text(json.dumps(results, indent=1))
    print(f"card: {smi}")
    return 0


if __name__ == "__main__":
    sys.exit(main())
