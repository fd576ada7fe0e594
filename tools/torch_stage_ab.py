#!/usr/bin/env python3
"""Times the per-stage kernels of ``msgwam_tpu_torch`` (K2, K3, K4) and the
Path A day, or with ``--k1`` the deposit kernel K1, from one or more
checkouts on one GPU, in turns.

    python3 tools/torch_stage_ab.py NAME=PATH [NAME=PATH ...] [--k1]
                                    [--order a,b,b,a] [--out FILE]

Each ``NAME=PATH`` is the root of a checkout whose ``msgwam_tpu_torch`` is
timed; ``--order`` lists the names in the order their runs go (default:
each once, as given).  Every run is a subprocess of its own with ``PATH``
first on ``sys.path``, so two versions of the package never share a
process; each builds its kernels into its own ``_build/``.  A run
measures, on the bench population (``chip_smoke.py``'s ``bench_setup``),
at 1e5 and 1e6 rays, on the launch state and on the state after a Path A
day (720 steps):

* K2, K3 and K4 (a later stage) device time per launch: CUDA events
  around ``ITERS`` launches enqueued behind a sleep kernel, ``N_SAMPLES``
  samples; a launch is whatever the checkout's ``launch`` enqueues (the
  kernel and, before the redesign, its reduce kernel);
* the device time of one whole Path A step (``rk3_step_fused_windowed``,
  glue included), the same way;
* the Path A day (``simulate``, 720 steps) on the host clock, three times
  at 1e5 and once at 1e6;
* a ``torch.profiler`` view of 10 Path A steps at 1e5: device operations,
  busy time and idle share per step, and the host's time by operator
  (self CPU time, the 12 largest).

With ``--k1`` a run times one K1 call (``projection_cuda.launch``) the same
way on the populations of ``chip_smoke.py`` (this file's checkout's): the
random population at 1e5 and 1e6 rays, the bench population's deposit at
launch at 1e5 and 1e6 and after a Path A day at 1e6, rays 5-40 km tall at
1e6 and a 1024-cell grid at 1e5, and two that split the call's cost: the
random population at 1e6 with every ray masked (the loads, the staging and
the tail, no walk) and one 256-ray tile (the floor of a launch and its
tail); and, from ``torch.profiler`` over
``ITERS`` calls, the device time per call of each kernel a call launches
(before the redesign: the deposit and its reduce kernel).

Prints one JSON line per run, each with the card's ``nvidia-smi`` name and
power limit, and with ``--out`` writes them all to ``FILE`` as one JSON
object.
"""

from __future__ import annotations

import importlib.util
import inspect
import json
import os
import subprocess
import sys
import time
from pathlib import Path

N_SAMPLES = 5
ITERS = 20            # launches per sample
DT = 120.0
DAY = 720
SIZES = (100_000, 1_000_000)


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def samples(fn):
    """Device ms per call of ``fn``: events around ITERS calls behind a
    sleep kernel, so that they time the device and not the host."""
    import torch

    for _ in range(3):
        fn()
    out = []
    for _ in range(N_SAMPLES):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(50_000_000)
        a.record()
        for _ in range(ITERS):
            fn()
        b.record()
        torch.cuda.synchronize()
        out.append(a.elapsed_time(b) / ITERS)
    return out


def kernel_us(fn) -> dict:
    """Device µs per call of ``fn`` of each kernel it launches, by name,
    from ``torch.profiler`` over ITERS calls."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(ITERS):
            fn()
        torch.cuda.synchronize()
    out = {}
    for e in prof.events():
        if e.device_type == torch.autograd.DeviceType.CUDA:
            out[e.name] = out.get(e.name, 0.0) + e.time_range.elapsed_us() / ITERS
    return out


def worker_k1() -> dict:
    import torch

    import msgwam_tpu_torch as mtt
    from msgwam_tpu_torch import _build
    from msgwam_tpu_torch.ops import projection_cuda

    spec = importlib.util.spec_from_file_location(
        "chip_smoke", Path(__file__).resolve().parents[1] / "chip_smoke.py")
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    res = {"build_s": time.perf_counter() - t0}
    log = _build.library_path().with_suffix(".log").read_text()
    part = log.split("== projection.cu")[-1].split("==")[0]
    res["ptxas"] = [x.strip() for x in part.splitlines()
                    if "registers" in x or "spill" in x]
    small, large = SIZES
    pops = {f"random_{n}": lambda n=n: smoke.deposit_population(n, dev)
            for n in SIZES}
    pops[f"wide_spans_{large}"] = lambda: smoke.deposit_population(
        large, dev, extent=(5e3, 40e3))
    pops[f"cells1024_{small}"] = lambda: smoke.deposit_population(
        small, dev, n_cells=1024)

    def masked(n):
        """Every ray masked: the loads, the staging and the tail, no walk."""
        args = smoke.deposit_population(n, dev)
        return (*args[:4], torch.zeros_like(args[4]), args[5])

    pops[f"masked_{large}"] = lambda: masked(large)
    pops["one_tile_256"] = lambda: smoke.deposit_population(256, dev)

    def bench(n, day=False):
        cfg, bg, state, statics = smoke.bench_setup(n, dev, window_cells=-1)
        if day:
            state, _, _ = mtt.simulate(state, statics, bg, cfg, mtt.RunConfig(
                dt=DT, n_steps=DAY, save_every=DAY))
        return smoke.k1_inputs(state, statics, bg, cfg)

    for n in SIZES:
        pops[f"bench_launch_{n}"] = lambda n=n: bench(n)
    pops[f"path_a_day_{large}"] = lambda: bench(large, day=True)
    for name, make in pops.items():
        args = make()
        res[f"k1_{name}_ms"] = samples(lambda: projection_cuda.launch(*args))
        res[f"k1_{name}_kernels_us"] = kernel_us(lambda: projection_cuda.launch(*args))
        del args
        torch.cuda.empty_cache()
    return res


def worker() -> dict:
    import torch
    from torch.profiler import ProfilerActivity, profile

    import msgwam_tpu_torch as mtt
    from msgwam_tpu_torch import _build
    from msgwam_tpu_torch.ops import ray_physics, rhs_cuda, rhs_cuda_windowed

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    res = {"build_s": time.perf_counter() - t0}
    log = _build.library_path().with_suffix(".log").read_text()
    part = log.split("== rhs_windowed.cu")[-1].split("==")[0]
    res["ptxas"] = [x.strip() for x in part.splitlines() if "registers" in x]
    redesigned = "inp" in inspect.signature(rhs_cuda.launch).parameters

    def setup(n):
        cfg = mtt.REFERENCE_RUN_CONFIG.replace(
            saturate_online=True, dtype="float32", rhs_backend="pallas",
            window_cells=-1)
        gc = mtt.GridConfig()
        uu = mtt.velocities_sine_homogeneous(
            torch.tensor(gc.centers(), dtype=torch.float32), cfg)
        bg = mtt.make_background(gc, cfg, uu, torch.zeros_like(uu),
                                 dtype=torch.float32, device=dev)
        rays, statics = mtt.gaussian_spectrum_source(
            cfg, bg, n, dtype=torch.float32, device=dev, z_launch=2000.0,
            dz_launch=500.0, amplitude_alpha=0.003)
        state = mtt.State(rays, mtt.MeanState(uu.to(dev),
                                              torch.zeros_like(uu).to(dev)))
        return cfg, bg, state, statics

    def kernels(cfg, bg, state, statics):
        """Launch closures for K2, K3 and a later K4 stage."""
        stage = ray_physics.RK3_STAGES[1]
        fields = rhs_cuda.ray_fields(state, statics)
        outs = tuple(torch.empty_like(fields[0]) for _ in range(3))
        q = tuple(torch.zeros_like(fields[0]) for _ in range(3))
        c0 = cfg.replace(window_cells=0)
        if redesigned:
            inp = rhs_cuda.inputs(DT, state, statics, bg, cfg)
            u, v = state.mean
            n_tab = bg.centers.shape[0]
            wind = tuple(torch.zeros((4, n_tab), device=dev).unbind(0))
            work = rhs_cuda.scratch(fields[0].shape[0], n_tab, dev)
            return {
                "k2": lambda: rhs_cuda.launch(inp, u, v, work),
                "k3": lambda: rhs_cuda_windowed.launch(inp, u, v, work=work),
                "k4": lambda: rhs_cuda_windowed.launch(
                    inp, u, v, fields, outs, q, wind, stage, work=work)}
        params, scalars, tables = rhs_cuda.prepare_inputs(DT, state, statics,
                                                          bg, cfg)
        window = rhs_cuda_windowed.window_for(cfg, bg.centers.shape[0])
        base = (params, scalars, tables, fields, statics.active)
        return {
            "k2": lambda: rhs_cuda.launch(*base, c0.saturate_online,
                                          c0.faithful_saturation),
            "k3": lambda: rhs_cuda_windowed.launch(
                *base, window, cfg.saturate_online, cfg.faithful_saturation),
            "k4": lambda: rhs_cuda_windowed.launch(
                *base, window, cfg.saturate_online, cfg.faithful_saturation,
                outs=outs, q=q, stage=stage)}

    def simulate(state, statics, bg, cfg, n_steps):
        run = mtt.RunConfig(dt=DT, n_steps=n_steps, save_every=n_steps)
        torch.cuda.synchronize()
        t = time.perf_counter()
        final, _, _ = mtt.simulate(state, statics, bg, cfg, run)
        torch.cuda.synchronize()
        return final, time.perf_counter() - t

    for n in (100_000, 1_000_000):
        cfg, bg, state, statics = setup(n)
        simulate(state, statics, bg, cfg, 3)
        days = []
        for _ in range(3 if n == 100_000 else 1):
            spread, wall = simulate(state, statics, bg, cfg, DAY)
            days.append(wall)
        res[f"path_a_day_s_{n}"] = days
        for label, st in (("launch", state), ("spread", spread)):
            for name, fn in kernels(cfg, bg, st, statics).items():
                res[f"{name}_{n}_{label}_ms"] = samples(fn)
            res[f"k4_step_{n}_{label}_ms"] = samples(
                lambda: rhs_cuda_windowed.rk3_step_fused_windowed(
                    DT, st, statics, bg, cfg))
        if n == 100_000:
            run = mtt.RunConfig(dt=DT, n_steps=10, save_every=10)
            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CPU,
                                     ProfilerActivity.CUDA]) as prof:
                t = time.perf_counter()
                mtt.simulate(state, statics, bg, cfg, run)
                torch.cuda.synchronize()
                wall = time.perf_counter() - t
            dev_ev = [e for e in prof.events()
                      if e.device_type == torch.autograd.DeviceType.CUDA]
            busy = sum(e.time_range.elapsed_us() for e in dev_ev) / 1e3
            res["profile_10_steps"] = {
                "wall_ms_per_step": wall * 100, "device_ops_per_step": len(dev_ev) / 10,
                "device_busy_ms_per_step": busy / 10,
                "idle_share": max(0.0, 1.0 - busy / (wall * 1e3))}
            top = sorted(prof.key_averages(), key=lambda e: -e.self_cpu_time_total)
            res["host_top_ops_us_per_step"] = [
                (e.key, e.count / 10, e.self_cpu_time_total / 10) for e in top[:12]]
        del cfg, bg, state, statics, spread
        torch.cuda.empty_cache()
    return res


def main(argv) -> int:
    if argv[:1] in (["--worker"], ["--worker-k1"]):
        sys.path.insert(0, os.path.abspath(argv[1]))
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("torch_stage_ab: no CUDA device")
        print(json.dumps(worker_k1() if argv[0] == "--worker-k1" else worker()),
              flush=True)
        return 0
    mode = "--worker"
    if "--k1" in argv:
        argv = [a for a in argv if a != "--k1"]
        mode = "--worker-k1"
    order, out_file = None, None
    if "--order" in argv:
        i = argv.index("--order")
        order = argv[i + 1].split(",")
        argv = argv[:i] + argv[i + 2:]
    if "--out" in argv:
        i = argv.index("--out")
        out_file = argv[i + 1]
        argv = argv[:i] + argv[i + 2:]
    paths = dict(a.split("=", 1) for a in argv)
    order = order or list(paths)
    smi = _smi()
    runs = []
    for name in order:
        out = subprocess.run(
            [sys.executable, os.path.abspath(__file__), mode,
             os.path.abspath(paths[name])],
            capture_output=True, text=True, cwd=os.path.abspath(paths[name]))
        if out.returncode:
            sys.stderr.write(out.stdout[-4000:] + out.stderr[-8000:])
            raise SystemExit(f"run {name} failed ({out.returncode})")
        res = {"name": name, "smi": smi,
               **json.loads(out.stdout.strip().splitlines()[-1])}
        print(json.dumps(res), flush=True)
        runs.append(res)
    if out_file:
        os.makedirs(os.path.dirname(os.path.abspath(out_file)), exist_ok=True)
        with open(out_file, "w") as f:
            json.dump({"smi": smi, "runs": runs}, f, indent=1)
    print(smi)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
