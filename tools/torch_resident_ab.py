#!/usr/bin/env python3
"""Times the whole-run kernel of ``msgwam_tpu_torch`` (K5, K6, K7) from one
or more checkouts on one GPU, in turns.

    python3 tools/torch_resident_ab.py NAME=PATH [NAME=PATH ...] [--order a,b,b,a]
                                       [--out FILE]

Each ``NAME=PATH`` is the root of a checkout whose ``msgwam_tpu_torch``
is timed; ``--order`` lists the names in the order their runs go (default:
each once, as given).  Every run is a subprocess of its own with ``PATH``
first on ``sys.path``, so two versions of the package never share a
process; each builds its kernels into its own ``_build/``.  A run measures,
on the bench population (``chip_smoke.py``'s ``bench_setup``):

* K5 device time per step (CUDA events around one launch of ``STEPS``
  steps, enqueued behind a sleep kernel, the state restored before each
  sample) at 1e5 and 1e6 rays, with
  ``prognostic_mean`` on and off, on the launch state and on the state
  after 720 steps;
* the Path B day (``simulate_resident``, 720 steps, ``save_every=72``) at
  1e5, host clock;
* K6 per step on configs[3] (lifecycle, tidal wind, no prognostic mean);
* K7 per step and the Path E day on configs[4] (8 x 125,000 rays).

Prints one JSON line per run, each with the card's ``nvidia-smi`` name and
power limit, and with ``--out`` writes them all to ``FILE`` as one JSON
object.
"""

from __future__ import annotations

import json
import math
import os
import subprocess
import sys
import time

N_SAMPLES = 5
STEPS = 10            # steps per timed launch
DT = 120.0
DAY = 720


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def worker() -> dict:
    import torch

    import msgwam_tpu_torch as mtt
    from msgwam_tpu_torch import _build
    from msgwam_tpu_torch.ops import step_cuda, step_cuda_stream
    from msgwam_tpu_torch.parallel import ensemble_simulate, stack_ensemble
    from msgwam_tpu_torch.state import tree_map

    dev = torch.device("cuda")
    t0 = time.perf_counter()
    _build.library()
    build_s = time.perf_counter() - t0

    def setup(n, **kw):
        cfg = mtt.REFERENCE_RUN_CONFIG.replace(**{
            "saturate_online": True, "dtype": "float32", "rhs_backend": "pallas",
            "window_cells": -1, **kw})
        gc = mtt.GridConfig()
        centers = torch.tensor(gc.centers(), dtype=torch.float32)
        uu = mtt.velocities_sine_homogeneous(centers, cfg)
        bg = mtt.make_background(gc, cfg, uu, torch.zeros_like(uu),
                                 dtype=torch.float32, device=dev)
        rays, statics = mtt.gaussian_spectrum_source(
            cfg, bg, n, dtype=torch.float32, device=dev, z_launch=2000.0,
            dz_launch=500.0, amplitude_alpha=0.003)
        state = mtt.State(rays, mtt.MeanState(uu.to(dev), torch.zeros_like(uu).to(dev)))
        return cfg, bg, state, statics

    def samples(fn, init):
        """Device ms of ``fn(work)`` per sample, ``work`` restored from
        ``init`` (untimed) before each; each sample's events are enqueued
        behind a sleep kernel, so that they time the device and not the
        host's launch overhead."""
        work = [x.clone() for x in init]
        out = []
        for i in range(N_SAMPLES + 1):
            for w, x in zip(work, init):
                w.copy_(x)
            a = torch.cuda.Event(enable_timing=True)
            b = torch.cuda.Event(enable_timing=True)
            torch.cuda.synchronize()
            torch.cuda._sleep(20_000_000)       # ~10 ms at H100 clocks
            a.record()
            fn(work)
            b.record()
            torch.cuda.synchronize()
            if i:                               # the first is a warm-up
                out.append(a.elapsed_time(b))
        return out

    log = _build.library_path().with_suffix(".log").read_text()
    part = log.split("== step_resident.cu")[-1].split("==")[0]
    res = {"build_s": build_s,
           "ptxas": [x.strip() for x in part.splitlines() if "spill" in x
                     or "registers" in x]}
    for n in (100_000, 1_000_000):
        cfg, bg, state, statics = setup(n)
        ops = step_cuda.operands(state, statics, bg, cfg, DT)
        init = [state.rays.dens, state.rays.r, state.rays.m,
                torch.stack([state.mean.u, state.mean.v])]
        act = statics.active.to(torch.uint8)
        spread = [x.clone() for x in init]
        for _ in range(DAY // 72):
            step_cuda.launch(ops, *spread, act, 72)
        torch.cuda.synchronize()
        for label, st in (("launch", init), ("spread", spread)):
            for prog in (True, False):
                o = ops._replace(prognostic=prog)
                ms = samples(lambda w: step_cuda.launch(o, *w, act, STEPS), st)
                res[f"k5_{n}_{label}_prog{int(prog)}_ms_per_step"] = [
                    x / STEPS for x in ms]

    cfg, bg, state, statics = setup(100_000)
    run = mtt.RunConfig(dt=DT, n_steps=DAY, save_every=72)
    mtt.simulate_resident(state, statics, bg, cfg,
                          mtt.RunConfig(dt=DT, n_steps=2, save_every=1))
    days = []
    for _ in range(3):
        torch.cuda.synchronize()
        t = time.perf_counter()
        mtt.simulate_resident(state, statics, bg, cfg, run)
        torch.cuda.synchronize()
        days.append(time.perf_counter() - t)
    res["path_b_day_s"] = days

    # K6 on configs[3]: lifecycle, tidal wind, no prognostic mean
    cfg3, bg3, s3, st3 = setup(100_000, window_cells=24, cull=True, relaunch=True,
                               m_max=2.0 * math.pi / 300.0, prognostic_mean=False)
    centers = torch.tensor(mtt.GridConfig().centers(), dtype=torch.float32,
                           device=dev)
    wind = lambda t: (mtt.tidal_shear(centers, t.to(dev), cfg3),
                      torch.zeros_like(centers))
    ops3 = step_cuda.operands(s3, st3, bg3, cfg3, DT)
    src = step_cuda_stream._template((s3.rays, st3), s3.rays.r)
    life = step_cuda_stream.lifecycle_for(bg3, cfg3, (*src[:3], src[3].bool()))
    table = step_cuda_stream._wind_table(wind, 0.0, 0, STEPS, DT,
                                         bg3.centers.shape[0], dev)
    init3 = [s3.rays.dens, s3.rays.r, s3.rays.m,
             torch.stack([s3.mean.u, s3.mean.v])[None].contiguous(),
             st3.active.to(torch.uint8)]
    res["k6_ms_per_step"] = [x / STEPS for x in samples(
        lambda w: step_cuda.launch(ops3, *w, STEPS, 1, life, table, stream=True),
        init3)]

    # K7 on configs[4]: 8 x 125,000, prognostic mean, no lifecycle
    cfg4, bg4, s4, st4 = setup(125_000, window_cells=24)
    states, statics4 = stack_ensemble([(s4, st4)] * 8)
    flat = lambda tree: tree_map(torch.flatten, tree)
    fstate = mtt.State(flat(states.rays), mtt.MeanState(s4.mean.u, s4.mean.v))
    fstat = flat(statics4)
    ops4 = step_cuda.operands(fstate, fstat, bg4, cfg4, DT)
    init4 = [fstate.rays.dens, fstate.rays.r, fstate.rays.m,
             torch.stack([states.mean.u, states.mean.v], dim=1).contiguous(),
             fstat.active.to(torch.uint8)]
    res["k7_ms_per_step"] = [x / STEPS for x in samples(
        lambda w: step_cuda.launch(ops4, *w, STEPS, n_members=8, stream=True),
        init4)]
    ensemble_simulate(states, statics4, bg4, cfg4,
                      mtt.RunConfig(dt=DT, n_steps=2, save_every=1), backend="mega")
    days = []
    for _ in range(2):
        torch.cuda.synchronize()
        t = time.perf_counter()
        ensemble_simulate(states, statics4, bg4, cfg4, run, backend="mega")
        torch.cuda.synchronize()
        days.append(time.perf_counter() - t)
    res["path_e_day_s"] = days
    return res


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        sys.path.insert(0, os.path.abspath(argv[1]))
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("torch_resident_ab: no CUDA device")
        print(json.dumps(worker()), flush=True)
        return 0
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
            [sys.executable, os.path.abspath(__file__), "--worker",
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
