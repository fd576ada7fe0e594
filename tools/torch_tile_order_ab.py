#!/usr/bin/env python3
"""Times K5's whole run (``simulate_resident``) of one or more checkouts on
one GPU, in turns, with K5's tile order on and off where a checkout has it.

    python3 tools/torch_tile_order_ab.py NAME=PATH [NAME=PATH ...]
                                         [--order a,b,b,a] [--out FILE]

Each ``NAME=PATH`` is the root of a checkout; every run is a subprocess of
its own with ``PATH`` first on ``sys.path``.  A run measures:

* a simulated day (720 steps) at ``N_RAYS`` rays in launches of each of
  ``SAVE_EVERY`` steps, on the bench population (m linspaced) and on a
  keyed one (m drawn at random), host clock, the best of ``REPS`` after a
  warm-up, with the time the call takes to return (the host's enqueue);
  where the checkout has ``step_cuda.ORDER_MIN_STEPS`` and
  ``ORDER_MIN_RAYS``, once with the order forced on and once off;
* where it has ``step_cuda.tile_order``, the order's own device time a
  launch (key, sort, the gather of the stacked slab and the scatter back,
  as ``step_cuda.whole_run`` makes them; CUDA events behind a sleep
  kernel) and its host time, at each of ``N_RAYS``;
* ``python -m msgwam_tpu_torch run --preset fast --kernels mega`` in
  process (72 launches of 10 steps at 1e5), the best of ``REPS`` after a
  warm-up.

Prints one JSON line per run with the card's ``nvidia-smi`` name and power
limit; ``--out`` writes them all to ``FILE``.
"""

from __future__ import annotations

import json
import os
import subprocess
import sys
import tempfile
import time

N_RAYS = (100_000, 300_000, 1_000_000)
SAVE_EVERY = (1, 3, 10, 24, 72)
DAY = 720
REPS = 3
DT = 120.0


def _smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def worker() -> dict:
    import torch

    import msgwam_tpu_torch as mtt
    from msgwam_tpu_torch import _build, cli
    from msgwam_tpu_torch.ops import step_cuda

    dev = torch.device("cuda")
    _build.library()
    has_order = hasattr(step_cuda, "ORDER_MIN_STEPS")
    default = (getattr(step_cuda, "ORDER_MIN_STEPS", None),
               getattr(step_cuda, "ORDER_MIN_RAYS", None))

    def force(steps, rays):
        step_cuda.ORDER_MIN_STEPS, step_cuda.ORDER_MIN_RAYS = steps, rays

    def setup(n, keyed):
        cfg = mtt.REFERENCE_RUN_CONFIG.replace(
            saturate_online=True, dtype="float32", rhs_backend="pallas",
            window_cells=-1)
        gc = mtt.GridConfig()
        centers = torch.tensor(gc.centers(), dtype=torch.float32)
        uu = mtt.velocities_sine_homogeneous(centers, cfg)
        bg = mtt.make_background(gc, cfg, uu, torch.zeros_like(uu),
                                 dtype=torch.float32, device=dev)
        key = torch.Generator(device=dev).manual_seed(n + 1) if keyed else None
        rays, statics = mtt.gaussian_spectrum_source(
            cfg, bg, n, dtype=torch.float32, device=dev, z_launch=2000.0,
            dz_launch=500.0, amplitude_alpha=0.003, key=key)
        state = mtt.State(rays, mtt.MeanState(uu.to(dev),
                                              torch.zeros_like(uu).to(dev)))
        return cfg, bg, state, statics

    def day(args, save):
        run = mtt.RunConfig(dt=DT, n_steps=DAY, save_every=save)
        mtt.simulate_resident(*args, run)
        walls, hosts = [], []
        for _ in range(REPS):
            torch.cuda.synchronize()
            t = time.perf_counter()
            mtt.simulate_resident(*args, run)
            hosts.append(time.perf_counter() - t)
            torch.cuda.synchronize()
            walls.append(time.perf_counter() - t)
        return {"wall_s": min(walls), "host_s": min(hosts)}

    modes = ({"on": (0, 0), "off": (0, 1 << 62)} if has_order
             else {"parent": None})
    res = {"days": []}
    for n in N_RAYS:
        for keyed in (False, True):
            cfg, bg, state, statics = setup(n, keyed)
            for save in SAVE_EVERY:
                for mode, value in modes.items():
                    if value is not None:
                        force(*value)
                    res["days"].append({"n": n, "keyed": keyed, "save_every": save,
                                        "mode": mode,
                                        **day((state, statics, bg, cfg), save)})
    if has_order:
        force(0, 1 << 62)
        res["order"] = {}
        for n in N_RAYS:
            cfg, bg, state, statics = setup(n, True)
            ops = step_cuda.operands(state, statics, bg, cfg, DT)
            rays = state.rays
            slab = torch.stack([x.to(torch.float32) for x in (
                rays.dens, rays.r, rays.m, statics.active, *ops.frozen)])

            def once():
                order = step_cuda.tile_order(ops, slab[1], slab[2], ops.active)
                cur = slab.index_select(1, order)
                out = torch.cat([cur[:4], cur[:1]])
                out = torch.empty_like(out).index_copy_(1, order, out)
                slab[:4].copy_(out[:4])
                return out

            reps = 20
            dev_ms, host_ms = [], []
            for i in range(4):
                a = torch.cuda.Event(enable_timing=True)
                b = torch.cuda.Event(enable_timing=True)
                torch.cuda.synchronize()
                torch.cuda._sleep(200_000_000)
                a.record()
                t = time.perf_counter()
                for _ in range(reps):
                    once()
                host = time.perf_counter() - t
                b.record()
                torch.cuda.synchronize()
                if i:
                    dev_ms.append(a.elapsed_time(b) / reps)
                    host_ms.append(host * 1e3 / reps)
            res["order"][str(n)] = {"device_ms": dev_ms, "host_ms": host_ms}

    def cli_fast():
        walls = []
        with tempfile.TemporaryDirectory() as tmp:
            argv = ["run", "--preset", "fast", "--kernels", "mega",
                    "--no-plot", "--out", tmp]
            for i in range(REPS + 1):
                torch.cuda.synchronize()
                t = time.perf_counter()
                cli.main(argv)
                torch.cuda.synchronize()
                if i:
                    walls.append(time.perf_counter() - t)
        return walls

    if has_order:
        force(*default)
        res["order_min_steps_rays"] = default
    res["cli_fast_s"] = cli_fast()
    if has_order:
        force(0, 0)
        res["cli_fast_forced_order_s"] = cli_fast()
    return res


def main(argv) -> int:
    if argv[:1] == ["--worker"]:
        sys.path.insert(0, os.path.abspath(argv[1]))
        import torch

        if not torch.cuda.is_available():
            raise SystemExit("torch_tile_order_ab: no CUDA device")
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
