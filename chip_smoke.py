#!/usr/bin/env python3
"""Smoke run of msgwam_tpu_torch on one NVIDIA GPU (the H100 it targets).

    python3 chip_smoke.py

Builds the CUDA kernels from ``msgwam_tpu_torch/csrc`` (nvcc, at first
use), then, in order:

0. prints the device (``torch.cuda.get_device_name`` and ``nvidia-smi``'s
   name and power limit) and turns TF32 off for matmuls and cuDNN;
1. prints the build time and the compiler's register/spill report;
2. K1 (flux deposit) against its plain twin on the random population at
   1e5 and 1e6 rays, on rays 5-40 km tall at 1e6 (binned walks of long
   spans) and on a 1024-cell grid at 1e5 (the widest shared-memory tier);
   on the bench population at launch (phase 8) and on Path A's state after
   a day at 1e6 (after phase 6): error relative to the maximum against the
   float32 twin (bar 2e-5) and the float64 twin (bar 1e-6), bitwise
   equality of two launches, one device kernel per call
   (``torch.profiler``), the block plan against its mirror
   (``ray_physics.project_plan``), and the device time of kernel and twin;
3. K2 (fused RHS, the per-stage template with the window compiled out)
   against its twin on the bench population (gaussian source at 2 km,
   online saturation, float32) at 1e5 and 1e6 rays, each output within
   2e-5 of the twin's maximum, the flux within 1e-6 of the float64 twin,
   bitwise equality of two launches, the block plan against its mirror
   (``ray_physics.stage_plan``), times; and again on the states after a
   day (the K2 day's at 1e5, Path A's at 1e6);
4. K3 (windowed fused RHS) the same way at 1e5 and 1e6, and on a mixed
   population (tiles 5, 30 and 90 km tall, ``window_cells=16,
   window_cells2=48``) whose tiles take the first window, the second tier
   and the full width: the tier of every tile as the twin's, the flux
   within 1e-6 of the float64 twin, and K3's outputs bitwise K2's;
5. the K2 day: ``simulate`` with ``rhs_backend="pallas", window_cells=0``
   at 1e5 rays for 720 steps (one simulated day at dt = 120 s): exactly
   3 x 720 K2 launches, a finite final state, device operations per step
   (``torch.profiler``), the first 5 steps against the plain torch path,
   and ray-steps/s and ``sim_day_wall_s`` of both paths; then K2 against
   its twin again on the spread-out final state;
6. Path A, the default fused step: ``simulate`` with
   ``rhs_backend="pallas"`` and the default ``window_cells`` at 1e5 and
   1e6 rays for 720 steps each: exactly 3 x 720 K4 launches and none of
   K2 or K3, the window mirror's fallback share at the start and the end
   of the day; at 1e5 at most 6 device operations per step
   (``torch.profiler`` over 10 steps), one device kernel per K4 launch,
   the first 5 steps against the plain path, and 3 rk4 steps through K3,
   4 launches a step; at both sizes, on the launch state and after the
   day, K4 against its twin over one step (rays and wind) and over one
   later-stage launch (y', q' and the wind's u, v, qu, qv from the
   kernel's tail), bitwise repeats, and the device time of one launch and
   of one step;
7. Path B, ``simulate_resident`` at 1e5 rays for 720 steps with
   ``save_every=72``: exactly 10 K5 launches, a finite final state, K5
   against its twin and against Path A over 9 steps (online and offline,
   3e-5), one step's wind increment within 1e-6 of the float64 plain path,
   two runs bitwise equal, times; K5's device time per step in 10-step
   launches at 1e5 and 1e6 rays, on the launch state and after a day, with
   the prognostic wind and without (the difference is what the flux's
   deposit, reduce and grid-wide wait cost), and its block plan against the
   Python mirror with the share of tiles held on chip; K5 at 2e6 rays (past
   the on-chip capacity) against its twin over 3 steps; then 1e6 rays for
   20 steps through ``simulate_resident``;
8. K1 on its route: 5 steps with ``rhs_backend="xla",
   projection_backend="pallas"`` at 1e5 rays: 15 K1 launches, within 1e-4
   of the dense ``mxu`` path; then K1 (as in 2) on what the route deposits
   at launch, at 1e5 and 1e6 rays;
10. Path D, ``BASELINE.json`` ``configs[3]`` (``benchmarks/run.py:403-418``):
   ``simulate_resident`` with cull, relaunch, ``m_max = 2 pi/300``, a tidal
   ``wind_fn`` and ``prognostic_mean=False`` at 1e5 rays for 720 steps
   with ``save_every=72``: exactly 10 K6 launches and no other kernel, the
   culls and relaunches of the day (nonzero), K6 against its twin over 9
   steps (3e-5, masks equal; also at ``m_max = pi/1500``, where culls fire
   in those steps, with relaunch and without), K6 with the
   lifecycle off bitwise K5, the day's wall against Path C (``simulate``
   with the lifecycle, K4) and Path B (K5, no lifecycle), a profile, and
   K6's device time per step in 10-step launches;
11. the launch sort at 1e6 rays over the Path D day: sorted and unsorted
   runs in turns, bitwise the same rays, both day walls;
12. Path E, ``configs[4]`` (``benchmarks/run.py:420-434``): 8 members of
   125,000 rays in one K7 launch per 72 steps over a day: exactly 10 K7
   launches, members 0 and 7 of a perturbed ensemble within 1e-5 of their
   own K6 runs over 9 steps, K7 against its twin over 3 steps, the day's
   wall against 8 sequential K6 days, and K7's device time per step in
   10-step launches;
13. the adjoint, in float32 on the bench population: the gradient of
   sum((u_final - u0)^2) in a density scale and its derivative along a
   seeded per-ray direction through the K2 route (1e5 rays, 3 steps),
   Path A (K4, 1e5 rays, 20 steps), Path B (K5, 1e5 rays, 20 steps with
   ``save_every=10``) and Path E (K7, 2 x 50,000 rays, 10 steps), each
   finite, nonzero, within 5e-4 of the plain route's (``rhs_backend=
   "xla"``, mxu backends), with the kernels launched as the forward needs
   and no more; Path A with ``remat`` False, True and ``"full"`` at 1e5
   rays over 100 steps (the forward bitwise the same, the gradient within
   1e-6) and with ``"full"`` at 1e6 rays over 20 steps, each with its
   forward and backward wall time and ``torch.cuda.max_memory_allocated``;
   and K1 and K6 refusing an input that needs a gradient;
14. the driver, ``msgwam_tpu_torch.cli.main(["run", ...])`` in-process on
   the card with ``--no-plot`` into a temporary directory: the ``fast``
   preset (1e5 rays, 720 steps, float32) with ``--kernels mxu`` (the plain
   route), ``pallas`` (exactly 3 x 720 K2 launches), ``windowed`` (3 x 720
   K4) and ``mega`` (72 K5), each kernel route's first saved frame (step
   10) of flux and wave action within 1e-4 of the plain route's, no
   fallback printed, and the same spec in float64 on ``--kernels xla`` as
   the oracle of each route's day-end flux (reported); ``mega`` for 360
   steps and ``--resume`` for 360 more, bitwise the 720-step run;
   ``examples/config4.json`` as written (K6, 10 launches) with ``--log-every
   100 --stream-history`` through the native writer, the streamed file read
   back equal to ``diagnostics.npz``'s u, v, and again without
   ``--stream-history``; a config file with a file-level ``"kernels":
   "windowed"``, ``"integrator": "rk4"`` and ``"projection_backend":
   "pallas"`` at 1e5 rays for 20 steps: 80 K3 launches and 4 K1 calls
   (two a saved frame) and finite diagnostics.  Walls: the steps
   (``--log-every`` chunks, behind a synchronize) and the whole command;
15. ray sharding (``msgwam_tpu_torch.parallel``), the card's compute mode
   printed first: (a) NCCL, a world of 1 in this process: Path A sharded
   at 1e6 rays (the bench population) against unsharded Path A, within
   2e-5 after one step and 1e-4 after 5 (and whether bitwise equal), then
   20 sharded steps with every count at 0 just before: exactly 3 x 20 K4
   launches, all in its flux tail, and 3 x 20 all-reduces; the wall and
   device operations per step of both (``torch.profiler``, 10 steps);
   K4's flux tail against its twin on one later-stage launch (y', q' and
   the rank's flux) and its device time; the K2, K3 (rk4) and K1 routes
   sharded at 1e5 rays over 1 and 3 steps, to the same bars, with one
   launch and one all-reduce an RHS evaluation (9 each, 12 for K3); the time of one all-reduce of the flux;
   the gradient of [13]'s loss in its scale, its direction and the initial
   wind through sharded Path A at 1e6 rays over 10 steps with
   ``remat=True`` (``shard_state``, then ``simulate`` with the ray group)
   against the same run unsharded: bitwise or within 1e-6, 6 x 10 K4
   launches in the flux tail (the forward's and the checkpoint's replay),
   all-reduces 3 a step forward and 6 a step backward (the replay and the
   plain rerun; a world of 1 skips the wind's cotangent sum), the
   backward's wall and the peak of device memory of both; (b) gloo, two
   ranks on the one card as spawned processes, each with its own timeout:
   1e6 rays, 5e5 a rank, through Path A for 5 steps, each rank's rays and
   the wind within 1e-4 of the same slots of the unsharded run, the wall
   per step over 20 steps and one all-reduce's time on gloo; configs[4]'s
   8 x 125,000 ensemble on the ``mega`` mesh route, 4 members a rank in
   one K7 launch each, members 0 and 7 within 1e-5 of their own K6 runs;
   the gradients of Path A over 5 steps (``remat=True``) within 1e-4 of
   the unsharded run's, with the wind's cotangent summed over the ranks
   once a stage but the last (14 all-reduces), and of the ensemble over 9
   steps on the mesh within 5e-4 of the meshless K7 run's;
   (c) ``cli.main(["run", "--shard", "--kernels", "windowed", "--preset",
   "fast", ...])`` in-process as the world of 1: 3 x 20 K4 launches in the
   flux tail, its step-10 frame within 1e-4 of the unsharded run's;
16. the examples and the dry run as a user runs them
   (``msgwam_tpu_torch.examples``, ``msgwam_tpu_torch.dryrun``):
   ``megakernel_day`` at 1e6 rays x 720 steps, exactly 10 K5 launches, a
   finite final state bitwise the direct ``simulate_resident`` call, its
   day wall, and its ``main`` (warm-up and timed day, 20 launches) with the
   same result; a 36-step K5 launch at 1e6 from its inputs within 3e-5
   of K5's twin, and the day's first launch (72 steps: chaotic at 1e6)
   within 1e-4 of the twin or within 3 times the twin's own move under a
   1e-7 change of the densities;
   ``config_ladder``'s configs 1 and 2 finite, config 5's one K7 launch,
   members 0 and 7 within 1e-4 of their own K6 runs and every member's
   wind response within 1e-4 of K6's twin; config 5 step by step over its
   60 steps (K7 a launch a step, and the scan backend in float32) against
   the scan backend in float64, with the first step and field, if any,
   where K7's error passes ten times float32's own (logged);
   ``critical_level_relaunch`` at its defaults, the streamed history read
   back equal to the frames pushed; ``reference_experiment`` through the
   shim for 100 steps on the card within 1e-9 of ``--device cpu``;
   ``source_inversion`` at full size in float64: two iterations within 1e-9
   of ``--device cpu``'s (losses and parameters), the loss falling along
   the card's gradient, the wall of one iteration; ``entry()`` on the card and
   ``dryrun_multichip(2, device="cuda")`` (two gloo ranks on the card, one
   K6 launch each, each rank's member within 1e-4 of K6's twin) with both
   OK lines;
18. (before 17) the benchmark as a user runs it,
   ``msgwam_tpu_torch.bench`` (``python -m msgwam_tpu_torch bench``), each
   row with every launch count at 0 just before it and exactly the launches
   its route needs (a warm-up and three timed runs), its value rays x steps
   over its best time, and the card's name and power limit as
   ``nvidia-smi``'s: (a) the bare command in-process, 1e5 rays x 8000
   steps in one K5 launch a run and the 1e6 x 1000 extra (no
   ``extra_error``), then the 1e5 row with ``--fallback``; (b) ``bench
   --backend pallasw`` at 1e5 x 72 and ``bench --help`` in fresh
   processes; (c) ``--all`` at 1e5 x 72: K5 on mega, 3 K2 launches a step
   on pallas, 3 K4 on pallasw, none on mxu, mxu+compensated and xla; (d)
   ``--matrix`` (15 rows, 1e5 to 5e7 rays: K5 far past its on-chip
   capacity, the sorted rows on K6) with no ``error`` row and its artifact
   equal to the printed rows; (e) ``--grad`` at 1e5 x 100 with remat
   ``full`` on mxu (no kernel) and pallasw (K4 forwards only), finite and
   nonzero; (f) ``--sharded`` at 1e5 as the NCCL world of 1: K4 in its
   flux tail, three all-reduces a step; (g) ``--save-every 72 --steps
   720`` against one 720-step launch, in turns: Path B's host work a
   launch, and whether the two final states are bitwise equal;
19. (before 17) the program's tracing (``utils/profiling.py``) on the
   bench population at 1e5 in a seeded random order (as a keyed draw
   leaves it) with each tile's heights moved to a band of its own (5, 30
   or 90 km tall, ``window_cells=16, window_cells2=48``, so that every tier
   runs): one K4 launch, one K5 launch and one K6 launch (configs[3]'s
   lifecycle and tidal wind) of ``TRACE_STEPS`` steps, each run with the
   window-tier counting off and on (a CPU profiler session): its outputs
   bitwise the same, and its tier counts equal to its twin's on the same
   inputs (every tile window of every stage counted once); the cost of a
   gated ``span()`` in us on this host, off and under a profiler (off:
   under 1 us);
17. one K4 step profiled in a fresh process: the fallback of a window that
   lost records (below), exercised on every run, last.

Every profiled window (``measure``) is held to the port's launch counters:
one that records fewer of the port's kernels than were launched in it has
lost CUPTI records, and is measured again in a fresh process that runs
only that window, whose record must be whole; the checks then read, for
each kernel, the larger count of the two windows.

Every kernel's entry in the summary line carries its bound, the larger of
its bytes over the H100's memory rate and its operations over its f32 rate
(``bound``; operations counted from ``csrc/ray_physics.cuh``, the deposit's
by the cells this run's rays cover), and the command-line route that
reaches it (``cli``, with its launches in [14], ``cli_launches``) and the
bench's (``bench``, with its launches in [18], ``bench_launches``; null
where the bench does not reach the kernel).

Any failed check raises and the exit code is nonzero.  Without a CUDA
device the script fails at once.  Its second-to-last lines are a JSON
``{"kernels": [...]}`` summary and the ``nvidia-smi`` line; its last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import contextlib
import inspect
import io
import json
import logging
import math
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

import msgwam_tpu_torch as mtt
from msgwam_tpu_torch import _build, bench, cli
from msgwam_tpu_torch.diagnostics import window_fallback_stats
from msgwam_tpu_torch.ops.dispersion import cg_r
from msgwam_tpu_torch.ops import (collective, projection_cuda, ray_physics,
                                  rhs_cuda, rhs_cuda_windowed, step_cuda,
                                  step_cuda_stream)
from msgwam_tpu_torch.parallel import (ensemble_simulate, initialize_distributed,
                                       make_mesh, shard_state, sharded_simulate,
                                       stack_ensemble)
from msgwam_tpu_torch.parallel.distributed import world
from msgwam_tpu_torch.state import tree_map
from msgwam_tpu_torch.utils import history_io, profiling

SEED = 0
N_MAIN = 100_000
SIZES = (100_000, 1_000_000)
DT = 120.0
DAY_STEPS = 720
TWIN_BAR = 2e-5        # f32 kernel vs f32 twin, relative to the maximum
F64_BAR = 1e-6         # deposit vs the float64 twin, relative to the maximum
TRAJ_BAR = 1e-4        # 5-step trajectories, as tests/test_rhs_fused.py
RESIDENT_BAR = 3e-5    # 9-step whole runs, as tests/test_megakernel.py
RESIDENT_STEPS = 72    # steps per K5 launch in the day
KERNEL_COUNTS = (projection_cuda, rhs_cuda, rhs_cuda_windowed, step_cuda,
                 step_cuda_stream)
STREAM_STEPS = 72      # steps per K6/K7 launch in the day, as K5's
M_MAX_D = 2.0 * math.pi / 300.0    # configs[3] (benchmarks/run.py:407)
N_MEMBERS, N_PER_MEMBER = 8, 125_000   # configs[4] (benchmarks/run.py:425-428)
TIMED_STEPS = 10       # steps per timed K5-K7 launch (device time per step)
N_ABOVE = (2_000_000, 10_000_000)   # K5 runs past the on-chip capacity
# (1,081,344 rays); at 1e7 a block's tiles past its 64th keep their windows
# in the device-memory scratch

# The device kernels of the port (csrc/*.cu), as the profiler names them:
# K1, K2-K4, K5-K7.  A profiled window holds as many as the launch
# counters say were launched in it, or CUPTI lost records (``measure``).
PORT_KERNELS = ("project_kernel", "stage_kernel", "step_resident_kernel")
LEAD_KERNELS = 64           # sleep kernels before a window's call (``profiled``)
REMEASURE_TIMEOUT_S = 300   # a fresh process that profiles one window again
WINDOWS = []                # every profiled window (``measure``)
MESHES = {}                 # this process's NCCL world of 1 (``rays_mesh``)

# The bound of a kernel: the larger of its
# bytes (each input read once, each output written once) over the H100's
# 3.35 TB/s and its operations over the 67 TFLOP/s of f32 outside the tensor
# cores, both at the 700 W limit.  Operations per ray, counted from
# csrc/ray_physics.cuh: the windowed RHS of one stage without the deposit
# (dispersion and deposit inputs 44, window bounds 8, three lookups 30,
# tendencies with online saturation 38), the three RK3 field updates, and
# the deposit per covered cell (span test, overlap, two products, two
# float64 conversions and sums).
HBM_BYTES_PER_S = 3.35e12
F32_OPS_PER_S = 67e12
RHS_OPS = 120
RK3_OPS = 12
DEPOSIT_CELL_OPS = 11


def log(*a):
    print(*a, flush=True)


def rel(a, b):
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    return float((a - b).abs().max() / (a.abs().max() + 1e-30))


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def reset_launches():
    """Every kernel's launch count to 0."""
    for module in KERNEL_COUNTS:
        if isinstance(module.LAUNCHES, dict):
            module.LAUNCHES.update(dict.fromkeys(module.LAUNCHES, 0))
        else:
            module.LAUNCHES = 0


def launches() -> dict:
    """The launch count of every kernel: K1-K7, and of K4's launches
    those in its flux tail (``K4_flux``, ray sharding)."""
    return {"K1": projection_cuda.LAUNCHES, "K2": rhs_cuda.LAUNCHES,
            "K3": rhs_cuda_windowed.LAUNCHES["rhs_fused_windowed"],
            "K4": rhs_cuda_windowed.LAUNCHES["rk3_step_fused_windowed"],
            "K4_flux": rhs_cuda_windowed.LAUNCHES["rk3_step_fused_windowed_flux"],
            "K5": step_cuda.LAUNCHES, **step_cuda_stream.LAUNCHES}


def port_launches() -> int:
    """Launches of the port's kernels since the last reset, each counted
    once (``K4_flux`` is a part of ``K4``)."""
    return sum(v for k, v in launches().items() if k != "K4_flux")


def expect_launches(what: str, **want):
    """Fails unless the kernels named in ``want`` were launched exactly so
    often and every other kernel not at all since the last reset."""
    got = launches()
    want = {k: want.get(k, 0) for k in got}
    check(got == want, f"{what}: launches {got}, expected {want}")
    return got


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Device time of one call of ``fn``: CUDA events around ``iters``
    calls, enqueued behind a sleep kernel so that the host's launch
    overhead is hidden and the events time the device alone."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(50_000_000)          # ~30 ms at H100 clocks
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def bound(n_bytes: float, n_ops: float) -> tuple:
    """``(bound_ms, bound_by)`` for the bytes and operations of one call."""
    t_bytes = n_bytes / HBM_BYTES_PER_S * 1e3
    t_ops = n_ops / F32_OPS_PER_S * 1e3
    return max(t_bytes, t_ops), "bytes" if t_bytes >= t_ops else "operations"


def covered_cells(r_lo, r_up, active, dz: float, nzmax: int) -> float:
    """Mean deposit cells per active ray, by cell_span's rule (deposit.cuh)."""
    lo = torch.clamp(torch.trunc(r_lo / dz), 0, nzmax)
    up = torch.clamp(torch.trunc(r_up / dz + 1.0), 0, nzmax)
    return float(((up - lo) * active).sum() / active.sum().clamp(min=1))


def state_cells(state, bg) -> float:
    """covered_cells of a state on its background's deposit grid."""
    r, hdr = state.rays.r, 0.5 * state.rays.dr
    dz = float(bg.centers[1] - bg.centers[0])
    return covered_cells(r - hdr, r + hdr, torch.ones_like(r), dz,
                         bg.centers.shape[0] - 2)


def step_ops(n: int, cells: float, deposit: bool = True) -> float:
    """Operations of one whole RK3 step of n rays (K5-K7)."""
    return 3 * n * (RHS_OPS + RK3_OPS + (DEPOSIT_CELL_OPS * cells if deposit else 0))


def launch_ms(fn, init, reps: int = 5) -> float:
    """Median device time of ``fn(work)``, ``work`` restored from ``init``
    (untimed) before each sample, the events behind a sleep kernel."""
    work = [x.clone() for x in init]
    times = []
    for i in range(reps + 1):
        for w, x in zip(work, init):
            w.copy_(x)
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        torch.cuda.synchronize()
        torch.cuda._sleep(20_000_000)
        start.record()
        fn(work)
        end.record()
        torch.cuda.synchronize()
        if i:
            times.append(start.elapsed_time(end))
    return float(np.median(times))


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# populations
# ---------------------------------------------------------------------------

def deposit_population(n: int, device, seed: int = SEED, extent=(300.0, 900.0),
                       n_cells: int = 0):
    """The random deposit population of tests/test_projection.py (realistic
    extents and values, f32-representable), two value rows, on the cell
    centers the main path deposits onto; ``extent`` the range of the rays'
    extents in metres (5-40 km: rays spanning 5-41 cells), ``n_cells`` a
    uniform grid of that many cells over the same heights in place of the
    centers (1024: the widest grid the kernel takes)."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(1e3, 80e3, n).astype(np.float32)
    dr = rng.uniform(*extent, n).astype(np.float32)
    vals = (rng.lognormal(0.0, 1.0, (2, n)) * rng.uniform(0.1, 1.0, (2, n))
            * 0.12).astype(np.float32)
    pv = np.abs(rng.normal(1e-12, 1e-13, n)).astype(np.float32)
    grid = mtt.GridConfig().centers().astype(np.float32)
    if n_cells:
        grid = np.linspace(grid[0], grid[-1], n_cells + 1).astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return (t(vals), t(r - 0.5 * dr), t(r + 0.5 * dr), t(pv),
            torch.ones(n, dtype=torch.bool, device=device), t(grid))


def k1_inputs(state, statics, bg, cfg):
    """What the K1 route deposits for a state (models/rhs.py:144-151): the
    two flux rows cg_r k dens and cg_r l dens, the rays' edges, the phase
    volume and the mask, on the cell centers."""
    rays = state.rays
    cgr = cg_r(rays.k, rays.l, rays.m, rays.phi, cfg.bvf)
    return (torch.stack([cgr * rays.k * rays.dens, cgr * rays.l * rays.dens]),
            rays.r - 0.5 * rays.dr, rays.r + 0.5 * rays.dr,
            torch.abs(statics.dkk * statics.dll * rays.dm), statics.active,
            bg.centers)


def bench_setup(n: int, device, rhs_backend="pallas", bench=True, **cfg_kw):
    """The bench population: REFERENCE_RUN_CONFIG with online saturation in
    float32, sine-jet winds, a gaussian spectrum of ``n`` rays launched at
    2 km with 500 m extents at 0.3% of saturation (``bench=False``: the
    source's defaults, as tests/test_megakernel.py).  ``window_cells=0``
    unless ``cfg_kw`` says otherwise."""
    cfg = mtt.REFERENCE_RUN_CONFIG.replace(**{
        "saturate_online": True, "dtype": "float32",
        "rhs_backend": rhs_backend, "window_cells": 0, **cfg_kw})
    gc = mtt.GridConfig()
    centers = torch.tensor(gc.centers(), dtype=torch.float32)
    uu = mtt.velocities_sine_homogeneous(centers, cfg)
    vv = torch.zeros_like(uu)
    bg = mtt.make_background(gc, cfg, uu, vv, dtype=torch.float32, device=device)
    source_kw = dict(z_launch=2000.0, dz_launch=500.0,
                     amplitude_alpha=0.003) if bench else {}
    rays, statics = mtt.gaussian_spectrum_source(
        cfg, bg, n, dtype=torch.float32, device=device, **source_kw)
    state = mtt.State(rays, mtt.MeanState(uu.to(device), vv.to(device)))
    return cfg, bg, state, statics


def tile_spans(state, widths_km, seed: int = SEED):
    """The mixed population: the rays of each 256-ray tile moved to a band
    of its own height, the bands' widths cycling through ``widths_km``."""
    n = state.rays.r.shape[0]
    rng = np.random.default_rng(seed)
    tiles = -(-n // ray_physics.TILE)
    width = np.resize(np.asarray(widths_km, np.float64) * 1e3, tiles)
    lo = rng.uniform(2e3, 95e3 - width)
    r = (np.repeat(lo, ray_physics.TILE)[:n]
         + rng.uniform(0.0, 1.0, n) * np.repeat(width, ray_physics.TILE)[:n])
    r = torch.tensor(r, dtype=torch.float32, device=state.rays.r.device)
    return state._replace(rays=state.rays._replace(r=r))


def plain_cfg(cfg):
    """The plain torch path: composable RHS, dense mxu backends,
    compensated deposit."""
    return cfg.replace(rhs_backend="xla", projection_backend="mxu",
                       interp_backend="mxu", flux_accum="compensated")


def to64(tree):
    return mtt.from_numpy(mtt.to_numpy(tree), device=tree_device(tree),
                          dtype="float64")


def tree_device(tree):
    while isinstance(tree, tuple):
        tree = tree[0]
    return tree.device


# ---------------------------------------------------------------------------
# phases
# ---------------------------------------------------------------------------

def timing(res: dict) -> dict:
    """The timing keys of a kernel's entry in the summary line.  No single
    PyTorch call computes any of these kernels' functions: library_ms is
    null."""
    return {k: res[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")} | {
        "library_ms": None}


def k1_call(args, work):
    """One K1 launch on checked inputs."""
    return projection_cuda.launch(*args, work=work)


def phase_k1(args, label: str) -> dict:
    """K1 on one population: against its float32 and float64 twins, a
    bitwise repeat, one device kernel per call, the block plan against its
    mirror, and the device time of kernel and twin."""
    n, grid = args[1].shape[0], args[5]
    n_cells = grid.shape[0] - 1
    args64 = [a.double() if a.is_floating_point() else a for a in args]
    out = projection_cuda.project_pallas(*args)
    out2 = projection_cuda.project_pallas(*args)
    torch.cuda.synchronize()
    twin = projection_cuda.project_pallas_reference(*args)
    twin64 = projection_cuda.project_pallas_reference(*args64)
    sms = torch.cuda.get_device_properties(grid.device).multi_processor_count
    plan = projection_cuda.device_plan(n, n_cells, grid.device)
    mirror = ray_physics.project_plan(n, n_cells, sms)
    check(plan == mirror, f"K1 ({label}): plan {plan} against the mirror {mirror}")
    work = projection_cuda.scratch(n, n_cells, grid.device)
    kernels = measure(f"[2] K1 {label}, n={n}", k1_call, (args, work))["kernels"]
    res = {
        "n": n, "n_cells": n_cells, "plan": tuple(plan),
        "err_vs_twin": rel(twin, out),
        "err_vs_f64": rel(twin64, out),
        "twin_err_vs_f64": rel(twin64, twin),
        "max_abs_err": float((out.double() - twin.double()).abs().max()),
        "bitwise": bool(torch.equal(out, out2)),
        "kernels": kernels,
        "ms": cuda_ms(lambda: projection_cuda.launch(*args, work=work)),
        "plain_ms": cuda_ms(lambda: projection_cuda.project_pallas_reference(*args),
                            iters=5),
    }
    # bytes: two values, both edges, the phase volume and the mask per ray
    res["cells"] = covered_cells(args[1], args[2], args[4].float(),
                                 float(grid[1] - grid[0]), n_cells - 1)
    res["bound_ms"], res["bound_by"] = bound(21 * n, n * DEPOSIT_CELL_OPS
                                             * res["cells"])
    log(f"[2] K1 {label}, n={n}, {n_cells} cells (plan {tuple(plan)}, "
        f"{res['cells']:.2f} cells a ray): kernel vs f32 twin "
        f"{res['err_vs_twin']:.3e}, vs f64 twin {res['err_vs_f64']:.3e} "
        f"(f32 twin vs f64 {res['twin_err_vs_f64']:.3e}), bitwise repeat "
        f"{res['bitwise']}, device kernels of a call {kernels}; kernel "
        f"{res['ms']:.5f} ms (bound {res['bound_ms']:.5f} ms, "
        f"{res['bound_by']}, share {res['bound_ms'] / res['ms']:.3f}), twin "
        f"{res['plain_ms']:.4f} ms")
    check(res["err_vs_twin"] <= TWIN_BAR, f"K1 vs twin ({label}, {n})")
    check(res["err_vs_f64"] < F64_BAR, f"K1 vs f64 twin ({label}, {n})")
    check(res["bitwise"], f"K1 bitwise repeat ({label}, {n})")
    check(sum(kernels.values()) == 1
          and not any("deposit_reduce" in k for k in kernels),
          f"K1 ({label}): one device kernel a call, got {kernels}")
    return res


def phase_k1_random(device) -> dict:
    """K1 on the random population at 1e5 and 1e6 rays, on rays spanning
    5-41 cells at 1e6, and on a 1024-cell grid at 1e5."""
    res = {f"random_{n}": phase_k1(deposit_population(n, device), "random")
           for n in SIZES}
    res["wide_spans_1000000"] = phase_k1(
        deposit_population(1_000_000, device, extent=(5e3, 40e3)),
        "extents 5-40 km")
    res["cells1024_100000"] = phase_k1(
        deposit_population(100_000, device, n_cells=1024), "1024-cell grid")
    return res


def check_plan(state, bg, what: str):
    """The per-stage kernels' block plan on the card against its mirror."""
    n = state.rays.r.shape[0]
    sms = torch.cuda.get_device_properties(state.rays.r.device).multi_processor_count
    plan = rhs_cuda.device_plan(n, bg.centers.shape[0] - 1, state.rays.r.device)
    mirror = ray_physics.stage_plan(n, bg.centers.shape[0] - 1, sms)
    check(plan == mirror, f"{what}: plan {plan} against the mirror {mirror}")
    return plan


def phase_k2(state, statics, bg, cfg, label: str) -> dict:
    n = state.rays.r.shape[0]
    plan = check_plan(state, bg, f"K2 at {n}")
    inp = rhs_cuda.inputs(DT, state, statics, bg, cfg)
    work = rhs_cuda.scratch(n, bg.centers.shape[0], state.rays.r.device)
    tend, flux = rhs_cuda.rhs_fused(DT, state, statics, bg, cfg)
    tend2, flux2 = rhs_cuda.rhs_fused(DT, state, statics, bg, cfg)
    torch.cuda.synchronize()
    ttend, tflux = rhs_cuda.rhs_fused_reference(DT, state, statics, bg, cfg)
    s64, st64, bg64 = to64((state, statics, bg))
    _, tflux64 = rhs_cuda.rhs_fused_reference(DT, s64, st64, bg64, cfg)
    errs = {f: rel(ttend[f], tend[f]) for f in ("dens", "r", "m")}
    errs["flux"] = rel(tflux, flux)
    bitwise = all(torch.equal(tend[f], tend2[f]) for f in tend) and \
        torch.equal(flux, flux2)
    res = {
        "n": n, "state": label, "plan": tuple(plan), "errs": errs,
        "flux_err_vs_f64": rel(tflux64, flux),
        "max_abs_err": max(float((tend[f].double() - ttend[f].double()).abs().max())
                           for f in tend),
        "bitwise": bool(bitwise),
        "ms": cuda_ms(lambda: rhs_cuda.launch(inp, *state.mean, work)),
        "plain_ms": cuda_ms(
            lambda: rhs_cuda.rhs_fused_reference(DT, state, statics, bg, cfg),
            iters=5),
    }
    # bytes: 11 fields and the mask in, three tendencies out, per ray
    res["bound_ms"], res["bound_by"] = bound(
        57 * n, n * (RHS_OPS + DEPOSIT_CELL_OPS * state_cells(state, bg)))
    log(f"[3] K2 n={n} ({label}, plan {tuple(plan)}): kernel vs twin "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; flux vs f64 twin {res['flux_err_vs_f64']:.3e}; bitwise repeat "
        f"{res['bitwise']}; kernel {res['ms']:.4f} ms (bound "
        f"{res['bound_ms']:.5f} ms), twin {res['plain_ms']:.4f} ms")
    for k, v in errs.items():
        check(v <= TWIN_BAR, f"K2 {k} vs twin at {n} ({label})")
    check(res["flux_err_vs_f64"] < F64_BAR, f"K2 flux vs f64 twin at {n}")
    check(res["bitwise"], f"K2 bitwise repeat at {n}")
    return res


def phase_k3(state, statics, bg, cfg, label: str) -> dict:
    n = state.rays.r.shape[0]
    plan = check_plan(state, bg, f"K3 at {n}")
    params, scalars, tables = rhs_cuda.prepare_inputs(DT, state, statics, bg, cfg)
    fields = rhs_cuda.ray_fields(state, statics)
    window = rhs_cuda_windowed.window_for(cfg, bg.centers.shape[0])
    inp = rhs_cuda.inputs(DT, state, statics, bg, cfg)
    work = rhs_cuda.scratch(n, bg.centers.shape[0], state.rays.r.device)
    outs, flux, tiers = rhs_cuda_windowed.launch(inp, *state.mean, tiers=True)
    outs2, flux2, _ = rhs_cuda_windowed.launch(inp, *state.mean)
    k2_tend, k2_flux = rhs_cuda.rhs_fused(DT, state, statics, bg, cfg)
    torch.cuda.synchronize()
    prepared = (params, scalars, tables, fields, statics.active)
    ttend, tflux, ttiers = ray_physics.fused(*prepared, cfg.saturate_online,
                                             cfg.faithful_saturation, window, plan)
    s64, st64, bg64 = to64((state, statics, bg))
    _, tflux64 = rhs_cuda_windowed.rhs_fused_windowed_reference(DT, s64, st64,
                                                                bg64, cfg)
    names = ("dens", "r", "m")
    errs = {f: rel(ttend[f], o) for f, o in zip(names, outs)}
    errs["flux"] = rel(tflux, flux)
    res = {
        "n": n, "state": label, "window": window, "errs": errs,
        "flux_err_vs_f64": rel(tflux64, flux),
        "max_abs_err": max(float((o.double() - ttend[f].double()).abs().max())
                           for f, o in zip(names, outs)),
        "bitwise": all(torch.equal(a, b) for a, b in zip(outs, outs2))
        and bool(torch.equal(flux, flux2)),
        "equals_k2": all(torch.equal(o, k2_tend[f]) for f, o in zip(names, outs))
        and bool(torch.equal(flux, k2_flux)),
        "tiers_as_twin": bool(torch.equal(tiers.long().cpu(), ttiers.cpu())),
        "tier_counts": {t: int((tiers == t).sum()) for t in (1, 2, 0)},
        "ms": cuda_ms(lambda: rhs_cuda_windowed.launch(inp, *state.mean,
                                                       work=work)),
        "plain_ms": cuda_ms(lambda: ray_physics.fused(
            *prepared, cfg.saturate_online, cfg.faithful_saturation,
            window, plan), iters=5),
    }
    res["bound_ms"], res["bound_by"] = bound(
        57 * n, n * (RHS_OPS + DEPOSIT_CELL_OPS * state_cells(state, bg)))
    log(f"[4] K3 n={n} ({label}, c_pad/W/W2 {window}): kernel vs twin "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; flux vs f64 twin {res['flux_err_vs_f64']:.3e}; bitwise repeat "
        f"{res['bitwise']}; equals K2 {res['equals_k2']}; tiles per tier "
        f"(1, 2, full) {res['tier_counts']}, as the twin's "
        f"{res['tiers_as_twin']}; kernel {res['ms']:.4f} ms, twin "
        f"{res['plain_ms']:.4f} ms")
    for k, v in errs.items():
        check(v <= TWIN_BAR, f"K3 {k} vs twin at {n} ({label})")
    check(res["flux_err_vs_f64"] < F64_BAR, f"K3 flux vs f64 twin at {n}")
    check(res["bitwise"], f"K3 bitwise repeat at {n} ({label})")
    check(res["tiers_as_twin"], f"K3 tiers at {n} ({label})")
    check(res["equals_k2"], f"K3 equals K2 at {n} ({label})")
    return res


def timed_simulate(state, statics, bg, cfg, n_steps: int):
    run = mtt.RunConfig(dt=DT, n_steps=n_steps, save_every=n_steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, _, hist = mtt.simulate(state, statics, bg, cfg, run)
    torch.cuda.synchronize()
    return final, hist, time.perf_counter() - t0


def finite(state) -> bool:
    return all(bool(torch.isfinite(x).all())
               for x in (*state.rays, *state.mean))


def timed_resident(state, statics, bg, cfg, n_steps: int, save_every: int):
    run = mtt.RunConfig(dt=DT, n_steps=n_steps, save_every=save_every)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, _, hist = mtt.simulate_resident(state, statics, bg, cfg, run)
    torch.cuda.synchronize()
    return final, hist, time.perf_counter() - t0


def profiled(fn):
    """``(profile, wall seconds)`` of one call of ``fn`` under
    ``torch.profiler``, after ``LEAD_KERNELS`` short sleep kernels and
    before one more (``device_events`` leaves the sleeps out).  CUPTI drops
    the first records of a profiler session: none in a fresh process, then
    one or two a session once another process has made a CUDA context on
    the card (``tools/torch_cupti_windows.py``, ``PERF.md`` §6).  A lead of
    one kernel, however long, left the rest to the window's own kernels;
    the drops fall on the lead's kernels instead."""
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(LEAD_KERNELS):
            torch.cuda._sleep(1000)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        torch.cuda._sleep(1000)
        torch.cuda.synchronize()
    return prof, wall


def device_events(prof, sleeps: bool = False) -> list:
    """The device events of a ``profiled`` window, without its sleeps (or
    only they, with ``sleeps``) and without the program's spans, which the
    profiler also draws on the device's rows."""
    return [e for e in prof.events()
            if e.device_type == torch.autograd.DeviceType.CUDA
            and not getattr(e, "is_user_annotation", False)
            and ("spin_kernel" in e.name) == sleeps]


def tier_buffers() -> None:
    """The program's window-tier counters on this card, made now: a
    profiled window would otherwise make each at its first use there, one
    zeroing kernel more in that window's device operations."""
    from torch.profiler import ProfilerActivity, profile

    device = torch.device("cuda", torch.cuda.current_device())
    with profile(activities=[ProfilerActivity.CPU]):
        for kernel in profiling.KERNELS:
            profiling.tier_counter(device, kernel)
    torch.cuda.synchronize()


def window_stats(fn, args, n_steps: int) -> dict:
    """One profiled call of ``fn(*args)``: the device kernels by name, the
    port's kernels it launched (its launch counters) and the records of
    them (``PORT_KERNELS`` by name), the records of its sleep kernels that
    CUPTI dropped (``sleeps_lost``), and per step the wall, the device
    operations, the device busy time and the idle share (``None`` where
    the profiler records no device activity)."""
    before = port_launches()
    free = torch.cuda.mem_get_info()[0]
    prof, wall = profiled(lambda: fn(*args))
    launched = port_launches() - before
    dev = device_events(prof)
    kernels = {}
    for e in dev:
        kernels[e.name] = kernels.get(e.name, 0) + 1
    busy_ms = sum(e.time_range.elapsed_us() for e in dev) / 1e3
    return {"kernels": kernels, "launched": launched,
            "device_free_mib": free / 2**20,
            "sleeps_lost": LEAD_KERNELS + 1 - len(device_events(prof, True)),
            "recorded": sum(v for k, v in kernels.items()
                            if any(p in k for p in PORT_KERNELS)),
            "wall_ms_per_step": wall * 1e3 / n_steps,
            "device_ops_per_step": len(dev) / n_steps if dev else None,
            "device_busy_ms_per_step": busy_ms / n_steps if dev else None,
            "idle_share": max(0.0, 1.0 - busy_ms / (wall * 1e3)) if dev else None}


def measure(label: str, fn, args: tuple, n_steps: int = 1) -> dict:
    """``window_stats`` of one call of ``fn(*args)``, held to the port's
    launch counters.  CUPTI drops the first records of a session, which
    ``profiled``'s lead of sleep kernels takes (``sleeps_lost`` counts
    them), and rarely a longer run of records (``PERF.md`` §6-7).  A window
    that records fewer of the port's kernels than the counters say it launched
    is measured again in a fresh process that runs only that window
    (:func:`remeasure`), whose window must record every one.  A lost
    record can only lower a count, so the checks then read, for each
    kernel name, the larger of the two windows' counts: a kernel that
    either window records beyond what is allowed still fails them.  The
    times per step are the fresh window's.  ``fn`` is a function of this
    module and ``args`` what ``torch.save`` can write.  Every window, and
    any re-measurement, is kept in ``WINDOWS`` for the summary."""
    res = window_stats(fn, args, n_steps)
    entry = {"label": label, "launched": res["launched"],
             "recorded": res["recorded"], "sleeps_lost": res["sleeps_lost"],
             "device_free_mib": res["device_free_mib"]}
    if res["recorded"] < res["launched"]:
        log(f"[profiler] {label}: the window recorded {res['recorded']} of "
            f"the {res['launched']} kernels the port launched in it "
            f"({res['device_free_mib']:.0f} MiB of the card free; kernels "
            f"{res['kernels']}; sleeps lost {res['sleeps_lost']}); "
            f"measuring it again in a fresh process")
        first = res["kernels"]
        res = remeasure(fn, args, n_steps)
        entry["remeasured"] = {k: res[k] for k in
                               ("launched", "recorded", "process_s")}
        log(f"[profiler] {label}, fresh process: recorded {res['recorded']} "
            f"of {res['launched']}, kernels {res['kernels']} (seconds "
            f"{res['process_s']})")
        check(res["launched"] > 0 and res["recorded"] >= res["launched"],
              f"{label}: the profiler recorded {res['recorded']} of the "
              f"{res['launched']} kernels launched in a fresh process too")
        res["kernels"] = {k: max(first.get(k, 0), res["kernels"].get(k, 0))
                          for k in {**first, **res["kernels"]}}
        res["device_ops_per_step"] = sum(res["kernels"].values()) / n_steps
        entry["kernels_both_windows"] = res["kernels"]
    WINDOWS.append(entry)
    res["remeasured"] = "remeasured" in entry
    return res


def remeasure(fn, args: tuple, n_steps: int) -> dict:
    """``window_stats`` of ``fn(*args)`` in a fresh process
    (:func:`remeasure_child`, within ``REMEASURE_TIMEOUT_S``)."""
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        job = Path(tmp) / "window.pt"
        torch.save({"fn": fn.__name__, "args": args, "n_steps": n_steps}, job)
        p = subprocess.run(
            [sys.executable, "-c",
             f"import chip_smoke; chip_smoke.remeasure_child({str(job)!r})"],
            cwd=HERE, capture_output=True, text=True,
            timeout=REMEASURE_TIMEOUT_S)
        check(p.returncode == 0, f"re-measuring {fn.__name__} failed:\n"
              f"{p.stdout[-2000:]}{p.stderr[-2000:]}")
        res = json.loads(job.with_suffix(".json").read_text())
    res["process_s"]["total"] = time.perf_counter() - t0
    return res


def remeasure_child(job: str) -> None:
    """The fresh process of :func:`remeasure`: the window's inputs back on
    the card, one call to warm up, then one profiled call, its
    ``window_stats`` written beside the job."""
    t = [time.perf_counter()]
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    _build.library()
    tier_buffers()
    t.append(time.perf_counter())
    spec = torch.load(job, weights_only=False)
    fn = globals()[spec["fn"]]
    fn(*spec["args"])
    torch.cuda.synchronize()
    t.append(time.perf_counter())
    res = window_stats(fn, spec["args"], spec["n_steps"])
    t.append(time.perf_counter())
    res["process_s"] = dict(zip(("library", "inputs_and_warm_up", "window"),
                                np.diff(t).tolist()))
    Path(job).with_suffix(".json").write_text(json.dumps(res))


def profile_run(label: str, fn, args: tuple, n_steps: int) -> dict:
    """Device operations and device busy time per step over one call of
    ``fn(*args)`` (:func:`measure`)."""
    res = measure(label, fn, args, n_steps)
    return {k: res[k] for k in ("wall_ms_per_step", "device_ops_per_step",
                                "device_busy_ms_per_step", "idle_share",
                                "remeasured")}


def traj_errs(want, got) -> dict:
    errs = {f: rel(getattr(want.rays, f), getattr(got.rays, f))
            for f in ("dens", "r", "m")}
    errs["u"] = rel(want.mean.u, got.mean.u)
    return errs


def fmt(errs: dict) -> str:
    return ", ".join(f"{k} {v:.3e}" for k, v in errs.items())


def phase_k2_day(device, smi: str) -> tuple:
    cfg, bg, state, statics = bench_setup(N_MAIN, device)
    # warm-up: the first launches of every torch op on the card
    timed_simulate(state, statics, bg, cfg, 3)
    timed_simulate(state, statics, bg, plain_cfg(cfg), 3)

    reset_launches()
    final, hist, wall = timed_simulate(state, statics, bg, cfg, DAY_STEPS)
    counts = expect_launches("K2 day", K2=3 * DAY_STEPS)
    check(finite(final), "K2 day final state is not finite")
    check(hist[0].rays.r.shape == (1, N_MAIN), "history layout")

    _, _, wall_plain = timed_simulate(state, statics, bg, plain_cfg(cfg),
                                      DAY_STEPS)
    rate = N_MAIN * DAY_STEPS / wall
    rate_plain = N_MAIN * DAY_STEPS / wall_plain
    log(f"[5] K2 day n={N_MAIN}, {DAY_STEPS} steps: launches {counts}, final "
        f"state finite; on {smi}:")
    log(f"[5]   K2 path:    sim_day_wall_s {wall:.4f}, ray-steps/s {rate:.4e}")
    log(f"[5]   plain path: sim_day_wall_s {wall_plain:.4f}, "
        f"ray-steps/s {rate_plain:.4e}")

    prof = profile_run("[5] K2 path, 10 steps", timed_simulate,
                       (state, statics, bg, cfg, 10), 10)
    log(f"[5]   profiler over 10 steps: {prof}")
    a, _, _ = timed_simulate(state, statics, bg, cfg, 5)
    b, _, _ = timed_simulate(state, statics, bg, plain_cfg(cfg), 5)
    errs = traj_errs(b, a)
    log(f"[5]   first 5 steps, K2 path vs plain path: {fmt(errs)}")
    for k, v in errs.items():
        check(v < TRAJ_BAR, f"5-step trajectory {k}")
    return final, statics, bg, cfg, {
        "launches": counts["K2"], "sim_day_wall_s": wall,
        "ray_steps_per_s": rate, "plain_sim_day_wall_s": wall_plain,
        "plain_ray_steps_per_s": rate_plain, "traj_errs": errs, "profile": prof,
    }


def phase_k4(state, statics, bg, cfg, label: str) -> dict:
    """K4 against its twin on a state: one step (three launches, the wind
    updated in the kernel's tail) and one later-stage launch with the same
    inputs, the wind's outputs (u, v, qu, qv) included; bitwise repeat;
    the device time of one launch and of one step."""
    n = state.rays.r.shape[0]
    device = state.rays.r.device
    plan = check_plan(state, bg, f"K4 at {n}")
    one = rhs_cuda_windowed.rk3_step_fused_windowed(DT, state, statics, bg, cfg)
    again = rhs_cuda_windowed.rk3_step_fused_windowed(DT, state, statics, bg, cfg)
    twin = rhs_cuda_windowed.rk3_step_fused_windowed_reference(
        DT, state, statics, bg, cfg, plan)
    errs = traj_errs(twin, one)
    errs["v"] = rel(twin.mean.v, one.mean.v)
    bitwise = all(torch.equal(x, y) for x, y in
                  zip((*one.rays, *one.mean), (*again.rays, *again.mean)))
    # one later-stage launch: y, q and the wind in, y', q' and the wind out
    inp = rhs_cuda.inputs(DT, state, statics, bg, cfg)
    fields = list(inp.fields)
    gen = torch.Generator(device=device).manual_seed(SEED)
    q = tuple(1e-3 * torch.randn(n, device=device, generator=gen) * f
              for f in (fields[0], fields[1], fields[5]))
    n_tab = bg.centers.shape[0]
    quv = tuple(1e-4 * torch.randn(n_tab, device=device, generator=gen)
                for _ in range(2))
    stage = ray_physics.RK3_STAGES[1]
    outs = tuple(torch.empty_like(fields[0]) for _ in range(3))
    q_k = tuple(x.clone() for x in q)
    wind = tuple(torch.empty((4, n_tab), device=device).unbind(0))
    wind[2].copy_(quv[0])
    wind[3].copy_(quv[1])
    rhs_cuda_windowed.launch(inp, *state.mean, fields, outs, q_k, wind, stage)
    ys, q_t, _, wind_t = rhs_cuda_windowed.stage_reference(
        inp, fields, q, *state.mean, quv, stage, plan)
    stage_errs = {f: rel(t, k) for f, t, k in
                  zip(("dens", "r", "m", "q_dens", "q_r", "q_m", "u", "v", "qu",
                       "qv"), (*ys, *q_t, *wind_t), (*outs, *q_k, *wind))}
    work = rhs_cuda.scratch(n, n_tab, device)
    wbuf = tuple(torch.empty((4, n_tab), device=device).unbind(0))
    ms = cuda_ms(lambda: rhs_cuda_windowed.launch(
        inp, *state.mean, fields, outs, q_k, wbuf, stage, work=work))
    step_ms = cuda_ms(lambda: rhs_cuda_windowed.rk3_step_fused_windowed(
        DT, state, statics, bg, cfg))
    plain_ms = cuda_ms(lambda: rhs_cuda_windowed.stage_reference(
        inp, fields, q, *state.mean, quv, stage, plan), iters=5)
    # bytes: K3's plus q in and out, per ray (a later stage reads q)
    b_ms, b_by = bound(81 * n, n * (RHS_OPS + RK3_OPS + DEPOSIT_CELL_OPS
                                    * state_cells(state, bg)))
    abs_err = max(float((getattr(one.rays, f).double()
                         - getattr(twin.rays, f).double()).abs().max())
                  for f in ("dens", "r", "m"))
    log(f"[6]   K4 n={n} ({label}, plan {tuple(plan)}): one step vs twin "
        f"{fmt(errs)}; one stage launch vs twin {fmt(stage_errs)}; bitwise "
        f"repeat {bitwise}; one launch {ms:.5f} ms (bound {b_ms:.5f} ms, "
        f"{b_by}, share {b_ms / ms:.3f}), one step {step_ms:.5f} ms, twin "
        f"stage {plain_ms:.4f} ms")
    for k, v in (*errs.items(), *stage_errs.items()):
        check(v <= TWIN_BAR, f"K4 {k} vs twin at {n} ({label})")
    check(bitwise, f"K4 bitwise repeat at {n} ({label})")
    return {"n": n, "state": label, "plan": tuple(plan), "errs": errs,
            "stage_errs": stage_errs, "bitwise": bitwise, "max_abs_err": abs_err,
            "ms": ms, "step_ms": step_ms, "plain_ms": plain_ms,
            "bound_ms": b_ms, "bound_by": b_by}


def k4_step(state, statics, bg, cfg):
    """One K4 step: three launches."""
    return rhs_cuda_windowed.rk3_step_fused_windowed(DT, state, statics, bg, cfg)


def phase_path_a(device, smi: str) -> dict:
    """The default fused step: K4, three launches per step, no glue."""
    res = {}
    spread = {}
    for n in SIZES:
        cfg, bg, state, statics = bench_setup(n, device, window_cells=-1)
        timed_simulate(state, statics, bg, cfg, 3)
        fb_start = window_fallback_stats(DT, state, statics, bg, cfg)
        reset_launches()
        final, hist, wall = timed_simulate(state, statics, bg, cfg, DAY_STEPS)
        counts = expect_launches(f"Path A day at {n}", K4=3 * DAY_STEPS)
        check(finite(final), f"Path A final state at {n} is not finite")
        check(hist[0].rays.r.shape == (1, n), "Path A history layout")
        fb_end = window_fallback_stats(DT, final, statics, bg, cfg)
        rate = n * DAY_STEPS / wall
        log(f"[6] Path A n={n}, {DAY_STEPS} steps, window_cells=-1: launches "
            f"{counts}; sim_day_wall_s {wall:.4f}, ray-steps/s {rate:.4e} on "
            f"{smi}")
        log(f"[6]   window mirror, tiles leaving the first window: start "
            f"{float(fb_start.fallback_rate):.4f}, end "
            f"{float(fb_end.fallback_rate):.4f} (full width "
            f"{float(fb_start.full_rate):.4f}, {float(fb_end.full_rate):.4f}) "
            f"of {int(fb_start.n_blocks)} tiles")
        r = {"launches": counts["K4"], "sim_day_wall_s": wall,
             "ray_steps_per_s": rate,
             "fallback_start": float(fb_start.fallback_rate),
             "fallback_end": float(fb_end.fallback_rate),
             "full_start": float(fb_start.full_rate),
             "full_end": float(fb_end.full_rate)}
        if n == N_MAIN:
            # device operations per step, and one kernel per K4 launch
            reset_launches()
            prof = profile_run("[6] Path A, 10 steps", timed_simulate,
                               (state, statics, bg, cfg, 10), 10)
            k4_calls = launches()["K4"]
            reset_launches()
            kernels = measure("[6] one K4 step", k4_step,
                              (state, statics, bg, cfg))["kernels"]
            per_call = launches()["K4"]
            log(f"[6]   profiler over 10 steps: {prof}; K4 launches {k4_calls}; "
                f"the device kernels of one K4 step ({per_call} launches): "
                f"{kernels}")
            check(prof["device_ops_per_step"] is not None
                  and prof["device_ops_per_step"] <= 6,
                  f"Path A: {prof['device_ops_per_step']} device ops per step")
            check(sum(kernels.values()) == per_call == 3,
                  f"Path A: one kernel per K4 launch, got {kernels}")
            r["profile"] = prof
            r["step_kernels"] = kernels
            a, _, _ = timed_simulate(state, statics, bg, cfg, 5)
            b, _, _ = timed_simulate(state, statics, bg, plain_cfg(cfg), 5)
            errs = traj_errs(b, a)
            log(f"[6]   first 5 steps, Path A vs plain path: {fmt(errs)}")
            for k, v in errs.items():
                check(v < TRAJ_BAR, f"Path A 5-step trajectory {k}")
            r["traj_errs"] = errs
            # the generic integrators take K3: 4 launches per rk4 step
            cfg4 = cfg.replace(integrator="rk4")
            reset_launches()
            a4, _, _ = timed_simulate(state, statics, bg, cfg4, 3)
            k3_counts = expect_launches("rk4 through K3", K3=12)
            b4, _, _ = timed_simulate(state, statics, bg, plain_cfg(cfg4), 3)
            rk4_errs = traj_errs(b4, a4)
            log(f"[6]   rk4, 3 steps: launches {k3_counts}; vs plain rk4 "
                f"{fmt(rk4_errs)}")
            for k, v in rk4_errs.items():
                check(v < TRAJ_BAR, f"rk4 through K3, {k}")
            r["k3_launches"] = k3_counts["K3"]
            r["rk4_errs"] = rk4_errs
        r["k4_launch"] = phase_k4(state, statics, bg, cfg, "launch")
        r["k4_spread"] = phase_k4(final, statics, bg, cfg,
                                  f"after {DAY_STEPS} steps")
        res[n] = r
        spread[n] = (final, statics, bg, cfg)
        del cfg, bg, state, statics, final, hist
    main = res[N_MAIN]
    k4 = main["k4_launch"]
    out = {**main, "max_abs_err": max(res[n][k]["max_abs_err"] for n in SIZES
                                      for k in ("k4_launch", "k4_spread")),
           **{k: k4[k] for k in ("ms", "plain_ms", "bound_ms", "bound_by")},
           "sizes": {str(n): res[n] for n in SIZES}}
    return out, spread


def resident_twin(state, statics, bg, cfg, n_steps: int, save_every: int):
    """K5's twin over a run, launch by launch: ``(dens, r, m, uv, prop)``."""
    ops = step_cuda.operands(state, statics, bg, cfg, DT)
    out = (state.rays.dens, state.rays.r, state.rays.m,
           torch.stack([state.mean.u, state.mean.v]))
    for _ in range(n_steps // save_every):
        *out, prop = step_cuda.step_resident_reference(ops, *out, save_every)
    return (*out, prop)


def phase_path_b(device, smi: str) -> dict:
    """simulate_resident: K5, save_every whole steps per launch."""
    cfg, bg, state, statics = bench_setup(N_MAIN, device, window_cells=-1)
    timed_resident(state, statics, bg, cfg, 2, 1)
    reset_launches()
    final, hist, wall = timed_resident(state, statics, bg, cfg, DAY_STEPS,
                                       RESIDENT_STEPS)
    counts = expect_launches("Path B day", K5=DAY_STEPS // RESIDENT_STEPS)
    check(finite(final), "Path B final state is not finite")
    check(hist[0].rays.r.shape == (DAY_STEPS // RESIDENT_STEPS, N_MAIN),
          "Path B history layout")
    again, _, wall2 = timed_resident(state, statics, bg, cfg, DAY_STEPS,
                                     RESIDENT_STEPS)
    bitwise = all(torch.equal(x, y) for x, y in
                  zip((*final.rays, *final.mean), (*again.rays, *again.mean)))
    check(bitwise, "Path B: two runs differ")
    rate = N_MAIN * DAY_STEPS / wall
    prof = profile_run("[7] Path B day", timed_resident,
                       (state, statics, bg, cfg, DAY_STEPS, RESIDENT_STEPS),
                       DAY_STEPS)
    log(f"[7] Path B n={N_MAIN}, {DAY_STEPS} steps, save_every "
        f"{RESIDENT_STEPS}: launches {counts}; sim_day_wall_s {wall:.4f} "
        f"(again {wall2:.4f}), ray-steps/s {rate:.4e} on {smi}; two runs "
        f"bitwise equal {bitwise}")
    log(f"[7]   profiler over the day: {prof}")

    # 9 steps against the twin and against Path A, online and offline
    res9 = {}
    run9 = mtt.RunConfig(dt=DT, n_steps=9, save_every=3)
    for mode, c, s in (("online", cfg, state),
                       ("offline", cfg.replace(saturate_online=False),
                        state._replace(rays=state.rays._replace(
                            dens=state.rays.dens * 50.0)))):
        got, ghist, _ = timed_resident(s, statics, bg, c, 9, 3)
        dens, r, m, uv, prop = resident_twin(s, statics, bg, c, 9, 3)
        twin_errs = {"dens": rel(dens, got.rays.dens), "r": rel(r, got.rays.r),
                     "m": rel(m, got.rays.m), "u": rel(uv[0], got.mean.u),
                     "dens_prop": rel(prop, ghist[2][-1])}
        pa, _, phist = mtt.simulate(s, statics, bg, c, run9)
        a_errs = traj_errs(pa, got)
        a_errs["dens_prop"] = rel(phist[2], ghist[2])
        abs_err = max(float((x.double() - y.double()).abs().max()) for x, y in
                      ((dens, got.rays.dens), (r, got.rays.r), (m, got.rays.m)))
        log(f"[7]   9 steps {mode}: K5 vs twin {fmt(twin_errs)}; vs Path A "
            f"{fmt(a_errs)}")
        for k, v in (*twin_errs.items(), *a_errs.items()):
            check(v < RESIDENT_BAR, f"K5 9 steps {mode} {k}")
        res9[mode] = {"vs_twin": twin_errs, "vs_path_a": a_errs,
                      "max_abs_err": abs_err}

    # one step's wind increment against the float64 plain path
    c4, bg4, s4, st4 = bench_setup(4096, device, bench=False, window_cells=-1)
    k, _, _ = timed_resident(s4, st4, bg4, c4, 1, 1)
    du32 = k.mean.u.double() - s4.mean.u.double()
    c64 = c4.replace(dtype="float64", projection_backend="xla",
                     interp_backend="gather", rhs_backend="xla", window_cells=0)
    u64 = s4.mean.u.double().cpu()
    bg64 = mtt.make_background(mtt.GridConfig(), c64, u64, torch.zeros_like(u64),
                               dtype=torch.float64, device=device)
    s64, st64 = to64((s4, st4))
    a64, _, _ = mtt.simulate(s64, st64, bg64, c64,
                             mtt.RunConfig(dt=DT, n_steps=1, save_every=1))
    du64 = a64.mean.u - s64.mean.u
    wind_err = float((du32 - du64).abs().max() / du64.abs().max())
    log(f"[7]   one step at 4096 rays: wind increment vs float64 plain path "
        f"{wind_err:.3e}")
    check(wind_err < F64_BAR, "K5 wind increment vs float64")

    # device time per step in launches of TIMED_STEPS steps, at 1e5 and 1e6
    # rays, on the launch state and the state after a day, with the
    # prognostic wind and without (the difference: the cost of the flux's
    # deposit, reduce and grid-wide wait); the block plan against its mirror
    sms = torch.cuda.get_device_properties(device).multi_processor_count
    per_step, plans = {}, {}
    for n, setup in ((N_MAIN, (cfg, bg, state, statics)),
                     (1_000_000, bench_setup(1_000_000, device, window_cells=-1))):
        c, b, s, st = setup
        ops = step_cuda.operands(s, st, b, c, DT)
        init = [s.rays.dens, s.rays.r, s.rays.m, torch.stack([s.mean.u, s.mean.v])]
        spread = [x.clone() for x in init]
        for _ in range(DAY_STEPS // RESIDENT_STEPS):
            step_cuda.launch(ops, *spread, st.active, RESIDENT_STEPS)
        for label, start in (("launch", init), ("spread", spread)):
            for prog in (True, False):
                o = ops._replace(prognostic=prog)
                per_step[f"{n}_{label}_prog{int(prog)}"] = launch_ms(
                    lambda w: step_cuda.launch(o, *w, st.active, TIMED_STEPS),
                    start) / TIMED_STEPS
        plan = step_cuda.device_plan(n, 1, ops, False)
        mirror = step_cuda.resident_plan(n, 1, ops.c_pad, ops.n_tab - 1,
                                         ops.online, ops.prognostic, sms=sms)
        check(plan == mirror, f"K5 plan at {n}: {plan} against the mirror {mirror}")
        plans[n] = plan._asdict() | {"on_chip_share": plan.on_chip_share}
        log(f"[7]   K5 at {n} rays, ms per step in {TIMED_STEPS}-step launches on "
            f"{smi}: launch state {per_step[f'{n}_launch_prog1']:.5f} with the "
            f"prognostic wind, {per_step[f'{n}_launch_prog0']:.5f} without "
            f"(difference {per_step[f'{n}_launch_prog1'] - per_step[f'{n}_launch_prog0']:.5f}); "
            f"after {DAY_STEPS} steps {per_step[f'{n}_spread_prog1']:.5f} and "
            f"{per_step[f'{n}_spread_prog0']:.5f}; plan {tuple(plan)}, tiles on "
            f"chip {plan.on_chip_share:.4f} (mirror equal)")
        if n == N_MAIN:
            k5_cells = state_cells(s, b)
            ms = per_step[f"{n}_launch_prog1"]
            plain_ms = cuda_ms(lambda: step_cuda.step_resident_reference(
                ops, *init, 1), iters=3)
        del setup, c, b, s, st, ops, init, spread

    # past the on-chip capacity: tiles streamed through device memory, and
    # at 1e7 tile windows in the device-memory scratch
    above, above_abs = {}, 0.0
    for n in N_ABOVE:
        cfg2, bg2, state2, statics2 = bench_setup(n, device, window_cells=-1)
        ops2 = step_cuda.operands(state2, statics2, bg2, cfg2, DT)
        init2 = [state2.rays.dens, state2.rays.r, state2.rays.m,
                 torch.stack([state2.mean.u, state2.mean.v])]
        plan2 = step_cuda.device_plan(n, 1, ops2, False)
        got2 = step_cuda.launch(ops2, *[x.clone() for x in init2],
                                statics2.active, 3)
        twin2 = step_cuda.step_resident_reference(ops2, *init2, 3)
        errs = {f: rel(w, g) for f, w, g in zip(("dens", "r", "m", "u"),
                                                (*twin2[:3], twin2[3][0]),
                                                (*got2[:3], got2[3][0]))}
        log(f"[7]   K5 at {n} rays (tiles on chip {plan2.on_chip_share:.4f}, "
            f"{plan2.scratch_windows} tile windows in the scratch), 3 steps vs "
            f"twin: {fmt(errs)}")
        for k, v in errs.items():
            check(v < RESIDENT_BAR, f"K5 above the on-chip capacity at {n}, {k}")
        above_abs = max(above_abs, *(float((w.double() - g.double()).abs().max())
                                     for w, g in zip(twin2[:3], got2[:3])))
        above[n] = {"errs": errs, "on_chip_share": plan2.on_chip_share,
                    "scratch_windows": plan2.scratch_windows}
        del cfg2, bg2, state2, statics2, ops2, init2, got2, twin2
        torch.cuda.empty_cache()

    # 1e6 rays through simulate_resident
    cfg6, bg6, state6, statics6 = bench_setup(1_000_000, device, window_cells=-1)
    timed_resident(state6, statics6, bg6, cfg6, 2, 1)
    final6, _, wall6 = timed_resident(state6, statics6, bg6, cfg6, 20, 10)
    check(finite(final6), "Path B at 1e6 not finite")
    log(f"[7]   1e6 rays, 20 steps in 2 launches: {wall6 * 50:.4f} ms per "
        f"step of wall, ray-steps/s {1e6 * 20 / wall6:.4e} on {smi}")
    bound_ms, bound_by = bound(57 * N_MAIN / TIMED_STEPS, step_ops(N_MAIN, k5_cells))
    return {"launches": counts["K5"], "sim_day_wall_s": wall,
            "sim_day_wall_s_again": wall2, "ray_steps_per_s": rate,
            "profile": prof, "nine_steps": res9, "wind_err_vs_f64": wind_err,
            "max_abs_err": max(res9["online"]["max_abs_err"], above_abs),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by, "per_step_ms": per_step, "plans": plans,
            "above_capacity": above,
            "ms_per_step_1e6": wall6 * 50, "ray_steps_per_s_1e6": 1e6 * 20 / wall6}


def phase_k1_route(device) -> dict:
    """The K1 route over 5 steps at 1e5 rays, and K1 on what the route
    deposits at launch, at 1e5 and 1e6 rays."""
    cfg, bg, state, statics = bench_setup(
        N_MAIN, device, rhs_backend="xla", projection_backend="pallas",
        interp_backend="mxu")
    reset_launches()
    a, _, wall = timed_simulate(state, statics, bg, cfg, 5)
    counts = expect_launches("K1 route", K1=15)
    b, _, _ = timed_simulate(state, statics, bg, plain_cfg(cfg), 5)
    errs = traj_errs(b, a)
    log(f"[8] K1 route n={N_MAIN}, 5 steps: launches {counts}; vs mxu path "
        f"{fmt(errs)}")
    for k, v in errs.items():
        check(v < TRAJ_BAR, f"K1 route trajectory {k}")
    k1 = {f"bench_launch_{N_MAIN}": phase_k1(k1_inputs(state, statics, bg, cfg),
                                             "bench population at launch")}
    c6, b6, s6, st6 = bench_setup(1_000_000, device, rhs_backend="xla",
                                  projection_backend="pallas")
    k1["bench_launch_1000000"] = phase_k1(k1_inputs(s6, st6, b6, c6),
                                          "bench population at launch")
    return {"launches": counts["K1"], "errs": errs, "k1": k1}


# ---------------------------------------------------------------------------
# Paths D and E: the lifecycle, the launch sort and the ensemble (K6, K7)
# ---------------------------------------------------------------------------

def path_d_setup(n: int, device, **cfg_kw):
    """configs[3] (benchmarks/run.py:403-418): the bench population with
    online saturation, cull, relaunch from the launch population itself,
    m_max = 2 pi/300, ``prognostic_mean=False`` and a tidal ``wind_fn``;
    ``window_cells=24`` as there."""
    cfg, bg, state, statics = bench_setup(n, device, **{
        "window_cells": 24, "cull": True, "relaunch": True, "m_max": M_MAX_D,
        "prognostic_mean": False, **cfg_kw})
    return cfg, bg, state, statics, (state.rays, statics), path_d_wind(cfg, bg)


def path_d_wind(cfg, bg):
    """configs[3]'s tidal ``wind_fn`` on the background's centers."""
    centers = bg.centers
    return lambda t: (mtt.tidal_shear(centers, t.to(centers.device), cfg),
                      torch.zeros_like(centers))


def path_d_day(state, statics, bg, cfg, run, source):
    """configs[3] through ``simulate_resident`` (K6)."""
    return mtt.simulate_resident(state, statics, bg, cfg, run, source=source,
                                 wind_fn=path_d_wind(cfg, bg))


def timed(fn):
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    out = fn()
    torch.cuda.synchronize()
    return out, time.perf_counter() - t0


def stream_twin(state, statics, bg, cfg, run, source=None, wind=None):
    """K6's twin over a run, launch by launch: ``(dens, r, m, uv, prop,
    act)`` in slot order (no launch sort)."""
    ops = step_cuda.operands(state, statics, bg, cfg, run.dt)
    src = step_cuda_stream._template(source, state.rays.r) if source else None
    life = (step_cuda_stream.lifecycle_for(
        bg, cfg, None if src is None else (*src[:3], src[3].bool()))
            if cfg.cull or cfg.relaunch else None)
    out = (state.rays.dens, state.rays.r, state.rays.m,
           torch.stack([state.mean.u, state.mean.v])[None], None,
           statics.active.to(torch.uint8))
    for ci in range(run.n_steps // run.save_every):
        w = None if wind is None else step_cuda_stream._wind_table(
            wind, 0.0, ci, run.save_every, run.dt, bg.centers.shape[0],
            state.rays.r.device)
        out = step_cuda_stream.step_stream_reference(
            ops, out[0], out[1], out[2], out[3], out[5], run.save_every, life, w)
    return out


def masked_errs(want, got, both) -> dict:
    """Relative errors of dens, r, m on the slots both masks hold."""
    z = lambda x: torch.where(both, x, torch.zeros_like(x))
    return {f: rel(z(w), z(g)) for f, w, g in zip(("dens", "r", "m"), want, got)}


def k6_vs_twin(cfg, bg, state, statics, source, wind, label: str) -> dict:
    """K6 against its twin over 9 steps in 3 launches.  Mask flips are a
    discrete event (a ulp on a borderline cull relaunches a ray): any are
    reported and held to the twin's own sensitivity, its flips under a
    1e-7 density perturbation (tests/test_lifecycle_kernel.py:179-234),
    and the fields are compared on the slots both masks hold."""
    run9 = mtt.RunConfig(dt=DT, n_steps=9, save_every=3)
    got, gst, ghist = mtt.simulate_resident(state, statics, bg, cfg, run9,
                                            source=source, wind_fn=wind)
    dens, r, m, uv, prop, act = stream_twin(state, statics, bg, cfg, run9,
                                            source, wind)
    act = act.bool()
    flips = int((act != gst.active).sum())
    calib = None
    both = act & gst.active
    errs = masked_errs((dens, r, m), (got.rays.dens, got.rays.r, got.rays.m), both)
    errs["u"] = rel(uv[0, 0], got.mean.u)
    errs["dens_prop"] = rel(torch.where(both, prop, 0 * prop),
                            torch.where(both, ghist[2][-1], 0 * prop))
    if flips:
        sp = state._replace(rays=state.rays._replace(dens=state.rays.dens * (1 + 1e-7)))
        calib = int((stream_twin(sp, statics, bg, cfg, run9, source, wind)[5].bool()
                     != act).sum())
        check(flips <= 3 * max(calib, 2), f"K6 {label}: {flips} mask flips "
              f"against the twin's own {calib}")
    abs_err = max(float((x.double() - y.double()).abs().max()) for x, y in
                  ((dens, got.rays.dens), (r, got.rays.r), (m, got.rays.m)))
    res = {"errs": errs, "flips": flips, "flip_calibration": calib,
           "active_end": int(gst.active.sum()), "max_abs_err": abs_err}
    log(f"[10]   9 steps, K6 vs twin ({label}): {fmt(errs)}; mask flips {flips}"
        f" (calibration {calib}); active at the end {res['active_end']}")
    for k, v in errs.items():
        check(v < RESIDENT_BAR, f"K6 9 steps {label} {k}")
    return res


def phase_path_d(device, smi: str) -> dict:
    """configs[3]: simulate_resident with the lifecycle, K6."""
    cfg, bg, state, statics, source, wind = path_d_setup(N_MAIN, device)
    day = mtt.RunConfig(dt=DT, n_steps=DAY_STEPS, save_every=STREAM_STEPS)
    mtt.simulate_resident(state, statics, bg, cfg,
                          mtt.RunConfig(dt=DT, n_steps=2, save_every=1),
                          source=source, wind_fn=wind)
    reset_launches()
    (final, fst, hist), wall = timed(lambda: mtt.simulate_resident(
        state, statics, bg, cfg, day, source=source, wind_fn=wind))
    counts = expect_launches("Path D day", K6=DAY_STEPS // STREAM_STEPS)
    check(finite(final), "Path D final state is not finite")
    check(hist[0].rays.r.shape == (DAY_STEPS // STREAM_STEPS, N_MAIN),
          "Path D history layout")
    rate = N_MAIN * DAY_STEPS / wall

    # culls and relaunches over the day: a step-by-step run whose frames
    # count the slots refilled in the step (back at their launch height:
    # every live ray moves), and a cull-only day
    step1 = mtt.RunConfig(dt=DT, n_steps=DAY_STEPS, save_every=1)
    _, _, refills = step_cuda_stream.simulate_streaming(
        state, statics, bg, cfg, step1, source=source, wind_fn=wind,
        observe=lambda s, st, aux: (s.rays.r == source[0].r).sum())
    relaunched = int(refills.sum())
    _, cull_st, _ = mtt.simulate_resident(state, statics, bg,
                                          cfg.replace(relaunch=False), day,
                                          wind_fn=wind)
    culled = int(N_MAIN - cull_st.active.sum())
    log(f"[10] Path D (configs[3]) n={N_MAIN}, {DAY_STEPS} steps, save_every "
        f"{STREAM_STEPS}: launches {counts}; sim_day_wall_s {wall:.4f}, "
        f"ray-steps/s {rate:.4e} on {smi}; relaunches over the day "
        f"{relaunched}, rays culled in a cull-only day {culled}")
    check(relaunched > 0 and culled > 0, "Path D: no cull or relaunch fired")

    prof = profile_run("[10] Path D day", path_d_day,
                       (state, statics, bg, cfg, day, source), DAY_STEPS)
    log(f"[10]   profiler over the day: {prof}")

    twin = {"configs3": k6_vs_twin(cfg, bg, state, statics, source, wind,
                                   "m_max 2pi/300")}
    # at m_max = pi/1500 the launch population's largest |m| is culled at
    # once: the cull-only run must lose rays, the relaunch run refill them
    cfg_f = cfg.replace(m_max=math.pi / 1500.0)
    twin["fires"] = k6_vs_twin(cfg_f, bg, state, statics, source, wind,
                               "m_max pi/1500")
    check(twin["fires"]["active_end"] == N_MAIN, "relaunch refills every slot")
    twin["fires_cull_only"] = k6_vs_twin(cfg_f.replace(relaunch=False), bg,
                                         state, statics, None, wind,
                                         "m_max pi/1500, cull only")
    check(twin["fires_cull_only"]["active_end"] < N_MAIN,
          "no cull fired in the 9-step twin check")

    # K6 with the lifecycle off against K5 (one source, two instantiations)
    run9 = mtt.RunConfig(dt=DT, n_steps=9, save_every=3)
    plain = cfg.replace(cull=False, relaunch=False)
    bitwise = {}
    for prog in (False, True):
        c = plain.replace(prognostic_mean=prog)
        a, _, _ = mtt.simulate_resident(state, statics, bg, c, run9)
        b, _, _ = step_cuda_stream.simulate_streaming(state, statics, bg, c, run9)
        bitwise[f"prognostic_{prog}"] = all(
            torch.equal(x, y) for x, y in zip((*a.rays, *a.mean), (*b.rays, *b.mean)))
        if not bitwise[f"prognostic_{prog}"]:
            check(max(traj_errs(a, b).values()) < RESIDENT_BAR,
                  f"K6 off vs K5, prognostic {prog}")
    log(f"[10]   K6 with the lifecycle off vs K5, 9 steps: bitwise {bitwise}")
    check(bitwise["prognostic_False"], "K6 off vs K5 not bitwise")

    # the same day on Path C (simulate with the lifecycle, K4) and Path B
    # (K5, the population without the lifecycle)
    cfg_c = cfg.replace(window_cells=-1)
    run_c = mtt.RunConfig(dt=DT, n_steps=DAY_STEPS, save_every=DAY_STEPS)
    mtt.simulate(state, statics, bg, cfg_c, mtt.RunConfig(dt=DT, n_steps=2,
                                                         save_every=2),
                 source=source, wind_fn=wind)
    (fc, stc, _), wall_c = timed(lambda: mtt.simulate(
        state, statics, bg, cfg_c, run_c, source=source, wind_fn=wind))
    check(finite(fc), "Path C final state is not finite")
    (_, _, _), wall_b = timed(lambda: mtt.simulate_resident(
        state, statics, bg, plain, day))
    log(f"[10]   the day: Path D {wall:.4f} s, Path C (simulate + lifecycle, "
        f"K4) {wall_c:.4f} s ({N_MAIN * DAY_STEPS / wall_c:.4e} ray-steps/s), "
        f"Path B (K5, no lifecycle) {wall_b:.4f} s "
        f"({N_MAIN * DAY_STEPS / wall_b:.4e}) on {smi}")

    # device time per step of K6 in launches of TIMED_STEPS steps (and its
    # twin over one step); no prognostic wind, so no deposit
    ops = step_cuda.operands(state, statics, bg, cfg, DT)
    src = step_cuda_stream._template(source, state.rays.r)
    life = step_cuda_stream.lifecycle_for(bg, cfg, (*src[:3], src[3].bool()))
    uv = torch.stack([state.mean.u, state.mean.v])[None].contiguous()
    table = step_cuda_stream._wind_table(wind, 0.0, 0, TIMED_STEPS, DT,
                                         bg.centers.shape[0], device)
    act = statics.active.to(torch.uint8)
    init = [state.rays.dens, state.rays.r, state.rays.m, uv, act]
    ms = launch_ms(lambda w: step_cuda.launch(ops, *w, TIMED_STEPS, 1, life,
                                              table, stream=True), init) / TIMED_STEPS
    plain_ms = cuda_ms(lambda: step_cuda_stream.step_stream_reference(
        ops, *init, 1, life, table[:1]), iters=3)
    # bytes: 45 in and 13 out per ray a launch, the template's mask read a step
    bound_ms, bound_by = bound((58 / TIMED_STEPS + 1) * N_MAIN,
                               step_ops(N_MAIN, 0.0, deposit=False))
    log(f"[10]   K6 {ms:.5f} ms per step in {TIMED_STEPS}-step launches on "
        f"{smi} (bound {bound_ms:.5f} ms, {bound_by}), twin {plain_ms:.4f} ms "
        f"per step")
    return {"launches": counts["K6"], "sim_day_wall_s": wall,
            "ray_steps_per_s": rate, "relaunched": relaunched, "culled": culled,
            "profile": prof, "twin": twin, "k5_bitwise": bitwise,
            "path_c_sim_day_wall_s": wall_c, "path_b_sim_day_wall_s": wall_b,
            "max_abs_err": max(t["max_abs_err"] for t in twin.values()),
            "ms": ms, "plain_ms": plain_ms, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_launch_sort(device, smi: str) -> dict:
    """The Path D day at 1e6 rays, launch-sorted against unsorted, in
    turns.  The mean wind is prescribed, so every ray evolves on its own
    and both runs must give bitwise the same rays."""
    n = 1_000_000
    cfg, bg, state, statics, source, wind = path_d_setup(n, device)
    day = mtt.RunConfig(dt=DT, n_steps=DAY_STEPS, save_every=STREAM_STEPS)
    short = mtt.RunConfig(dt=DT, n_steps=4, save_every=2)
    obs = lambda s, st, aux: st.active.sum()
    for sort in (False, True):
        mtt.simulate_resident(state, statics, bg, cfg, short, source=source,
                              wind_fn=wind, launch_sort=sort, observe=obs)
    walls, finals = {False: [], True: []}, {}
    for sort in (False, True, True, False):
        (fin, fst, _), w = timed(lambda: mtt.simulate_resident(
            state, statics, bg, cfg, day, source=source, wind_fn=wind,
            launch_sort=sort, observe=obs))
        walls[sort].append(w)
        finals[sort] = (fin, fst)
    same = all(torch.equal(x, y) for x, y in zip(
        (*finals[False][0].rays, finals[False][1].active),
        (*finals[True][0].rays, finals[True][1].active)))
    log(f"[11] launch sort, n={n}, {DAY_STEPS} steps, save_every {STREAM_STEPS}"
        f" on {smi}: sim_day_wall_s unsorted {walls[False]}, sorted "
        f"{walls[True]}; rays bitwise equal {same}")
    check(same, "launch sort changed the rays")
    return {"n": n, "unsorted_s": walls[False], "sorted_s": walls[True],
            "bitwise": same}


def ensemble_members(device, scale: float):
    """configs[4]'s members (benchmarks/run.py:420-434: the bench
    population at 125,000 rays, online saturation, prognostic mean, no
    lifecycle), member e's amplitude scaled by 1 + scale e."""
    cfg, bg, state, statics = bench_setup(N_PER_MEMBER, device, window_cells=24)
    members = []
    for e in range(N_MEMBERS):
        rays = state.rays._replace(dens=state.rays.dens * (1.0 + scale * e))
        members.append((state._replace(rays=rays), statics))
    return cfg, bg, members


def ensemble_mega(states, statics, bg, cfg, run):
    """An ensemble through ``ensemble_simulate(backend="mega")`` (K7)."""
    return ensemble_simulate(states, statics, bg, cfg, run, backend="mega")


def phase_path_e(device, smi: str) -> dict:
    """configs[4]: the 8-member ensemble in one K7 launch per 72 steps."""
    cfg, bg, members = ensemble_members(device, 0.0)
    states, statics = stack_ensemble(members)
    day = mtt.RunConfig(dt=DT, n_steps=DAY_STEPS, save_every=STREAM_STEPS)
    ensemble_simulate(states, statics, bg, cfg,
                      mtt.RunConfig(dt=DT, n_steps=2, save_every=1), backend="mega")
    reset_launches()
    (fin, _, mh), wall = timed(lambda: ensemble_simulate(
        states, statics, bg, cfg, day, backend="mega"))
    counts = expect_launches("Path E day", K7=DAY_STEPS // STREAM_STEPS)
    check(finite(fin), "Path E final state is not finite")
    check(tuple(mh.u.shape) == (N_MEMBERS, DAY_STEPS // STREAM_STEPS, 100),
          "Path E history layout")
    walls_seq = []
    for s1, st1 in members:
        _, w = timed(lambda: step_cuda_stream.simulate_streaming(
            s1, st1, bg, cfg, day))
        walls_seq.append(w)
    rate = N_MEMBERS * N_PER_MEMBER * DAY_STEPS / wall
    prof = profile_run("[12] Path E day", ensemble_mega,
                       (states, statics, bg, cfg, day), DAY_STEPS)
    log(f"[12] Path E (configs[4]) {N_MEMBERS} x {N_PER_MEMBER}, {DAY_STEPS} "
        f"steps: launches {counts}; sim_day_wall_s {wall:.4f}, ray-steps/s "
        f"{rate:.4e}; {N_MEMBERS} sequential K6 days {sum(walls_seq):.4f} s on {smi}")
    log(f"[12]   profiler over the day: {prof}")

    # members of a perturbed ensemble against their own K6 runs, 9 steps
    cfg_p, bg_p, mem_p = ensemble_members(device, 0.1)
    sp, stp = stack_ensemble(mem_p)
    run9 = mtt.RunConfig(dt=DT, n_steps=9, save_every=3)
    fe, _, mhe = step_cuda_stream.simulate_streaming_ensemble(sp, stp, bg_p,
                                                              cfg_p, run9)
    member_errs = {}
    for e in (0, N_MEMBERS - 1):
        f1, _, h1 = step_cuda_stream.simulate_streaming(*mem_p[e], bg_p, cfg_p,
                                                        run9)
        errs = {f: rel(getattr(f1.rays, f), getattr(fe.rays, f)[e])
                for f in ("dens", "r", "m")}
        errs["u"] = rel(f1.mean.u, fe.mean.u[e])
        errs["u_history"] = rel(h1[0].mean.u, mhe.u[:, e])
        member_errs[e] = errs
        for k, v in errs.items():
            check(v < 1e-5, f"K7 member {e} vs its K6 run, {k}")
    check(rel(fe.mean.u[0], fe.mean.u[-1]) > 1e-6, "the members do not differ")
    log(f"[12]   9 steps, members vs their own K6 runs: {member_errs}")

    # K7 against its twin over 3 steps, and one launch of one step
    flat = lambda tree: tree_map(torch.flatten, tree)
    fstate = mtt.State(flat(sp.rays), mtt.MeanState(sp.mean.u[0], sp.mean.v[0]))
    fstat = flat(stp)
    ops = step_cuda.operands(fstate, fstat, bg_p, cfg_p, DT)
    uv = torch.stack([sp.mean.u, sp.mean.v], dim=1).contiguous()
    act = fstat.active.to(torch.uint8)
    base = (fstate.rays.dens, fstate.rays.r, fstate.rays.m)
    work = [x.clone() for x in (*base, uv)]
    k7 = step_cuda.launch(ops, *work, act.clone(), 3, n_members=N_MEMBERS,
                          stream=True)
    tw = step_cuda_stream.step_stream_reference(ops, *base, uv, act, 3,
                                                n_members=N_MEMBERS)
    twin_errs = {f: rel(w, g) for f, w, g in zip(("dens", "r", "m"), tw, k7)}
    twin_errs["u"] = rel(tw[3][:, 0], k7[3][:, 0])
    abs_err = max(float((w.double() - g.double()).abs().max())
                  for w, g in zip(tw[:3], k7[:3]))
    for k, v in twin_errs.items():
        check(v < RESIDENT_BAR, f"K7 vs twin {k}")
    ms = launch_ms(lambda w: step_cuda.launch(
        ops, *w, TIMED_STEPS, n_members=N_MEMBERS, stream=True),
        [*base, uv, act]) / TIMED_STEPS
    plain_ms = cuda_ms(lambda: step_cuda_stream.step_stream_reference(
        ops, *base, uv, act, 1, n_members=N_MEMBERS), iters=2, warmup=1)
    n_all = N_MEMBERS * N_PER_MEMBER
    bound_ms, bound_by = bound(57 * n_all / TIMED_STEPS,
                               step_ops(n_all, state_cells(fstate, bg_p)))
    plan = step_cuda.device_plan(N_PER_MEMBER, N_MEMBERS, ops, True)
    log(f"[12]   3 steps, K7 vs twin: {fmt(twin_errs)}; K7 {ms:.5f} ms per step "
        f"in {TIMED_STEPS}-step launches on {smi} (bound {bound_ms:.5f} ms, "
        f"{bound_by}), twin {plain_ms:.4f} ms per step; plan {tuple(plan)}, "
        f"tiles on chip {plan.on_chip_share:.4f}")
    return {"launches": counts["K7"], "sim_day_wall_s": wall,
            "ray_steps_per_s": rate, "sequential_k6_s": walls_seq,
            "profile": prof, "member_errs": member_errs, "twin_errs": twin_errs,
            "max_abs_err": abs_err, "ms": ms, "plain_ms": plain_ms,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "on_chip_share": plan.on_chip_share}


# ---------------------------------------------------------------------------
# the adjoint (phase 13)
# ---------------------------------------------------------------------------

ADJ_BAR = 5e-4     # kernel route against the plain route, as the JAX tests
ADJ_N = 100_000
ADJ_BIG = 1_000_000
ADJ_MEMBERS, ADJ_PER_MEMBER = 2, 50_000


def plain_route(cfg):
    """The plain route the kernels' gradients are held to: the composable
    RHS with the dense mxu backends, full width, ``flux_accum`` kept."""
    return cfg.replace(rhs_backend="xla", projection_backend="mxu",
                       interp_backend="mxu", window_cells=0)


def collective_counts() -> tuple:
    """The flux's all-reduces and f's (``ops/collective.py``) since the
    last reset, which this resets."""
    counts = (collective.ALL_REDUCES, collective.BACKWARD_ALL_REDUCES)
    collective.ALL_REDUCES = collective.BACKWARD_ALL_REDUCES = 0
    return counts


def adjoint_run(run_fn, state, theta, wind: bool = False):
    """Forward and backward of L = sum((u_final - u0)^2), the density
    scaled by ``scale * (1 + eps * theta)``, at scale 1 and eps 0: dL/dscale
    and dL/deps (the derivative along theta), with ``wind`` dL/du0 too
    (``d_u``, a tensor), the final state, the forward's and the backward's
    wall time, and the all-reduces of each (``reduces``: the flux's
    forward, the flux's and f's backward)."""
    device = state.rays.r.device
    scale = torch.ones((), device=device, requires_grad=True)
    eps = torch.zeros((), device=device, requires_grad=True)
    dens = state.rays.dens * scale * (1.0 + eps * theta)
    u0 = state.mean.u.clone().requires_grad_(wind)
    torch.cuda.synchronize()
    collective_counts()
    t0 = time.perf_counter()
    final = run_fn(state._replace(rays=state.rays._replace(dens=dens),
                                  mean=state.mean._replace(u=u0)))
    loss = ((final.mean.u - state.mean.u) ** 2).sum()
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    fwd = collective_counts()
    loss.backward()
    torch.cuda.synchronize()
    t2 = time.perf_counter()
    grads = (float(scale.grad), float(eps.grad))
    check(all(math.isfinite(g) and g != 0.0 for g in grads),
          f"gradient not finite and nonzero: {grads}")
    res = {"d_scale": grads[0], "d_theta": grads[1], "fwd_s": t1 - t0,
           "bwd_s": t2 - t1, "reduces": [fwd[0], *collective_counts()]}
    if wind:
        check(bool(torch.isfinite(u0.grad).all()) and bool(u0.grad.any()),
              "dL/du0 not finite and nonzero")
        res["d_u"] = u0.grad
    return res, tree_map(torch.Tensor.detach, final)


def grad_errs(got: dict, want: dict) -> dict:
    errs = {k: abs(got[k] - want[k]) / abs(want[k]) for k in ("d_scale", "d_theta")}
    if "d_u" in got:
        errs["d_u"] = rel(want["d_u"], got["d_u"])
    return errs


def peak_run(run_fn, state, theta, wind: bool = False) -> dict:
    """adjoint_run with the peak of allocated device memory over it."""
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    res, final = adjoint_run(run_fn, state, theta, wind)
    res["peak_gib"] = torch.cuda.max_memory_allocated() / 2**30
    res["peak_over_inputs_gib"] = (torch.cuda.max_memory_allocated() - base) / 2**30
    return res, final


def phase_adjoint(device, smi: str) -> dict:
    """Gradients through each differentiable kernel route against the
    plain route, remat as a memory schedule, and the routes that stay
    forward only."""
    gen = torch.Generator().manual_seed(SEED)
    res = {}
    # compensated: the plain route's own f32 deposit error (4.4e-6 at 1e6
    # rays natively) stays out of the comparison
    cfg, bg, state, statics = bench_setup(ADJ_N, device, flux_accum="compensated")
    theta = torch.randn(ADJ_N, generator=gen).to(device)

    def simulate_fn(c, n_steps, save_every, **kw):
        run = mtt.RunConfig(dt=DT, n_steps=n_steps, save_every=save_every)
        return lambda s: mtt.simulate(s, statics, bg, c, run, validate=False,
                                      **kw)[0]

    def resident_fn(c, n_steps, save_every):
        run = mtt.RunConfig(dt=DT, n_steps=n_steps, save_every=save_every)
        return lambda s: mtt.simulate_resident(s, statics, bg, c, run)[0]

    routes = {
        "K2": (simulate_fn(cfg, 3, 3), 3, {"K2": 9}),
        "K4 (Path A)": (simulate_fn(cfg.replace(window_cells=-1), 20, 20), 20,
                        {"K4": 60}),
        "K5 (Path B)": (resident_fn(cfg, 20, 10), 20, {"K5": 2}),
    }
    plain = {}
    for name, (fn, n_steps, want) in routes.items():
        if n_steps not in plain:
            plain_fn = simulate_fn(plain_route(cfg), n_steps, n_steps)
            adjoint_run(plain_fn, state, theta)        # warm-up
            plain[n_steps], _ = adjoint_run(plain_fn, state, theta)
        adjoint_run(fn, state, theta)                  # warm-up
        reset_launches()
        got, _ = adjoint_run(fn, state, theta)
        got["launches"] = expect_launches(f"adjoint {name}", **want)
        got["errs"] = grad_errs(got, plain[n_steps])
        for k, v in got["errs"].items():
            check(v < ADJ_BAR, f"adjoint {name}: {k} off the plain route by {v:.3e}")
        res[name] = got
        log(f"[13] {name} n={ADJ_N}, {n_steps} steps: d/dscale {got['d_scale']:.6e}, "
            f"d/dtheta {got['d_theta']:.6e}, vs plain route {fmt(got['errs'])}; "
            f"forward {got['fwd_s']:.4f} s, backward {got['bwd_s']:.4f} s "
            f"(plain route {plain[n_steps]['fwd_s']:.4f} s, "
            f"{plain[n_steps]['bwd_s']:.4f} s) on {smi}")
    res["plain"] = {str(k): v for k, v in plain.items()}

    # K7: two members, their own amplitudes and directions
    cfg_e, bg_e, st_e, stat_e = bench_setup(ADJ_PER_MEMBER, device,
                                            window_cells=24,
                                            flux_accum="compensated")
    members = [(st_e._replace(rays=st_e.rays._replace(
        dens=st_e.rays.dens * (1.0 + 0.1 * e))), stat_e)
        for e in range(ADJ_MEMBERS)]
    states, statics_e = stack_ensemble(members)
    theta_e = torch.randn(ADJ_MEMBERS, ADJ_PER_MEMBER, generator=gen).to(device)
    run_e = mtt.RunConfig(dt=DT, n_steps=10, save_every=5)
    ens = lambda s: mtt.simulate_streaming_ensemble(s, statics_e, bg_e, cfg_e,
                                                    run_e)[0]

    def ens_plain(s):
        one = lambda tree, e: tree_map(lambda x: x[e], tree)
        finals = [mtt.simulate(one(s, e), one(statics_e, e), bg_e,
                               plain_route(cfg_e), run_e, validate=False)[0]
                  for e in range(ADJ_MEMBERS)]
        return tree_map(lambda *xs: torch.stack(xs), *finals)

    want, _ = adjoint_run(ens_plain, states, theta_e)
    adjoint_run(ens, states, theta_e)
    reset_launches()
    got, _ = adjoint_run(ens, states, theta_e)
    got["launches"] = expect_launches("adjoint K7", K7=2)
    got["errs"] = grad_errs(got, want)
    for k, v in got["errs"].items():
        check(v < ADJ_BAR, f"adjoint K7: {k} off the plain route by {v:.3e}")
    res["K7 (Path E)"] = got
    log(f"[13] K7 (Path E) {ADJ_MEMBERS} x {ADJ_PER_MEMBER}, 10 steps: d/dscale "
        f"{got['d_scale']:.6e}, d/dtheta {got['d_theta']:.6e}, vs plain route "
        f"{fmt(got['errs'])}; forward {got['fwd_s']:.4f} s, backward "
        f"{got['bwd_s']:.4f} s (plain route {want['fwd_s']:.4f} s, "
        f"{want['bwd_s']:.4f} s) on {smi}")
    del states, statics_e, members, st_e, stat_e

    # remat: the same forward, bit for bit, and the same gradient; peaks
    path_a = cfg.replace(window_cells=-1)
    for n, n_steps, modes in ((ADJ_N, 100, (False, True, "full")),
                              (ADJ_BIG, 20, ("full",))):
        if n != ADJ_N:
            del state, statics, bg
            cfg, bg, state, statics = bench_setup(n, device,
                                                  flux_accum="compensated")
            path_a = cfg.replace(window_cells=-1)
            theta = torch.randn(n, generator=gen).to(device)
        runs = {}
        for remat in modes:                            # warm-up
            adjoint_run(simulate_fn(path_a, 2, 1, remat=remat), state, theta)
        for remat in modes:
            runs[remat] = peak_run(simulate_fn(path_a, n_steps, 10, remat=remat),
                                   state, theta)
            r = runs[remat][0]
            log(f"[13] Path A remat={remat!r} n={n}, {n_steps} steps "
                f"(save_every 10): forward {r['fwd_s']:.4f} s, backward "
                f"{r['bwd_s']:.4f} s, max_memory_allocated {r['peak_gib']:.3f} GiB "
                f"({r['peak_over_inputs_gib']:.3f} GiB over the inputs) on {smi}")
        base, base_final = runs[modes[0]]
        for remat in modes[1:]:
            r, final = runs[remat]
            same = all(torch.equal(a, b) for a, b in
                       zip(_build._tensors(base_final), _build._tensors(final)))
            check(same, f"remat={remat!r}: the forward differs from remat=False")
            r["errs"] = grad_errs(r, base)
            for k, v in r["errs"].items():
                check(v < 1e-6, f"remat={remat!r}: {k} off remat=False by {v:.3e}")
            log(f"[13]   remat={remat!r}: forward bitwise equal, gradient vs "
                f"remat=False {fmt(r['errs'])}")
        res[f"remat_{n}_{n_steps}"] = {str(k): v[0] for k, v in runs.items()}

    # the routes without a backward still refuse one
    args = list(k1_inputs(state, statics, bg, cfg))
    args[0] = args[0].clone().requires_grad_(True)
    for name, call in (
            ("project_pallas (K1)", lambda: projection_cuda.project_pallas(*args)),
            ("simulate_resident with the lifecycle (K6)",
             lambda: mtt.simulate_resident(
                 state._replace(rays=state.rays._replace(
                     dens=state.rays.dens.clone().requires_grad_(True))),
                 statics, bg, cfg.replace(cull=True),
                 mtt.RunConfig(dt=DT, n_steps=1, save_every=1)))):
        try:
            call()
        except NotImplementedError as e:
            log(f"[13] {name} refuses a gradient: {e}")
        else:
            raise AssertionError(f"{name} ran with an input that needs a gradient")
    return res


# ---------------------------------------------------------------------------
# [14] the driver: msgwam_tpu_torch.cli.main, in-process, on the card
# ---------------------------------------------------------------------------

CONFIG4 = Path(__file__).resolve().parent / "examples" / "config4.json"
DRIVER_ROUTES = ("mxu", "pallas", "windowed", "mega")  # the plain route first
DRIVER_K13_STEPS = 20


class Progress(logging.Handler):
    """Keeps the driver's progress records (``MetricsLogger``: step, total,
    percent, steps/s since the previous record)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.records = []

    def emit(self, record):
        self.records.append(record.args)


def cli_run(what: str, args: list, out: Path, **want) -> dict:
    """One ``msgwam_tpu_torch run ... --no-plot --out out`` through
    ``cli.main`` with every launch count set to 0 just before it: its
    printed lines, its wall, the seconds of its progress chunks (with
    ``--log-every``: the steps themselves, behind a synchronize) and its
    diagnostics.  Fails unless the kernels in ``want`` were launched
    exactly so often and no other."""
    progress = Progress()
    logger = logging.getLogger("msgwam_tpu_torch")
    logger.addHandler(progress)
    logger.setLevel(logging.INFO)
    printed = io.StringIO()
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(printed):
            cli.main(["run", *args, "--out", str(out), "--no-plot"])
    finally:
        logger.removeHandler(progress)
    wall = time.perf_counter() - t0
    counts = expect_launches(what, **want)
    chunk_s = 0.0
    last = 0
    for step, _, _, rate, _ in progress.records:
        chunk_s += (step - last) / rate
        last = step
    diag = dict(np.load(out / "diagnostics.npz"))
    check(all(np.all(np.isfinite(diag[k])) for k in
              ("wave_action", "flux", "tendency", "u", "v")),
          f"{what}: non-finite diagnostics")
    return {"printed": printed.getvalue(), "wall_s": wall,
            "sim_wall_s": chunk_s, "launches": counts, "diag": diag}


def rel_np(a, b) -> float:
    a, b = np.float64(a), np.float64(b)
    return float(np.max(np.abs(a - b)) / (np.max(np.abs(a)) + 1e-300))


def same_npz(a: Path, b: Path, skip=("__msgwam_manifest__",)) -> bool:
    with np.load(a) as x, np.load(b) as y:
        return sorted(x.files) == sorted(y.files) and all(
            np.array_equal(x[k], y[k]) for k in x.files if k not in skip)


def phase_driver(smi: str) -> dict:
    """``python -m msgwam_tpu_torch run`` in-process at the ``fast`` preset's
    full width through every kernel route, a resumed run, configs[3] from
    ``examples/config4.json`` with streamed history, and K1 + K3 from a
    config file."""
    fast = cli.FAST_PRESET
    n, steps = fast["source"]["n_ray"], fast["run"]["n_steps"]
    save = fast["run"]["save_every"]
    frames = steps // save
    want = {"mxu": {}, "pallas": {"K2": 3 * steps},
            "windowed": {"K4": 3 * steps}, "mega": {"K5": frames}}
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        # the float64 oracle: the fast spec in float64 on the xla route
        # (scatter sums in float64, so flux_accum "native")
        oracle = json.loads(json.dumps(fast))
        oracle["dtype"] = "float64"
        oracle["model"]["flux_accum"] = "native"
        (tmp / "oracle.json").write_text(json.dumps(oracle))
        runs = {}
        log_every = ["--log-every", str(steps)]
        for route in DRIVER_ROUTES:
            runs[route] = cli_run(f"--kernels {route}",
                                  ["--preset", "fast", "--kernels", route,
                                   *log_every], tmp / route, **want[route])
            check("falling back" not in runs[route]["printed"],
                  f"--kernels {route} fell back")
        runs["f64 xla"] = cli_run(
            "f64 oracle", ["--config", str(tmp / "oracle.json"), "--kernels",
                           "xla", *log_every], tmp / "oracle")
        plain = runs["mxu"]["diag"]
        oracle_flux = runs["f64 xla"]["diag"]["flux"]
        # the flux against the oracle's along the day, at these frames
        along = sorted({0, frames // 4, frames // 2, 3 * frames // 4,
                        frames - 1})
        for route, r in runs.items():
            d = r["diag"]
            check(d["flux"].shape == (frames, fast["grid"]["n_face"] - 2),
                  f"{route}: diagnostics shape {d['flux'].shape}")
            r["first_frame_err"] = {k: rel_np(plain[k][0], d[k][0])
                                    for k in ("flux", "wave_action")}
            r["day_end_flux_err_vs_f64"] = rel_np(oracle_flux[-1],
                                                  d["flux"][-1])
            r["flux_err_vs_f64_by_step"] = {
                (i + 1) * save: rel_np(oracle_flux[i], d["flux"][i])
                for i in along}
            r["day_end_flux_err_vs_plain"] = rel_np(plain["flux"][-1],
                                                    d["flux"][-1])
            r["day_end_max_u"] = float(np.max(np.abs(d["u"][-1])))
            if route in want and route != "mxu":
                check(max(r["first_frame_err"].values()) < TRAJ_BAR,
                      f"--kernels {route}: step {save} off the plain route: "
                      f"{r['first_frame_err']}")
            name = (f"--kernels {route}" if route in want
                    else "the float64 oracle (--kernels xla)")
            log(f"[14] {name} n={n}, {steps} steps: launches "
                f"{r['launches']}, sim_day_wall_s {r['sim_wall_s']:.4f} "
                f"(the whole run {r['wall_s']:.3f} s) on {smi}; step {save} "
                f"vs the plain route {fmt(r['first_frame_err'])}; day-end "
                f"flux vs the float64 oracle "
                f"{r['day_end_flux_err_vs_f64']:.3e} (by step: "
                f"{fmt(r['flux_err_vs_f64_by_step'])}), "
                f"vs the plain route {r['day_end_flux_err_vs_plain']:.3e}; "
                f"day-end max |u| {r['day_end_max_u']:.2f} m/s")

        # resume: two mega runs of half a day equal to the day, to the bit
        half = ["--preset", "fast", "--kernels", "mega", "--steps",
                str(steps // 2)]
        first = cli_run("mega, first half", half, tmp / "half_a",
                        K5=frames // 2)
        second = cli_run("mega, resumed half", [
            *half, "--resume", str(tmp / "half_a" / "final_state.npz")],
            tmp / "half_b", K5=frames // 2)
        check(f"at step {steps // 2}" in second["printed"],
              "the resumed run did not say so")
        resume_bitwise = same_npz(tmp / "mega" / "final_state.npz",
                                  tmp / "half_b" / "final_state.npz")
        resume_diag = all(np.array_equal(runs["mega"]["diag"][k][frames // 2:],
                                         second["diag"][k])
                          for k in ("wave_action", "flux", "u", "time"))
        log(f"[14] resume: mega {steps // 2} + {steps // 2} steps against "
            f"{steps}: final state bitwise {resume_bitwise}, diagnostics "
            f"bitwise {resume_diag} (walls {first['wall_s']:.3f}, "
            f"{second['wall_s']:.3f} s)")
        check(resume_bitwise and resume_diag,
              "the resumed run differs from the straight run")

        # configs[3] as examples/config4.json writes it, streamed
        spec4 = json.loads(CONFIG4.read_text())
        k6 = spec4["run"]["n_steps"] // spec4["run"]["save_every"]
        every = ["--log-every", str(spec4["run"]["save_every"])]
        check(history_io._load_native() is not None,
              "the native history writer did not build")
        streamed = cli_run("config4.json, streamed",
                           ["--config", str(CONFIG4), *every,
                            "--stream-history"], tmp / "c4s", K6=k6)
        unstreamed = cli_run("config4.json", ["--config", str(CONFIG4),
                                              *every], tmp / "c4", K6=k6)
        for r in (streamed, unstreamed):
            check("falling back" not in r["printed"], "config4.json fell back")
        hist = history_io.read_state_history(tmp / "c4s" / "state_history.msgw")
        stream_ok = (hist["dens"].shape == (k6, spec4["source"]["n_ray"])
                     and np.array_equal(hist["u"], streamed["diag"]["u"])
                     and np.array_equal(hist["v"], streamed["diag"]["v"]))
        same_diag = all(np.array_equal(streamed["diag"][k],
                                       unstreamed["diag"][k])
                        for k in ("wave_action", "flux", "u", "v"))
        log(f"[14] config4.json ({spec4['source']['n_ray']} rays, "
            f"{spec4['run']['n_steps']} steps, K6): launches "
            f"{streamed['launches']}; streamed file read back equal to "
            f"diagnostics.npz u, v: {stream_ok}; with --stream-history "
            f"{streamed['sim_wall_s']:.4f} s of chunks ({streamed['wall_s']:.3f}"
            f" s in all), without {unstreamed['sim_wall_s']:.4f} s "
            f"({unstreamed['wall_s']:.3f} s) on {smi}; diagnostics of the "
            f"two runs bitwise {same_diag}")
        check(stream_ok, "the streamed history differs from diagnostics.npz")

        # K1 and K3 from a config file: a file-level "windowed" (the step
        # through K3 with rk4, four launches a step) and the diagnostics
        # through K1 (two calls a frame)
        spec13 = json.loads(json.dumps(fast))
        spec13["kernels"] = "windowed"
        spec13["model"].update(projection_backend="pallas", integrator="rk4")
        spec13["run"]["n_steps"] = DRIVER_K13_STEPS
        (tmp / "k13.json").write_text(json.dumps(spec13))
        k13 = cli_run("K1 + K3 config", ["--config", str(tmp / "k13.json")],
                      tmp / "k13", K3=4 * DRIVER_K13_STEPS,
                      K1=2 * DRIVER_K13_STEPS // save)
        log(f"[14] K1 + K3 config (file-level windowed, rk4, "
            f"projection_backend pallas), n={n}, {DRIVER_K13_STEPS} steps: "
            f"launches {k13['launches']}, finite diagnostics, "
            f"{k13['wall_s']:.3f} s")

    for r in (*runs.values(), first, second, streamed, unstreamed, k13):
        del r["diag"], r["printed"]
    return {"routes": runs,
            "resume": {"bitwise": resume_bitwise,
                       "diagnostics_bitwise": resume_diag},
            "config4": {"streamed": streamed, "unstreamed": unstreamed,
                        "stream_read_back": stream_ok,
                        "diagnostics_bitwise": same_diag},
            "k1_k3": k13}


# ---------------------------------------------------------------------------
# ray sharding (phase 15)
# ---------------------------------------------------------------------------

N_SHARD = 1_000_000      # the bench population at full width, 5e5 a rank of 2
SHARD_STEPS = 20         # the sharded Path A run whose launches are counted
WORKER_TIMEOUT_S = 420   # each gloo rank's own limit: a hang fails [15]
HERE = Path(__file__).resolve().parent
GRAD_STEPS = 10          # [15](a)'s gradient through sharded Path A, remat=True
GLOO_GRAD_STEPS = 5      # [15](b)'s, over two gloo ranks
WORLD1_GRAD_BAR = 1e-6   # a world of 1 against unsharded, where not bitwise
GLOO_GRAD_BAR = 1e-4     # two gloo ranks against unsharded
ENS_RUN = dict(dt=DT, n_steps=9, save_every=9)   # [15](b)'s ensemble run


def compute_mode() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=compute_mode", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def sharded_run(mesh, state, statics, bg, cfg, n_steps: int):
    """``sharded_simulate`` over ``n_steps`` behind a synchronize: this
    rank's ``(final, wall seconds)``."""
    run = mtt.RunConfig(dt=DT, n_steps=n_steps, save_every=n_steps)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    final, _, _ = sharded_simulate(mesh, state, statics, bg, cfg, run)
    torch.cuda.synchronize()
    return final, time.perf_counter() - t0


def path_a_grad_fn(statics, bg, cfg, n_steps: int, mesh=None):
    """``adjoint_run``'s run function for Path A with ``remat=True``: the
    whole state split by ``shard_state`` and run by ``simulate`` with the
    mesh's ray group (what ``sharded_simulate`` runs, with ``remat``), or
    unsharded without a ``mesh``."""
    run = mtt.RunConfig(dt=DT, n_steps=n_steps, save_every=n_steps)
    if mesh is None:
        return lambda s: mtt.simulate(s, statics, bg, cfg, run, validate=False,
                                      remat=True)[0]
    group = mesh.get_group("rays")

    def fn(s):
        s, st = shard_state(mesh, s, statics)
        return mtt.simulate(s, st, bg, cfg, run, axis_name=group,
                            validate=False, remat=True)[0]

    return fn


def shard_theta(device):
    """The seeded direction of [15]'s gradients, the same in every
    process."""
    gen = torch.Generator().manual_seed(SEED)
    return torch.randn(N_SHARD, generator=gen).to(device)


def ensemble_grad_fn(statics, bg, cfg, mesh=None):
    """``adjoint_run``'s run function for configs[4]'s ensemble on the
    ``mega`` route (K7), on a mesh or not."""
    run = mtt.RunConfig(**ENS_RUN)
    return lambda s: ensemble_simulate(s, statics, bg, cfg, run, mesh=mesh,
                                       backend="mega")[0]


def ensemble_theta(device):
    gen = torch.Generator().manual_seed(SEED + 1)
    return torch.randn(N_MEMBERS, N_PER_MEMBER, generator=gen).to(device)


def host_grads(res: dict) -> dict:
    """``adjoint_run``'s gradients as NumPy, for an ``.npz``."""
    return {"d_scale": res["d_scale"], "d_theta": res["d_theta"],
            "d_u": res["d_u"].cpu().numpy(), "reduces": res["reduces"],
            "bwd_s": res["bwd_s"]}


def rays_mesh():
    """The ray mesh of this process's NCCL world of 1, made once."""
    if "rays" not in MESHES:
        initialize_distributed()
        MESHES["rays"] = make_mesh(1)
    return MESHES["rays"]


def sharded_steps(state, statics, bg, cfg, n_steps: int):
    """``sharded_run`` on :func:`rays_mesh`."""
    return sharded_run(rays_mesh(), state, statics, bg, cfg, n_steps)


def shard_errs(want, got, lo: int = 0) -> dict:
    """A rank's rays against the same slots of the unsharded run, and the
    wind."""
    hi = lo + got.rays.r.shape[0]
    errs = {f: rel(getattr(want.rays, f)[lo:hi], getattr(got.rays, f))
            for f in ("dens", "r", "m")}
    errs["u"] = rel(want.mean.u, got.mean.u)
    errs["v"] = rel(want.mean.v, got.mean.v)
    return errs


def same(a, b) -> bool:
    return all(torch.equal(x, y) for x, y in
               zip((*a.rays, *a.mean), (*b.rays, *b.mean)))


def all_reduce_ms(group, device, reps: int = 50) -> dict:
    """One all-reduce of a ``(2, 99)`` flux: the host's wall per call over
    ``reps`` calls ended by a synchronize, and under NCCL the device time
    (CUDA events)."""
    flux = torch.ones((2, 99), dtype=torch.float32, device=device)
    call = lambda: dist.all_reduce(flux, group=group)
    for _ in range(3):
        call()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(reps):
        call()
    torch.cuda.synchronize()
    res = {"wall_ms": (time.perf_counter() - t0) * 1e3 / reps}
    if dist.get_backend(group) == "nccl":
        res["device_ms"] = cuda_ms(call, iters=reps)
    return res


def k4_flux_tail(state, statics, bg, cfg) -> dict:
    """K4 in its flux tail against its twin on one later-stage launch: y',
    q' and the rank's flux; the device time of a launch in each tail."""
    n = state.rays.r.shape[0]
    device = state.rays.r.device
    n_tab = bg.centers.shape[0]
    plan = check_plan(state, bg, f"K4 flux tail at {n}")
    inp = rhs_cuda.inputs(DT, state, statics, bg, cfg)
    fields = list(inp.fields)
    gen = torch.Generator(device=device).manual_seed(SEED)
    q = tuple(1e-3 * torch.randn(n, device=device, generator=gen) * f
              for f in (fields[0], fields[1], fields[5]))
    quv = tuple(1e-4 * torch.randn(n_tab, device=device, generator=gen)
                for _ in range(2))
    stage = ray_physics.RK3_STAGES[1]
    outs = tuple(torch.empty_like(fields[0]) for _ in range(3))
    q_k = tuple(x.clone() for x in q)
    reset_launches()
    _, flux, _ = rhs_cuda_windowed.launch(inp, *state.mean, fields, outs, q_k,
                                          None, stage, flux_out=True)
    expect_launches("K4 flux tail launch", K4=1, K4_flux=1)
    ys, q_t, flux_t, _ = rhs_cuda_windowed.stage_reference(
        inp, fields, q, *state.mean, quv, stage, plan)
    errs = {f: rel(t, k) for f, t, k in
            zip(("dens", "r", "m", "q_dens", "q_r", "q_m", "flux"),
                (*ys, *q_t, flux_t), (*outs, *q_k, flux))}
    abs_err = max(float((t.double() - k.double()).abs().max())
                  for t, k in zip((*ys, flux_t), (*outs, flux)))
    work = rhs_cuda.scratch(n, n_tab, device)
    wbuf = tuple(torch.empty((4, n_tab), device=device).unbind(0))
    ms = cuda_ms(lambda: rhs_cuda_windowed.launch(
        inp, *state.mean, fields, outs, q_k, None, stage, work=work,
        flux_out=True))
    wind_ms = cuda_ms(lambda: rhs_cuda_windowed.launch(
        inp, *state.mean, fields, outs, q_k, wbuf, stage, work=work))
    for k, v in errs.items():
        check(v <= TWIN_BAR, f"K4 flux tail {k} vs twin at {n}")
    return {"errs": errs, "max_abs_err": abs_err, "ms": ms,
            "wind_tail_ms": wind_ms}


def gloo_worker(rank: int, init: str, out: str) -> None:
    """One of [15]'s two gloo ranks on the one card (:func:`gloo_rank`),
    in its world of two."""
    with world(init_method=init, world_size=2, rank=rank, backend="gloo",
               device="cuda:0") as device:
        gloo_rank(rank, device, out)


def gloo_rank(rank: int, device, out: str) -> None:
    """Path A at 1e6 rays (this rank's 5e5) for 5 steps, 20 timed steps,
    the all-reduce's time, and configs[4]'s ensemble on the mega mesh
    route; results to ``out/gloo<rank>.npz``."""
    torch.manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    mesh = make_mesh(2)
    cfg, bg, state, statics = bench_setup(N_SHARD, device, window_cells=-1)
    sharded_run(mesh, state, statics, bg, cfg, 2)
    reset_launches()
    collective.ALL_REDUCES = 0
    fin, _ = sharded_run(mesh, state, statics, bg, cfg, 5)
    counts = launches()
    reduces = collective.ALL_REDUCES
    dist.barrier()
    _, wall = sharded_run(mesh, state, statics, bg, cfg, SHARD_STEPS)
    ar = all_reduce_ms(mesh.get_group("rays"), device)
    log(f"[15] gloo rank {rank}: launches {counts}, all-reduces {reduces}; "
        f"{wall * 1e3 / SHARD_STEPS:.4f} ms a step; all-reduce {ar}")

    emesh = make_mesh(2, axis="ensemble")
    cfg_p, bg_p, mem_p = ensemble_members(device, 0.1)
    sp, stp = stack_ensemble(mem_p)
    run9 = mtt.RunConfig(**ENS_RUN)
    reset_launches()
    fe, _, mhe = ensemble_simulate(sp, stp, bg_p, cfg_p, run9, mesh=emesh,
                                   backend="mega")
    torch.cuda.synchronize()
    ens_counts = launches()
    ends = [0, N_MEMBERS - 1]
    host = lambda x: x.detach().cpu().numpy()

    # gradients: Path A over GLOO_GRAD_STEPS with remat, and the ensemble
    grad, _ = adjoint_run(path_a_grad_fn(statics, bg, cfg, GLOO_GRAD_STEPS,
                                         mesh), state, shard_theta(device),
                          wind=True)
    ens_grad, _ = adjoint_run(ensemble_grad_fn(stp, bg_p, cfg_p, emesh), sp,
                              ensemble_theta(device), wind=True)
    log(f"[15] gloo rank {rank}: Path A gradient over {GLOO_GRAD_STEPS} steps "
        f"(remat=True): all-reduces {grad['reduces']}, backward "
        f"{grad['bwd_s']:.4f} s; ensemble gradient: all-reduces "
        f"{ens_grad['reduces']}, backward {ens_grad['bwd_s']:.4f} s")
    grads = {f"grad_{k}": v for k, v in host_grads(grad).items()}
    grads.update({f"ens_grad_{k}": v for k, v in host_grads(ens_grad).items()})
    np.savez(f"{out}/gloo{rank}.npz", **grads,
             **{f: host(getattr(fin.rays, f)) for f in ("dens", "r", "m")},
             u=host(fin.mean.u), v=host(fin.mean.v),
             launches=json.dumps(counts), reduces=reduces,
             wall_ms_per_step=wall * 1e3 / SHARD_STEPS,
             all_reduce_wall_ms=ar["wall_ms"],
             ens_launches=json.dumps(ens_counts),
             **{f"ens_{f}": host(getattr(fe.rays, f)[ends])
                for f in ("dens", "r", "m")},
             ens_u=host(fe.mean.u[ends]), ens_hist_u=host(mhe.u[ends]))


def phase_gloo(five, want_grad: dict, smi: str) -> dict:
    """[15](b): two gloo ranks on the one card, as spawned processes, each
    within its own ``WORKER_TIMEOUT_S`` of their start.  ``five``: the
    unsharded Path A state after 5 steps; ``want_grad``: the unsharded
    gradient over ``GLOO_GRAD_STEPS`` (``adjoint_run`` with the wind)."""
    device = five.rays.r.device
    cfg_p, bg_p, mem_p = ensemble_members(device, 0.1)
    sp, stp = stack_ensemble(mem_p)
    want_ens, _ = adjoint_run(ensemble_grad_fn(stp, bg_p, cfg_p), sp,
                              ensemble_theta(device), wind=True)
    del sp, stp
    with tempfile.TemporaryDirectory() as tmp:
        init = f"file://{tmp}/store"
        procs = [subprocess.Popen(
            [sys.executable, "-c", f"import chip_smoke; "
             f"chip_smoke.gloo_worker({rank}, {init!r}, {tmp!r})"],
            cwd=HERE, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True) for rank in range(2)]
        t0 = time.perf_counter()
        try:
            outs = [p.communicate(timeout=max(
                1.0, t0 + WORKER_TIMEOUT_S - time.perf_counter()))[0]
                for p in procs]
        finally:
            for p in procs:
                p.kill()
        wall = time.perf_counter() - t0
        for rank, (p, o) in enumerate(zip(procs, outs)):
            for line in o.splitlines():
                if line.startswith("[15]"):
                    log(line)
            check(p.returncode == 0, f"gloo rank {rank} failed:\n{o[-4000:]}")
        res = [dict(np.load(f"{tmp}/gloo{rank}.npz")) for rank in range(2)]
    half = N_SHARD // 2
    errs = {}
    for rank, r in enumerate(res):
        counts = json.loads(str(r["launches"]))
        want = {k: 0 for k in counts} | {"K4": 15, "K4_flux": 15}
        check(counts == want and int(r["reduces"]) == 15,
              f"gloo rank {rank}: launches {counts}, all-reduces {r['reduces']}")
        e = {f: rel(getattr(five.rays, f)[rank * half:(rank + 1) * half],
                    torch.from_numpy(r[f])) for f in ("dens", "r", "m")}
        e.update(u=rel(five.mean.u, torch.from_numpy(r["u"])),
                 v=rel(five.mean.v, torch.from_numpy(r["v"])))
        errs[rank] = e
        for k, v in e.items():
            check(v < TRAJ_BAR, f"gloo rank {rank}, 5 steps, {k} vs unsharded")
        ens = json.loads(str(r["ens_launches"]))
        check(ens == {k: 0 for k in ens} | {"K7": 1},
              f"gloo rank {rank}: ensemble launches {ens}")

    # the gradients against the unsharded and meshless runs
    grad_errs_ = {}
    per_step = 3 * GLOO_GRAD_STEPS
    for rank, r in enumerate(res):
        for name, want, bar, reduces in (
                ("Path A", want_grad, GLOO_GRAD_BAR,
                 [per_step, 2 * per_step, per_step - 1]),
                ("ensemble", want_ens, ADJ_BAR, [0, 0, 0])):
            key = "grad_" if name == "Path A" else "ens_grad_"
            got = {k: float(r[key + k]) for k in ("d_scale", "d_theta")}
            got["d_u"] = torch.from_numpy(r[key + "d_u"])
            e = grad_errs(got, want)
            grad_errs_[f"{name}, rank {rank}"] = e
            for k, v in e.items():
                check(v < bar, f"gloo rank {rank}: {name} {k} off by {v:.3e}")
            # f's backward runs where the loss reads what the ray side
            # computed: not for the last stage, whose rays the wind-only
            # loss does not read
            check(r[key + "reduces"].tolist() == reduces,
                  f"gloo rank {rank}: {name} gradient's all-reduces "
                  f"{r[key + 'reduces'].tolist()}, not {reduces}")
    bwd_s = {rank: (float(r["grad_bwd_s"]), float(r["ens_grad_bwd_s"]))
             for rank, r in enumerate(res)}

    run9 = mtt.RunConfig(**ENS_RUN)
    member_errs = {}
    for i, e in enumerate((0, N_MEMBERS - 1)):
        f1, _, h1 = step_cuda_stream.simulate_streaming(*mem_p[e], bg_p, cfg_p,
                                                        run9)
        for rank, r in enumerate(res):
            me = {f: rel(getattr(f1.rays, f), torch.from_numpy(r[f"ens_{f}"][i]))
                  for f in ("dens", "r", "m")}
            me["u"] = rel(f1.mean.u, torch.from_numpy(r["ens_u"][i]))
            me["u_history"] = rel(h1[0].mean.u, torch.from_numpy(
                r["ens_hist_u"][i]))
            member_errs[f"member {e}, rank {rank}"] = me
            for k, v in me.items():
                check(v < 1e-5, f"gloo ensemble member {e} on rank {rank}, {k}")
    walls = [float(r["wall_ms_per_step"]) for r in res]
    reduce_ms = [float(r["all_reduce_wall_ms"]) for r in res]
    log(f"[15](b) gloo, 2 ranks on one card, {N_SHARD} rays ({half} a rank), "
        f"Path A 5 steps vs the unsharded run: {errs}; {SHARD_STEPS} steps "
        f"{walls} ms a step; one all-reduce {reduce_ms} ms (host wall); "
        f"configs[4] ensemble, 4 members a rank, one K7 launch each: "
        f"{member_errs}; both ranks {wall:.1f} s in all on {smi}")
    log(f"[15](b) gradients (dL/dscale, dL/dtheta, dL/du0) against the "
        f"unsharded Path A run ({GLOO_GRAD_STEPS} steps, remat=True) and the "
        f"meshless K7 run: {grad_errs_}; backward walls (Path A, ensemble) "
        f"{bwd_s} s; unsharded {want_grad['bwd_s']:.4f} s, meshless "
        f"{want_ens['bwd_s']:.4f} s")
    return {"errs": errs, "wall_ms_per_step": walls,
            "all_reduce_wall_ms": reduce_ms, "member_errs": member_errs,
            "grad_errs": grad_errs_, "grad_bwd_s": bwd_s,
            "ens_bwd_s_meshless": want_ens["bwd_s"], "wall_s": wall}


def phase_sharding(device, smi: str) -> dict:
    """Ray sharding (:func:`sharding_checks`) in an NCCL world of 1 made
    for the phase and ended after it, its cached mesh with it."""
    with world():
        try:
            return sharding_checks(device, smi)
        finally:
            MESHES.clear()


def sharding_checks(device, smi: str) -> dict:
    """Ray sharding: NCCL as a world of 1, gloo with two ranks on the one
    card, and ``--shard`` through the driver."""
    mode = compute_mode()
    log(f"[15] compute mode: {mode}")
    check(mode == "Default", f"[15] needs the Default compute mode, not {mode}")
    check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
          "[15](a): not an NCCL world of 1")
    mesh = rays_mesh()
    group = mesh.get_group("rays")

    # (a) Path A at 1e6 rays against the unsharded run
    cfg, bg, state, statics = bench_setup(N_SHARD, device, window_cells=-1)
    timed_simulate(state, statics, bg, cfg, 2)
    sharded_run(mesh, state, statics, bg, cfg, 2)
    one = timed_simulate(state, statics, bg, cfg, 1)[0]
    s_one = sharded_run(mesh, state, statics, bg, cfg, 1)[0]
    five = timed_simulate(state, statics, bg, cfg, 5)[0]
    s_five = sharded_run(mesh, state, statics, bg, cfg, 5)[0]
    e1, e5 = shard_errs(one, s_one), shard_errs(five, s_five)
    bitwise = {"1 step": same(one, s_one), "5 steps": same(five, s_five)}
    for k, v in e1.items():
        check(v <= TWIN_BAR, f"sharded Path A, 1 step, {k}")
    for k, v in e5.items():
        check(v <= TRAJ_BAR, f"sharded Path A, 5 steps, {k}")
    reset_launches()
    collective.ALL_REDUCES = 0
    _, wall_s = sharded_run(mesh, state, statics, bg, cfg, SHARD_STEPS)
    counts = expect_launches("sharded Path A", K4=3 * SHARD_STEPS,
                             K4_flux=3 * SHARD_STEPS)
    reduces = collective.ALL_REDUCES
    check(reduces == 3 * SHARD_STEPS, f"sharded Path A: {reduces} all-reduces")
    _, _, wall_u = timed_simulate(state, statics, bg, cfg, SHARD_STEPS)
    prof_s = profile_run("[15] sharded Path A, 10 steps", sharded_steps,
                         (state, statics, bg, cfg, 10), 10)
    prof_u = profile_run("[15] Path A, 10 steps", timed_simulate,
                         (state, statics, bg, cfg, 10), 10)
    tail = k4_flux_tail(state, statics, bg, cfg)
    nccl = all_reduce_ms(group, device)
    log(f"[15](a) NCCL world of 1, Path A at {N_SHARD} rays: sharded vs "
        f"unsharded after 1 step {fmt(e1)}, after 5 {fmt(e5)}; bitwise "
        f"{bitwise}; {SHARD_STEPS} sharded steps: launches {counts}, "
        f"all-reduces {reduces}; wall a step sharded "
        f"{wall_s * 1e3 / SHARD_STEPS:.4f} ms, unsharded "
        f"{wall_u * 1e3 / SHARD_STEPS:.4f} ms on {smi}")
    log(f"[15]   profiler over 10 steps, sharded: {prof_s}; unsharded: {prof_u}")
    log(f"[15]   K4 flux tail vs twin, one later-stage launch: "
        f"{fmt(tail['errs'])}; {tail['ms']:.5f} ms a launch (wind tail "
        f"{tail['wind_tail_ms']:.5f} ms); one NCCL all-reduce {nccl}")

    # (a) the gradient through sharded Path A with remat=True, against the
    # same run unsharded: dL/dscale, dL/dtheta, dL/du0
    theta = shard_theta(device)
    for m in (None, mesh):                                  # warm-up
        adjoint_run(path_a_grad_fn(statics, bg, cfg, 1, m), state, theta,
                    wind=True)
    grads = {}
    for name, m in (("unsharded", None), ("sharded", mesh)):
        reset_launches()
        grads[name], _ = peak_run(path_a_grad_fn(statics, bg, cfg, GRAD_STEPS, m),
                                  state, theta, wind=True)
        grads[name]["launches"] = expect_launches(
            f"{name} Path A gradient", K4=6 * GRAD_STEPS,
            K4_flux=6 * GRAD_STEPS if m else 0)
    g_u, g_s = grads["unsharded"], grads["sharded"]
    g_bitwise = (g_u["d_scale"] == g_s["d_scale"]
                 and g_u["d_theta"] == g_s["d_theta"]
                 and torch.equal(g_u["d_u"], g_s["d_u"]))
    g_errs = grad_errs(g_s, g_u)
    for k, v in g_errs.items():
        check(v < WORLD1_GRAD_BAR, f"sharded Path A gradient (world of 1): "
              f"{k} off the unsharded one by {v:.3e}")
    # a world of 1 skips f (a sum over one rank); the flux's all-reduces
    # run again in the checkpoint's replay and in K4's plain rerun
    check(g_s["reduces"] == [3 * GRAD_STEPS, 6 * GRAD_STEPS, 0],
          f"sharded Path A gradient: all-reduces {g_s['reduces']}, predicted "
          f"3 a step forward, 6 a step backward")
    for g in (g_u, g_s):
        g.pop("d_u")
        g["bwd_ms_per_step"] = g["bwd_s"] * 1e3 / GRAD_STEPS
        g["fwd_ms_per_step"] = g["fwd_s"] * 1e3 / GRAD_STEPS
    log(f"[15](a) gradient through sharded Path A at {N_SHARD} rays, "
        f"{GRAD_STEPS} steps, remat=True (world of 1) vs unsharded: bitwise "
        f"{g_bitwise}, {fmt(g_errs)}; all-reduces (forward, backward flux, "
        f"backward f) {g_s['reduces']}; launches {g_s['launches']}; a step "
        f"forward {g_s['fwd_ms_per_step']:.3f} ms, backward "
        f"{g_s['bwd_ms_per_step']:.3f} ms (unsharded "
        f"{g_u['fwd_ms_per_step']:.3f}, {g_u['bwd_ms_per_step']:.3f}); "
        f"max_memory_allocated {g_s['peak_gib']:.3f} GiB (unsharded "
        f"{g_u['peak_gib']:.3f}) on {smi}")
    want_grad, _ = adjoint_run(path_a_grad_fn(statics, bg, cfg, GLOO_GRAD_STEPS),
                               state, theta, wind=True)
    del theta

    routes = {}
    for name, per_step, kw in (
            ("K2", 3, dict()),
            ("K3", 4, dict(window_cells=-1, integrator="rk4")),
            ("K1", 3, dict(rhs_backend="xla", projection_backend="pallas",
                           interp_backend="mxu"))):
        c, b, s, st = bench_setup(N_MAIN, device, **kw)
        u1 = timed_simulate(s, st, b, c, 1)[0]
        s1 = sharded_run(mesh, s, st, b, c, 1)[0]
        reset_launches()
        collective.ALL_REDUCES = 0
        s3 = sharded_run(mesh, s, st, b, c, 3)[0]
        rc = expect_launches(f"sharded {name} route", **{name: 3 * per_step})
        check(collective.ALL_REDUCES == 3 * per_step,
              f"sharded {name} route: {collective.ALL_REDUCES} all-reduces")
        u3 = timed_simulate(s, st, b, c, 3)[0]
        r = {"errs_1": shard_errs(u1, s1), "errs_3": shard_errs(u3, s3),
             "bitwise_3": same(u3, s3), "launches": rc[name]}
        for k, v in r["errs_1"].items():
            check(v <= TWIN_BAR, f"sharded {name} route, 1 step, {k}")
        for k, v in r["errs_3"].items():
            check(v <= TRAJ_BAR, f"sharded {name} route, 3 steps, {k}")
        log(f"[15](a) {name} route sharded at {N_MAIN}: 1 step {fmt(r['errs_1'])}"
            f", 3 steps {fmt(r['errs_3'])} (bitwise {r['bitwise_3']}); "
            f"launches {rc[name]}, all-reduces {3 * per_step}")
        routes[name] = r

    gloo = phase_gloo(five, want_grad, smi)

    # (c) --shard through the driver, in this process's world of 1
    args = ["--preset", "fast", "--kernels", "windowed", "--steps",
            str(SHARD_STEPS)]
    with tempfile.TemporaryDirectory() as tmp:
        tmp = Path(tmp)
        collective.ALL_REDUCES = 0
        sh = cli_run("--shard --kernels windowed", [*args, "--shard"],
                     tmp / "s", K4=3 * SHARD_STEPS, K4_flux=3 * SHARD_STEPS)
        cli_reduces = collective.ALL_REDUCES
        check(cli_reduces == 3 * SHARD_STEPS, f"--shard: {cli_reduces} all-reduces")
        check("rays split over 1 rank(s)" in sh["printed"]
              and "falling back" not in sh["printed"], "--shard printed")
        un = cli_run("--kernels windowed", args, tmp / "u", K4=3 * SHARD_STEPS)
    cli_errs = {k: rel_np(un["diag"][k][0], sh["diag"][k][0])
                for k in ("flux", "wave_action", "u")}
    for k, v in cli_errs.items():
        check(v < TRAJ_BAR, f"--shard step 10 {k} vs the unsharded run")
    log(f"[15](c) --shard --kernels windowed, fast preset, {SHARD_STEPS} steps "
        f"(world of 1): launches {sh['launches']}, all-reduces {cli_reduces}; "
        f"step 10 vs the unsharded run {fmt(cli_errs)}; walls "
        f"{sh['wall_s']:.3f} s and {un['wall_s']:.3f} s")
    return {"compute_mode": mode, "errs_1": e1, "errs_5": e5, "bitwise": bitwise,
            "launches": counts, "all_reduces": reduces,
            "wall_ms_per_step": wall_s * 1e3 / SHARD_STEPS,
            "unsharded_wall_ms_per_step": wall_u * 1e3 / SHARD_STEPS,
            "profile": prof_s, "unsharded_profile": prof_u, "k4_flux_tail": tail,
            "grad": {"bitwise": g_bitwise, "errs": g_errs, "sharded": g_s,
                     "unsharded": g_u},
            "nccl_all_reduce": nccl, "routes": routes, "gloo": gloo,
            "cli": {"launches": sh["launches"], "all_reduces": cli_reduces,
                    "step10_errs": cli_errs}}


# ---------------------------------------------------------------------------
# [16] the examples and the dry run, as a user runs them
# ---------------------------------------------------------------------------

EXAMPLE_F64_BAR = 1e-9     # a float64 run on the card against the CPU's
SI_ITERS = 2               # source_inversion's iterations on the card
SI_STEP = 0.05             # the descent step along its first gradient
K5_TWIN_STEPS = 36         # a K5 launch at 1e6 held to its twin per ray
SPREAD_FACTOR = 3          # a chaotic launch against the twin's own spread


def quiet(fn, *args, **kw):
    """``(fn(*args, **kw), what it printed)``."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        res = fn(*args, **kw)
    return res, out.getvalue()


def stream_twin_errs(state, statics, bg, cfg, run, got_rays, got_u) -> dict:
    """One member's K6/K7 result (its rays and wind) against K6's twin
    over the same run, relative to the twin's maximum, and the largest
    absolute error of dens, r, m."""
    dens, r, m, uv, _, _ = stream_twin(state, statics, bg, cfg, run)
    want = {"dens": dens, "r": r, "m": m}
    errs = {f: rel(w, getattr(got_rays, f)) for f, w in want.items()}
    errs["u"] = rel(uv[0, 0], got_u)
    errs["max_abs_err"] = max(
        float((w.double().cpu() - getattr(got_rays, f).double().cpu())
              .abs().max()) for f, w in want.items())
    return errs


K7_WATCH_STEPS = (1, 2, 5, 10, 20, 30, 40, 50, 60)   # steps logged
K7_WATCH_FACTOR = 10     # K7's gap past float32's own that marks a fault


def k7_watch(cfg, bg, states, statics, run) -> dict:
    """Config 5's members step by step: K7 one launch a step, and the
    scan backend (``simulate`` member by member) in float32, each against
    the scan backend in float64.  Where K7's error outgrows the float32
    plain path's by ``K7_WATCH_FACTOR``, the first step and field; also the
    60 one-step launches against the one 60-step launch."""
    one = mtt.RunConfig(dt=run.dt, n_steps=1, save_every=1)
    k7, s = [], states
    for _ in range(run.n_steps):
        s = ensemble_simulate(s, statics, bg, cfg, one, backend="mega")[0]
        k7.append(s)
    whole = ensemble_simulate(states, statics, bg, cfg, run, backend="mega")[0]
    split = {f: rel(getattr(whole.rays, f), getattr(k7[-1].rays, f))
             for f in ("dens", "r", "m")}
    split["u"] = rel(whole.mean.u, k7[-1].mean.u)
    steps = mtt.RunConfig(dt=run.dt, n_steps=run.n_steps, save_every=1)
    keep = lambda st, stat, aux: st
    h32 = ensemble_simulate(states, statics, bg, cfg, steps, observe=keep)[2]
    h64 = ensemble_simulate(to64(states), to64(statics), to64(bg),
                            cfg.replace(dtype="float64"), steps,
                            observe=keep)[2]
    fields = ("dens", "r", "m", "u")
    n_members = states.rays.r.shape[0]
    pick = lambda st, f: st.mean.u if f == "u" else getattr(st.rays, f)
    errs = {"k7": {f: [] for f in fields}, "f32": {f: [] for f in fields}}
    first = None
    for t in range(run.n_steps):
        for f in fields:
            want = lambda e: pick(h64, f)[e, t]
            k = max(rel(want(e), pick(k7[t], f)[e]) for e in range(n_members))
            p = max(rel(want(e), pick(h32, f)[e, t]) for e in range(n_members))
            errs["k7"][f].append(k)
            errs["f32"][f].append(p)
            if first is None and k > K7_WATCH_FACTOR * max(p, 1e-7):
                first = {"step": t + 1, "field": f, "k7": k, "f32": p}
    members_u = [rel(pick(h64, "u")[e, -1], k7[-1].mean.u[e])
                 for e in range(n_members)]
    return {"first_divergence": first, "split_vs_one_launch": split,
            "members_u_vs_f64": members_u,
            "steps": {t: {kind: {f: errs[kind][f][t - 1] for f in fields}
                          for kind in errs} for t in K7_WATCH_STEPS
                      if t <= run.n_steps}}


def phase_examples(device, smi: str) -> dict:
    """The port's examples (``msgwam_tpu_torch.examples``) and its dry run
    (``msgwam_tpu_torch.dryrun``) on the card."""
    from msgwam_tpu_torch import api, dryrun
    from msgwam_tpu_torch.examples import (config_ladder, critical_level_relaunch,
                                           megakernel_day, reference_experiment,
                                           source_inversion)

    res, t_phase = {}, time.perf_counter()
    # megakernel_day: 1e6 rays, one day, ten K5 launches
    mk = megakernel_day
    cfg, bg, state, statics = mk.setup(mk.N_RAY, device)
    run = mtt.RunConfig(dt=mk.DT, n_steps=mk.N_STEPS, save_every=mk.SAVE_EVERY)
    mk.simulate_day(state, statics, bg, cfg, run)
    reset_launches()
    final, _, hist, wall = mk.simulate_day(state, statics, bg, cfg, run)
    counts = expect_launches("megakernel_day", K5=mk.N_STEPS // mk.SAVE_EVERY)
    check(finite(final), "megakernel_day: final state not finite")
    direct, _, _ = mtt.simulate_resident(state, statics, bg, cfg, run)
    check(same(direct, final), "megakernel_day: not bitwise simulate_resident")
    # K5 against its twin at the day's width: a K5_TWIN_STEPS launch from
    # the example's inputs within RESIDENT_BAR, and the day's first launch
    # (its first frame, SAVE_EVERY steps) within the twin's own spread.  At
    # 1e6 rays a 72-step run is chaotic: a 1e-7 change of the densities
    # moves the twin about as far as the kernel is from it (PERF.md §6),
    # so that launch is held to TRAJ_BAR or to SPREAD_FACTOR times the
    # twin's move, whichever is larger
    ops = step_cuda.operands(state, statics, bg, cfg, mk.DT)
    init = [state.rays.dens, state.rays.r, state.rays.m,
            torch.stack([state.mean.u, state.mean.v])]
    fields = ("dens", "r", "m", "u")
    pick = lambda out: (*out[:3], out[3][0])
    got = step_cuda.launch(ops, *[x.clone() for x in init], statics.active,
                           K5_TWIN_STEPS)
    twin = step_cuda.step_resident_reference(ops, *init, K5_TWIN_STEPS)
    short_errs = {f: rel(w, g) for f, w, g in zip(fields, pick(twin), pick(got))}
    short_abs = max(float((w.double() - g.double()).abs().max())
                    for w, g in zip(twin[:3], got[:3]))
    first = hist[0]
    day = (first.rays.dens[0], first.rays.r[0], first.rays.m[0],
           first.mean.u[0])
    twin = pick(step_cuda.step_resident_reference(ops, *init, mk.SAVE_EVERY))
    moved = pick(step_cuda.step_resident_reference(
        ops, init[0] * (1 + 1e-7), *init[1:], mk.SAVE_EVERY))
    window_errs = {f: rel(w, g) for f, w, g in zip(fields, twin, day)}
    spread = {f: rel(w, g) for f, w, g in zip(fields, twin, moved)}
    del ops, init, got, twin, moved, day
    log(f"[16] K5 at {mk.N_RAY} from megakernel_day's inputs: a "
        f"{K5_TWIN_STEPS}-step launch vs twin {fmt(short_errs)} (max abs "
        f"{short_abs:.3e}); the day's first launch ({mk.SAVE_EVERY} steps) vs "
        f"twin {fmt(window_errs)}, the twin's own move under a 1e-7 density "
        f"change {fmt(spread)}")
    for k, v in short_errs.items():
        check(v < RESIDENT_BAR,
              f"K5 {K5_TWIN_STEPS} steps at {mk.N_RAY} vs twin, {k}: {v}")
    for k, v in window_errs.items():
        check(v <= max(TRAJ_BAR, SPREAD_FACTOR * spread[k]),
              f"megakernel_day's first launch vs twin, {k}: {v} (the twin's "
              f"own spread {spread[k]})")
    reset_launches()
    out, printed = quiet(mk.main, [])
    main_counts = expect_launches("megakernel_day main",
                                  K5=2 * mk.N_STEPS // mk.SAVE_EVERY)
    check(same(out["final"], final), "megakernel_day main: another result")
    rate = mk.N_RAY * mk.N_STEPS / wall
    log(f"[16] megakernel_day {mk.N_RAY} x {mk.N_STEPS} (save_every "
        f"{mk.SAVE_EVERY}): launches {counts}, bitwise simulate_resident; "
        f"sim_day_wall_s {wall:.4f}, ray-steps/s {rate:.4e} on {smi}; main "
        f"(warm-up and timed day) launches {main_counts}")
    for line in printed.splitlines():
        log(f"[16]   {line}")
    res["megakernel_day"] = {"launches": counts["K5"], "wall_s": wall,
                             "ray_steps_per_s": rate,
                             "main_wall_s": out["wall_s"],
                             "short_launch_vs_twin": short_errs,
                             "short_launch_max_abs_err": short_abs,
                             "first_launch_vs_twin": window_errs,
                             "twin_spread": spread}
    del cfg, bg, state, statics, final, direct, out, hist, first

    # config_ladder: configs 1 and 2 on the plain path, config 5 through K7
    cl = config_ladder
    t0 = time.perf_counter()
    (wa, c1_out), (u2, c2_out) = (quiet(cl.config_1_fixed_background, device),
                                  quiet(cl.config_2_coupled, device))
    wall12 = time.perf_counter() - t0
    check(bool(np.isfinite(wa).all() and np.isfinite(u2).all()),
          "config_ladder configs 1, 2: not finite")
    cfg5, bg5, uu5, states5, statics5, run5 = cl.config_5_setup(device)
    reset_launches()
    (du5, c5_out), wall5 = timed(lambda: quiet(cl.config_5_ensemble, device))
    c5_counts = expect_launches("config_ladder config 5",
                                K7=run5.n_steps // run5.save_every)
    member_errs, twin5 = {}, {}
    for e in (0, cl.N_MEMBERS - 1):
        member = tree_map(lambda x: x[e], (states5, statics5))
        one, _, _ = step_cuda_stream.simulate_streaming(*member, bg5, cfg5, run5)
        member_errs[e] = rel(one.mean.u - uu5, torch.from_numpy(du5[e]))
        check(member_errs[e] < TRAJ_BAR,
              f"config 5 member {e} against its own run: {member_errs[e]}")
    # every member's wind response against K6's twin over the same window
    for e in range(cl.N_MEMBERS):
        member = tree_map(lambda x: x[e], (states5, statics5))
        uv = stream_twin(*member, bg5, cfg5, run5)[3]
        twin5[e] = rel(uv[0, 0] - uu5, torch.from_numpy(du5[e]))
        check(twin5[e] < TRAJ_BAR,
              f"config 5 member {e}'s wind response against K6's twin: "
              f"{twin5[e]}")
    log(f"[16] config_ladder ({cl.N_RAY} rays, {cl.N_STEPS} steps): configs "
        f"1 and 2 finite, {wall12:.3f} s; config 5 ({cl.N_MEMBERS} x "
        f"{cl.N_RAY // 4}, {run5.n_steps} steps): launches {c5_counts}, "
        f"{wall5:.4f} s; members 0 and 7 against their own K6 runs "
        f"{member_errs}; each member's wind response against K6's twin "
        f"{twin5}")
    for line in (c1_out + c2_out + c5_out).splitlines():
        log(f"[16]   {line}")
    watch = k7_watch(cfg5, bg5, states5, statics5, run5)
    log(f"[16] config 5, K7 watch: K7 (a launch a step) and the float32 scan "
        f"backend against the float64 scan backend, the largest member error "
        f"at steps {K7_WATCH_STEPS}: {watch['steps']}; first step where K7's "
        f"error passes {K7_WATCH_FACTOR}x float32's own: "
        f"{watch['first_divergence']}; each member's u at step "
        f"{run5.n_steps} {watch['members_u_vs_f64']}; 60 one-step launches "
        f"vs one 60-step launch {fmt(watch['split_vs_one_launch'])}")
    res["config_ladder"] = {"configs_1_2_wall_s": wall12,
                            "config_5_launches": c5_counts["K7"],
                            "config_5_wall_s": wall5,
                            "member_errs": member_errs,
                            "member_errs_vs_twin": twin5, "k7_watch": watch}

    # critical_level_relaunch at its defaults, streamed and read back
    with tempfile.TemporaryDirectory() as tmp:
        (crit, crit_out), wall_c = timed(lambda: quiet(
            critical_level_relaunch.main, ["--out", tmp]))
    check(np.array_equal(crit["history"], crit["pushed"]),
          "critical_level_relaunch: the file is not the frames pushed")
    active = int(crit["statics"].active.sum())
    log(f"[16] critical_level_relaunch (defaults): {crit['history'].shape[0]} "
        f"frames streamed and read back equal, {wall_c:.3f} s; active rays "
        f"at the end {active}")
    res["critical_level_relaunch"] = {"frames": int(crit["history"].shape[0]),
                                      "wall_s": wall_c, "active_end": active}

    # reference_experiment: the shim on the card against the CPU
    steps = 100
    try:
        (ref_gpu, _), wall_r = timed(lambda: quiet(
            reference_experiment.main, ["--steps", str(steps)]))
        ref_cpu, _ = quiet(reference_experiment.main,
                           ["--steps", str(steps), "--device", "cpu"])
    finally:
        api.DEVICE = None
    ref_errs = {k: rel_np(ref_cpu["hist"][k], ref_gpu["hist"][k])
                for k in ("dens", "rr", "mm")}
    ref_errs.update(u=rel_np(ref_cpu["hist_uu"], ref_gpu["hist_uu"]),
                    wa=rel_np(ref_cpu["wa"], ref_gpu["wa"]),
                    tendency=rel_np(ref_cpu["tendency"], ref_gpu["tendency"]))
    log(f"[16] reference_experiment, {steps} steps through the shim on the "
        f"card ({wall_r:.3f} s) vs --device cpu: {fmt(ref_errs)}")
    for k, v in ref_errs.items():
        check(v < EXAMPLE_F64_BAR, f"reference_experiment card vs cpu, {k}")
    res["reference_experiment"] = {"steps": steps, "wall_s": wall_r,
                                   "errs_vs_cpu": ref_errs}

    # source_inversion at full size in float64.  The optax chain at a rate
    # of 0.5 overshoots at first (losses 0.097, 1.30, 0.16, 0.63, 0.41 over
    # iterations 0-4, on the card as on the CPU), so the loss is held to
    # fall along the card's first gradient (a step of SI_STEP against it),
    # and the card's iterations to the CPU's
    si, _ = quiet(source_inversion.main, ["--iters", str(SI_ITERS)])
    si_cpu, _ = quiet(source_inversion.main,
                      ["--iters", str(SI_ITERS), "--device", "cpu"])
    si_errs = {"losses": max(abs(a - b) / abs(b) for a, b in
                             zip(si["losses"], si_cpu["losses"])),
               "params": rel(si_cpu["params"], si["params"])}
    simulate_wind = source_inversion.build_problem(device)
    with torch.no_grad():
        observed = simulate_wind(source_inversion.hidden_pattern(
            source_inversion.N_RAY, device))
    loss_fn = source_inversion.misfit(simulate_wind, observed)
    p0 = torch.zeros(source_inversion.N_RAY, dtype=torch.float64,
                     device=device, requires_grad=True)
    l0 = loss_fn(p0)
    l0.backward()
    with torch.no_grad():
        l1 = loss_fn(-SI_STEP * p0.grad / p0.grad.norm())
    it_s = float(np.median(si["walls_s"][1:]))
    log(f"[16] source_inversion ({source_inversion.N_RAY} rays, "
        f"{source_inversion.N_STEPS} steps, float64), {SI_ITERS} iterations: "
        f"losses {si['losses']}, against --device cpu {fmt(si_errs)}; one "
        f"iteration {it_s:.3f} s (first {si['walls_s'][0]:.3f} s) on {smi}; "
        f"a step of {SI_STEP} against the gradient: loss {l0.item():.6e} -> "
        f"{l1.item():.6e}")
    for k, v in si_errs.items():
        check(v < EXAMPLE_F64_BAR, f"source_inversion card vs cpu, {k}: {v}")
    check(l1.item() < l0.item(),
          f"source_inversion: no descent along the gradient ({l0.item()} -> "
          f"{l1.item()})")
    res["source_inversion"] = {"iterations": SI_ITERS, "losses": si["losses"],
                               "iteration_s": it_s,
                               "first_iteration_s": si["walls_s"][0],
                               "errs_vs_cpu": si_errs,
                               "descent": [l0.item(), l1.item()]}
    del simulate_wind, observed, loss_fn, p0

    # the dry run: entry() on the card, then two gloo ranks sharing it
    fn, example = dryrun.entry()
    (new_state, _), wall_e = timed(lambda: fn(*example))
    check(finite(new_state), "entry(): not finite")
    (dry, dry_out), wall_d = timed(lambda: quiet(
        dryrun.dryrun_multichip, 2, device="cuda"))
    for line in dry_out.splitlines():
        log(f"[16]   {line}")
    check("dryrun_multichip OK" in dry_out
          and "dryrun_multichip mega-ensemble OK" in dry_out,
          "dryrun_multichip: an OK line is missing")
    check(dry["launches"] == [{"K6": 1, "K7": 0}] * 2,
          f"dryrun_multichip: whole-run launches per rank {dry['launches']}")
    # each rank's K6 launch against K6's twin on the same member
    cfg_d, bg_d, _, _ = dryrun.setup(dryrun.PER_SHARD, device=device)
    mstates, mstatics = dryrun.mega_members(cfg_d, bg_d, 2)
    run_d = mtt.RunConfig(dt=dryrun.DT, n_steps=2, save_every=2)
    mega_errs = {}
    for e in range(2):
        member = tree_map(lambda x: x[e], (mstates, mstatics))
        got = tree_map(lambda x: x[e], dry["mega_final"])
        mega_errs[e] = stream_twin_errs(*member, bg_d, cfg_d, run_d,
                                        got.rays, got.mean.u)
        for k, v in mega_errs[e].items():
            check(k == "max_abs_err" or v < TRAJ_BAR,
                  f"dryrun_multichip rank {e}'s K6 launch vs twin, {k}: {v}")
    log(f"[16] dryrun: entry() {wall_e:.4f} s; dryrun_multichip(2, cuda) "
        f"{wall_d:.2f} s, one K6 launch a rank (one member a rank), each "
        f"against K6's twin {mega_errs}")
    res["dryrun"] = {"entry_wall_s": wall_e, "multichip_wall_s": wall_d,
                     "launches_per_rank": dry["launches"],
                     "mega_vs_twin": mega_errs}
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"[16] the phase took {res['wall_s']:.1f} s")
    return res


# ---------------------------------------------------------------------------
# [18] the bench entry point, as a user runs it
# ---------------------------------------------------------------------------

BENCH_ALL_STEPS = 72       # --all and the subcommand at 1e5
BENCH_MATRIX_STEPS = 800   # --matrix --steps: the rows from 1e6 up take 100
BENCH_GRAD_STEPS = 100     # --grad at 1e5, remat full
BENCH_SAVE, BENCH_SAVE_STEPS = 72, 720   # the --save-every pair
BENCH_TIMEOUT_S = 300      # each bench subprocess's own limit


class BenchRows:
    """While open, wraps ``bench._run`` (every row of ``run_one``) and
    ``bench._best_of``: each row's arguments, its launches with every
    count at 0 just before it, its all-reduces, its wall, the best time
    its value was computed from and, for rows of at most ``keep`` rays,
    its final state."""

    def __init__(self, keep: int = 0):
        self.keep = keep
        self.rows = []

    def __enter__(self):
        self._run, self._best_of = bench._run, bench._best_of
        sig = inspect.signature(self._run)
        best = []

        def run(*a, **kw):
            args = sig.bind(*a, **kw)
            args.apply_defaults()
            args = {k: v for k, v in args.arguments.items() if k != "device"}
            best.clear()
            reset_launches()
            collective_counts()
            t0 = time.perf_counter()
            rec = {"args": args}
            self.rows.append(rec)
            try:
                row, out = self._run(*a, **kw)
            finally:
                rec.update(wall_s=time.perf_counter() - t0,
                           launches=launches(),
                           reduces=collective_counts()[0], best_s=list(best))
            rec["row"] = row
            if args["n_ray"] <= self.keep:
                rec["final"] = out[0]
            return row, out

        def best_of(fn, device, reps=bench.REPS):
            b, out = self._best_of(fn, device, reps)
            best.append(b)
            return b, out

        bench._run, bench._best_of = run, best_of
        return self

    def __exit__(self, *exc):
        bench._run, bench._best_of = self._run, self._best_of


def bench_want(args: dict) -> dict:
    """The launches of one bench row: a warm-up and ``bench.REPS`` timed
    runs, each one launch a kernel launch window (K5, or K6 with the sort)
    or three a step (K2, K4; under sharding K4 in its flux tail)."""
    runs = 1 + bench.REPS
    steps, backend = args["n_steps"], args["backend"]
    if args["sharded"]:
        return {"K4": runs * 3 * steps, "K4_flux": runs * 3 * steps}
    if backend == "mega":
        kernel = "K6" if args["launch_sort"] == "on" else "K5"
        return {kernel: runs * steps // (args["save_every"] or steps)}
    return {"pallas": {"K2": runs * 3 * steps},
            "pallasw": {"K4": runs * 3 * steps}}.get(backend, {})


def bench_check(rec: dict, what: str, smi: str) -> dict:
    """A row of [18]: its launches as :func:`bench_want`'s, its value from
    its best time, the card's name and power limit; returns the row with
    its launches, wall and best time beside it."""
    args, row = rec["args"], rec["row"]
    want = bench_want(args)
    want = {k: want.get(k, 0) for k in rec["launches"]}
    check(rec["launches"] == want,
          f"[18] {what}: launches {rec['launches']}, expected {want}")
    check(len(rec["best_s"]) == 1, f"[18] {what}: {len(rec['best_s'])} timings")
    best = rec["best_s"][0]
    check(row["value"] == round(args["n_ray"] * args["n_steps"] / best, 1),
          f"[18] {what}: value {row['value']} is not rays x steps / best "
          f"({args['n_ray']} x {args['n_steps']} / {best})")
    check(f"{row['card']}, {row['power_limit']}" == smi,
          f"[18] {what}: card {row['card']!r}, {row['power_limit']!r}, "
          f"nvidia-smi {smi!r}")
    if args["backend"] == "mega" and not args["sharded"]:
        plan = step_cuda.resident_plan(args["n_ray"])
        row = {**row, "on_chip_share": plan.on_chip_share}
    return {**row, "launches": {k: v for k, v in rec["launches"].items() if v},
            "wall_s": rec["wall_s"], "best_s": best, "all_reduces": rec["reduces"]}


def bench_log(what: str, r: dict, smi: str) -> None:
    extra = {k: r[k] for k in ("peak_hbm_gb", "fallback_rate_end",
                               "fallback_rate_end_internal", "full_rate_end",
                               "compile_s", "on_chip_share") if k in r}
    log(f"[18] {what}: {r['value']:.6e} ray-steps/s (best {r['best_s']:.6f} s,"
        f" row {r['wall_s']:.3f} s), launches {r['launches']}, {extra} on {smi}")


def bench_cli(argv: list) -> list:
    """``bench.cli(argv)`` with what it prints kept and parsed: its JSON
    lines."""
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        bench.cli(argv)
    return [json.loads(line) for line in printed.getvalue().splitlines()
            if line.startswith("{")]


def bench_module(*args) -> subprocess.CompletedProcess:
    """``python -m msgwam_tpu_torch bench <args>`` in a fresh process."""
    return subprocess.run([sys.executable, "-m", "msgwam_tpu_torch", "bench",
                           *args], cwd=HERE, capture_output=True, text=True,
                          timeout=BENCH_TIMEOUT_S)


def phase_bench(device, smi: str) -> dict:
    """``python -m msgwam_tpu_torch bench`` as a user runs it: the bare
    command, the subcommand in a fresh process, --all, --matrix, --grad,
    --sharded and the --save-every pair, every row's launches counted."""
    del device
    t_phase = time.perf_counter()
    res = {}
    n = bench.N_RAY

    # (a) the bare command in-process: 1e5 x 8000 in one K5 launch a run,
    # and the 1e6 x 1000 extra; then the 1e5 row with --fallback
    with BenchRows() as rec:
        printed = bench_cli([])
        check(len(printed) == 1 and len(rec.rows) == 2,
              f"[18] bare: {len(printed)} lines, {len(rec.rows)} rows")
        line = printed[0]
        check("extra_error" not in line, f"[18] bare: {line.get('extra_error')}")
        check({"metric", "value", "unit", "vs_baseline", "card", "power_limit",
               "extra"} <= set(line), f"[18] bare: keys {sorted(line)}")
        bare = bench_check(rec.rows[0], "bare, the metric of record", smi)
        extra = bench_check(rec.rows[1], "bare, the 1e6 extra", smi)
        check(line["value"] == bare["value"]
              and line["extra"][0]["value"] == extra["value"],
              "[18] bare: the printed line is not the rows'")
        bench_cli(["--fallback"])
        fb = bench_check(rec.rows[2], "--fallback", smi)
    for what, r in (("bare, metric of record", bare),
                    ("bare, the extra 1e6 x 1000", extra),
                    ("--fallback 1e5 x 8000", fb)):
        bench_log(what, r, smi)
    res["bare"] = {"line": line, "metric_of_record": bare, "extra": extra,
                   "fallback": fb}

    # (b) the subcommand in a fresh process, and its --help
    t0 = time.perf_counter()
    sub = bench_module("--n-ray", str(n), "--steps", str(BENCH_ALL_STEPS),
                       "--backend", "pallasw")
    sub_s = time.perf_counter() - t0
    check(sub.returncode == 0, f"[18] bench subprocess: rc {sub.returncode}: "
                               f"{sub.stderr[-2000:]}")
    sub_row = json.loads(sub.stdout.strip().splitlines()[-1])
    check("pallasw" in sub_row["metric"]
          and f"{sub_row['card']}, {sub_row['power_limit']}" == smi,
          f"[18] bench subprocess: {sub_row}")
    helped = bench_module("--help")
    check(helped.returncode == 0 and "--matrix" in helped.stdout,
          f"[18] bench --help: rc {helped.returncode}")
    log(f"[18] python -m msgwam_tpu_torch bench --backend pallasw, {n} x "
        f"{BENCH_ALL_STEPS}: {sub_row['value']:.6e} ray-steps/s, the process "
        f"{sub_s:.1f} s; --help rc 0")
    res["subprocess"] = {"row": sub_row, "process_s": sub_s}

    # (c) --all at 1e5
    with BenchRows() as rec:
        printed = bench_cli(["--all", "--n-ray", str(n),
                             "--steps", str(BENCH_ALL_STEPS)])
    check(len(printed) == len(rec.rows) == 6, "[18] --all: not six rows")
    res["all"] = {}
    for line, r in zip(printed, rec.rows):
        a = r["args"]
        name = a["backend"] + ("+" + a["accum"] if a["accum"] != "native" else "")
        res["all"][name] = bench_check(r, f"--all {name}", smi)
        check(line["value"] == r["row"]["value"], f"[18] --all {name}: printed")
        bench_log(f"--all {name}, {n} x {BENCH_ALL_STEPS}", res["all"][name], smi)

    # (d) --matrix: every row, none an error, the artifact the rows
    with BenchRows() as rec, tempfile.TemporaryDirectory() as tmp:
        printed = bench_cli(["--matrix", "--steps", str(BENCH_MATRIX_STEPS),
                             "--out", tmp])
        written = json.loads((Path(tmp) / "bench_matrix.json").read_text())
    torch.cuda.empty_cache()
    errors = [r for r in printed if "error" in r]
    check(not errors, f"[18] --matrix: error rows {errors}")
    check(written == printed and len(rec.rows) == len(printed) == 15,
          "[18] --matrix: the artifact is not the printed rows")
    res["matrix"] = []
    for r in rec.rows:
        a = r["args"]
        what = (f"--matrix {a['backend']} {a['n_ray']:,} x {a['n_steps']}"
                + (f" save {a['save_every']} sort {a['launch_sort']}"
                   if a["save_every"] else "") + (" hprop" if a["hprop"] else ""))
        row = bench_check(r, what, smi)
        res["matrix"].append(row)
        bench_log(what, row, smi)

    # (e) --grad at 1e5, remat full, on the plain path and through K4
    res["grad"] = {}
    for backend in ("mxu", "pallasw"):
        reset_launches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        (row,) = bench_cli(["--grad", "--n-ray", str(n), "--steps",
                            str(BENCH_GRAD_STEPS), "--grad-remat", "full",
                            "--backend", backend])
        wall = time.perf_counter() - t0
        got = launches()
        check(row["gradient_finite"] and row["grad_max_abs"] > 0.0,
              f"[18] --grad {backend}: {row}")
        if backend == "pallasw":
            # three a step of every forward: the timed ones, and in each
            # gradient the first pass and remat's replays
            check(got["K4"] > 0 and got["K4"] % 3 == 0
                  and port_launches() == got["K4"] and not got["K4_flux"],
                  f"[18] --grad pallasw: launches {got}")
        else:
            check(port_launches() == 0, f"[18] --grad mxu: launches {got}")
        res["grad"][backend] = {**row, "launches": {k: v for k, v in got.items()
                                                    if v}, "wall_s": wall}
        log(f"[18] --grad --backend {backend} {n} x {BENCH_GRAD_STEPS}, remat "
            f"full: forward {row['forward_s']} s, value+grad {row['grad_s']} s,"
            f" ratio {row['bwd_fwd_ratio']}, |grad| max {row['grad_max_abs']:.6e},"
            f" peak {row.get('peak_hbm_gb')} GiB, launches "
            f"{res['grad'][backend]['launches']} on {smi}")

    # (f) --sharded as an NCCL world of 1 in this process: K4 in its flux
    # tail; the world taken down after the row if it was made for it
    with world():
        check(dist.get_backend() == "nccl" and dist.get_world_size() == 1,
              "[18] --sharded: not an NCCL world of 1")
        with BenchRows() as rec:
            (line,) = bench_cli(["--sharded", "--n-ray", str(n), "--steps",
                                 str(BENCH_ALL_STEPS)])
    sharded = bench_check(rec.rows[0], "--sharded", smi)
    want_reduces = (1 + bench.REPS) * 3 * BENCH_ALL_STEPS
    check("pallasw+sharded" in line["metric"]
          and sharded["all_reduces"] == want_reduces,
          f"[18] --sharded: {line['metric']}, all-reduces "
          f"{sharded['all_reduces']} (expected {want_reduces})")
    bench_log(f"--sharded {n} x {BENCH_ALL_STEPS}", sharded, smi)
    res["sharded"] = sharded

    # (g) --save-every 72 --steps 720 against one 720-step launch, in
    # turns: Path B's host work a launch
    order = (BENCH_SAVE, 0, 0, BENCH_SAVE)
    with BenchRows(keep=n) as rec:
        for save in order:
            flags = ["--n-ray", str(n), "--steps", str(BENCH_SAVE_STEPS)]
            bench_cli(flags + (["--save-every", str(save)] if save else []))
    pair = {}
    for save, r in zip(order, rec.rows):
        row = bench_check(r, f"--save-every {save}", smi)
        pair.setdefault(save, []).append(row["best_s"])
    launches_per_run = BENCH_SAVE_STEPS // BENCH_SAVE
    host_ms = (min(pair[BENCH_SAVE]) - min(pair[0])) / (launches_per_run - 1) * 1e3
    ten, one = rec.rows[0]["final"], rec.rows[1]["final"]
    bitwise = all(torch.equal(a, b) for a, b in
                  zip((*ten.rays, *ten.mean), (*one.rays, *one.mean)))
    res["save_every"] = {"best_s": {str(k): v for k, v in pair.items()},
                         "host_ms_per_launch": host_ms,
                         "ten_launches_bitwise_one": bitwise}
    log(f"[18] --save-every {BENCH_SAVE} --steps {BENCH_SAVE_STEPS} "
        f"({launches_per_run} K5 launches) against one launch, {n} rays, in "
        f"turns: best {pair[BENCH_SAVE]} s against {pair[0]} s: Path B's host "
        f"work {host_ms:.4f} ms a launch on {smi}; the final states bitwise "
        f"equal: {bitwise}")
    res["wall_s"] = time.perf_counter() - t_phase
    log(f"[18] the phase took {res['wall_s']:.1f} s")
    return res


TRACE_STEPS = 3       # steps of [19]'s K5 and K6 launches
SPAN_REPS = 100_000   # [19]'s gated spans timed with the profiler off
SPAN_BAR_US = 1.0     # a gated span's cost with no profiler


def keyed_order(state, statics, seed: int = SEED):
    """The rays in a seeded random order, as a keyed draw leaves them."""
    device = state.rays.r.device
    g = torch.Generator(device=device).manual_seed(seed)
    perm = torch.randperm(state.rays.r.shape[0], generator=g, device=device)
    take = lambda tree: tree_map(lambda x: x[perm].contiguous(), tree)
    return state._replace(rays=take(state.rays)), take(statics)


def counted(kernel: str, fn, device):
    """``fn(counter)`` inside a CPU profiler session, so that the window-tier
    counting is on, with ``kernel``'s counter on ``device``: its result and
    ``kernel``'s counts."""
    from torch.profiler import ProfilerActivity, profile

    profiling.reset_counts()
    with profile(activities=[ProfilerActivity.CPU]):
        out = fn(profiling.tier_counter(device, kernel))
    torch.cuda.synchronize()
    return out, profiling.counts()[kernel]


def span_us(reps: int) -> float:
    """The cost of one gated ``span()`` entered and left, in us."""
    t0 = time.perf_counter()
    for _ in range(reps):
        with profiling.span("msgwam.cost"):
            pass
    return (time.perf_counter() - t0) / reps * 1e6


def tier_row(kernel: str, n: int, kernel_fn, twin_fn, device) -> dict:
    """One kernel with counting off and on (outputs bitwise equal) and its
    twin's counts on the same inputs (equal to the kernel's)."""
    off = kernel_fn(None)
    on, got = counted(kernel, kernel_fn, device)
    bitwise = all(torch.equal(a, b) for a, b in zip(off, on))
    _, want = counted(kernel, twin_fn, device)
    log(f"[19] {kernel} at {n}: tiers {got} (twin {want}); counted outputs "
        f"bitwise the uncounted {bitwise}")
    check(bitwise, f"{kernel}: the counted launch's outputs differ")
    check(got == want, f"{kernel}: tier counts {got}, the twin's {want}")
    return {"tiers": got, "twin": want, "bitwise": bitwise}


def phase_tracing(device, smi: str) -> dict:
    """[19] The window-tier counts of K4, K5 and K6 against their twins,
    the outputs with counting on and off, and the cost of a span."""
    res = {"smi": smi}
    n = N_MAIN
    tiles = -(-n // ray_physics.TILE)
    windows = dict(window_cells=16, window_cells2=48)
    cfg, bg, state, statics = bench_setup(n, device, **windows)
    device = state.rays.r.device
    state, statics = keyed_order(state, statics)
    state = tile_spans(state, (5.0, 30.0, 90.0))
    n_tab = bg.centers.shape[0]
    inp = rhs_cuda.inputs(DT, state, statics, bg, cfg)
    fields = list(inp.fields)
    stage = ray_physics.RK3_STAGES[0]
    plan = rhs_cuda.device_plan(n, n_tab - 1, device)

    def k4(counter):
        outs = tuple(torch.empty_like(fields[0]) for _ in range(6))
        wind = tuple(torch.empty((4, n_tab), device=device).unbind(0))
        rhs_cuda_windowed.launch(inp, *state.mean, fields, outs[:3], outs[3:],
                                 wind, stage, counts=counter)
        return (*outs, *wind)

    def k4_twin(counter):
        return rhs_cuda_windowed.stage_reference(
            inp, fields, None, *state.mean, None, stage, plan, counts=counter)

    res["K4"] = tier_row("K4", n, k4, k4_twin, device)
    check(sum(res["K4"]["tiers"].values()) == tiles, "K4: a tile uncounted")
    check(all(res["K4"]["tiers"].values()), "K4: a tier never ran")

    ops = step_cuda.operands(state, statics, bg, cfg, DT)
    start = (state.rays.dens, state.rays.r, state.rays.m,
             torch.stack([state.mean.u, state.mean.v]))

    def k5(counter):
        return step_cuda.launch(ops, *(x.clone() for x in start), statics.active,
                                TRACE_STEPS, tiers=counter)

    def k5_twin(counter):
        return step_cuda.step_resident_reference(ops, *start, TRACE_STEPS,
                                                 tiers=counter)

    res["K5"] = tier_row("K5", n, k5, k5_twin, device)
    check(sum(res["K5"]["tiers"].values()) == 3 * TRACE_STEPS * tiles,
          "K5: a tile window uncounted")

    cfg, bg, state, statics, _, wind_fn = path_d_setup(n, device, **windows)
    state, statics = keyed_order(state, statics)
    state = tile_spans(state, (5.0, 30.0, 90.0))
    ops = step_cuda.operands(state, statics, bg, cfg, DT)
    src = step_cuda_stream._template((state.rays, statics), state.rays.r)
    life = step_cuda_stream.lifecycle_for(bg, cfg, (*src[:3], src[3].bool()))
    wind = step_cuda_stream._wind_table(wind_fn, 0.0, 0, TRACE_STEPS, DT, n_tab,
                                        device)
    start = (state.rays.dens, state.rays.r, state.rays.m,
             torch.stack([state.mean.u, state.mean.v])[None],
             statics.active.to(torch.uint8))

    def k6(counter):
        return step_cuda.launch(ops, *(x.clone() for x in start), TRACE_STEPS,
                                1, life, wind, tiers=counter, stream=True)

    def k6_twin(counter):
        return step_cuda_stream.step_stream_reference(
            ops, *start, TRACE_STEPS, life, wind, tiers=counter)

    res["K6"] = tier_row("K6", n, k6, k6_twin, device)
    check(sum(res["K6"]["tiers"].values()) == 3 * TRACE_STEPS * tiles,
          "K6: a tile window uncounted")

    from torch.profiler import ProfilerActivity, profile

    span_us(SPAN_REPS // 10)                    # warm-up
    off = span_us(SPAN_REPS)
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        on = span_us(SPAN_REPS // 100)
    ranges = [e.time_range.end - e.time_range.start for e in prof.events()
              if e.name == "msgwam.cost"]
    inside = sum(ranges) / len(ranges)
    res["span_us"] = {"off": off, "on": on, "on_recorded": inside}
    log(f"[19] a gated span: {off:.3f} us with no profiler, {on:.3f} us under "
        f"one, of which {inside:.3f} us inside its recorded range ({smi})")
    check(off < SPAN_BAR_US, f"a span with no profiler costs {off:.3f} us")
    return res


def phase_fresh_window(device) -> dict:
    """[17] The fallback of a window that lost records, exercised on every
    run: one K4 step at 1e5 rays profiled in a fresh process.  It runs
    last: a profiled process on the card may disturb this process's later
    windows (``PERF.md`` §7)."""
    cfg, bg, state, statics = bench_setup(N_MAIN, device, window_cells=-1)
    fresh = remeasure(k4_step, (state, statics, bg, cfg), 1)
    log(f"[17] one K4 step at {N_MAIN} profiled in a fresh process: "
        f"{fresh['kernels']} ({fresh['launched']} launched; seconds "
        f"{fresh['process_s']})")
    check(sum(fresh["kernels"].values()) == fresh["launched"] == 3
          == fresh["recorded"],
          f"Path A, fresh process: one kernel per K4 launch, got "
          f"{fresh['kernels']}")
    return {"kernels": fresh["kernels"], "process_s": fresh["process_s"]}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs the "
                         "port's kernels on the GPU and has no CPU mode")
    device = torch.device("cuda")
    t_run = time.perf_counter()
    torch.manual_seed(SEED)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi()
    log(f"[0] device {torch.cuda.get_device_name(0)} (nvidia-smi: {smi}); "
        f"torch {torch.__version__}, CUDA {torch.version.cuda}; TF32 off for "
        f"matmul and cuDNN")

    t0 = time.perf_counter()
    lib = _build.library()
    build_s = time.perf_counter() - t0
    tier_buffers()
    log(f"[1] built {_build.library_path().name} in {build_s:.2f} s ({lib._name})")
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if line.startswith("==") or "registers" in line or "spill" in line:
            log(f"[1]   {line.strip()}")

    k1 = phase_k1_random(device)
    k2, k3 = {}, {}
    for n in SIZES:
        cfg, bg, state, statics = bench_setup(n, device)
        k2[n] = phase_k2(state, statics, bg, cfg, "launch")
        k3[n] = phase_k3(state, statics, bg, cfg.replace(window_cells=-1),
                         "launch")
        del cfg, bg, state, statics
    cfg, bg, state, statics = bench_setup(N_MAIN, device, window_cells=16,
                                          window_cells2=48)
    k3["mixed"] = phase_k3(tile_spans(state, (5.0, 30.0, 90.0)), statics, bg,
                           cfg, "mixed tiles")
    check(all(k3["mixed"]["tier_counts"].values()), "mixed: a tier never ran")
    final, statics, bg, cfg, k2_day = phase_k2_day(device, smi)
    k2_spread = phase_k2(final, statics, bg, cfg, f"after {DAY_STEPS} steps")
    path_a, spread = phase_path_a(device, smi)
    k2_spread_1e6 = phase_k2(*spread[SIZES[1]],
                             f"after a Path A day of {DAY_STEPS} steps")
    k1["path_a_day_1000000"] = phase_k1(k1_inputs(*spread[SIZES[1]]),
                                        f"after a Path A day of {DAY_STEPS} steps")
    del spread
    path_b = phase_path_b(device, smi)
    route = phase_k1_route(device)
    path_d = phase_path_d(device, smi)
    sort = phase_launch_sort(device, smi)
    path_e = phase_path_e(device, smi)
    adjoint = phase_adjoint(device, smi)
    driver = phase_driver(smi)
    shard = phase_sharding(device, smi)
    examples = phase_examples(device, smi)
    bench_res = phase_bench(device, smi)
    tracing = phase_tracing(device, smi)
    fresh = phase_fresh_window(device)
    cli_launches = {k: v for r in driver["routes"].values()
                    for k, v in r["launches"].items() if v}
    cli_launches.update(K1=driver["k1_k3"]["launches"]["K1"],
                        K3=driver["k1_k3"]["launches"]["K3"],
                        K6=driver["config4"]["streamed"]["launches"]["K6"])

    kernels = [
        {"name": "K1 flux deposit (project_pallas)", "route": "cuda",
         "source": "msgwam_tpu_torch/csrc/projection.cu",
         "replaces": "msgwam_tpu/ops/projection_pallas.py:109",
         "launches": route["launches"], "redesigned": 6,
         "cli": '"projection_backend": "pallas" in a config file',
         "cli_launches": cli_launches["K1"],
         "bench": None, "bench_launches": None,
         "max_abs_err": max(r["max_abs_err"] for r in (*k1.values(),
                                                       *route["k1"].values())),
         **timing(k1[f"random_{N_MAIN}"])},
        {"name": "K2 fused RHS (rhs_fused)", "route": "cuda",
         "source": "msgwam_tpu_torch/csrc/rhs_windowed.cu",
         "replaces": "msgwam_tpu/ops/rhs_pallas.py:358",
         "launches": k2_day["launches"], "redesigned": 5,
         "cli": "--kernels pallas", "cli_launches": cli_launches["K2"],
         "bench": "python -m msgwam_tpu_torch bench --backend pallas (--all)",
         "bench_launches": bench_res["all"]["pallas"]["launches"]["K2"],
         "max_abs_err": max(k2[N_MAIN]["max_abs_err"], k2_spread["max_abs_err"],
                            k2_spread_1e6["max_abs_err"]),
         **timing(k2_spread)},
        {"name": "K3 windowed fused RHS (rhs_fused_windowed)", "route": "cuda",
         "source": "msgwam_tpu_torch/csrc/rhs_windowed.cu",
         "replaces": "msgwam_tpu/ops/rhs_pallas_windowed.py:338",
         "launches": path_a["k3_launches"], "redesigned": 5,
         "cli": '"kernels": "windowed" with "integrator": "rk4" in a config file',
         "cli_launches": cli_launches["K3"],
         "bench": None, "bench_launches": None,
         "max_abs_err": max(k3[N_MAIN]["max_abs_err"], k3["mixed"]["max_abs_err"]),
         **timing(k3[N_MAIN])},
        {"name": "K4 stage-fused windowed RHS (rk3_step_fused_windowed)",
         "route": "cuda", "source": "msgwam_tpu_torch/csrc/rhs_windowed.cu",
         "replaces": "msgwam_tpu/ops/rhs_pallas_windowed.py:392",
         "launches": path_a["launches"], "redesigned": 5,
         "cli": "--kernels windowed", "cli_launches": cli_launches["K4"],
         "bench": "python -m msgwam_tpu_torch bench --backend pallasw (--all; "
                  "--sharded runs its flux tail, --grad its forwards)",
         "bench_launches": bench_res["all"]["pallasw"]["launches"]["K4"],
         "max_abs_err": max(path_a["max_abs_err"],
                            shard["k4_flux_tail"]["max_abs_err"]),
         **timing(path_a),
         "sharded_launches": shard["launches"]["K4_flux"],
         "sharded_ms": shard["k4_flux_tail"]["ms"],
         "sharded_cli": "--shard --kernels windowed",
         "sharded_cli_launches": shard["cli"]["launches"]["K4_flux"]},
        {"name": "K5 whole-run kernel (simulate_resident)", "route": "cuda",
         "source": "msgwam_tpu_torch/csrc/step_resident.cu",
         "replaces": "msgwam_tpu/ops/step_pallas.py:538",
         "launches": path_b["launches"], "redesigned": 4,
         "cli": "--kernels mega", "cli_launches": cli_launches["K5"],
         "bench": "python -m msgwam_tpu_torch bench (bare: 1e5 x 8000, one "
                  "launch a run)",
         "bench_launches": bench_res["bare"]["metric_of_record"]["launches"]["K5"],
         "example": "python -m msgwam_tpu_torch.examples.megakernel_day",
         "example_launches": examples["megakernel_day"]["launches"],
         "max_abs_err": path_b["max_abs_err"], **timing(path_b)},
        {"name": "K6 whole-run kernel with the lifecycle (simulate_streaming)",
         "route": "cuda", "source": "msgwam_tpu_torch/csrc/step_resident.cu",
         "replaces": "msgwam_tpu/ops/step_pallas_stream.py:817",
         "launches": path_d["launches"], "redesigned": 4,
         "cli": "--kernels mega with the lifecycle or a tidal background "
                "(examples/config4.json)", "cli_launches": cli_launches["K6"],
         "bench": "python -m msgwam_tpu_torch bench --matrix (the "
                  "--launch-sort on rows)",
         "bench_launches": sum(r["launches"].get("K6", 0)
                               for r in bench_res["matrix"]),
         "example": "python -m msgwam_tpu_torch.dryrun --n-devices 2 "
                    "(one member a rank)",
         "example_launches": examples["dryrun"]["launches_per_rank"][0]["K6"],
         "max_abs_err": path_d["max_abs_err"], **timing(path_d)},
        {"name": "K7 ensemble whole-run kernel (simulate_streaming_ensemble)",
         "route": "cuda", "source": "msgwam_tpu_torch/csrc/step_resident.cu",
         "replaces": "msgwam_tpu/ops/step_pallas_stream.py:817",
         "launches": path_e["launches"], "redesigned": 4,
         "cli": None, "cli_launches": 0, "bench": None, "bench_launches": None,
         "example": "python -m msgwam_tpu_torch.examples.config_ladder",
         "example_launches": examples["config_ladder"]["config_5_launches"],
         "max_abs_err": path_e["max_abs_err"], **timing(path_e)},
    ]
    summary = {
        "k1": k1,
        "k2": {**{str(n): v for n, v in k2.items()}, "spread": k2_spread,
               "spread_1e6": k2_spread_1e6},
        "k3": {str(n): v for n, v in k3.items()},
        "k2_day": k2_day, "path_a": path_a, "path_b": path_b,
        "k1_route": route, "path_d": path_d, "launch_sort": sort,
        "path_e": path_e, "adjoint": adjoint, "driver": driver,
        "sharding": shard, "examples": examples, "bench": bench_res,
        "tracing": tracing,
        "profiler_windows": WINDOWS, "fresh_process_window": fresh,
        "build_s": build_s,
    }
    log("[9] details " + json.dumps(summary))
    log(f"[9] the run took {time.perf_counter() - t_run:.1f} s")
    check(all(math.isfinite(k[f]) for k in kernels
              for f in ("max_abs_err", "ms", "plain_ms", "bound_ms")),
          "non-finite summary")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
