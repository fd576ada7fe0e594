#!/usr/bin/env python3
"""Smoke run of msgwam_tpu_torch on one NVIDIA GPU (the H100 it targets).

    python3 chip_smoke.py

Builds the CUDA kernels from ``msgwam_tpu_torch/csrc`` (nvcc, at first
use), then, in order:

0. prints the device (``torch.cuda.get_device_name`` and ``nvidia-smi``'s
   name and power limit) and turns TF32 off for matmuls and cuDNN;
1. prints the build time and the compiler's register/spill report;
2. K1 (flux deposit) against its plain twin at 1e5 and 1e6 rays: error
   relative to the maximum against the float32 twin (bar 2e-5) and the
   float64 twin (bar 1e-6), bitwise equality of two launches, and the time
   of kernel and twin;
3. K2 (fused RHS) against its twin on the bench population (gaussian
   source at 2 km, online saturation, float32) at 1e5 and 1e6 rays, each
   output within 2e-5 of the twin's maximum, the flux against the float64
   twin, bitwise equality, times;
4. the main path: ``simulate`` with ``rhs_backend="pallas",
   window_cells=0`` at 1e5 rays for 720 steps (one simulated day at
   dt = 120 s): exactly 3 x 720 K2 launches, a finite final state, the
   first 5 steps against the plain torch path, and ray-steps/s and
   ``sim_day_wall_s`` of both paths; then K2 against its twin again on the
   spread-out final state;
5. K1 on its route: 5 steps with ``rhs_backend="xla",
   projection_backend="pallas"`` at 1e5 rays: 15 K1 launches, within 1e-4
   of the dense ``mxu`` path.

Any failed check raises and the exit code is nonzero.  Without a CUDA
device the script fails at once.  Its second-to-last lines are a JSON
``{"kernels": [...]}`` summary and the ``nvidia-smi`` line; its last line
is ``{"ok": true, "device": {...}}``.
"""

from __future__ import annotations

import json
import math
import subprocess
import sys
import time

import numpy as np
import torch

import msgwam_tpu_torch as mtt
from msgwam_tpu_torch import _build
from msgwam_tpu_torch.ops import projection_cuda, rhs_cuda

SEED = 0
N_MAIN = 100_000
SIZES = (100_000, 1_000_000)
DT = 120.0
DAY_STEPS = 720
TWIN_BAR = 2e-5        # f32 kernel vs f32 twin, relative to the maximum
F64_BAR = 1e-6         # deposit vs the float64 twin, relative to the maximum
TRAJ_BAR = 1e-4        # 5-step trajectories, as tests/test_rhs_fused.py


def log(*a):
    print(*a, flush=True)


def rel(a, b):
    a = a.detach().double().cpu()
    b = b.detach().double().cpu()
    return float((a - b).abs().max() / (a.abs().max() + 1e-30))


def check(ok: bool, what: str):
    if not ok:
        raise AssertionError(what)


def expect_launches(module, n: int, what: str):
    check(module.LAUNCHES == n,
          f"{what}: {module.__name__}.LAUNCHES = {module.LAUNCHES}, expected {n}")


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


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


# ---------------------------------------------------------------------------
# populations
# ---------------------------------------------------------------------------

def deposit_population(n: int, device, seed: int = SEED):
    """The random deposit population of tests/test_projection.py (realistic
    extents and values, f32-representable), two value rows, on the cell
    centers the main path deposits onto."""
    rng = np.random.default_rng(seed)
    r = rng.uniform(1e3, 80e3, n).astype(np.float32)
    dr = rng.uniform(300.0, 900.0, n).astype(np.float32)
    vals = (rng.lognormal(0.0, 1.0, (2, n)) * rng.uniform(0.1, 1.0, (2, n))
            * 0.12).astype(np.float32)
    pv = np.abs(rng.normal(1e-12, 1e-13, n)).astype(np.float32)
    grid = mtt.GridConfig().centers().astype(np.float32)
    t = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)
    return (t(vals), t(r - 0.5 * dr), t(r + 0.5 * dr), t(pv),
            torch.ones(n, dtype=torch.bool, device=device), t(grid))


def bench_setup(n: int, device, rhs_backend="pallas", **cfg_kw):
    """The bench population: REFERENCE_RUN_CONFIG with online saturation in
    float32, sine-jet winds, a gaussian spectrum of ``n`` rays launched at
    2 km with 500 m extents at 0.3% of saturation."""
    cfg = mtt.REFERENCE_RUN_CONFIG.replace(
        saturate_online=True, dtype="float32", rhs_backend=rhs_backend,
        window_cells=0, **cfg_kw)
    gc = mtt.GridConfig()
    centers = torch.tensor(gc.centers(), dtype=torch.float32)
    uu = mtt.velocities_sine_homogeneous(centers, cfg)
    vv = torch.zeros_like(uu)
    bg = mtt.make_background(gc, cfg, uu, vv, dtype=torch.float32, device=device)
    rays, statics = mtt.gaussian_spectrum_source(
        cfg, bg, n, z_launch=2000.0, dz_launch=500.0, amplitude_alpha=0.003,
        dtype=torch.float32, device=device)
    state = mtt.State(rays, mtt.MeanState(uu.to(device), vv.to(device)))
    return cfg, bg, state, statics


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

def phase_k1(n: int, device) -> dict:
    args = deposit_population(n, device)
    args64 = [a.double() if a.is_floating_point() else a for a in args]
    out = projection_cuda.project_pallas(*args)
    out2 = projection_cuda.project_pallas(*args)
    torch.cuda.synchronize()
    twin = projection_cuda.project_pallas_reference(*args)
    twin64 = projection_cuda.project_pallas_reference(*args64)
    res = {
        "n": n,
        "err_vs_twin": rel(twin, out),
        "err_vs_f64": rel(twin64, out),
        "twin_err_vs_f64": rel(twin64, twin),
        "max_abs_err": float((out.double() - twin.double()).abs().max()),
        "bitwise": bool(torch.equal(out, out2)),
        "ms": cuda_ms(lambda: projection_cuda.launch(*args)),
        "plain_ms": cuda_ms(lambda: projection_cuda.project_pallas_reference(*args),
                            iters=5),
    }
    log(f"[2] K1 n={n}: kernel vs f32 twin {res['err_vs_twin']:.3e}, "
        f"kernel vs f64 twin {res['err_vs_f64']:.3e} "
        f"(f32 twin vs f64 {res['twin_err_vs_f64']:.3e}), "
        f"bitwise repeat {res['bitwise']}, kernel {res['ms']:.4f} ms, "
        f"twin {res['plain_ms']:.4f} ms")
    check(res["err_vs_twin"] <= TWIN_BAR, f"K1 vs twin at {n}")
    check(res["err_vs_f64"] < F64_BAR, f"K1 vs f64 twin at {n}")
    check(res["bitwise"], f"K1 bitwise repeat at {n}")
    return res


def phase_k2(state, statics, bg, cfg, label: str) -> dict:
    n = state.rays.r.shape[0]
    prepared = (*rhs_cuda.prepare_inputs(DT, state, statics, bg, cfg),
                rhs_cuda.ray_fields(state, statics), statics.active,
                cfg.saturate_online, cfg.faithful_saturation)
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
        "n": n, "state": label, "errs": errs,
        "flux_err_vs_f64": rel(tflux64, flux),
        "max_abs_err": max(float((tend[f].double() - ttend[f].double()).abs().max())
                           for f in tend),
        "bitwise": bool(bitwise),
        "ms": cuda_ms(lambda: rhs_cuda.launch(*prepared)),
        "plain_ms": cuda_ms(
            lambda: rhs_cuda.rhs_fused_reference(DT, state, statics, bg, cfg),
            iters=5),
    }
    log(f"[3] K2 n={n} ({label}): kernel vs twin "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items())
        + f"; flux vs f64 twin {res['flux_err_vs_f64']:.3e}; bitwise repeat "
        f"{res['bitwise']}; kernel {res['ms']:.4f} ms, twin {res['plain_ms']:.4f} ms")
    for k, v in errs.items():
        check(v <= TWIN_BAR, f"K2 {k} vs twin at {n} ({label})")
    check(res["flux_err_vs_f64"] <= TWIN_BAR, f"K2 flux vs f64 twin at {n}")
    check(res["bitwise"], f"K2 bitwise repeat at {n}")
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


def phase_main(device, smi: str) -> tuple:
    cfg, bg, state, statics = bench_setup(N_MAIN, device)
    # warm-up: the first launches of every torch op on the card
    timed_simulate(state, statics, bg, cfg, 3)
    timed_simulate(state, statics, bg, plain_cfg(cfg), 3)

    rhs_cuda.LAUNCHES = 0
    projection_cuda.LAUNCHES = 0
    final, hist, wall = timed_simulate(state, statics, bg, cfg, DAY_STEPS)
    k2_launches, k1_launches = rhs_cuda.LAUNCHES, projection_cuda.LAUNCHES
    expect_launches(rhs_cuda, 3 * DAY_STEPS, "main path")
    check(k1_launches == 0, "main path ran K1")
    check(finite(final), "main path final state is not finite")
    check(hist[0].rays.r.shape == (1, N_MAIN), "history layout")

    _, _, wall_plain = timed_simulate(state, statics, bg, plain_cfg(cfg),
                                      DAY_STEPS)
    rate = N_MAIN * DAY_STEPS / wall
    rate_plain = N_MAIN * DAY_STEPS / wall_plain
    log(f"[4] main path n={N_MAIN}, {DAY_STEPS} steps: K2 launches "
        f"{k2_launches}, final state finite; on {smi}:")
    log(f"[4]   kernel path: sim_day_wall_s {wall:.4f}, ray-steps/s {rate:.4e}")
    log(f"[4]   plain path:  sim_day_wall_s {wall_plain:.4f}, "
        f"ray-steps/s {rate_plain:.4e}")

    a, _, _ = timed_simulate(state, statics, bg, cfg, 5)
    b, _, _ = timed_simulate(state, statics, bg, plain_cfg(cfg), 5)
    errs = {f: rel(getattr(b.rays, f), getattr(a.rays, f)) for f in ("dens", "r", "m")}
    errs["u"] = rel(b.mean.u, a.mean.u)
    log("[4]   first 5 steps, kernel vs plain path: "
        + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    for k, v in errs.items():
        check(v < TRAJ_BAR, f"5-step trajectory {k}")
    return final, statics, bg, cfg, {
        "launches": k2_launches, "sim_day_wall_s": wall,
        "ray_steps_per_s": rate, "plain_sim_day_wall_s": wall_plain,
        "plain_ray_steps_per_s": rate_plain, "traj_errs": errs,
    }


def phase_k1_route(device) -> dict:
    cfg, bg, state, statics = bench_setup(
        N_MAIN, device, rhs_backend="xla", projection_backend="pallas",
        interp_backend="mxu")
    rhs_cuda.LAUNCHES = 0
    projection_cuda.LAUNCHES = 0
    a, _, wall = timed_simulate(state, statics, bg, cfg, 5)
    k1_launches = projection_cuda.LAUNCHES
    expect_launches(projection_cuda, 15, "K1 route")
    check(rhs_cuda.LAUNCHES == 0, "K1 route ran K2")
    b, _, _ = timed_simulate(state, statics, bg, plain_cfg(cfg), 5)
    errs = {f: rel(getattr(b.rays, f), getattr(a.rays, f)) for f in ("dens", "r", "m")}
    errs["u"] = rel(b.mean.u, a.mean.u)
    log(f"[5] K1 route n={N_MAIN}, 5 steps: K1 launches {k1_launches}; vs mxu "
        "path " + ", ".join(f"{k} {v:.3e}" for k, v in errs.items()))
    for k, v in errs.items():
        check(v < TRAJ_BAR, f"K1 route trajectory {k}")
    return {"launches": k1_launches, "errs": errs}


def main() -> int:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs the "
                         "port's kernels on the GPU and has no CPU mode")
    device = torch.device("cuda")
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
    log(f"[1] built {_build.library_path().name} in {build_s:.2f} s ({lib._name})")
    for line in _build.library_path().with_suffix(".log").read_text().splitlines():
        if "registers" in line or "spill" in line:
            log(f"[1]   {line.strip()}")

    k1 = {n: phase_k1(n, device) for n in SIZES}
    k2 = {}
    for n in SIZES:
        cfg, bg, state, statics = bench_setup(n, device)
        k2[n] = phase_k2(state, statics, bg, cfg, "launch")
        del cfg, bg, state, statics
    final, statics, bg, cfg, main_res = phase_main(device, smi)
    k2_spread = phase_k2(final, statics, bg, cfg, f"after {DAY_STEPS} steps")
    route = phase_k1_route(device)

    kernels = [
        {"name": "K1 flux deposit (project_pallas)", "route": "cuda",
         "source": "msgwam_tpu_torch/csrc/projection.cu",
         "replaces": "msgwam_tpu/ops/projection_pallas.py:109",
         "launches": route["launches"],
         "max_abs_err": k1[N_MAIN]["max_abs_err"],
         "ms": k1[N_MAIN]["ms"], "plain_ms": k1[N_MAIN]["plain_ms"]},
        {"name": "K2 fused RHS (rhs_fused)", "route": "cuda",
         "source": "msgwam_tpu_torch/csrc/rhs_fused.cu",
         "replaces": "msgwam_tpu/ops/rhs_pallas.py:358",
         "launches": main_res["launches"],
         "max_abs_err": max(k2[N_MAIN]["max_abs_err"], k2_spread["max_abs_err"]),
         "ms": k2_spread["ms"], "plain_ms": k2_spread["plain_ms"]},
    ]
    summary = {
        "k1": {str(n): v for n, v in k1.items()},
        "k2": {**{str(n): v for n, v in k2.items()}, "spread": k2_spread},
        "main": main_res, "k1_route": route, "build_s": build_s,
    }
    log("[6] details " + json.dumps(summary))
    check(all(math.isfinite(k[f]) for k in kernels
              for f in ("max_abs_err", "ms", "plain_ms")), "non-finite summary")
    print(json.dumps({"kernels": kernels}))
    print(smi)
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
