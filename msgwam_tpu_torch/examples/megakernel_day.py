"""A simulated day of 1e6 coupled ray volumes in ten kernel launches.

The north-star demonstration (``BASELINE.json``), the counterpart of
``examples/megakernel_day.py``: a million-ray-volume gravity wave field,
fully coupled to the mean flow with online saturation, stepped through a
whole simulated day (720 steps at dt = 120 s) by the whole-run kernel K5
(``csrc/step_resident.cu``): one ``simulate_resident`` call, one launch
per ``save_every`` window.  At 1e6 rays every tile stays on chip (the
kernel holds up to 1,081,344 rays there).  On an NVIDIA H100 80GB HBM3 at
a 700 W power limit the timed day took 0.0940 s of wall clock, 7.66e9
ray-steps/s (``chip_smoke.py`` [16]).  ``--device cpu`` runs K5's plain
twin instead: pass a small ``--n-ray`` there.

Run:  python -m msgwam_tpu_torch.examples.megakernel_day [--n-ray 1000000]
          [--steps 720] [--save-every 72] [--device cpu] [--plot out.png]
"""

from __future__ import annotations

import argparse
import time

import numpy as np
import torch

import msgwam_tpu_torch as mtt
from msgwam_tpu_torch.state import default_device

N_RAY = 1_000_000
N_STEPS = 720          # one day at dt = 120 s
SAVE_EVERY = 72
DT = 120.0


def setup(n_ray: int, device=None):
    """``(cfg, bg, state, statics)``: the bench population of ``n_ray``
    rays (a Gaussian spectrum launched at 2 km, 500 m deep, at 0.3% of
    saturation) over the sine jet, float32, online saturation."""
    device = default_device(device)
    cfg = mtt.REFERENCE_RUN_CONFIG.replace(
        saturate_online=True, dtype="float32",
        projection_backend="mxu", interp_backend="mxu",
    )
    gc = mtt.GridConfig()
    uu = mtt.velocities_sine_homogeneous(
        torch.tensor(gc.centers(), dtype=torch.float32), cfg)
    bg = mtt.make_background(gc, cfg, uu, torch.zeros_like(uu),
                             dtype=torch.float32, device=device)
    rays, statics = mtt.gaussian_spectrum_source(
        cfg, bg, n_ray, z_launch=2000.0, dz_launch=500.0,
        amplitude_alpha=0.003, dtype=torch.float32,
    )
    uu = uu.to(device)
    state = mtt.State(rays, mtt.MeanState(uu, torch.zeros_like(uu)))
    return cfg, bg, state, statics


def _sync(device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def simulate_day(state, statics, bg, cfg, run):
    """One ``simulate_resident`` call behind a synchronize: ``(final,
    statics, history, wall seconds)``."""
    device = state.rays.r.device
    _sync(device)
    t0 = time.perf_counter()
    final, statics_f, hist = mtt.simulate_resident(state, statics, bg, cfg, run)
    _sync(device)
    return final, statics_f, hist, time.perf_counter() - t0


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m msgwam_tpu_torch.examples.megakernel_day")
    ap.add_argument("--n-ray", type=int, default=N_RAY)
    ap.add_argument("--steps", type=int, default=N_STEPS)
    ap.add_argument("--save-every", type=int, default=SAVE_EVERY)
    ap.add_argument("--device", help="torch device (default: the card)")
    ap.add_argument("--plot", help="write the wave-action panels here")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    cfg, bg, state, statics = setup(args.n_ray, device)
    run = mtt.RunConfig(dt=DT, n_steps=args.steps, save_every=args.save_every)

    simulate_day(state, statics, bg, cfg, run)          # build + warm-up
    final, statics_f, hist, wall = simulate_day(state, statics, bg, cfg, run)

    sim_seconds = args.steps * run.dt
    print(f"{args.n_ray} rays × {args.steps} steps "
          f"({sim_seconds / 3600:.1f} simulated hours) in {wall:.4f} s wall "
          f"on {device} ({args.n_ray * args.steps / wall:.4g} ray-steps/s, "
          f"{sim_seconds / wall:.0f}× real time)")
    centers = bg.centers.cpu().numpy()
    du = (final.mean.u - state.mean.u).cpu().numpy()
    print(f"mean-flow response: max |ΔU| = {np.max(np.abs(du)):.3f} m/s at "
          f"z = {centers[np.argmax(np.abs(du))] / 1e3:.0f} km")

    if args.plot:
        from msgwam_tpu_torch.diagnostics import wave_action_history
        from msgwam_tpu_torch.plotting import plot_wave_action_panels

        h_state, h_active, _ = hist
        diag = wave_action_history(h_state.rays, h_active, statics_f, bg, cfg)
        t = np.arange(1, args.steps // args.save_every + 1) \
            * run.dt * args.save_every
        faces = bg.faces.cpu().numpy()
        plot_wave_action_panels(
            t, faces[:-1] + 0.5 * (faces[1] - faces[0]),
            diag.wave_action.cpu().numpy(), diag.tendency.cpu().numpy(),
            plot_max_s=float(t[-1]), show=False, save_path=args.plot,
        )
        print(f"wrote {args.plot}")
    return {"final": final, "history": hist, "wall_s": wall}


if __name__ == "__main__":
    main()
