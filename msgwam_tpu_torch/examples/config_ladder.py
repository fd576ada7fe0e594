"""The BASELINE.json config ladder, end to end, in one script: the
counterpart of ``examples/config_ladder.py``.

Each BASELINE benchmark configuration as a small runnable demo (sized to
finish in seconds; raise the constants for real runs):

  1. Gaussian source spectrum over a fixed background, flux diagnostics only
     (``prognostic_mean=False``: the wind tendencies vanish).
  2. Interactive wave–mean-flow coupling: the projected pseudo-momentum flux
     divergence updates U(z) every step.
  5. A stochastic-source ensemble of 8 members.  On the card the whole
     ensemble runs as one launch of the kernel K7 (``backend="mega"``:
     members partitioned over the kernel's blocks); on the CPU the members
     run one after another through ``simulate`` (``backend="scan"``).  In
     a ``torch.distributed`` world of more than one rank the members are
     split over the ranks (``make_mesh(axis="ensemble")``).

Configs 1 and 2 run the dense ``mxu`` backends: plain PyTorch on the card.
Config 0 (the reference's single-packet default run) is
:mod:`.reference_experiment`; configs 3–4 (tidal shear + critical-level
culling and relaunch) are :mod:`.critical_level_relaunch`.

The ensemble's members are drawn from ``torch.Generator`` seeds 0-7 on
the host, so the card and the CPU run the same members; the JAX example
draws them from ``jax.random.PRNGKey(i)``, whose numbers are other ones.

Run:  python -m msgwam_tpu_torch.examples.config_ladder [--device cpu]
          [--plot out.png]
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

import msgwam_tpu_torch as mtt
from msgwam_tpu_torch.state import default_device

N_RAY = 2_000
N_STEPS = 240          # 8 simulated hours at dt=120 s
DT = 120.0
N_MEMBERS = 8


def base_setup(cfg, device=None, dtype=torch.float32):
    """``(grid, background, initial wind)``: the sine jet on the default
    grid."""
    gc = mtt.GridConfig()
    uu = mtt.velocities_sine_homogeneous(
        torch.tensor(gc.centers(), dtype=dtype), cfg)
    bg = mtt.make_background(gc, cfg, uu, torch.zeros_like(uu), dtype=dtype,
                             device=default_device(device))
    return gc, bg, uu.to(bg.centers.device)


def _still(uu):
    return mtt.MeanState(uu, torch.zeros_like(uu))


def _source(cfg, bg, n_ray: int, key=None):
    return mtt.gaussian_spectrum_source(
        cfg, bg, n_ray, z_launch=4000.0, dz_launch=2000.0,
        amplitude_alpha=0.01, key=key, dtype=torch.float32,
    )


def config_1_fixed_background(device=None):
    """Spectrum over a fixed background; wave-action flux diagnostics."""
    from msgwam_tpu_torch.diagnostics import wave_action_history

    cfg = mtt.REFERENCE_RUN_CONFIG.replace(
        saturate_online=True, dtype="float32", prognostic_mean=False,
        projection_backend="mxu", interp_backend="mxu",
    )
    gc, bg, uu = base_setup(cfg, device)
    rays, statics = _source(cfg, bg, N_RAY)
    state = mtt.State(rays, _still(uu))
    run = mtt.RunConfig(dt=DT, n_steps=N_STEPS, save_every=N_STEPS // 12)

    final, _, hist = mtt.simulate(state, statics, bg, cfg, run)
    hist_state, hist_active, _ = hist
    diag = wave_action_history(hist_state.rays, hist_active, statics, bg, cfg)
    wa = diag.wave_action.cpu().numpy()
    print(f"[config 1] fixed background: projected wave action, frame totals "
          f"{wa.sum(axis=1)[:4].round(4)} ...")
    return wa


def config_2_coupled(device=None):
    """Interactive coupling: flux divergence feeds back into U(z)."""
    cfg = mtt.REFERENCE_RUN_CONFIG.replace(
        saturate_online=True, dtype="float32",
        projection_backend="mxu", interp_backend="mxu",
    )
    gc, bg, uu = base_setup(cfg, device)
    rays, statics = _source(cfg, bg, N_RAY)
    state = mtt.State(rays, _still(uu))
    run = mtt.RunConfig(dt=DT, n_steps=N_STEPS, save_every=N_STEPS // 12)

    final, _, hist = mtt.simulate(state, statics, bg, cfg, run)
    u0, u1 = uu.cpu().numpy(), final.mean.u.cpu().numpy()
    du = u1 - u0
    centers = bg.centers.cpu().numpy()
    print(f"[config 2] coupled: max |ΔU| after {N_STEPS} steps = "
          f"{np.abs(du).max():.3f} m/s at z = "
          f"{centers[np.abs(du).argmax()] / 1e3:.0f} km")
    return np.stack([u0, u1])


def keyed_member(i: int, cfg, bg):
    """Member ``i``'s source: the config's spectrum drawn from a host
    ``torch.Generator`` seeded ``i``."""
    return _source(cfg, bg, N_RAY // 4, key=torch.Generator().manual_seed(i))


def config_5_setup(device=None, draw: Optional[Callable] = None):
    """``(cfg, bg, uu, states, statics, run)``: config 5's members stacked
    member-leading, and its run of ``N_STEPS // 4`` steps in one window.
    ``draw(i, cfg, bg) -> (rays, statics)`` makes member ``i``'s source
    (default :func:`keyed_member`)."""
    from msgwam_tpu_torch.parallel import stack_ensemble

    draw = draw or keyed_member
    cfg = mtt.REFERENCE_RUN_CONFIG.replace(
        saturate_online=True, dtype="float32",
        projection_backend="mxu", interp_backend="mxu",
    )
    gc, bg, uu = base_setup(cfg, device)
    members = []
    for i in range(N_MEMBERS):
        rays, statics = draw(i, cfg, bg)
        members.append((mtt.State(rays, _still(uu)), statics))
    states, statics = stack_ensemble(members)
    run = mtt.RunConfig(dt=DT, n_steps=N_STEPS // 4, save_every=N_STEPS // 4)
    return cfg, bg, uu, states, statics, run


def config_5_ensemble(device=None, draw: Optional[Callable] = None):
    """Stochastic-source ensemble.  On the card the whole ensemble runs as
    ONE launch of the kernel K7 per window (``backend="mega"``: members
    partitioned over the kernel's blocks); elsewhere the members run in
    turn through ``simulate`` (``backend="scan"``).  Split over the ranks
    when the ``torch.distributed`` world has more than one.  ``draw`` as
    in :func:`config_5_setup`."""
    from msgwam_tpu_torch.parallel import ensemble_simulate, make_mesh

    cfg, bg, uu, states, statics, run = config_5_setup(device, draw)
    world = dist.get_world_size() if dist.is_initialized() else 1
    mesh = make_mesh(axis="ensemble") if world > 1 else None
    backend = "mega" if bg.centers.device.type == "cuda" else "scan"
    finals, _, _ = ensemble_simulate(states, statics, bg, cfg, run,
                                     mesh=mesh, backend=backend)
    du = (finals.mean.u - uu[None, :]).cpu().numpy()
    spread = du.max(axis=0) - du.min(axis=0)
    print(f"[config 5] ensemble of {N_MEMBERS} ({backend} backend): member "
          f"wind-response spread max {spread.max():.4f} m/s (ranks: {world})")
    return du


def main(argv=None):
    ap = argparse.ArgumentParser(
        prog="python -m msgwam_tpu_torch.examples.config_ladder")
    ap.add_argument("--device", help="torch device (default: the card)")
    ap.add_argument("--plot", default=None, help="save a summary figure")
    args = ap.parse_args(argv)
    device = default_device(args.device)

    wa = config_1_fixed_background(device)
    u2 = config_2_coupled(device)
    du5 = config_5_ensemble(device)

    if args.plot:
        import matplotlib
        matplotlib.use("Agg")
        import matplotlib.pyplot as plt

        z = mtt.GridConfig().centers() / 1e3
        fig, axes = plt.subplots(1, 3, figsize=(12, 4))
        axes[0].imshow(wa.T, aspect="auto", origin="lower",
                       extent=[0, N_STEPS * DT / 3600, 0, 100])
        axes[0].set(title="cfg 1: wave action", xlabel="t [h]", ylabel="z [km]")
        axes[1].plot(u2[0], z, label="U(z, t=0)")
        axes[1].plot(u2[1], z, label="U(z, final)")
        axes[1].set(title="cfg 2: coupled wind", xlabel="U [m/s]")
        axes[1].legend()
        for m in du5:
            axes[2].plot(m, z, lw=0.7)
        axes[2].set(title="cfg 5: ensemble ΔU", xlabel="ΔU [m/s]")
        fig.tight_layout()
        fig.savefig(args.plot, dpi=120)
        print(f"wrote {args.plot}")


if __name__ == "__main__":
    main()
