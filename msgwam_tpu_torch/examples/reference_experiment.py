"""The reference's default experiment (``raytracer.py``), written against
the port's drop-in shim (:mod:`msgwam_tpu_torch.api`) exactly as a
reference user would write it: the counterpart of
``examples/reference_experiment.py``, with the same setup, the same
state-vector time loop, the same diagnostics and the two-panel figure.  A
reference user switching to the port changes one import line.

NOTE ON SIMILARITY: this example *deliberately* follows the structure and
parameter values of the upstream driver (``raytracer.py:32-240``): that is
the entire point of a drop-in-compatibility demonstration.  The code itself
is written fresh (argparse CLI, dict-based history, functions, decimated
diagnostics); the engine underneath is the port, in float64.

The shim computes on the card unless ``--device`` names another device
(it sets ``api.DEVICE``).  The figure is written only with ``--plot``.

Run:  python -m msgwam_tpu_torch.examples.reference_experiment [--steps N]
          [--nray 60] [--device cpu] [--plot FIG.png]
"""

from __future__ import annotations

import argparse

import numpy as np

import msgwam_tpu_torch.api as lprop  # <- the one changed line vs the reference
from msgwam_tpu_torch.state import default_device


def experiment(nt_max=None, nray: int = 60) -> dict:
    """The reference's run of ``nt_max`` steps (default two days) on
    ``api.DEVICE``: the ray and zonal wind histories, and the wave action
    and tendency of the conservation diagnostics."""
    # ---- global configuration (reference defaults) ----
    NN = 0.01
    ngrid = 101
    grid_max = 100e3
    lprop.HPROP_GLOBAL = False
    phi0 = np.deg2rad(0)
    dt = 120
    nday = 2
    nt_max = nt_max if nt_max else int(86400 / dt * nday)
    time = np.linspace(0, nt_max * dt, nt_max + 1)

    lprop.set_model_setup(
        bvf=NN, rhs=lprop.rhs_default, boussinesq=False, sig_rr=10000,
        u0=4, rr0=40000, rr1=40000, phi0=phi0, kappa=1.0,
        saturate_online=False,
    )

    # ---- initial condition ----
    alpha = 0.01
    k_abs_init = 2 * np.pi / 50e3
    direction = 90
    grid = np.linspace(0, grid_max, ngrid)
    grids = 0.5 * (grid[:-1] + grid[1:])
    lprop.grid = grid
    lprop.grids = grids

    init_kk = np.ones(nray) * k_abs_init * np.sin(np.deg2rad(direction))
    init_ll = np.ones(nray) * k_abs_init * np.cos(np.deg2rad(direction))
    init_mm = np.ones(nray) * -2 * np.pi / 5e3
    init_lon = np.zeros(nray)
    init_lat = np.ones(nray) * phi0
    edges = np.linspace(0, 15000, nray + 1)
    init_rr = 0.5 * (edges[:-1] + edges[1:])
    init_drr = np.ones(nray) * np.diff(init_rr)[0]
    rr_mm_area = 5e-5 * init_drr
    init_dmm = rr_mm_area / init_drr
    init_uu = lprop.velocities_sine_homogeneous(grids)
    init_vv = np.zeros(init_uu.shape)

    lprop.set_hydrostatics()
    lprop.set_pressure_gradient(init_uu, init_vv)
    init_dkk = np.ones(nray) * 1e-4
    init_dll = np.ones(nray) * 1e-4
    lprop.set_statics(dll=init_dll, dkk=init_dkk, rr_mm_area=rr_mm_area)

    f0 = 2 * lprop.ROT_EARTH * np.sin(phi0)
    rhobar_ray = np.interp(init_rr, grids, lprop.rhobar)
    omh = lprop.omega(init_kk, init_ll, init_mm, phi0)
    amplitude = alpha**2 * rhobar_ray / 2 * omh / init_mm**2 / (omh**2 - f0**2) * NN**2
    profile = np.exp(-((init_rr - init_rr.mean()) ** 2) / 2 / 2000**2)
    init_dens = amplitude * profile / init_dkk / init_dll / init_dmm

    # ---- history + time loop (reference state-vector pattern) ----
    hist = {name: np.zeros((nt_max + 1, nray)) for name in
            ("dens", "lam", "phi", "rr", "drr", "kk", "ll", "mm", "dmm")}
    hist_uu = np.zeros((nt_max + 1, len(grids)))
    hist_vv = np.zeros((nt_max + 1, len(grids)))
    for name, val in zip(hist, (init_dens, init_lon, init_lat, init_rr,
                                init_drr, init_kk, init_ll, init_mm, init_dmm)):
        hist[name][0] = val
    hist_uu[0], hist_vv[0] = init_uu, init_vv

    for nt in range(1, nt_max + 1):
        state_in = np.array([
            hist["dens"][nt - 1], hist["lam"][nt - 1], hist["phi"][nt - 1],
            hist["rr"][nt - 1], hist["drr"][nt - 1], hist["kk"][nt - 1],
            hist["ll"][nt - 1], hist["mm"][nt - 1], hist["dmm"][nt - 1],
            hist_uu[nt - 1], hist_vv[nt - 1],
        ], dtype=object)
        out = lprop.RK3(dt, state_in)
        dens_prop, hist["lam"][nt], hist["phi"][nt], hist["rr"][nt], \
            hist["drr"][nt], hist["kk"][nt], hist["ll"][nt], hist["mm"][nt], \
            hist["dmm"][nt], hist_uu[nt], hist_vv[nt] = out
        if not lprop.model_config["saturate_online"]:
            hist["dens"][nt] = lprop.saturation(
                dt, dens_prop, hist["rr"][nt - 1],
                (hist["rr"][nt] - hist["rr"][nt - 1]) / 1,
                hist["drr"][nt - 1], (hist["drr"][nt] - hist["drr"][nt - 1]) / dt,
                hist["kk"][nt], hist["ll"][nt], hist["mm"][nt - 1],
                (hist["mm"][nt] - hist["mm"][nt - 1]) / dt, direct=True,
            )
        else:
            hist["dens"][nt] = dens_prop
        print("progress: {0:.2f}%".format(nt / nt_max * 100), end="\r")
    print()

    # ---- wave-action conservation diagnostics (raytracer.py:194-240) ----
    nproj = max(nt_max - 4, 1)
    wa = np.zeros((nproj, len(grids)))
    flux = np.zeros((nproj, len(grids) - 1))
    for nt in range(nproj):
        common = (hist["dens"][nt], hist["lam"][nt], hist["phi"][nt],
                  hist["rr"][nt] - 0.5 * hist["drr"][nt],
                  hist["rr"][nt] + 0.5 * hist["drr"][nt],
                  hist["kk"][nt], hist["ll"][nt],
                  hist["mm"][nt] - 0.5 * hist["dmm"][nt],
                  hist["mm"][nt] + 0.5 * hist["dmm"][nt],
                  init_dkk, init_dll, hist["dmm"][nt])
        wa[nt] = lprop.wave_projection(*common, grid, var=2)
        flux[nt] = lprop.wave_projection(*common, grids, var=1)

    dz = np.diff(grid[:2])[0]
    tendency = np.zeros((nproj, len(grids)))
    tendency[:, 1:-1] = -np.diff(flux, axis=-1) / dz
    return {"hist": hist, "hist_uu": hist_uu, "time": time, "grids": grids,
            "wa": wa, "tendency": tendency,
            "plot_max_s": min(24 * 3600, nt_max * dt)}


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m msgwam_tpu_torch.examples.reference_experiment")
    ap.add_argument("--steps", type=int, default=None, help="override nt_max")
    ap.add_argument("--nray", type=int, default=60)
    ap.add_argument("--device", help="torch device (default: the card)")
    ap.add_argument("--plot", default=None, help="write the figure here")
    args = ap.parse_args(argv)

    lprop.DEVICE = str(default_device(args.device))
    res = experiment(args.steps, args.nray)
    if args.plot:
        from msgwam_tpu_torch.plotting import plot_wave_action_panels

        nproj = res["wa"].shape[0]
        plot_wave_action_panels(
            res["time"][:nproj], res["grids"], res["wa"], res["tendency"],
            plot_max_s=res["plot_max_s"], show=False, save_path=args.plot,
        )
        print(f"wrote {args.plot}")
    return res


if __name__ == "__main__":
    main()
