"""BASELINE config-4 style experiment, the counterpart of
``examples/critical_level_relaunch.py``: a continuously launched wave
spectrum propagating into a transient (tidal) shear.  Rays are absorbed at
descending critical levels (|m| grows without bound, cg_r -> 0), culled and
relaunched from the source, while the pseudo-momentum flux history streams
to disk through the native async writer (``utils/history_io.py``).

The run is ``simulate`` on the dense ``mxu`` backends with the lifecycle
and a ``wind_fn`` (the plain PyTorch path on the card), in chunks of an
hour, each with its own start time ``t0``.

Run:  python -m msgwam_tpu_torch.examples.critical_level_relaunch
          [--nray 20000] [--hours 12] [--out results_critical] [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import os

import numpy as np
import torch

import msgwam_tpu_torch as mtt
from msgwam_tpu_torch.diagnostics import pseudo_momentum_flux
from msgwam_tpu_torch.state import default_device
from msgwam_tpu_torch.utils.history_io import HistoryWriter, read_history

DT = 120.0
CHUNK_STEPS = 30       # stream one snapshot per hour


def setup(n_ray: int, device=None):
    """``(cfg, bg, source, state, wind_fn)``: the spectrum, its relaunch
    template (``source``, the launch state itself) and the tidal wind."""
    device = default_device(device)
    cfg = mtt.REFERENCE_RUN_CONFIG.replace(
        dtype="float32",
        projection_backend="mxu", interp_backend="mxu",
        saturate_online=True,
        prognostic_mean=False,            # wind is imposed (tidal), not prognostic
        u0=25.0, rr0=20e3, sig_rr=8e3,
        cull=True, relaunch=True,
        m_max=2 * math.pi / 300.0,        # absorb when lambda_z < 300 m
    )
    gc = mtt.GridConfig()
    zeros = torch.zeros(gc.n_cell)
    bg = mtt.make_background(gc, cfg, zeros, zeros, dtype=torch.float32,
                             device=device)
    centers = bg.centers
    source = mtt.gaussian_spectrum_source(
        cfg, bg, n_ray, z_launch=2000.0, dz_launch=800.0,
        amplitude_alpha=0.005, dtype=torch.float32,
    )
    u0 = mtt.tidal_shear(centers, 0.0, cfg)
    state = mtt.State(source[0], mtt.MeanState(u0, torch.zeros_like(u0)))

    def wind_fn(t):
        return mtt.tidal_shear(centers, t, cfg), torch.zeros_like(centers)

    return cfg, bg, source, state, wind_fn


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m msgwam_tpu_torch.examples.critical_level_relaunch")
    ap.add_argument("--nray", type=int, default=20000)
    ap.add_argument("--hours", type=float, default=12.0)
    ap.add_argument("--out", default="results_critical")
    ap.add_argument("--device", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    cfg, bg, source, state, wind_fn = setup(args.nray, args.device)
    statics = source[1]
    n_chunks = int(args.hours * 3600 / DT / CHUNK_STEPS)
    chunk = mtt.RunConfig(dt=DT, n_steps=CHUNK_STEPS, save_every=CHUNK_STEPS)

    os.makedirs(args.out, exist_ok=True)
    path = os.path.join(args.out, "wa_history.msgw")
    n_cell = bg.centers.shape[0]
    pushed = []
    with HistoryWriter(path, (2, n_cell - 1), np.float32) as w:
        for c in range(n_chunks):
            state, statics, _ = mtt.simulate(
                state, statics, bg, cfg, chunk, source=source,
                wind_fn=wind_fn, t0=c * CHUNK_STEPS * DT)
            flux = pseudo_momentum_flux(state.rays, statics, bg, cfg)
            pushed.append(flux.cpu().numpy())
            w.push(pushed[-1])
            n_active = int(statics.active.sum())
            print(f"t = {(c + 1) * CHUNK_STEPS * DT / 3600:5.1f} h   "
                  f"active rays {n_active}/{args.nray}   "
                  f"max |m| {float(state.rays.m.abs().max()):.4f}",
                  flush=True)

    hist = read_history(path)
    print(f"streamed flux history: {hist.shape} -> {path}")
    if not np.all(np.isfinite(hist)):
        raise FloatingPointError(f"non-finite flux in {path}")
    return {"history": hist, "pushed": np.stack(pushed) if pushed else None,
            "final": state, "statics": statics, "path": path}


if __name__ == "__main__":
    main()
