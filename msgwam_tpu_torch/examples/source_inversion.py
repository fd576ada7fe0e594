"""Spectrum inversion by gradient descent THROUGH the coupled simulation:
the counterpart of ``examples/source_inversion.py``.

A capability the NumPy reference (raytracer.py) cannot offer: because the
whole wave/mean-flow system is differentiable, the classic
parameterization-tuning problem (*which gravity-wave source spectrum
produced this observed wind evolution?*) becomes an optimization solved
with autograd end to end through propagation, projection, saturation and
the mean-flow feedback.

Truth: the Gaussian-spectrum source (``models/sources.py``, the BASELINE
config-1 shape) modulated by a hidden smooth two-bump pattern across the
launch spectrum.  Observation: ten frames of the mean zonal wind over a
200-step coupled run.  Unknowns: one log-amplitude per spectral ray (200
parameters), the high-dimensional regime where adjoint gradients are the
only practical tool.

The run is float64 (adjoints through 200 coupled steps of clamped
saturation overflow in float32, and the kernels are float32 only), so it
takes the plain PyTorch path and its autograd, on the card unless
``--device`` names another device.  The optimizer is the JAX example's
optax chain rebuilt in torch: the global-norm clip at 10, Adam, and the
cosine decay from 0.5 to 0.025 over 150 iterations.

Run:  python -m msgwam_tpu_torch.examples.source_inversion [--iters 150]
          [--device cpu]
"""

from __future__ import annotations

import argparse
import math
import time

import numpy as np
import torch

import msgwam_tpu_torch as mtt
from msgwam_tpu_torch.state import default_device

N_RAY = 200
N_STEPS = 200
N_FRAMES = 10
DT = 120.0
BASE_ALPHA = 0.0015            # sub-breaking base amplitude
N_ITER = 150
LR = 0.5                       # optax.cosine_decay_schedule(0.5, 150, alpha=0.05)
LR_ALPHA = 0.05
CLIP_NORM = 10.0               # optax.clip_by_global_norm(10.0)


def hidden_pattern(n_ray: int, device=None) -> torch.Tensor:
    """The modulation to recover: two smooth bumps across the spectrum,
    one enhancing short waves, one suppressing long ones."""
    x = torch.linspace(-1.0, 1.0, n_ray, dtype=torch.float64,
                       device=default_device(device))
    return (0.7 * torch.exp(-((x + 0.4) ** 2) / 0.08)
            - 0.5 * torch.exp(-((x - 0.5) ** 2) / 0.05))


def build_problem(device=None):
    """``simulate_wind(log_amp)``: the wave-driven change of the mean zonal
    wind, one frame every ``N_STEPS // N_FRAMES`` steps, for a per-ray
    log-amplitude field, in float64 on ``device``."""
    device = default_device(device)
    cfg = mtt.REFERENCE_RUN_CONFIG.replace(saturate_online=True)
    gc = mtt.GridConfig()
    uu = mtt.velocities_sine_homogeneous(
        torch.tensor(gc.centers(), dtype=torch.float64), cfg).to(device)
    bg = mtt.make_background(gc, cfg, uu, torch.zeros_like(uu), device=device)
    run = mtt.RunConfig(dt=DT, n_steps=N_STEPS,
                        save_every=N_STEPS // N_FRAMES)
    rays0, statics = mtt.gaussian_spectrum_source(
        cfg, bg, N_RAY, amplitude_alpha=BASE_ALPHA)

    def simulate_wind(log_amp):
        """Mean-zonal-wind history for a per-ray log-amplitude field."""
        rays = rays0._replace(dens=rays0.dens * torch.exp(log_amp))
        state = mtt.State(rays, mtt.MeanState(uu, torch.zeros_like(uu)))
        _, _, history = mtt.simulate(state, statics, bg, cfg, run,
                                     validate=False)
        # observe the wave-DRIVEN wind change: the background jet itself
        # (|u| ~ 4 m/s) would otherwise dominate every frame norm
        return history[0].mean.u - uu

    return simulate_wind


def misfit(simulate_wind, observed):
    """``loss_fn(log_amp)``: the misfit of the wind history against
    ``observed``, each frame normalized so that early (small-response)
    frames count too, plus a weak prior toward the base spectrum (rays
    whose waves never reach the observed layers are otherwise
    unconstrained)."""
    frame_scale = (observed * observed).sum(dim=-1) + 1e-30

    def loss_fn(log_amp):
        diff = simulate_wind(log_amp) - observed
        return (((diff * diff).sum(dim=-1) / frame_scale).sum()
                + 1e-4 * (log_amp * log_amp).mean())

    return loss_fn


def cosine_decay(step: int) -> float:
    """``optax.cosine_decay_schedule(LR, N_ITER, alpha=LR_ALPHA)`` over
    ``LR``, in closed form: the factor of ``torch.optim.lr_scheduler.
    LambdaLR``."""
    t = min(step, N_ITER)
    return (1.0 - LR_ALPHA) * 0.5 * (1.0 + math.cos(math.pi * t / N_ITER)) \
        + LR_ALPHA


def clip_by_global_norm_(params, max_norm: float = CLIP_NORM) -> None:
    """``optax.clip_by_global_norm``: the gradients unchanged when their
    global norm is below ``max_norm``, else scaled as ``g / norm *
    max_norm`` (``clip_grad_norm_`` divides by ``norm + 1e-6`` instead)."""
    grads = [p.grad for p in params]
    norm = torch.sqrt(sum((g * g).sum() for g in grads))
    if not bool(norm < max_norm):
        for g in grads:
            g.copy_(g / norm * max_norm)


def make_optimizer(params):
    """``(optimizer, scheduler)``: Adam with optax's defaults (b1 0.9, b2
    0.999, eps 1e-8) under the cosine decay."""
    opt = torch.optim.Adam(params, lr=LR, betas=(0.9, 0.999), eps=1e-8)
    return opt, torch.optim.lr_scheduler.LambdaLR(opt, cosine_decay)


def optimizer_step(params, opt, sched) -> None:
    """One update of the chain ``clip_by_global_norm(10)``, ``adam``."""
    clip_by_global_norm_(params)
    opt.step()
    sched.step()


def main(argv=None) -> dict:
    ap = argparse.ArgumentParser(
        prog="python -m msgwam_tpu_torch.examples.source_inversion")
    ap.add_argument("--iters", type=int, default=N_ITER,
                    help="iterations to run (the schedule spans N_ITER)")
    ap.add_argument("--device", help="torch device (default: the card)")
    args = ap.parse_args(argv)

    device = default_device(args.device)
    simulate_wind = build_problem(device)
    truth = hidden_pattern(N_RAY, device)
    with torch.no_grad():
        observed = simulate_wind(truth)

    loss_fn = misfit(simulate_wind, observed)

    # start from the unmodulated source
    params = torch.zeros(N_RAY, dtype=torch.float64, device=device,
                         requires_grad=True)
    opt, sched = make_optimizer([params])

    def corrcoef():
        return float(np.corrcoef(params.detach().cpu().numpy(),
                                 truth.cpu().numpy())[0, 1])

    losses, walls = [], []
    for it in range(args.iters):
        t0 = time.perf_counter()
        opt.zero_grad()
        loss = loss_fn(params)
        loss.backward()
        optimizer_step([params], opt, sched)
        losses.append(loss.item())
        walls.append(time.perf_counter() - t0)
        if it % 25 == 0:
            print(f"iter {it:3d}  loss {losses[-1]:.3e}  "
                  f"pattern corr {corrcoef():.4f}  ({walls[-1]:.3f} s)")

    corr = corrcoef()
    rms = float(torch.sqrt(torch.mean((params.detach() - truth) ** 2)))
    print(f"recovered {N_RAY}-parameter spectrum: corr {corr:.4f}, "
          f"rms error {rms:.3f} (pattern rms "
          f"{float(torch.sqrt(torch.mean(truth ** 2))):.3f})")
    print(f"loss: {losses[0]:.3e} -> {losses[-1]:.3e} on {device}")
    return {"losses": losses, "walls_s": walls, "params": params.detach()}


if __name__ == "__main__":
    main()
