"""The spectrum inversion of tests/test_source_inversion.py, through the
port: gradient descent with ``torch.optim.Adam`` and ``clip_grad_norm_``
on one log-amplitude per ray of a Gaussian spectrum source, through 60
coupled steps of ``simulate`` in float64, must reduce the misfit of the
observed wind history and start recovering the hidden pattern (the
thresholds of that test: loss below 0.3 of its start, correlation above
0.5)."""

import math

import numpy as np
import torch

import msgwam_tpu_torch as mtt

torch.set_num_threads(1)

N_RAY, N_STEPS, N_FRAMES = 100, 60, 6
BASE_ALPHA = 0.0015


def hidden_pattern(n_ray):
    """``examples/source_inversion.py:hidden_pattern``."""
    x = torch.linspace(-1.0, 1.0, n_ray, dtype=torch.float64)
    return (0.7 * torch.exp(-((x + 0.4) ** 2) / 0.08)
            - 0.5 * torch.exp(-((x - 0.5) ** 2) / 0.05))


def build_problem():
    """``examples/source_inversion.py:build_problem`` at the test's size:
    the wave-driven change of the mean zonal wind, one frame every 10
    steps, for a per-ray log-amplitude field."""
    cfg = mtt.REFERENCE_RUN_CONFIG.replace(saturate_online=True)
    gc = mtt.GridConfig()
    uu = mtt.velocities_sine_homogeneous(
        torch.tensor(gc.centers(), dtype=torch.float64), cfg)
    bg = mtt.make_background(gc, cfg, uu, torch.zeros_like(uu), device="cpu")
    run = mtt.RunConfig(dt=120.0, n_steps=N_STEPS,
                        save_every=N_STEPS // N_FRAMES)
    rays0, statics = mtt.gaussian_spectrum_source(
        cfg, bg, N_RAY, amplitude_alpha=BASE_ALPHA)

    def simulate_wind(log_amp):
        rays = rays0._replace(dens=rays0.dens * torch.exp(log_amp))
        state = mtt.State(rays, mtt.MeanState(uu, torch.zeros_like(uu)))
        _, _, history = mtt.simulate(state, statics, bg, cfg, run,
                                     validate=False)
        return history[0].mean.u - uu

    return simulate_wind


def test_spectrum_inversion_recovers_the_pattern():
    simulate_wind = build_problem()
    truth = hidden_pattern(N_RAY)
    with torch.no_grad():
        observed = simulate_wind(truth)
    frame_scale = (observed * observed).sum(dim=-1) + 1e-30

    def loss_fn(log_amp):
        diff = simulate_wind(log_amp) - observed
        return (((diff * diff).sum(dim=-1) / frame_scale).sum()
                + 1e-4 * (log_amp * log_amp).mean())

    params = torch.zeros(N_RAY, dtype=torch.float64, requires_grad=True)
    opt = torch.optim.Adam([params], lr=0.3)
    loss0 = None
    for _ in range(25):
        opt.zero_grad()
        loss = loss_fn(params)
        loss.backward()
        if loss0 is None:
            loss0 = loss.item()
            assert math.isfinite(loss0)
            assert bool(torch.isfinite(params.grad).all())
        torch.nn.utils.clip_grad_norm_([params], 10.0)
        opt.step()
    corr = float(np.corrcoef(params.detach().numpy(), truth.numpy())[0, 1])
    assert loss.item() < 0.3 * loss0, (loss0, loss.item())
    assert corr > 0.5, corr
