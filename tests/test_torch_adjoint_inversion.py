"""The spectrum inversion of tests/test_source_inversion.py, through the
port: gradient descent with ``torch.optim.Adam`` and the example's
global-norm clip on one log-amplitude per ray of a Gaussian spectrum
source, through 60 coupled steps of ``simulate`` in float64, must reduce
the misfit of the observed wind history and start recovering the hidden
pattern (the thresholds of that test: loss below 0.3 of its start,
correlation above 0.5).  The problem is the port's example's
(``msgwam_tpu_torch.examples.source_inversion``) at that test's size."""

import math

import numpy as np
import pytest
import torch

from msgwam_tpu_torch.examples import source_inversion as si

torch.set_num_threads(1)


@pytest.fixture
def small_problem(monkeypatch):
    """The example's constants cut as tests/test_source_inversion.py:31-33
    cuts the JAX example's."""
    monkeypatch.setattr(si, "N_RAY", 100)
    monkeypatch.setattr(si, "N_STEPS", 60)
    monkeypatch.setattr(si, "N_FRAMES", 6)


def test_spectrum_inversion_recovers_the_pattern(small_problem):
    simulate_wind = si.build_problem("cpu")
    truth = si.hidden_pattern(si.N_RAY, "cpu")
    with torch.no_grad():
        observed = simulate_wind(truth)
    loss_fn = si.misfit(simulate_wind, observed)

    params = torch.zeros(si.N_RAY, dtype=torch.float64, requires_grad=True)
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
        si.clip_by_global_norm_([params], 10.0)
        opt.step()
    corr = float(np.corrcoef(params.detach().numpy(), truth.numpy())[0, 1])
    assert loss.item() < 0.3 * loss0, (loss0, loss.item())
    assert corr > 0.5, corr
