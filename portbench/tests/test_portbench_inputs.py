"""The cell's inputs come from the seed alone."""

import json

import torch

from portbench import inputs
from portbench.tests.conftest import BENCH

CONF = json.loads((BENCH / "configs" / "ref_1e6.json").read_text())
SMALL = dict(CONF, n_ray=2000)


def test_same_seed_same_inputs():
    a = inputs.population(SMALL, 2**31 + 12345, "cpu")
    b = inputs.population(SMALL, 2**31 + 12345, "cpu")
    for x, y in zip(a, b):
        assert torch.equal(x, y)


def test_other_seed_other_draw_same_sizes():
    a = inputs.population(SMALL, 1, "cpu")
    b = inputs.population(SMALL, 2, "cpu")
    assert all(x.shape == y.shape == (2000,) for x, y in zip(a, b))
    assert not torch.equal(a.m, b.m)
    assert not torch.equal(a.r, b.r)
    # the frozen fields that a relaunch template must share are constants
    for f in ("k", "l", "dr", "dm", "dkk", "dll", "area", "phi"):
        assert torch.equal(getattr(a, f), getattr(b, f))


def test_draw_respects_the_spectrum():
    spec = SMALL["spectrum"]
    p = inputs.population(SMALL, 99, "cpu")
    k_abs = 2 * torch.pi / spec["wavelength_h"]
    lo = spec["m_center"] - spec["m_halfwidth"] * spec["m_sigma"]
    assert bool((p.m <= -k_abs + 1e-15).all()) and bool((p.m >= lo - 1e-12).all())
    half = spec["dz_launch"] / 2
    assert bool((abs(p.r - spec["z_launch"]) <= half).all())
    assert bool(torch.isfinite(p.dens).all()) and bool((p.dens > 0).all())


def test_negative_and_huge_seeds_are_seeds():
    a = inputs.population(SMALL, -5, "cpu")
    b = inputs.population(SMALL, 2**40 + 3, "cpu")
    assert bool(torch.isfinite(a.dens).all()) and bool(torch.isfinite(b.dens).all())
