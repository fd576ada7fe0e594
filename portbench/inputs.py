"""The inputs of a cell, made from ``--seed`` on the device.

A frozen copy of the port's bench population (``msgwam_tpu_torch/bench.py``
``_setup`` with the keyed draw of ``gaussian_spectrum_source``): ray
volumes launched around ``z_launch`` with vertical wavenumbers from a
gaussian spectrum cut at ``m_halfwidth`` standard deviations, an
amplitude jitter ``exp(0.3 N)`` and launch heights spread uniformly over
``dz_launch``, at a fraction ``amplitude_alpha^2`` of saturation.  The
seed drives one ``torch.Generator`` on the device; every seed gives the
same sizes, only other draws.  The wind is the sine jet of the reference
driver, and the imposed wind the tidal shear of ``BASELINE.json``
``configs[3]``.  Nothing here imports the program: the harness hands
these tensors to the program and to the reference alike.
"""

from __future__ import annotations

import math
from typing import NamedTuple

import torch

from .reference.model import ROT_EARTH, interp


class Population(NamedTuple):
    """Per-ray fields, float64, on the device."""

    dens: torch.Tensor
    lam: torch.Tensor
    phi: torch.Tensor
    r: torch.Tensor
    dr: torch.Tensor
    k: torch.Tensor
    l: torch.Tensor
    m: torch.Tensor
    dm: torch.Tensor
    dkk: torch.Tensor
    dll: torch.Tensor
    area: torch.Tensor


def generator(seed: int, device) -> torch.Generator:
    """The cell's generator on ``device``; any whole number is a seed."""
    gen = torch.Generator(device=device)
    gen.manual_seed(int(seed) % 2**64)
    return gen


def centers(grid: dict) -> torch.Tensor:
    """Cell centers of the uniform grid, float64 on the host."""
    faces = torch.linspace(0.0, float(grid["z_max"]), int(grid["n_face"]),
                           dtype=torch.float64)
    return 0.5 * (faces[:-1] + faces[1:])


def sine_jet(z, model: dict):
    """The reference driver's wind: a tanh-enveloped sine jet."""
    env = 0.5 * (torch.tanh((z - model["rr0"]) / model["sig_rr"]) + 1.0)
    return model["u0"] * env * torch.sin(z / model["sig_rr"] * 2.0 * math.pi)


def tidal(z, t, model: dict, wind: dict):
    """The transient tidal wind ``U(z, t)``: phase moving down at the
    tide's period and vertical wavelength, under the jet's envelope."""
    phase = 2.0 * math.pi * (z / wind["lambda_z"] + t / wind["period"])
    env = 0.5 * (torch.tanh((z - model["rr0"]) / model["sig_rr"]) + 1.0)
    return model["u0"] * env * torch.sin(phase)


def _truncated_normal(gen, lo: float, hi: float, n: int):
    erf = lambda x: math.erf(x / math.sqrt(2.0))
    u = torch.rand((n,), generator=gen, dtype=torch.float64, device=gen.device)
    u = erf(lo) + (erf(hi) - erf(lo)) * u
    return torch.clamp(math.sqrt(2.0) * torch.special.erfinv(u), lo, hi)


def population(conf: dict, seed: int, device) -> Population:
    """The cell's ray volumes from ``seed``, in float64 on ``device``;
    ``conf`` is a configuration file's contents."""
    model, spec = conf["model"], conf["spectrum"]
    n = int(conf["n_ray"])
    gen = generator(seed, device)
    f64 = dict(dtype=torch.float64, device=device)
    ones = torch.ones((n,), **f64)
    k_abs = 2.0 * math.pi / spec["wavelength_h"]
    m_c, m_s = spec["m_center"], spec["m_sigma"]
    draw = _truncated_normal(gen, -spec["m_halfwidth"], spec["m_halfwidth"], n)
    jitter = torch.exp(0.3 * torch.randn((n,), generator=gen, **f64))
    z_off = spec["dz_launch"] * (torch.rand((n,), generator=gen, **f64) - 0.5)
    m = torch.clamp(m_c + m_s * draw, max=-k_abs)
    r = spec["z_launch"] + z_off
    dr = ones * spec["dz_launch"]
    area = 5e-5 * dr
    dm = area / dr
    k = ones * k_abs
    l = torch.zeros_like(ones)
    dkk = ones * 1e-4
    dll = ones * 1e-4
    phi0 = model["phi0"]
    ff = 2.0 * ROT_EARTH * math.sin(phi0)
    z = centers(conf["grid"]).to(device)
    rhobar = model["rhobar0"] * (torch.ones_like(z) if model["boussinesq"]
                                 else torch.exp(-z / model["hh"]))
    rho_ray = interp(r, z, rhobar)
    bvf = model["bvf"]
    omh = torch.sqrt((bvf * bvf * k * k + ff * ff * m * m) / (k * k + m * m))
    spectrum = torch.exp(-((m - m_c) ** 2) / 2.0 / m_s**2)
    amplitude = (spec["amplitude_alpha"] ** 2 * rho_ray / 2.0 * omh / m**2
                 / (omh**2 - ff**2) * bvf**2)
    dens = amplitude * spectrum * jitter / dkk / dll / dm
    return Population(dens=dens, lam=torch.zeros_like(r), phi=ones * phi0,
                      r=r, dr=dr, k=k, l=l, m=m, dm=dm, dkk=dkk, dll=dll,
                      area=area)
