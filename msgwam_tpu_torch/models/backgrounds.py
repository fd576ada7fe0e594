"""Analytic background wind profiles: the counterpart of
:mod:`msgwam_tpu.models.backgrounds`.  Pure functions of height (and
config) on tensors, with the reference's quirks kept as written."""

from __future__ import annotations

import math

import torch

from ..config import ModelConfig


def velocities_tanh(lam, phi, rr, cfg: ModelConfig):
    """3-D jet: Gaussian in φ, tanh in r.  Like the reference, returns a
    ``(4, 3) + shape`` array with the zonal wind in slot [0]."""
    envelope = (
        torch.exp(-((phi - cfg.phi0) ** 2) / 2.0 / cfg.sig_phi**2)
        * (torch.tanh((rr - cfg.rr0) / cfg.sig_rr) + 1.0)
        * 0.5
    )
    uu = cfg.u0 * envelope
    out = torch.zeros((4, 3) + tuple(lam.shape), dtype=uu.dtype,
                      device=uu.device)
    out[0] = uu
    return out


def velocities_tanh_homogeneous(rr, cfg: ModelConfig):
    """Horizontally homogeneous tanh jet."""
    return cfg.u0 * 0.5 * (torch.tanh((rr - cfg.rr0) / cfg.sig_rr) + 1.0)


def velocities_gauss_homogeneous(rr, cfg: ModelConfig):
    """Horizontally homogeneous Gaussian jet.  The reference's dead-zone
    mask asks for ``rr <= rr0 - 3σ`` *and* ``rr >= rr0 + 3σ``, so it never
    fires (quirk, kept as written)."""
    uu = cfg.u0 * torch.exp(-((rr - cfg.rr0) ** 2) / 2.0 / cfg.sig_rr**2)
    dead = (rr <= cfg.rr0 - 3 * cfg.sig_rr) & (rr >= cfg.rr0 + 3 * cfg.sig_rr)
    return torch.where(dead, torch.zeros_like(uu), uu)


def velocities_sine_homogeneous(rr, cfg: ModelConfig):
    """tanh-enveloped sine jet, the profile the reference driver runs."""
    envelope = 0.5 * (torch.tanh((rr - cfg.rr0) / cfg.sig_rr) + 1.0)
    return cfg.u0 * envelope * torch.sin(rr / cfg.sig_rr * 2.0 * math.pi)


def tidal_shear(rr, t, cfg: ModelConfig, period: float = 43200.0,
                lambda_z: float = 30e3):
    """Transient, downward-phase-propagating tidal wind U(z, t)."""
    phase = 2.0 * math.pi * (rr / lambda_z + t / period)
    envelope = 0.5 * (torch.tanh((rr - cfg.rr0) / cfg.sig_rr) + 1.0)
    return cfg.u0 * envelope * torch.sin(phase)
