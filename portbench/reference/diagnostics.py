"""The reference driver's conservation diagnostics of one frame, written
out from ``python-msgwam`` ``raytracer.py:210-237``: the wave action
(``var=2``: each ray's density) deposited onto the cells of the *face*
grid, and the wave-action flux (``var=1``: the vertical group velocity
times the density) onto the cells of the *center* grid, both with the
ray's phase-space volume ``|dk dl dm|`` and the index rule of
:func:`.model.deposit`.  Plain PyTorch in the dtype of its inputs; it
imports nothing of the program."""

from __future__ import annotations

import torch

from .model import Column, Frozen, Rays, cg_r, deposit


def wave_action(rays: Rays, fz: Frozen, col: Column, bvf: float,
                stored=None) -> tuple:
    """``(wave_action, flux)`` of the active rays: ``(len(faces) - 1,)``
    on the face grid's cells and ``(len(centers) - 1,)`` on the center
    grid's.

    ``stored`` is the precision the rays' heights and extents are kept in
    (default: the inputs' own).  The edges ``r -/+ dr / 2`` and the index
    rule's ratios are evaluated in it, the deposit in the inputs' dtype:
    the rule truncates ``edge / dz`` from origin 0 while the center grid's
    cells start half a cell up, so an edge within one rounding of a
    multiple of ``dz`` moves half a cell of the ray's flux, and the cell
    such a ray falls in is the one its own precision puts it in."""
    phase_vol = (fz.dkk * fz.dll * fz.dm).abs()
    r, dr = rays.r, fz.dr
    if stored is not None:
        r, dr = r.to(stored), dr.to(stored)
    lo = (r - 0.5 * dr).to(rays.r.dtype)
    up = (r + 0.5 * dr).to(rays.r.dtype)
    action = deposit(rays.dens[None], lo, up, phase_vol, rays.active, col.faces,
                     stored)
    cgr = cg_r(fz.k, fz.l, rays.m, fz.phi, bvf)
    flux = deposit((cgr * rays.dens)[None], lo, up, phase_vol, rays.active,
                   col.centers, stored)
    return action[0], flux[0]
